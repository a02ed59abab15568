"""Minimal PCD (Point Cloud Data) writer/reader (port of
`mr_slam_tpu/eval/pcd.py`: `write_pcd`, `read_pcd`, `cloud_to_pcd`) —
artifact parity with the reference system's `pcl::io::savePCDFile*`
dumps (`savingGlobalMap`, `global_manager.cpp:143-170`). Host numpy; the
files are byte for byte the reference package's."""
from __future__ import annotations

import numpy as np

from ..ops.pointcloud import PointCloud


def write_pcd(path: str, xyz: np.ndarray, binary: bool = True, intensity=None):
    """Write Nx3 float32 points (+ optional intensity column)."""
    xyz = np.ascontiguousarray(xyz, np.float32)
    n = xyz.shape[0]
    extra = intensity is not None
    header = (
        "# .PCD v0.7 - Point Cloud Data file format\n"
        "VERSION 0.7\n"
        f"FIELDS x y z{' intensity' if extra else ''}\n"
        f"SIZE 4 4 4{' 4' if extra else ''}\n"
        f"TYPE F F F{' F' if extra else ''}\n"
        f"COUNT 1 1 1{' 1' if extra else ''}\n"
        f"WIDTH {n}\nHEIGHT 1\nVIEWPOINT 0 0 0 1 0 0 0\nPOINTS {n}\n"
        f"DATA {'binary' if binary else 'ascii'}\n"
    )
    data = xyz if not extra else np.concatenate(
        [xyz, np.asarray(intensity, np.float32).reshape(-1, 1)], axis=1
    )
    with open(path, "wb") as f:
        f.write(header.encode())
        if binary:
            f.write(np.ascontiguousarray(data, np.float32).tobytes())
        else:
            np.savetxt(f, data, fmt="%.6f")


def read_pcd(path: str) -> np.ndarray:
    """Read x/y/z(/intensity) PCD written by write_pcd or PCL."""
    with open(path, "rb") as f:
        header = {}
        n_fields = 3
        while True:
            line = f.readline().decode(errors="replace").strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key] = val
            if key == "FIELDS":
                n_fields = len(val.split())
            if key == "DATA":
                break
        n = int(header["POINTS"])
        if header["DATA"] == "binary":
            raw = np.frombuffer(f.read(4 * n_fields * n), np.float32)
            return raw.reshape(n, n_fields)
        return np.loadtxt(f).reshape(n, n_fields)


def cloud_to_pcd(path: str, pc: PointCloud, binary: bool = True):
    """Write the valid points of a masked cloud (any device)."""
    xyz = pc.xyz.detach().cpu().numpy()[pc.mask.cpu().numpy()]
    write_pcd(path, xyz, binary=binary)
