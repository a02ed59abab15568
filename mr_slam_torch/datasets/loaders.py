"""Real-dataset loaders: KITTI velodyne and NCLT (port of
`mr_slam_tpu/datasets/loaders.py`, host numpy, the same code).

Parity targets: A-LOAM's `kittiHelper.cpp` (KITTI raw -> topics) and
the NCLT sessions the reference system's Full Usage drives. Binary
files stream through numpy into fixed-capacity masked clouds; the
scanlog converter turns any sequence into the native prefetching format
(`mr_slam_torch/native.py`).
"""
from __future__ import annotations

import os
from typing import Iterator

import numpy as np

from ..ops.pointcloud import SENTINEL


def load_kitti_bin(path: str, capacity: int | None = None):
    """One KITTI velodyne .bin (Nx4 float32 x,y,z,reflectance) ->
    (xyz (C,3) float32 padded, mask (C,), intensity (C,))."""
    raw = np.fromfile(path, dtype=np.float32).reshape(-1, 4)
    n = raw.shape[0]
    c = capacity or n
    xyz = np.full((c, 3), SENTINEL, np.float32)
    mask = np.zeros((c,), bool)
    inten = np.zeros((c,), np.float32)
    m = min(n, c)
    xyz[:m] = raw[:m, :3]
    inten[:m] = raw[:m, 3]
    mask[:m] = True
    return xyz, mask, inten


def iter_kitti_sequence(
    velodyne_dir: str, capacity: int = 131072
) -> Iterator[tuple[int, np.ndarray, np.ndarray]]:
    """Yield (frame_index, xyz, mask) over a KITTI sequence directory
    (000000.bin, 000001.bin, ...) — `kittiHelper.cpp`'s read loop."""
    files = sorted(f for f in os.listdir(velodyne_dir) if f.endswith(".bin"))
    for i, f in enumerate(files):
        xyz, mask, _ = load_kitti_bin(os.path.join(velodyne_dir, f), capacity)
        yield i, xyz, mask


def load_kitti_poses(path: str) -> np.ndarray:
    """KITTI poses file (N lines of 12 floats, 3x4 row-major cam-frame
    pose) -> (N, 4, 4)."""
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    n = raw.shape[0]
    out = np.tile(np.eye(4, dtype=np.float64), (n, 1, 1))
    out[:, :3, :4] = raw
    return out


def load_nclt_velodyne_bin(path: str, capacity: int | None = None):
    """NCLT velodyne_sync .bin: packed little-endian x,y,z uint16
    (scaled by 0.005, offset -100) + intensity u8 + ring u8 per point.

    Returns (xyz (C,3), mask (C,), intensity (C,))."""
    raw = np.fromfile(path, dtype=np.uint8)
    rec = raw.reshape(-1, 8)
    xs = rec[:, 0].astype(np.uint16) | (rec[:, 1].astype(np.uint16) << 8)
    ys = rec[:, 2].astype(np.uint16) | (rec[:, 3].astype(np.uint16) << 8)
    zs = rec[:, 4].astype(np.uint16) | (rec[:, 5].astype(np.uint16) << 8)
    scale, offset = 0.005, -100.0
    pts = np.stack(
        [xs * scale + offset, ys * scale + offset, zs * scale + offset], axis=-1
    ).astype(np.float32)
    inten = rec[:, 6].astype(np.float32)
    n = pts.shape[0]
    c = capacity or n
    xyz = np.full((c, 3), SENTINEL, np.float32)
    mask = np.zeros((c,), bool)
    out_inten = np.zeros((c,), np.float32)
    m = min(n, c)
    xyz[:m] = pts[:m]
    out_inten[:m] = inten[:m]
    mask[:m] = True
    return xyz, mask, out_inten


def load_nclt_groundtruth(path: str) -> np.ndarray:
    """NCLT groundtruth CSV: utime, x, y, z, r, p, h -> (N, 7)."""
    return np.loadtxt(path, delimiter=",")


def to_scanlog(
    out_path: str,
    frames: Iterator[tuple[float, np.ndarray, np.ndarray]],
    max_points: int,
) -> int:
    """Convert any (stamp, xyz, mask) iterator into the native scanlog
    format (C++ prefetching reader). Returns frame count."""
    from .. import native

    w = native.ScanLogWriter(out_path, max_points)
    count = 0
    ident = np.eye(3, 4, dtype=np.float32).reshape(-1)
    try:
        for stamp, xyz, mask in frames:
            pts = np.asarray(xyz, np.float32)[np.asarray(mask, bool)]
            w.write(float(stamp), ident, pts[:max_points])
            count += 1
    finally:
        w.close()
    return count
