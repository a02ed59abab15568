"""ctypes loaders for the framework-free native components: the
max-clique solver (`csrc/maxclique.cpp`, the same bytes as the
reference's `native/maxclique.cpp`) and the binary scan log with its
prefetching reader (`csrc/scanlog.cpp`, the port's copy of
`native/scanlog.cpp`).

Each source is compiled with g++ into `mr_slam_torch/build/` (listed in
`.gitignore`) at first use; the library name carries a digest of the
source and the flags. Unlike the reference, which drops to fallbacks
when its build fails (a greedy clique heuristic, no scan log), a failed
build raises here.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent
_SRC = _PKG / "csrc" / "maxclique.cpp"
_SCANLOG_SRC = _PKG / "csrc" / "scanlog.cpp"
_BUILD = _PKG / "build"
_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


def _build(src: Path, extra: tuple[str, ...] = ()) -> ctypes.CDLL:
    """Compile `src` (if its library is not built yet) and load it."""
    flags = _FLAGS + extra
    digest = hashlib.sha256(src.read_bytes() + " ".join(flags).encode()).hexdigest()
    lib_path = _BUILD / f"lib{src.stem}-{digest[:16]}.so"
    if not lib_path.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(["g++", *flags, "-o", str(tmp), str(src)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"building {src.name} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    return ctypes.CDLL(str(lib_path))


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the max-clique library."""
    lib = _build(_SRC)
    lib.mrslam_max_clique.restype = ctypes.c_int
    lib.mrslam_max_clique.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
    return lib


@functools.cache
def load_scanlog() -> ctypes.CDLL:
    """Build (if needed) and load the scan-log library."""
    lib = _build(_SCANLOG_SRC, ("-pthread",))
    lib.mrslam_scanlog_writer_open.restype = ctypes.c_void_p
    lib.mrslam_scanlog_writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint32]
    lib.mrslam_scanlog_write.restype = ctypes.c_int
    lib.mrslam_scanlog_write.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_uint32,
    ]
    lib.mrslam_scanlog_writer_close.argtypes = [ctypes.c_void_p]
    lib.mrslam_scanlog_open.restype = ctypes.c_void_p
    lib.mrslam_scanlog_open.argtypes = [ctypes.c_char_p]
    lib.mrslam_scanlog_n_frames.restype = ctypes.c_uint32
    lib.mrslam_scanlog_n_frames.argtypes = [ctypes.c_void_p]
    lib.mrslam_scanlog_max_points.restype = ctypes.c_uint32
    lib.mrslam_scanlog_max_points.argtypes = [ctypes.c_void_p]
    lib.mrslam_scanlog_next.restype = ctypes.c_int64
    lib.mrslam_scanlog_next.argtypes = [
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_double),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ]
    lib.mrslam_scanlog_close.argtypes = [ctypes.c_void_p]
    return lib


def max_clique(adj: np.ndarray) -> np.ndarray:
    """Indices of a maximum clique of the boolean adjacency `adj` (exact
    branch-and-bound, mode 0; the solver falls back to its heuristic
    inside when the node budget is exceeded)."""
    lib = load()
    adj = np.ascontiguousarray(np.asarray(adj, bool).astype(np.uint8))
    n = adj.shape[0]
    out = np.zeros((max(n, 1),), np.int32)
    size = lib.mrslam_max_clique(
        adj.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), n,
        0,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int)),
    )
    return out[:size].astype(np.int64)


def _fptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


class ScanLogWriter:
    """Write a binary scan log (see `csrc/scanlog.cpp` for the format):
    per frame a stamp, a 3x4 pose (R row-major, t) and up to
    `max_points` points."""

    def __init__(self, path: str, max_points: int):
        self._lib = load_scanlog()
        self._h = self._lib.mrslam_scanlog_writer_open(path.encode(), max_points)
        if not self._h:
            raise OSError(f"cannot open {path}")

    def write(self, stamp: float, pose12: np.ndarray, xyz: np.ndarray) -> None:
        pose12 = np.ascontiguousarray(pose12, np.float32)
        xyz = np.ascontiguousarray(xyz, np.float32)
        if pose12.size != 12 or xyz.ndim != 2 or xyz.shape[1] != 3:
            raise ValueError(f"pose12 needs 12 values and xyz (n, 3): {pose12.shape}, {xyz.shape}")
        if not self._h:
            raise ValueError("write to a closed scan log")
        self._lib.mrslam_scanlog_write(self._h, float(stamp), _fptr(pose12), _fptr(xyz),
                                       xyz.shape[0])

    def close(self) -> None:
        if self._h:
            self._lib.mrslam_scanlog_writer_close(self._h)
            self._h = None


class ScanLogReader:
    """Iterate prefetched frames: (stamp, pose12, xyz padded to
    max_points with 1e6, n). A background thread decodes ahead."""

    def __init__(self, path: str):
        self._lib = load_scanlog()
        self._h = self._lib.mrslam_scanlog_open(path.encode())
        if not self._h:
            raise OSError(f"cannot open {path}")
        self.n_frames = self._lib.mrslam_scanlog_n_frames(self._h)
        self.max_points = self._lib.mrslam_scanlog_max_points(self._h)

    def __iter__(self):
        while True:
            stamp = ctypes.c_double()
            pose = np.zeros((12,), np.float32)
            xyz = np.zeros((self.max_points, 3), np.float32)
            n = self._lib.mrslam_scanlog_next(self._h, ctypes.byref(stamp), _fptr(pose),
                                              _fptr(xyz))
            if n < 0:
                return
            yield stamp.value, pose, xyz, int(n)

    def close(self) -> None:
        if self._h:
            self._lib.mrslam_scanlog_close(self._h)
            self._h = None
