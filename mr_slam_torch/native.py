"""ctypes loader for the framework-free native max-clique solver.

The port keeps its own copy of the reference's solver source,
`mr_slam_torch/csrc/maxclique.cpp` (the same bytes as the reference's
`native/maxclique.cpp`), and compiles it with g++ into
`mr_slam_torch/build/` (listed in `.gitignore`) at first use. Unlike the
reference, which drops to a greedy heuristic when the build fails
(`pcm.py:122-131`), a failed build raises here.
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
_BUILD = _PKG / "build"
_FLAGS = ("-O2", "-std=c++17", "-fPIC", "-shared")


@functools.cache
def load() -> ctypes.CDLL:
    """Build (if needed) and load the max-clique library."""
    digest = hashlib.sha256(_SRC.read_bytes() + " ".join(_FLAGS).encode()).hexdigest()
    lib_path = _BUILD / f"libmaxclique-{digest[:16]}.so"
    if not lib_path.exists():
        _BUILD.mkdir(parents=True, exist_ok=True)
        tmp = lib_path.with_name(f"{lib_path.name}.{os.getpid()}.tmp")
        proc = subprocess.run(
            ["g++", *_FLAGS, "-o", str(tmp), str(_SRC)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"building {_SRC.name} failed:\n{proc.stdout}{proc.stderr}")
        os.replace(tmp, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.mrslam_max_clique.restype = ctypes.c_int
    lib.mrslam_max_clique.argtypes = [
        ctypes.POINTER(ctypes.c_uint8), ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int),
    ]
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
