"""Time-interpolated transform tree — the tf2 analogue (port of
`mr_slam_tpu/geometry/tf_tree.py`, host numpy, the same code).

The reference system publishes the `/map -> robot_N/odom` frame chain
at 10 Hz (`global_manager.cpp:2242-2276` `publishTF`) through tf2. This
module is the host-runtime equivalent: a small buffer of time-stamped
transforms per frame pair with slerp/lerp interpolation and frame-chain
composition. Device code receives resolved poses as tensors.
"""
from __future__ import annotations

from bisect import bisect_left
from typing import Dict, List, Tuple

import numpy as np


def _quat_from_R(R: np.ndarray) -> np.ndarray:
    """Rotation matrix -> unit quaternion (w, x, y, z)."""
    t = np.trace(R)
    if t > 0:
        s = np.sqrt(t + 1.0) * 2
        return np.array([
            0.25 * s,
            (R[2, 1] - R[1, 2]) / s,
            (R[0, 2] - R[2, 0]) / s,
            (R[1, 0] - R[0, 1]) / s,
        ])
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(R[i, i] - R[j, j] - R[k, k] + 1.0) * 2
    q = np.zeros(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
    return q


def _R_from_quat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q / np.linalg.norm(q)
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def _slerp(q0: np.ndarray, q1: np.ndarray, a: float) -> np.ndarray:
    d = float(np.dot(q0, q1))
    if d < 0.0:
        q1, d = -q1, -d
    if d > 0.9995:
        out = q0 + a * (q1 - q0)
        return out / np.linalg.norm(out)
    th = np.arccos(np.clip(d, -1.0, 1.0))
    return (np.sin((1 - a) * th) * q0 + np.sin(a * th) * q1) / np.sin(th)


class TransformBuffer:
    """Buffer of stamped parent<-child transforms over a frame tree.

    `set_transform(parent, child, stamp, R, t)` appends (out-of-order
    stamps are inserted); `lookup(target, source, stamp)` returns the
    (R, t) mapping source-frame coordinates into target-frame
    coordinates at `stamp`, interpolating (slerp + lerp) between the
    bracketing samples and composing across the tree path — tf2's
    `lookupTransform` semantics."""

    def __init__(self, cache_size: int = 10000):
        self.cache_size = cache_size
        # (parent, child) -> (stamps list, quats list, ts list)
        self._edges: Dict[Tuple[str, str], Tuple[List[float], list, list]] = {}
        self._adj: Dict[str, List[str]] = {}
        # resolved frame paths, invalidated on topology change only
        self._paths: Dict[Tuple[str, str], List[str]] = {}

    def set_transform(self, parent: str, child: str, stamp: float,
                      R: np.ndarray, t: np.ndarray) -> None:
        key = (parent, child)
        if key not in self._edges:
            if (child, parent) in self._edges:
                raise ValueError(f"edge {child}<-{parent} already exists "
                                 "with opposite orientation")
            self._edges[key] = ([], [], [])
            self._adj.setdefault(parent, []).append(child)
            self._adj.setdefault(child, []).append(parent)
            self._paths.clear()  # topology changed
        stamps, quats, ts = self._edges[key]
        q = _quat_from_R(np.asarray(R, np.float64))
        tv = np.asarray(t, np.float64).copy()
        stamp = float(stamp)
        if not stamps or stamp >= stamps[-1]:
            # fast path: stamps are usually monotonic (10 Hz publishers)
            stamps.append(stamp)
            quats.append(q)
            ts.append(tv)
        else:
            i = bisect_left(stamps, stamp)
            stamps.insert(i, stamp)
            quats.insert(i, q)
            ts.insert(i, tv)
        if len(stamps) > self.cache_size + (self.cache_size >> 2):
            # amortized O(1)/insert trim to cache_size
            cut = len(stamps) - self.cache_size
            del stamps[:cut], quats[:cut], ts[:cut]

    def frames(self) -> List[str]:
        return sorted(self._adj)

    def _edge_at(self, parent: str, child: str, stamp: float):
        stamps, quats, ts = self._edges[(parent, child)]
        if not stamps:
            raise LookupError(f"no data for {parent}<-{child}")
        i = bisect_left(stamps, stamp)
        if i == 0:
            q, t = quats[0], ts[0]
        elif i == len(stamps):
            q, t = quats[-1], ts[-1]
        else:
            s0, s1 = stamps[i - 1], stamps[i]
            a = 0.0 if s1 == s0 else (stamp - s0) / (s1 - s0)
            q = _slerp(quats[i - 1], quats[i], a)
            t = (1 - a) * ts[i - 1] + a * ts[i]
        return _R_from_quat(q), t

    def _path(self, src: str, dst: str) -> List[str]:
        cached = self._paths.get((src, dst))
        if cached is not None:
            return cached
        if src not in self._adj or dst not in self._adj:
            raise LookupError(f"unknown frame in {src}->{dst}")
        prev = {src: src}
        queue = [src]
        while queue:
            f = queue.pop(0)
            if f == dst:
                break
            for g in self._adj[f]:
                if g not in prev:
                    prev[g] = f
                    queue.append(g)
        if dst not in prev:
            raise LookupError(f"frames {src} and {dst} are not connected")
        path = [dst]
        while path[-1] != src:
            path.append(prev[path[-1]])
        path = path[::-1]
        self._paths[(src, dst)] = path
        return path

    def lookup(self, target: str, source: str, stamp: float):
        """(R, t) with x_target = R @ x_source + t."""
        R = np.eye(3)
        t = np.zeros(3)
        path = self._path(source, target)
        for a, b in zip(path, path[1:]):
            # hop a -> b: need transform mapping a-coords into b-coords
            if (b, a) in self._edges:          # b is parent of a
                Rh, th = self._edge_at(b, a, stamp)
            else:                               # a is parent of b: invert
                Rp, tp = self._edge_at(a, b, stamp)
                Rh = Rp.T
                th = -Rp.T @ tp
            R = Rh @ R
            t = Rh @ t + th
        return R, t

    def can_transform(self, target: str, source: str) -> bool:
        try:
            self._path(source, target)
            return True
        except LookupError:
            return False


def publish_map_to_odom(buffer: TransformBuffer, robot: int,
                        map_T_odom: np.ndarray, stamp: float) -> None:
    """The back-end's TF product: `/map -> robot_N/odom` from the
    optimized map transform (`publishTF`, `global_manager.cpp:2242`)."""
    R = np.asarray(map_T_odom[:3, :3])
    t = np.asarray(map_T_odom[:3, 3])
    buffer.set_transform("map", f"robot_{robot}/odom", stamp, R, t)
