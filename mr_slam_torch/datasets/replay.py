"""Bag-style replay: a host feeder that streams timestamped multi-robot
frames into the online session (port of `mr_slam_tpu/datasets/
replay.py`: `Frame`, `synthetic_bag`, `scanlog_bag`, `replay`).

The reference system is driven by rosbag playback: frames fan out to
the per-robot odometry nodes and robots are discovered as their topics
appear. Here a "bag" is any iterable of `Frame(stamp, robot, scan)`
records sorted by stamp; `replay` feeds them into an `OnlineSlam` in
stamp order, registering robots on first sight.

Sources:
  * `synthetic_bag` — raycast a multi-robot synthetic world (the port's
    numpy raycaster, one seeded numpy generator per robot) into an
    interleaved frame stream;
  * `scanlog_bag` — read frames from native binary scan logs
    (`csrc/scanlog.cpp`), one file per robot, merged by stamp;
  * any user iterable of `Frame`s.

Clouds are CPU tensors; the session moves them to its device.
"""
from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import Iterable, Iterator, Sequence

import numpy as np
import torch

from ..geometry import se3
from ..geometry.se3 import Pose
from ..ops import pointcloud as pcl
from . import synthetic


@dataclass
class Frame:
    stamp: float
    robot: int
    scan: pcl.PointCloud          # body-frame masked cloud
    origin: Pose | None = None    # robot's initial pose (first frame only)
    imu: tuple | None = None      # (gyro (S,3), acc (S,3), dt (S)) packet
    times: object | None = None   # (P,) sweep-relative point times


def synthetic_bag(
    world,
    trajs: Sequence[Pose],
    n_frames: int,
    frame_dt: float = 0.1,
    stagger: float = 0.03,
    n_rings: int = 16,
    n_azimuth: int = 512,
    seed: int = 0,
    with_imu: bool = False,
    imu_sub: int = 10,
) -> list[Frame]:
    """Raycast an interleaved multi-robot frame stream: robot r's frame
    i is stamped i * frame_dt + r * stagger, so robots' frames
    interleave like concurrent rosbag topics. Robot r's range noise is
    drawn from `np.random.default_rng(seed + r)`. IMU packets belong to
    the LIO front-end, which is not ported: `with_imu=True` raises."""
    if with_imu:
        raise NotImplementedError("IMU packets feed the LIO front-end: ROADMAP Queue 1 step 14")
    frames: list[Frame] = []
    for r, traj in enumerate(trajs):
        rng = np.random.default_rng(seed + r)
        for i in range(n_frames):
            xyz, _, hit = synthetic.scan(world, se3.index(traj, i), n_rings=n_rings,
                                         n_azimuth=n_azimuth, rng=rng)
            frames.append(Frame(
                stamp=i * frame_dt + r * stagger,
                robot=r,
                scan=synthetic.scan_to_cloud(xyz, hit),
                origin=se3.index(traj, 0) if i == 0 else None,
            ))
    frames.sort(key=lambda f: f.stamp)
    return frames


def scanlog_bag(paths: dict[int, str]) -> Iterator[Frame]:
    """Merge per-robot native scan logs ({robot: path}) into one
    stamp-ordered stream (multi-bag playback). A robot's first frame
    carries its log's pose as the origin."""
    from .. import native

    readers = {r: native.ScanLogReader(p) for r, p in paths.items()}
    iters = {r: iter(rd) for r, rd in readers.items()}
    heap: list[tuple[float, int, tuple]] = []

    def push(r: int) -> None:
        rec = next(iters[r], None)
        if rec is None:
            readers[r].close()
        else:
            heapq.heappush(heap, (rec[0], r, rec))

    first_seen: set[int] = set()
    try:
        for r in iters:
            push(r)
        while heap:
            _, r, (st, pose12, xyz, n) = heapq.heappop(heap)
            origin = None
            if r not in first_seen:
                first_seen.add(r)
                P = torch.from_numpy(np.asarray(pose12, np.float32).reshape(3, 4))
                origin = Pose(P[:, :3].contiguous(), P[:, 3].contiguous())
            mask = torch.arange(xyz.shape[0]) < n
            yield Frame(stamp=float(st), robot=r,
                        scan=pcl.park(pcl.PointCloud(torch.from_numpy(xyz), mask)), origin=origin)
            push(r)
    finally:  # a consumer that stops early leaves readers (and their threads) open
        for rd in readers.values():
            rd.close()


def replay(frames: Iterable[Frame], session) -> int:
    """Stream frames into an `OnlineSlam` session in stamp order,
    registering robots on first sight. Returns the frame count."""
    n = 0
    for f in frames:
        if f.robot not in session.robots:
            session.register_robot(f.robot, f.origin)
        session.add_frame(f.robot, f.scan, stamp=f.stamp, times=f.times, imu=f.imu)
        n += 1
    return n
