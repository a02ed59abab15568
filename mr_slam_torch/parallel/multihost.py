"""The multi-process runtime over a robot axis of ranks (port of
`mr_slam_tpu/parallel/multihost.py`: `initialize`, `robot_mesh`,
`local_robot_ids`, `feed_global`, `frontend_spmd`,
`_replicate_to_hosts`, `run_multihost`).

It replaces the reference's one-ROS-node-set-per-robot topology
(`global_manager.cpp:287-442`) with three pieces:

  * every process calls `initialize()` (`init_process_group`) and owns a
    contiguous block of the robots (`local_robot_ids`), whose scans it
    keeps on its own device (`feed_global`);
  * each process runs its robots' front-ends, one after another as
    `pipeline.run` does (`frontend_spmd`), then one all-gather
    replicates every robot's keyframe store, odometry and keyframe flags
    to every process (`_replicate_to_hosts`);
  * the back-end runs redundantly on every process with identical
    inputs: robot pairs are shared out between processes for loop
    verification, the accepted loops all-gathered, and the pose graph
    solved with its edges sharded over the processes
    (`pipeline.run_backend(..., group=...)`).

The reference's `_SPMD_CACHE` (a bounded LRU of jitted `shard_map`
programs) has no counterpart: the port compiles no programs, so there
is nothing to memoize, and a rank's front-end products are those of
the single-process run on the same device, bit for bit.

The backend follows from the layout, chosen here and not by trial:
gloo on the CPU; NCCL when each rank has its own card; gloo when
several ranks of one host share a card, since NCCL refuses two ranks of
one communicator on one device. The layout is read per host
(LOCAL_WORLD_SIZE), so ranks spread over hosts of one card each take
NCCL. Gloo runs `all_reduce` and `all_gather` on
CUDA tensors (through pinned host copies), which is all the port uses.
"""
from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

from ..frontend import keyframes as kf
from ..geometry.se3 import Pose
from ..ops import pointcloud as pcl
from . import mesh

ROBOT_AXIS = mesh.ROBOT_AXIS
TIMEOUT_S = 300.0  # a rank that dies cannot hold the others in a collective longer


def choose_backend(device: torch.device, num_processes: int) -> tuple[str, str]:
    """(backend, why) for `num_processes` ranks, each on `device`'s type,
    decided from the ranks on THIS host: the LOCAL_WORLD_SIZE that
    `multihost_worker.launch` (or torchrun) sets, else `num_processes`
    (every rank on this host). NCCL when this host's ranks have a card
    each, gloo when some of them share one (NCCL refuses two ranks of one
    communicator on one device) or run on the CPU. So two hosts of one
    card each, one rank a host, take NCCL."""
    if device.type != "cuda":
        return "gloo", "CPU ranks"
    local_processes = int(os.environ.get("LOCAL_WORLD_SIZE", num_processes))
    cards = torch.cuda.device_count()
    if local_processes > cards:
        return "gloo", (f"{local_processes} ranks on this host share {cards} card(s): NCCL "
                        "refuses two ranks of one communicator on one device")
    return "nccl", (f"{local_processes} of {num_processes} ranks on this host's {cards} "
                    "card(s), one card a rank")


def initialize(
    coordinator_address: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    device="cuda",
) -> torch.device:
    """`init_process_group` with the reference's environment fallbacks
    (MRSLAM_COORDINATOR, MRSLAM_NUM_PROCESSES, MRSLAM_PROCESS_ID); a
    no-op for a single process (nothing configured). Returns this rank's
    device: `device`'s type, and on a CUDA machine the card
    rank % device_count (the card unless the caller asks for the CPU; a
    missing card raises). `coordinator_address` is host:port or an
    init-method URL (tcp://..., file://...). Every collective that waits
    longer than TIMEOUT_S raises."""
    from ..runtime.online import resolve_device

    dev = resolve_device(device)
    coordinator_address = coordinator_address or os.environ.get("MRSLAM_COORDINATOR")
    if num_processes is None and "MRSLAM_NUM_PROCESSES" in os.environ:
        num_processes = int(os.environ["MRSLAM_NUM_PROCESSES"])
    if process_id is None and "MRSLAM_PROCESS_ID" in os.environ:
        process_id = int(os.environ["MRSLAM_PROCESS_ID"])
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", (process_id or 0) % torch.cuda.device_count())
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    if coordinator_address is None or num_processes in (None, 1):
        return dev
    backend, _ = choose_backend(dev, num_processes)
    url = coordinator_address if "://" in coordinator_address else f"tcp://{coordinator_address}"
    dist.init_process_group(backend, init_method=url, world_size=num_processes,
                            rank=process_id, timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return dev


def robot_mesh(n_robots: int | None = None) -> mesh.Mesh:
    """The 1-D robot mesh over every rank. Each rank owns one contiguous
    block of the robots (`local_robot_ids`), all blocks of one size:
    `n_robots` (default: one a rank) must be a multiple of the ranks."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    n = world if n_robots is None else n_robots
    if n % world:
        raise ValueError(f"{n} robots do not split evenly over {world} ranks")
    return mesh.make_mesh(world, 1)


def local_robot_ids(m: mesh.Mesh, n_robots: int) -> list[int]:
    """The robots this rank owns: its contiguous block of the robot axis."""
    return list(range(n_robots))[mesh.block(n_robots, m.shape[ROBOT_AXIS], m.index(ROBOT_AXIS))]


def feed_global(local_blocks: dict[int, object], device) -> dict[int, object]:
    """The host feeder: this rank's per-robot blocks (`PointCloud`s or
    `Pose`s of numpy arrays or tensors) as tensors on its device. There
    is no global array to assemble: each rank keeps its own robots."""
    def move(x):
        return torch.as_tensor(x).to(device)

    return {r: type(b)(*(move(x) for x in b)) for r, b in local_blocks.items()}


def frontend_spmd(scans: dict[int, pcl.PointCloud], cfg, origins: dict[int, Pose]) -> dict:
    """This rank's robots' front-ends, one after another, as
    `pipeline.run` runs them: {robot: RobotResult}."""
    from ..runtime import observability as obs
    from ..runtime import pipeline as pl

    out = {}
    for r in sorted(scans):
        with obs.tracer.span(f"robot{r}"):
            out[r] = pl.run_frontend(scans[r], cfg.for_robot(r), origins[r])
    return out


def _robot_tensors(rr) -> list[torch.Tensor]:
    """A RobotResult as the tensors that travel: the keyframe store, the
    odometry poses and the per-frame keyframe flags."""
    s = rr.store
    T = rr.odom_poses.t.shape[0]
    flags = torch.zeros(T, dtype=torch.bool)
    flags[torch.as_tensor(rr.kf_frame_idx, dtype=torch.int64)] = True
    return [s.xyz, s.mask, s.poses.R, s.poses.t, s.stamps, s.count, s.last_pose.R,
            s.last_pose.t, rr.odom_poses.R, rr.odom_poses.t, flags.to(s.xyz.device)]


def _to_bytes(tensors: list[torch.Tensor]) -> torch.Tensor:
    return torch.cat([t.contiguous().reshape(-1).view(torch.uint8) for t in tensors])


def _from_bytes(buf: torch.Tensor, like: list[torch.Tensor]) -> list[torch.Tensor]:
    out, at = [], 0
    for t in like:
        n = t.numel() * t.element_size()
        out.append(buf[at:at + n].clone().view(t.dtype).reshape(t.shape))
        at += n
    return out


def _replicate_to_hosts(local: dict, n_robots: int, group) -> list:
    """Every robot's RobotResult on every rank, from each rank's own
    block of robots: one all-gather of the fixed-capacity keyframe
    stores, odometry poses and keyframe flags, packed as bytes (the
    collective in place of the reference's hub-and-spoke SubMap fan-in).
    The bytes arrive unchanged, so every copy equals its owner's bit for
    bit."""
    from ..runtime import pipeline as pl

    like = _robot_tensors(local[min(local)])
    buf = torch.stack([_to_bytes(_robot_tensors(local[r])) for r in sorted(local)])
    if group is not None:
        buf = mesh.all_gather(buf, group).flatten(0, 1)
    if buf.shape[0] != n_robots:
        raise ValueError(f"{buf.shape[0]} robots' products for {n_robots} robots")
    robots = []
    for r in range(n_robots):
        (xyz, mask, kR, kt, stamps, count, lR, lt, oR, ot, flags) = _from_bytes(buf[r], like)
        store = kf.KeyframeStore(xyz=xyz, mask=mask, poses=Pose(kR, kt), stamps=stamps,
                                 count=count, last_pose=Pose(lR, lt))
        robots.append(pl.RobotResult(
            odom_poses=Pose(oR, ot), store=store,
            kf_frame_idx=np.flatnonzero(flags.cpu().numpy()).astype(np.int64),
        ))
    return robots


def run_multihost(scans: dict, cfg, origins: dict, m: mesh.Mesh):
    """Multi-robot SLAM across processes: this rank's front-ends, then
    every robot's products replicated to every rank, then the back-end
    on every rank with robot pairs shared out and the pose graph solved
    edge-sharded over the robot axis (identical inputs, so every rank
    returns the same `SlamResult`). `scans` / `origins`: this rank's
    robots (`feed_global`)."""
    from ..runtime import observability as obs
    from ..runtime import pipeline as pl

    group = m.group(ROBOT_AXIS)
    dev = next(iter(scans.values())).xyz.device
    with obs.tracer.span("multihost.frontend"):
        local = frontend_spmd(scans, cfg, origins)
    with obs.tracer.span("multihost.replicate"):
        robots = _replicate_to_hosts(local, cfg.n_robots, group)
        pl._sync(dev)
    return pl.run_backend(robots, cfg, group=group)
