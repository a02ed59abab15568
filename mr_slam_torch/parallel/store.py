"""Batched multi-robot keyframe store — the array-native `RobotHandle`
(port of `mr_slam_tpu/parallel/store.py`: `MultiRobotStore`, `init`,
`ingest`, `gate_and_add`, `write_descriptor`, `robot_view`,
`cross_robot_distances`).

The whole multi-robot state is one NamedTuple of tensors with a leading
robot axis: every robot's keyframe clouds, poses and stamps (a batched
`KeyframeStore`) and its descriptor database (a dict of (R, K, ...)
tensors, or one flat (R, K, D) tensor).

Writes go IN PLACE, as `frontend/keyframes.maybe_add` does: a keyframe
append writes one (P, 3) row instead of copying the whole store. The
gate stays a device bool: `gate_and_add` always writes slot
min(count, capacity - 1) of its robot through `torch.where`, keeping the
old contents when the gate is closed, so a frame never waits on the
device. `robot_view` returns views of one row, which the next write
changes; a caller that keeps a view across frames clones it.

Robot and slot indices are host integers. `cross_robot_distances`
takes a process group for the reference's sharded branch: each rank
holds its robots' rows, and the databases are all-gathered over the
group along the robot axis (`parallel/mesh.all_gather`).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..frontend import keyframes as kf
from ..geometry.se3 import Pose
from ..ops import pointcloud as pcl

_BOUNDS = ((-150.0, -150.0, -150.0), (150.0, 150.0, 150.0))


def map_descriptors(fn, tree, *rest):
    """`fn` over the tensors of a descriptor tree (a dict of tensors, or
    one tensor), with matching trees `rest`."""
    if isinstance(tree, dict):
        return {k: fn(v, *(r[k] for r in rest)) for k, v in tree.items()}
    return fn(tree, *rest)


class MultiRobotStore(NamedTuple):
    """All per-robot state, robot-major. Every tensor has leading dim R.

    `descriptors` is a flat (R, K, D) tensor or a dict of (R, K, ...)
    tensors (the structured per-method descriptors of
    `pipeline.describe_one`)."""

    stores: kf.KeyframeStore       # batched over robots; count (R,) int64
    descriptors: object            # (R, K, D) tensor or dict of them
    desc_valid: torch.Tensor       # (R, K) bool

    @property
    def n_robots(self) -> int:
        return self.desc_valid.shape[0]

    @property
    def kf_capacity(self) -> int:
        return self.desc_valid.shape[1]

    def robot_view(self, row: int):
        """Single-robot (KeyframeStore, descriptors) views of row `row` —
        what the per-pair loop stage consumes."""
        s = self.stores
        store = kf.KeyframeStore(
            xyz=s.xyz[row], mask=s.mask[row], poses=Pose(s.poses.R[row], s.poses.t[row]),
            stamps=s.stamps[row], count=s.count[row],
            last_pose=Pose(s.last_pose.R[row], s.last_pose.t[row]),
        )
        return store, map_descriptors(lambda a: a[row], self.descriptors)


def init(
    n_robots: int,
    kf_capacity: int,
    points_per_kf: int,
    desc_dim: int | None = None,
    desc_template=None,
    device=None,
) -> MultiRobotStore:
    """`desc_dim`: flat (R, K, D) descriptor layout. `desc_template`:
    alternatively one un-batched descriptor dict (from
    `pipeline.describe_one`); buffers become (R, K, *leaf.shape)."""
    single = kf.init(kf_capacity, points_per_kf, device)

    def rep(x):
        return x[None].expand(n_robots, *x.shape).clone()

    stores = kf.KeyframeStore(
        xyz=rep(single.xyz), mask=rep(single.mask),
        poses=Pose(rep(single.poses.R), rep(single.poses.t)),
        stamps=rep(single.stamps), count=rep(single.count),
        last_pose=Pose(rep(single.last_pose.R), rep(single.last_pose.t)),
    )
    if desc_template is not None:
        descs = map_descriptors(
            lambda a: torch.zeros((n_robots, kf_capacity, *a.shape), dtype=a.dtype, device=device),
            desc_template,
        )
    else:
        descs = torch.zeros((n_robots, kf_capacity, desc_dim or 0), device=device)
    return MultiRobotStore(
        stores=stores, descriptors=descs,
        desc_valid=torch.zeros((n_robots, kf_capacity), dtype=torch.bool, device=device),
    )


def _write_rows(bufs, robot: int, idx: torch.Tensor, ok: torch.Tensor, vals) -> None:
    """For each (buf, val): buf[robot, idx] = val where `ok`, else kept.
    `idx` is a (1,) device index, so nothing syncs."""
    for buf, val in zip(bufs, vals):
        row = buf[robot]
        old = row.index_select(0, idx)[0]
        row.index_copy_(0, idx, torch.where(ok, val.to(buf.dtype), old)[None])


def ingest(
    store: MultiRobotStore,
    robot: int,
    cloud_xyz: torch.Tensor,
    cloud_mask: torch.Tensor,
    pose: Pose,
    stamp: torch.Tensor,
    descriptor,
) -> MultiRobotStore:
    """Append one (already gated, already voxelized) keyframe and its
    descriptor for `robot` — the SubMap + descriptor ingestion as one
    in-place write; a no-op when the robot's row is full."""
    s = store.stores
    count = s.count[robot]
    ok = count < store.kf_capacity
    idx = torch.clamp(count, max=store.kf_capacity - 1).reshape(1)
    names = [] if not isinstance(descriptor, dict) else list(descriptor)
    dbufs = [store.descriptors[k] for k in names] if names else [store.descriptors]
    dvals = [descriptor[k] for k in names] if names else [descriptor]
    _write_rows(
        [s.xyz, s.mask, s.poses.R, s.poses.t, s.stamps, *dbufs], robot, idx, ok,
        [cloud_xyz, cloud_mask, pose.R, pose.t, stamp.reshape(()), *dvals],
    )
    _write_rows([store.desc_valid], robot, idx, ok, [ok])  # valid |= ok
    s.count[robot] += ok.to(s.count.dtype)
    s.last_pose.R[robot] = pose.R
    s.last_pose.t[robot] = pose.t
    return store


def gate_and_add(
    store: MultiRobotStore,
    robot: int,
    cloud: pcl.PointCloud,
    pose: Pose,
    stamp: torch.Tensor,
    dist_thresh: float,
    leaf: float,
):
    """Distance gate + voxelize + append one frame for `robot` — the
    batched-store twin of `keyframes.maybe_add`, in place and without a
    host sync. The descriptor slot is written by a follow-up
    `write_descriptor` once the caller has described the stored cloud.
    Returns (store, added: device bool, slot: device int64)."""
    s = store.stores
    count = s.count[robot]
    dist = torch.linalg.norm(pose.t - s.last_pose.t[robot])
    ok = (dist > dist_thresh) & (count < store.kf_capacity)
    k = torch.clamp(count, max=store.kf_capacity - 1)
    ds = pcl.voxel_downsample(cloud, leaf, s.xyz.shape[2], bounds=_BOUNDS)
    _write_rows(
        [s.xyz, s.mask, s.poses.R, s.poses.t, s.stamps], robot, k.reshape(1), ok,
        [ds.xyz, ds.mask, pose.R, pose.t, stamp.reshape(())],
    )
    s.count[robot] += ok.to(s.count.dtype)
    s.last_pose.R[robot] = torch.where(ok, pose.R, s.last_pose.R[robot])
    s.last_pose.t[robot] = torch.where(ok, pose.t, s.last_pose.t[robot])
    return store, ok, k


def write_descriptor(store: MultiRobotStore, robot: int, k: int, descriptor) -> MultiRobotStore:
    """Write one descriptor (dict or flat) into slot (robot, k) — the
    incremental descriptor append."""
    if isinstance(descriptor, dict):
        for name, val in descriptor.items():
            store.descriptors[name][robot, k] = val
    else:
        store.descriptors[robot, k] = descriptor
    store.desc_valid[robot, k] = True
    return store


def cross_robot_distances(store: MultiRobotStore, queries: torch.Tensor,
                          group=None) -> torch.Tensor:
    """All-pairs squared L2 descriptor distances: queries (R, Q, D) per
    robot against EVERY robot's flat database. With `group` the store
    holds this rank's robots and the databases of all the group's ranks
    are all-gathered along the robot axis first (the collective in place
    of per-topic subscription). Returns (R_local, Q, R_total, K) with
    invalid entries +inf."""
    db, valid = store.descriptors, store.desc_valid
    if group is not None:
        from . import mesh

        db = mesh.all_gather(db, group).flatten(0, 1)
        valid = mesh.all_gather(valid, group).flatten(0, 1)
    q2 = torch.sum(queries * queries, dim=-1)[..., None, None]
    d2 = torch.sum(db * db, dim=-1)[None, None]
    qd = torch.einsum("rqd,skd->rqsk", queries, db)
    dist = q2 + d2 - 2.0 * qd
    return torch.where(valid[None, None], torch.clamp(dist, min=0.0), torch.inf)
