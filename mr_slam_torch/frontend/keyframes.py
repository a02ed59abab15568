"""Distance-gated keyframes in fixed-capacity buffers (port of
`mr_slam_tpu/frontend/keyframes.py`).

The gate is a device bool. `maybe_add` writes through `torch.where`
instead of syncing it to the host: every frame writes slot
min(count, capacity - 1), keeping the old contents when the gate is
closed, so a front-end loop never waits on the device. The store's
tensors are updated IN PLACE (one 4096-point row per frame instead of a
copy of the whole 12 MiB store); callers that need the old store keep a
clone.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.se3 import Pose
from ..ops import pointcloud as pcl

_BOUNDS = ((-150.0, -150.0, -150.0), (150.0, 150.0, 150.0))


class KeyframeStore(NamedTuple):
    """Fixed-capacity keyframe log for one robot.

    xyz:    (K, P, 3) body-frame keyframe clouds (voxelized)
    mask:   (K, P)    per-point validity
    poses:  Pose with batch (K,) — odometry pose at capture
    stamps: (K,)      capture times (seconds)
    count:  ()        number of keyframes written (device int64)
    last_pose: Pose   pose at the last accepted keyframe (gate anchor)
    """

    xyz: torch.Tensor
    mask: torch.Tensor
    poses: Pose
    stamps: torch.Tensor
    count: torch.Tensor
    last_pose: Pose

    @property
    def capacity(self) -> int:
        return self.xyz.shape[0]

    @property
    def points_per_kf(self) -> int:
        return self.xyz.shape[1]

    def cloud(self, i) -> pcl.PointCloud:
        return pcl.PointCloud(self.xyz[i], self.mask[i])


def init(capacity: int, points_per_kf: int, device=None) -> KeyframeStore:
    return KeyframeStore(
        xyz=torch.full((capacity, points_per_kf, 3), pcl.SENTINEL, device=device),
        mask=torch.zeros((capacity, points_per_kf), dtype=torch.bool, device=device),
        poses=se3.identity((capacity,), device=device),
        stamps=torch.zeros((capacity,), device=device),
        count=torch.zeros((), dtype=torch.int64, device=device),
        # first frame always gates in
        last_pose=Pose(
            torch.eye(3, device=device), torch.full((3,), torch.inf, device=device)
        ),
    )


def maybe_add(
    store: KeyframeStore,
    cloud: pcl.PointCloud,
    pose: Pose,
    stamp: torch.Tensor,
    dist_thresh: float = 2.0,
    leaf: float = 0.2,
):
    """Distance gate + append (no-op when the gate is closed or the store
    is full). Returns (store, added: device bool)."""
    dist = torch.linalg.norm(pose.t - store.last_pose.t)
    add = (dist > dist_thresh) & (store.count < store.capacity)
    ds = pcl.voxel_downsample(cloud, leaf, store.points_per_kf, bounds=_BOUNDS)
    idx = torch.clamp(store.count, max=store.capacity - 1).reshape(1)

    def write(buf: torch.Tensor, new: torch.Tensor) -> None:
        old = buf.index_select(0, idx)[0]
        buf.index_copy_(0, idx, torch.where(add, new, old)[None])

    write(store.xyz, ds.xyz)
    write(store.mask, ds.mask)
    write(store.poses.R, pose.R)
    write(store.poses.t, pose.t)
    write(store.stamps, stamp.reshape(()))
    new_store = store._replace(
        count=store.count + add.to(torch.int64),
        last_pose=Pose(
            torch.where(add, pose.R, store.last_pose.R),
            torch.where(add, pose.t, store.last_pose.t),
        ),
    )
    return new_store, add


def merged_neighborhood(
    store: KeyframeStore, center_idx: torch.Tensor, window: int, poses: Pose | None = None
) -> pcl.PointCloud:
    """Keyframes [center-window, center+window] in the world frame,
    concatenated (`mergeNearestKeyframes`). `center_idx` may carry a
    leading batch (B,): the result is then (B, (2w+1) P, 3)."""
    if poses is None:
        poses = store.poses
    K = store.capacity
    offs = torch.arange(-window, window + 1, device=store.xyz.device)
    raw = center_idx[..., None] + offs                       # (..., 2w+1)
    idx = torch.clamp(raw, 0, K - 1)
    in_range = (raw >= 0) & (raw < store.count)
    R, t = poses.R[idx], poses.t[idx]
    pts = store.xyz[idx] @ R.transpose(-1, -2) + t[..., None, :]
    mask = store.mask[idx] & in_range[..., None]
    lead = center_idx.shape
    return pcl.park(
        pcl.PointCloud(pts.reshape(*lead, -1, 3), mask.reshape(*lead, -1))
    )
