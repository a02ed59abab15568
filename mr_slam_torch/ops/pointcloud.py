"""Fixed-capacity masked point clouds and PCL-filter equivalents (port of
`mr_slam_tpu/ops/pointcloud.py`: `PointCloud`, `park`, `crop_box`,
`transform`, `voxel_downsample`).

Every cloud is a fixed-capacity (..., N, 3) buffer with an (..., N)
validity mask; invalid slots hold the finite SENTINEL coordinate. The
functions take any leading batch shape where the reference is vmapped.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..devconst import const
from . import segment


class PointCloud(NamedTuple):
    """xyz: (..., N, 3) float32; mask: (..., N) bool."""

    xyz: torch.Tensor
    mask: torch.Tensor

    @property
    def capacity(self) -> int:
        return self.xyz.shape[-2]

    def count(self) -> torch.Tensor:
        return torch.sum(self.mask, dim=-1)


SENTINEL = 1e6  # parked coordinate for invalid slots


def park(pc: PointCloud) -> PointCloud:
    """Move invalid points to the far-away sentinel so they can never be
    nearest neighbours or fall into real voxels."""
    xyz = torch.where(pc.mask[..., None], pc.xyz, torch.full_like(pc.xyz, SENTINEL))
    return PointCloud(xyz, pc.mask)


def crop_box(pc: PointCloud, lo, hi) -> PointCloud:
    """PassThrough/CropBox: keep lo <= xyz <= hi per axis (+-inf entries
    leave an axis unconstrained)."""
    lo = const(tuple(float(v) for v in lo), pc.xyz.device)
    hi = const(tuple(float(v) for v in hi), pc.xyz.device)
    inside = torch.all((pc.xyz >= lo) & (pc.xyz <= hi), dim=-1)
    return park(PointCloud(pc.xyz, pc.mask & inside))


def transform(pc: PointCloud, pose) -> PointCloud:
    """Rigid transform of valid points (sentinels re-parked)."""
    xyz = pc.xyz @ pose.R.transpose(-1, -2) + pose.t[..., None, :]
    return park(PointCloud(xyz, pc.mask))


def voxel_downsample(
    pc: PointCloud,
    leaf: float,
    capacity: int,
    bounds: tuple = ((-200.0, -200.0, -200.0), (200.0, 200.0, 200.0)),
) -> PointCloud:
    """Exact centroid voxel-grid downsample (PCL VoxelGrid semantics).

    The reference lexsorts the integer voxel triples; here one exact
    int64 key (i * D1 + j) * D2 + k orders them the same way (each axis
    spans at most ~2,700 cells at leaf 0.15 over +-200 m, so the key
    fits in 36 bits). A stable sort, run starts, and segment sums give
    one centroid per occupied voxel, in ascending (i, j, k) order — the
    order matters downstream, where points are picked by position. The
    segment sums add in point order on every device (`segment`).
    Points outside `bounds` are dropped. Leading batch dims are
    independent clouds.

    Voxel coords are `floor((x - lo) * r)` with `r` the float32
    reciprocal of `leaf`: the reference writes a division, but `leaf`
    is a static argument there and XLA rewrites a division by a
    constant into that multiply. Points within an ulp of a voxel face
    land in the reference's cell only this way.
    """
    xyz, mask = pc.xyz, pc.mask
    dev = xyz.device
    batch = xyz.shape[:-2]
    n = xyz.shape[-2]
    xyz2 = xyz.reshape(-1, n, 3)
    mask2 = mask.reshape(-1, n)
    B = xyz2.shape[0]
    lo = const(tuple(float(v) for v in bounds[0]), dev)
    inv_leaf = torch.full((), float(np.float32(1.0) / np.float32(leaf)), dtype=torch.float32,
                          device=dev)
    ijk = torch.floor((xyz2 - lo) * inv_leaf).to(torch.int64)
    # grid dims in f32 on the host, as the reference computes them
    span = np.float32(bounds[1]) - np.float32(bounds[0])
    dims = [int(v) + 1 for v in np.ceil(span / np.float32(leaf))]
    valid = mask2 & torch.all((ijk >= 0) & (ijk < const(tuple(dims), dev, torch.int64)), dim=-1)
    key = (ijk[..., 0] * dims[1] + ijk[..., 1]) * dims[2] + ijk[..., 2]
    big = dims[0] * dims[1] * dims[2]  # above every valid key: invalids last
    key = torch.where(valid, key, torch.full_like(key, big))
    skey, order = torch.sort(key, dim=-1, stable=True)
    sxyz = torch.gather(xyz2, 1, order[..., None].expand(B, n, 3))
    svalid = torch.gather(valid, 1, order)
    first = torch.ones_like(svalid)
    first[:, 1:] = skey[:, 1:] != skey[:, :-1]
    first = first & svalid
    seg = torch.cumsum(first.to(torch.int64), dim=-1) - 1
    seg = torch.where(svalid & (seg < capacity), seg, torch.full_like(seg, capacity))
    flat = (seg + torch.arange(B, device=dev)[:, None] * (capacity + 1)).reshape(-1)
    w = svalid.to(torch.float32).reshape(-1)
    sums = segment.scatter_sum(B * (capacity + 1), flat, sxyz.reshape(-1, 3) * w[:, None])
    cnts = segment.scatter_sum(B * (capacity + 1), flat, w)
    sums = sums.reshape(B, capacity + 1, 3)[:, :capacity]
    cnts = cnts.reshape(B, capacity + 1)[:, :capacity]
    out_mask = cnts > 0
    centroids = sums / torch.clamp(cnts[..., None], min=1.0)
    out = park(PointCloud(centroids, out_mask))
    return PointCloud(out.xyz.reshape(*batch, capacity, 3), out.mask.reshape(*batch, capacity))
