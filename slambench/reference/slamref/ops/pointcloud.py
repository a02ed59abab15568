"""Fixed-capacity masked point clouds and PCL-filter equivalents (port of
`mr_slam_tpu/ops/pointcloud.py`: `PointCloud`, `make`, `park`, `pad_to`,
`compact`, `crop_box`, `crop_radius`, `transform`, `voxel_downsample`,
`knn`, `covariances_knn`).

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


def make(xyz: torch.Tensor, mask: torch.Tensor | None = None) -> PointCloud:
    if mask is None:
        mask = torch.ones(xyz.shape[:-1], dtype=torch.bool, device=xyz.device)
    return park(PointCloud(xyz.to(torch.float32), mask))


def park(pc: PointCloud) -> PointCloud:
    """Move invalid points to the far-away sentinel so they can never be
    nearest neighbours or fall into real voxels."""
    xyz = torch.where(pc.mask[..., None], pc.xyz, torch.full_like(pc.xyz, SENTINEL))
    return PointCloud(xyz, pc.mask)


def pad_to(pc: PointCloud, capacity: int) -> PointCloud:
    """Grow (or shrink, keeping valid-first order) to a fixed capacity."""
    n = pc.xyz.shape[-2]
    if n == capacity:
        return pc
    if n < capacity:
        pad = capacity - n
        xyz = torch.cat([pc.xyz, pc.xyz.new_full((*pc.xyz.shape[:-2], pad, 3), SENTINEL)], dim=-2)
        mask = torch.cat([pc.mask, pc.mask.new_zeros((*pc.mask.shape[:-1], pad))], dim=-1)
        return PointCloud(xyz, mask)
    pc = compact(pc)
    return PointCloud(pc.xyz[..., :capacity, :], pc.mask[..., :capacity])


def compact(pc: PointCloud) -> PointCloud:
    """Stable-sort valid points to the front (same capacity)."""
    order = torch.sort((~pc.mask).to(torch.uint8), dim=-1, stable=True).indices
    xyz = torch.gather(pc.xyz, -2, order[..., None].expand(pc.xyz.shape))
    return PointCloud(xyz, torch.gather(pc.mask, -1, order))


def crop_box(pc: PointCloud, lo, hi) -> PointCloud:
    """PassThrough/CropBox: keep lo <= xyz <= hi per axis (+-inf entries
    leave an axis unconstrained)."""
    lo = const(tuple(float(v) for v in lo), pc.xyz.device)
    hi = const(tuple(float(v) for v in hi), pc.xyz.device)
    inside = torch.all((pc.xyz >= lo) & (pc.xyz <= hi), dim=-1)
    return park(PointCloud(pc.xyz, pc.mask & inside))


def crop_radius(pc: PointCloud, center, radius: float) -> PointCloud:
    c = const(tuple(float(v) for v in center), pc.xyz.device)
    d2 = torch.sum((pc.xyz - c) ** 2, dim=-1)
    return park(PointCloud(pc.xyz, pc.mask & (d2 <= radius * radius)))


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


# knn materialises (M, N) distance and sort-key matrices per cloud;
# clouds are taken in chunks of at most this many matrix entries (2^26:
# 256 MiB of f32 distances and 512 MiB of int64 keys, the cross term's
# float64 temporary no larger), so a 256-keyframe store of 4096-point
# clouds goes 4 clouds at a time
KNN_CHUNK_ELEMS = 1 << 26


def _sum_sq(x: torch.Tensor) -> torch.Tensor:
    """x0^2 + x1^2 + x2^2 in float32 as fused multiply-adds,
    fma(x2, x2, fma(x1, x1, x0 * x0)) (the products exact in float64),
    the rounding of the reference's CPU lowering: the squared norms
    enter a difference of large terms, where an ulp moves neighbours."""
    xd = x.double()
    acc = (xd[..., 0] * xd[..., 0]).float()
    acc = (acc.double() + xd[..., 1] * xd[..., 1]).float()
    return (acc.double() + xd[..., 2] * xd[..., 2]).float()


def _cross(q: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """q @ x^T for (..., M, 3) and (..., N, 3) as the float32 chain
    fma(q2, x2, fma(q1, x1, q0 * x0)), the products exact in float64:
    the reference's CPU dot, on every device (a cuBLAS GEMM rounds
    otherwise), so the card's neighbours are the CPU's. At most one (M, N)
    float64 and one float32 temporary are alive at a time."""
    qd, xd = q.double(), x.double()
    acc = (qd[..., :, None, 0] * xd[..., None, :, 0]).float()
    for j in (1, 2):
        t = qd[..., :, None, j] * xd[..., None, :, j]
        acc = t.add_(acc).float()
    return acc


def _order_key(d2: torch.Tensor) -> torch.Tensor:
    """int64 keys that order like the float32 values `d2` (-0.0 as 0.0),
    the lower column first among equal values: the reference's `top_k`
    tie rule, which `torch.topk` does not promise."""
    bits = (d2 + 0.0).view(torch.int32)
    mono = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits).to(torch.int64)
    col = torch.arange(d2.shape[-1], device=d2.device)
    return mono * d2.shape[-1] + col


def _knn_one(query: torch.Tensor, xyz: torch.Tensor, mask: torch.Tensor, k: int):
    d2 = _sum_sq(query)[..., None] + _sum_sq(xyz)[..., None, :] - _cross(2.0 * query, xyz)
    d2 = torch.where(mask[..., None, :], d2, torch.inf)
    if k == 1:  # argmin returns the first of equal minima: the key's order
        idx = torch.argmin(d2, dim=-1, keepdim=True)
    else:
        idx = torch.topk(_order_key(d2), k, dim=-1, largest=False, sorted=True).indices
    return torch.clamp(torch.gather(d2, -1, idx), min=0.0), idx


def knn(query: torch.Tensor, pc: PointCloud, k: int):
    """Brute-force k-NN of queries (..., M, 3) against masked clouds
    (..., N, 3): |q - p|^2 = |q|^2 + |p|^2 - 2 q.p, then the k smallest
    in ascending order, the lower index first among equal distances.
    Leading dims are independent clouds, taken in chunks of
    `KNN_CHUNK_ELEMS` distance entries. Returns (dists (..., M, k), idx
    (..., M, k)); masked points get +inf distance."""
    batch = query.shape[:-2]
    M, N = query.shape[-2], pc.xyz.shape[-2]
    q = query.reshape(-1, M, 3)
    xyz = pc.xyz.reshape(-1, N, 3)
    mask = pc.mask.reshape(-1, N)
    step = max(1, KNN_CHUNK_ELEMS // max(M * N, 1))
    parts = [_knn_one(q[s:s + step], xyz[s:s + step], mask[s:s + step], k)
             for s in range(0, q.shape[0], step)]
    d2 = torch.cat([p[0] for p in parts])
    idx = torch.cat([p[1] for p in parts])
    return d2.reshape(*batch, M, k), idx.reshape(*batch, M, k)


def covariances_knn(pc: PointCloud, k: int = 10):
    """Per-point neighbourhood mean / covariance via brute-force kNN (the
    GICP preprocessing), any leading batch of clouds. The k neighbours
    are summed in distance order, the covariance's products accumulated
    as fused multiply-adds (float64 products rounded to float32 at each
    step), as the reference's CPU lowering adds them: nearly planar
    neighbourhoods leave a smallest eigenvalue at the rounding level,
    where another order changes the eigen features downstream. Returns
    (means (..., N, 3), covs (..., N, 3, 3), valid (..., N))."""
    d2, idx = knn(pc.xyz, pc, k)
    N = pc.xyz.shape[-2]
    flat = idx.reshape(*idx.shape[:-2], N * k, 1).expand(*idx.shape[:-2], N * k, 3)
    neigh = torch.gather(pc.xyz, -2, flat).reshape(*idx.shape, 3)   # (..., N, k, 3)
    w = torch.isfinite(d2)
    wn = torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1)
    z = torch.where(w[..., None], neigh, 0.0)
    total = z[..., 0, :]
    for j in range(1, k):
        total = total + z[..., j, :]
    mean = total / wn
    d = torch.where(w[..., None], neigh - mean[..., None, :], 0.0).double()
    acc = (d[..., 0, :, None] * d[..., 0, None, :]).float()
    for j in range(1, k):
        acc = (acc.double() + d[..., j, :, None] * d[..., j, None, :]).float()
    cov = acc / torch.clamp(wn[..., None] - 1, min=1)
    return mean, cov, pc.mask & (wn[..., 0] >= 3)
