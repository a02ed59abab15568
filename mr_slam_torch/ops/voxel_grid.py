"""Voxel-hash Gaussian grid (port of `mr_slam_tpu/ops/voxel_grid.py`).

An open-addressed voxel table built from scatters and gathers: every
point hashes its voxel coord into a slot, the lowest point index claims
the slot (scatter-min), claims are verified by coordinate equality, and
per-voxel Gaussian stats accumulate by scatter-add. Each cell is one
PACKED (H, 16) float32 row

    [coords(3) count mean(3) cov_sym(6: xx yy zz xy xz yz) valid pad(2)]

so a lookup is one contiguous 64-byte row load — the layout the Hopper
kernel (`ops/hopper_vgicp.py`) reads with four float4 loads.

Port notes:
  * the lowbias32 hash needs uint32 wraparound; PyTorch has no full
    uint32 arithmetic, so `_hash` works in int64 and keeps 32 bits after
    every multiply, add and xor (two's complement for negative coords).
    Slots are bit-equal to the reference;
  * `floor(x / leaf)` divides by a float32 tensor on the input's device
    — an IEEE division (dividing a CUDA tensor by a Python float would
    multiply by the reciprocal and move points on voxel faces);
  * scatter-min is `scatter_reduce_(..., "amin")`; scatter-add is
    `segment.scatter_sum`, which adds each cell's points in index order
    on every device (no float atomics), so builds are bit-stable;
  * `build`, `lookup*` take any leading batch shape (the reference
    vmaps them over verify candidates): batch item b uses table rows
    b*H .. b*H + H - 1 of the flattened table.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..devconst import const
from . import segment
from .pointcloud import PointCloud

_P1, _P2, _P3 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D
_M32 = 0xFFFFFFFF

_UNCLAIMED = 2**30

# packed row layout
_C0, _CNT, _MU, _COV, _VALID = 0, 3, 4, 7, 13
_ROW = 16
# symmetric cov order: xx yy zz xy xz yz
_SYM_I = (0, 1, 2, 0, 0, 1)
_SYM_J = (0, 1, 2, 1, 2, 2)


def _cov_from_sym6(s: torch.Tensor) -> torch.Tensor:
    """(..., 6) -> (..., 3, 3)."""
    xx, yy, zz, xy, xz, yz = (s[..., k] for k in range(6))
    return torch.stack(
        [
            torch.stack([xx, xy, xz], dim=-1),
            torch.stack([xy, yy, yz], dim=-1),
            torch.stack([xz, yz, zz], dim=-1),
        ],
        dim=-2,
    )


class VoxelGrid(NamedTuple):
    """Open-addressed voxel table of Gaussian cells (packed rows)."""

    packed: torch.Tensor  # (..., H, 16) float32
    leaf: float

    @property
    def table_size(self) -> int:
        return self.packed.shape[-2]

    @property
    def coords(self) -> torch.Tensor:
        return self.packed[..., _C0:_C0 + 3].to(torch.int64)

    @property
    def count(self) -> torch.Tensor:
        return self.packed[..., _CNT]

    @property
    def mean(self) -> torch.Tensor:
        return self.packed[..., _MU:_MU + 3]

    @property
    def cov(self) -> torch.Tensor:
        return _cov_from_sym6(self.packed[..., _COV:_COV + 6])

    @property
    def valid(self) -> torch.Tensor:
        return self.packed[..., _VALID] > 0.5


def _pack(coords, count, mean, cov, valid) -> torch.Tensor:
    # one view per entry: indexing with the index tuples would copy them
    # to the device from pageable memory, a host sync per call
    sym6 = torch.stack([cov[..., i, j] for i, j in zip(_SYM_I, _SYM_J)], dim=-1)
    pad = torch.zeros_like(count)
    return torch.cat(
        [
            coords.to(torch.float32), count[..., None], mean, sym6,
            valid.to(torch.float32)[..., None], pad[..., None], pad[..., None],
        ],
        dim=-1,
    )


def _mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 for int64 `a` in [0, 2^32) and constant c < 2^32,
    in 16-bit halves so no int64 product overflows."""
    lo = a & 0xFFFF
    hi = a >> 16
    return (lo * c + (((hi * c) & 0xFFFF) << 16)) & _M32


def _hash(ijk: torch.Tensor, table_size: int) -> torch.Tensor:
    """lowbias32 spatial hash of integer voxel coords (..., 3) -> int64
    slots in [0, table_size), bit-equal to the reference's uint32 hash."""
    u = ijk.to(torch.int64) & _M32
    h = (_mul32(u[..., 0], _P1) + _mul32(u[..., 1], _P2) + _mul32(u[..., 2], _P3)) & _M32
    h = h ^ (h >> 16)
    h = _mul32(h, 0x7FEB352D)
    h = h ^ (h >> 15)
    h = _mul32(h, 0x846CA68B)
    h = h ^ (h >> 16)
    return h % table_size


def _voxel(xyz: torch.Tensor, leaf: float) -> torch.Tensor:
    """Integer voxel coords floor(xyz / leaf) (int64), IEEE division."""
    leaf_t = torch.full((), leaf, dtype=torch.float32, device=xyz.device)
    return torch.floor(xyz / leaf_t).to(torch.int64)


def _batch_offset(B: int, per: int, device) -> torch.Tensor:
    return torch.arange(B, device=device)[:, None] * per


def build(
    pc: PointCloud,
    leaf: float,
    table_size: int,
    min_points: int = 1,
    regularize: str = "none",
) -> VoxelGrid:
    """Build a Gaussian voxel map from a masked cloud (..., N, 3).

    regularize: 'none' | 'plane' — 'plane' clamps eigenvalues to
    (1, 1, 1e-3) scale like fast_gicp's RegularizationMethod::PLANE.
    """
    if regularize not in ("none", "plane"):
        raise ValueError(f"unknown regularize {regularize!r}")
    xyz, mask = pc.xyz, pc.mask
    dev = xyz.device
    batch = xyz.shape[:-2]
    n = xyz.shape[-2]
    H = table_size
    xyz = xyz.reshape(-1, n, 3)
    mask = mask.reshape(-1, n)
    B = xyz.shape[0]
    ijk = _voxel(xyz, leaf)                                   # (B, n, 3)
    gslot = (_hash(ijk, H) + _batch_offset(B, H, dev)).reshape(-1)
    # Claim: lowest point index wins the slot.
    idx = torch.arange(n, device=dev).expand(B, n)
    claim = torch.full((B * H,), n, dtype=torch.int64, device=dev)
    claim.scatter_reduce_(0, gslot, torch.where(mask, idx, n).reshape(-1), "amin")
    have_owner = claim < n
    owner = torch.clamp(claim, max=n - 1) + _batch_offset(B, n, dev).repeat_interleave(H)
    cell_coord = ijk.reshape(-1, 3)[owner]                    # (B*H, 3)
    ijk = ijk.reshape(-1, 3)
    contrib = mask.reshape(-1) & torch.all(ijk == cell_coord[gslot], dim=-1)
    w = contrib.to(torch.float32)
    pts = xyz.reshape(-1, 3)
    count = segment.scatter_sum(B * H, gslot, w)
    xsum = segment.scatter_sum(B * H, gslot, pts * w[:, None])
    mean = xsum / torch.clamp(count[:, None], min=1.0)
    xx = (pts[:, :, None] * pts[:, None, :]).reshape(-1, 9)
    xxsum = segment.scatter_sum(B * H, gslot, xx * w[:, None])
    cov = xxsum.reshape(-1, 3, 3) / torch.clamp(count[:, None, None], min=1.0) - (
        mean[:, :, None] * mean[:, None, :]
    )
    valid = have_owner & (count >= min_points)
    if regularize == "plane":
        from . import linalg3

        eye = torch.eye(3, dtype=torch.float32, device=dev)
        evals, V = linalg3.eigh3(cov + 1e-9 * eye)
        scale = torch.clamp(evals[..., 2:3], min=1e-6)
        clamped = torch.clamp(evals / scale, min=1e-3) * scale
        comp = [
            sum(clamped[..., k] * V[..., i, k] * V[..., j, k] for k in range(3))
            for i, j in ((0, 0), (1, 1), (2, 2), (0, 1), (0, 2), (1, 2))
        ]
        cov = _cov_from_sym6(torch.stack(comp, dim=-1))
    coords = torch.where(have_owner[:, None], cell_coord, _UNCLAIMED)
    packed = _pack(coords, count, mean, cov, valid)
    return VoxelGrid(packed=packed.reshape(*batch, H, _ROW), leaf=float(leaf))


# Neighbour offset sets, mirroring fast_gicp NeighborSearchMethod.
OFFSETS = {
    "direct1": ((0, 0, 0),),
    "direct7": (
        (0, 0, 0), (1, 0, 0), (-1, 0, 0), (0, 1, 0), (0, -1, 0), (0, 0, 1), (0, 0, -1),
    ),
    "direct27": tuple(
        (i, j, k) for i in (-1, 0, 1) for j in (-1, 0, 1) for k in (-1, 0, 1)
    ),
}


def _gather_rows(packed: torch.Tensor, slot: torch.Tensor) -> torch.Tensor:
    """Rows packed[..., slot, :] with per-batch-item tables: packed
    (..., H, 16), slot (..., M, K) -> (..., M, K, 16)."""
    H = packed.shape[-2]
    flat = packed.reshape(-1, _ROW)
    B = flat.shape[0] // H
    s = slot.reshape(B, -1) + _batch_offset(B, H, slot.device)
    return flat[s.reshape(-1)].reshape(*slot.shape, _ROW)


def lookup_rows(grid: VoxelGrid, xyz: torch.Tensor, neighbors: str = "direct1"):
    """Raw packed lookup of `xyz` (..., M, 3) and its neighbour offsets:
    (rows (..., M, K, 16), found (..., M, K))."""
    offs = const(OFFSETS[neighbors], xyz.device, torch.int64)
    nijk = _voxel(xyz, grid.leaf)[..., :, None, :] + offs    # (..., M, K, 3)
    rows = _gather_rows(grid.packed, _hash(nijk, grid.table_size))
    found = (rows[..., _VALID] > 0.5) & torch.all(
        rows[..., _C0:_C0 + 3] == nijk.to(torch.float32), dim=-1
    )
    return rows, found


def lookup(grid: VoxelGrid, xyz: torch.Tensor, neighbors: str = "direct1"):
    """Gaussian cells containing `xyz` (..., M, 3) and neighbours: found
    (..., M, K), count (..., M, K), mean (..., M, K, 3), cov
    (..., M, K, 3, 3)."""
    rows, found = lookup_rows(grid, xyz, neighbors)
    return (
        found,
        rows[..., _CNT],
        rows[..., _MU:_MU + 3],
        _cov_from_sym6(rows[..., _COV:_COV + 6]),
    )


def lookup_slots(grid: VoxelGrid, xyz: torch.Tensor):
    """direct1 correspondence as (slot (..., M) int32, found (..., M)
    bool): `packed[slot]` is the row `lookup_rows` would return. The
    cached-correspondence input of the VGICP kernel's slot mode."""
    ijk = _voxel(xyz, grid.leaf)
    slot = _hash(ijk, grid.table_size)
    rows = _gather_rows(grid.packed, slot[..., None])[..., 0, :]
    found = (rows[..., _VALID] > 0.5) & torch.all(
        rows[..., _C0:_C0 + 3] == ijk.to(torch.float32), dim=-1
    )
    return slot.to(torch.int32), found


def insert(grid: VoxelGrid, pc: PointCloud, min_points: int = 1) -> VoxelGrid:
    """Incrementally merge a cloud (N, 3) into an existing unregularized
    grid (H, 16): existing cells accumulate moments; new voxels claim
    empty slots (lowest point index wins); points hashing onto a foreign
    occupied slot are dropped. Not for grids built with
    regularize='plane' (regularization destroys the raw moments)."""
    dev = pc.xyz.device
    ijk = _voxel(pc.xyz, grid.leaf)
    n = pc.xyz.shape[0]
    H = grid.table_size
    slot = _hash(ijk, H)
    coords0 = grid.coords
    count0 = grid.count
    occupied = torch.any(coords0 != _UNCLAIMED, dim=-1) | (count0 > 0)
    claim = torch.full((H,), n, dtype=torch.int64, device=dev)
    claim.scatter_reduce_(
        0, slot, torch.where(pc.mask, torch.arange(n, device=dev), n), "amin"
    )
    newly_claimed = (~occupied) & (claim < n)
    owner_coord = torch.where(
        occupied[:, None], coords0, ijk[torch.clamp(claim, max=n - 1)]
    )
    owner_coord = torch.where(
        (occupied | newly_claimed)[:, None], owner_coord, _UNCLAIMED
    )
    contrib = pc.mask & torch.all(ijk == owner_coord[slot], dim=-1)
    w = contrib.to(torch.float32)
    mean0 = grid.mean
    xsum = mean0 * count0[:, None]
    xxsum = (grid.cov + mean0[:, :, None] * mean0[:, None, :]) * count0[:, None, None]
    count = segment.index_add(count0, slot, w)
    xsum = segment.index_add(xsum, slot, pc.xyz * w[:, None])
    xx = pc.xyz[:, :, None] * pc.xyz[:, None, :]
    xxsum = segment.index_add(xxsum.reshape(H, 9), slot, (xx * w[:, None, None]).reshape(n, 9))
    mean = xsum / torch.clamp(count[:, None], min=1.0)
    cov = xxsum.reshape(H, 3, 3) / torch.clamp(count[:, None, None], min=1.0) - (
        mean[:, :, None] * mean[:, None, :]
    )
    valid = (count >= min_points) & torch.any(owner_coord != _UNCLAIMED, dim=-1)
    return VoxelGrid(packed=_pack(owner_coord, count, mean, cov, valid), leaf=grid.leaf)


def _empty_row(device) -> torch.Tensor:
    return const((float(_UNCLAIMED),) * 3 + (0.0,) * (_ROW - 3), device)


def decay(grid: VoxelGrid, center: torch.Tensor, radius: float) -> VoxelGrid:
    """Drop cells farther than `radius` from `center`, freeing their
    slots — the moving-FOV map trim."""
    keep = (torch.linalg.norm(grid.mean - center[None, :], dim=-1) <= radius) & (
        grid.count > 0
    )
    packed = torch.where(keep[:, None], grid.packed, _empty_row(grid.packed.device))
    return VoxelGrid(packed=packed, leaf=grid.leaf)


def empty(leaf: float, table_size: int, device=None) -> VoxelGrid:
    """An all-unclaimed grid (odometry map initial state)."""
    packed = _empty_row(torch.device(device or "cpu")).expand(table_size, _ROW).clone()
    return VoxelGrid(packed=packed, leaf=float(leaf))
