"""M2DP global descriptor — multiview 2-D projection signature (port of
`mr_slam_tpu/loop/m2dp.py`: `projection_basis`, `describe`).

The centred, PCA-aligned cloud is projected onto J view planes (azimuth x
elevation samples); per view a polar occupancy signature (L rings x T
sectors); the descriptor is the first left / right singular-vector pair
of the J x (L*T) signature matrix, its sign made canonical. The per-view
projections of a chunk of clouds are one product, the signatures one
integer count (`segment.count`, exact in any order).

`torch.linalg.svd` on a CUDA tensor checks cuSOLVER's status on the host:
one sync per chunk of clouds.
"""
from __future__ import annotations

import functools
import math

import torch

from ..devconst import const
from ..ops import linalg3, segment
from ..ops.pointcloud import PointCloud
from .ring import angles


def projection_basis(dirs: torch.Tensor):
    """Per-view in-plane basis (ex, ey) orthogonal to each view direction
    (..., 3). Near-vertical views (cross(dir, z) degenerate) fall back to
    cross(dir, x), normalized per row."""
    dev = dirs.device
    ex = torch.linalg.cross(dirs, const((0.0, 0.0, 1.0), dev).expand(dirs.shape), dim=-1)
    ex_n = torch.sqrt(torch.sum(ex * ex, dim=-1, keepdim=True))
    alt = torch.linalg.cross(dirs, const((1.0, 0.0, 0.0), dev).expand(dirs.shape), dim=-1)
    alt_n = torch.sqrt(torch.sum(alt * alt, dim=-1, keepdim=True))
    ex = torch.where(ex_n > 1e-3, ex / torch.clamp(ex_n, min=1e-9),
                     alt / torch.clamp(alt_n, min=1e-9))
    return ex, torch.linalg.cross(dirs, ex, dim=-1)


@functools.lru_cache(maxsize=None)
def _view_dirs(n_azimuth: int, n_elevation: int, device: torch.device) -> torch.Tensor:
    """The (J, 3) view directions, made once per device (a copy from the
    host waits for the stream); read-only."""
    az = torch.from_numpy(angles(n_azimuth))
    el = torch.from_numpy(angles(n_elevation, math.pi / 2))
    azg, elg = torch.meshgrid(az, el, indexing="ij")
    dirs = torch.stack([torch.cos(elg) * torch.cos(azg), torch.cos(elg) * torch.sin(azg),
                        torch.sin(elg)], dim=-1)
    return dirs.reshape(-1, 3).to(device)


# clouds per chunk: each holds (J, N) projections, radii, angles and
# cell indices per cloud (~6 MiB at J = 64, N = 4096 for each)
CHUNK = 32


def describe(
    pc: PointCloud,
    n_azimuth: int = 4,
    n_elevation: int = 16,
    n_rings: int = 8,
    n_sectors: int = 16,
    r_max: float = 80.0,
) -> torch.Tensor:
    """Clouds (..., N, 3) -> M2DP descriptors (..., J + L*T): concat(u1,
    v1) of the SVD of the (J, L*T) view-signature matrix, J = n_azimuth *
    n_elevation, times the sign of its sum."""
    batch, n = pc.xyz.shape[:-2], pc.xyz.shape[-2]
    xyz, mask = pc.xyz.reshape(-1, n, 3), pc.mask.reshape(-1, n)
    args = (n_azimuth, n_elevation, n_rings, n_sectors, r_max)
    d = torch.cat([_describe(xyz[s:s + CHUNK], mask[s:s + CHUNK], *args)
                   for s in range(0, xyz.shape[0], CHUNK)])
    return d.reshape(*batch, d.shape[-1])


def _describe(xyz, mask, n_azimuth, n_elevation, n_rings, n_sectors, r_max):
    B, n = mask.shape
    w = mask.to(torch.float32)
    cnt = torch.clamp(torch.sum(w, dim=-1), min=1.0)                  # (B,)
    mean = torch.sum(xyz * w[..., None], dim=-2) / cnt[:, None]
    centered = (xyz - mean[:, None, :]) * w[..., None]
    cov = centered.transpose(-1, -2) @ centered / cnt[:, None, None]
    _, V = linalg3.eigh3(cov)
    pts = centered @ torch.flip(V, dims=(-1,))                        # principal axis first
    dirs = _view_dirs(n_azimuth, n_elevation, xyz.device)             # (J, 3)
    J, LT = dirs.shape[0], n_rings * n_sectors
    ex, ey = projection_basis(dirs)
    px = ex @ pts.transpose(-1, -2)                                   # (B, J, N)
    py = ey @ pts.transpose(-1, -2)
    r = torch.sqrt(px ** 2 + py ** 2)
    theta = torch.atan2(py, px)
    ri = torch.clamp((torch.sqrt(torch.clamp(r / r_max, max=1.0)) * n_rings).to(torch.int64),
                     0, n_rings - 1)
    ti = torch.clamp(((theta + math.pi) / (2 * math.pi) * n_sectors).to(torch.int64),
                     0, n_sectors - 1)
    row = torch.arange(B * J, device=xyz.device).reshape(B, J, 1) * LT
    counts = segment.count(B * J * LT, row + ri * n_sectors + ti, mask[:, None, :].expand(B, J, n))
    sig = counts.to(torch.float32).reshape(B, J, LT) / cnt[:, None, None]
    U, _, Vh = torch.linalg.svd(sig, full_matrices=False)
    d = torch.cat([U[..., :, 0], Vh[..., 0, :]], dim=-1)
    return d * torch.sign(torch.sum(d, dim=-1, keepdim=True) + 1e-9)
