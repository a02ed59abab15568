"""Point-cloud registration: VGICP and point-to-plane ICP (port of the
main-path part of `mr_slam_tpu/ops/registration.py`).

Correspondences come from `VoxelGrid` gathers; each Gauss-Newton step
accumulates a 6x6 system, solves it with the unrolled LDL^T and retracts
on SE(3). `lax.scan` loops become Python loops (the iteration counts are
static). The VGICP accumulation is the Hopper kernel
(`ops/hopper_vgicp.py`): `_gn_terms_from_rows` (points already
transformed) dispatches to it, and every inner step of `_vgicp_direct1`
launches it once on a CUDA tensor with the pose applied inside.

Ported: `RegistrationResult`, `_gn_update`, `_uncenter`, `_select_best`,
`_gn_terms_from_rows`, `_vgicp_direct1` (batched over a leading B),
`vgicp` (direct1 without source covariances only), `point_to_plane_icp`
and `fitness`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..geometry import se3
from ..geometry.se3 import Pose
from . import hopper_vgicp, linalg3, voxel_grid
from .pointcloud import PointCloud


class RegistrationResult(NamedTuple):
    pose: Pose                    # refined source->target transform
    num_inliers: torch.Tensor     # matched points at the final iterate
    error: torch.Tensor           # mean weighted residual cost
    fitness: torch.Tensor         # PCL-style fitness (mean sq dist, capped)
    converged: torch.Tensor       # final update norm below tolerance


def _select_best(best: torch.Tensor, *arrays):
    """arrays[..., best[...], ...]: pick candidate `best` along the K
    axis (the reference contracts a one-hot; a gather is exact)."""
    out = []
    for a in arrays:
        idx = best.reshape(*best.shape, 1, *([1] * (a.dim() - best.dim() - 1)))
        idx = idx.expand(*best.shape, 1, *a.shape[best.dim() + 1:])
        out.append(torch.gather(a, best.dim(), idx).squeeze(best.dim()))
    return out


def _eye6(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(6, dtype=like.dtype, device=like.device)


def _gn_update(H: torch.Tensor, b: torch.Tensor, damping: float) -> torch.Tensor:
    """Solve (H + lambda I) dx = b, lambda = damping * mean(diag H) + 1e-9."""
    diag = torch.diagonal(H, dim1=-2, dim2=-1)
    lam = damping * torch.mean(diag, dim=-1)[..., None, None] + 1e-9
    return linalg3.solve_psd(H + lam * _eye6(H), b)


def _uncenter(dx_c: torch.Tensor, center: torch.Tensor) -> torch.Tensor:
    """Centered GN update (rho_c, phi) -> origin parameterization:
    rho = rho_c + c x phi."""
    rho = dx_c[..., 0:3] + torch.linalg.cross(center, dx_c[..., 3:6], dim=-1)
    return torch.cat([rho, dx_c[..., 3:6]], dim=-1)


def _gn_terms_from_rows(
    tp: torch.Tensor,        # (B, N, 3) transformed source points
    mask: torch.Tensor,      # (B, N) bool
    table: torch.Tensor,     # (B, H, 16) packed voxel tables
    slot: torch.Tensor,      # (B, N) int32 cached correspondence slots
    found: torch.Tensor,     # (B, N) bool
    max_corr2: float,
    eps: float = 1e-6,
    center: torch.Tensor | None = None,
):
    """GN accumulation against CACHED correspondences: `table[slot]` is
    the cached row set of the reference's `rows` argument (the table
    does not change during a registration). `center` (B, 3): optional
    linearization center — J = [-I | hat(tp - c)] keeps the 6x6 normal
    equations well-conditioned in f32; the caller converts the solved
    update back with `_uncenter`. Runs the Hopper kernel in slot mode
    (its plain twin on CPU). Returns (H (B,6,6), b (B,6), cost (B,),
    inliers (B,))."""
    return hopper_vgicp.gn_accumulate(
        tp, mask, table, slot=slot, found=found, eps=eps,
        max_corr2=max_corr2, center=center,
    )


def _f32_square(x: float) -> float:
    """The reference squares gate radii in float32."""
    return float(np.float32(x) * np.float32(x))


def vgicp(
    source: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    source_covs: torch.Tensor | None = None,
    iters: int = 20,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
    neighbors: str = "direct1",
    schedule: tuple | None = None,
) -> RegistrationResult:
    """Voxelized GICP against a Gaussian voxel map, batched: source
    (B, N, 3), target (B, H, 16), init (B,). Only the loop-verification
    configuration is ported — direct1 neighbours without source
    covariances (the reference's fused `_vgicp_direct1` path). Any other
    combination raises, including a `schedule` off direct1, which the
    reference silently ignores there."""
    if source_covs is not None or neighbors != "direct1":
        raise NotImplementedError(
            "only direct1 VGICP without source covariances is ported"
            + (" (schedule applies to direct1 only)" if schedule is not None else "")
        )
    return _vgicp_direct1(
        source, target, init, iters=iters, max_corr_dist=max_corr_dist,
        damping=damping, tol=tol, schedule=schedule,
    )


def _default_schedule(iters: int, inner: int) -> tuple:
    return tuple(
        (min(inner, iters - k * inner), 1) for k in range(-(-iters // inner))
    )


def _vgicp_direct1(
    source: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    iters: int = 20,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
    inner: int = 10,
    schedule: tuple | None = None,
) -> RegistrationResult:
    """Fused direct1 VGICP with correspondence caching, batched over a
    leading B (the reference vmaps it over verify candidates).

    `iters` GN steps run as ceil(iters/inner) association rounds
    (`voxel_grid.lookup_slots`) x `inner` gather-free GN steps against
    the cached slots; `schedule` ((inner_iters, source_stride), ...)
    overrides that with the annealed rounds. Each inner step is one
    Hopper kernel launch for the whole batch."""
    max_corr2 = _f32_square(max_corr_dist)
    if schedule is None:
        schedule = _default_schedule(iters, inner)
    # linearization center: masked source centroid, fixed across rounds
    wm = source.mask.to(torch.float32)
    centroid = torch.sum(source.xyz * wm[..., None], dim=-2) / torch.clamp(
        torch.sum(wm, dim=-1), min=1.0
    )[..., None]
    pose = init
    B = source.xyz.shape[0]
    dev = source.xyz.device
    last_dx = torch.full((B,), torch.inf, device=dev)
    cost = torch.zeros((B,), device=dev)
    n_in = torch.zeros((B,), device=dev)
    for inner_n, stride in schedule:
        sxyz = source.xyz[:, ::stride].contiguous()
        smask = source.mask[:, ::stride].contiguous()
        slot, found = voxel_grid.lookup_slots(target, se3.apply(pose, sxyz))
        c = se3.apply(pose, centroid[:, None, :])[:, 0].contiguous()
        for _ in range(inner_n):
            # the kernel applies the pose itself: one launch per step
            H, b, cst, n = hopper_vgicp.gn_accumulate(
                sxyz, smask, target.packed, slot=slot, found=found, max_corr2=max_corr2,
                center=c, pose=Pose(pose.R.contiguous(), pose.t.contiguous()),
            )
            dx_c = _gn_update(H + 1e-6 * _eye6(H), b, damping)
            pose = se3.compose(se3.exp(_uncenter(dx_c, c)), pose)
            last_dx = torch.linalg.norm(dx_c, dim=-1)
            cost, n_in = cst / torch.clamp(n, min=1.0), n
    fit = fitness(source, target, pose, max_range=1.0)
    return RegistrationResult(
        pose=se3.normalize(pose), num_inliers=n_in, error=cost, fitness=fit,
        converged=last_dx < tol,
    )


def _planarity(C: torch.Tensor):
    """(normal, planar) of covariances (..., 3, 3): smallest-eigenvalue
    axis, and lambda0 < 0.1 * lambda1."""
    eye = torch.eye(3, dtype=C.dtype, device=C.device)
    evals, V = linalg3.eigh3(C + 1e-9 * eye)
    return V[..., :, 0], evals[..., 0] < 0.1 * torch.clamp(evals[..., 1], min=1e-9)


def point_to_plane_icp(
    source: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    iters: int = 20,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
    neighbors: str = "direct7",
    inner: int = 4,
    schedule: tuple | None = None,
) -> RegistrationResult:
    """Point-to-plane ICP (FAST-LIO's `esti_plane` geometry) against
    planes pooled from the matched cell and its neighbour cells, with a
    nearest-single-cell fallback. Association rounds x `inner` GN steps
    against the cached planes; `schedule` as in `_vgicp_direct1`.
    Single cloud: source (N, 3), target (H, 16), init ()."""
    if schedule is None:
        schedule = _default_schedule(iters, inner)
    max_corr2 = _f32_square(max_corr_dist)
    pose = init
    dev = source.xyz.device
    last_dx = torch.full((), torch.inf, device=dev)
    cost = torch.zeros((), device=dev)
    n_in = torch.zeros((), device=dev)
    for inner_n, stride in schedule:
        sxyz = source.xyz[::stride]
        smask = source.mask[::stride]
        tp = se3.apply(pose, sxyz)
        found, cnt, mu, Cv = voxel_grid.lookup(target, tp, neighbors)
        # Candidate A: moments pooled over all found neighbour cells.
        wk = torch.where(found, cnt, 0.0)                       # (N, K)
        wsum = torch.sum(wk, dim=-1)
        mu_p = torch.einsum("nk,nki->ni", wk, mu) / torch.clamp(wsum[:, None], min=1.0)
        M2 = Cv + mu[..., :, None] * mu[..., None, :]
        M2_p = torch.einsum("nk,nkij->nij", wk, M2) / torch.clamp(
            wsum[:, None, None], min=1.0
        )
        Cp = M2_p - mu_p[:, :, None] * mu_p[:, None, :]
        # Candidate B: nearest single cell.
        d2k = torch.where(found, torch.sum((mu - tp[:, None, :]) ** 2, dim=-1), torch.inf)
        best = torch.argmin(d2k, dim=-1)
        mu_c, Cv_c, cnt_c = _select_best(best, mu, Cv, wk)
        n_p, planar_p = _planarity(Cp)
        n_c, planar_c = _planarity(Cv_c)
        use_pool = planar_p & (wsum >= 5)
        use_cell = (~use_pool) & planar_c & (cnt_c >= 3)
        n = torch.where(use_pool[:, None], n_p, n_c)
        mu_b = torch.where(use_pool[:, None], mu_p, mu_c)
        usable = smask & (use_pool | use_cell)
        for _ in range(inner_n):
            tp_i = se3.apply(pose, sxyz)
            d2_b = torch.sum((mu_b - tp_i) ** 2, dim=-1)
            w = (usable & (d2_b < max_corr2)).to(torch.float32)
            r = torch.sum(n * (tp_i - mu_b), dim=-1)
            J = torch.cat([n, torch.linalg.cross(tp_i, n, dim=-1)], dim=-1)  # (N, 6)
            H = (J * w[:, None]).T @ J
            b = -(J.T @ (r * w))
            dx = _gn_update(H + 1e-6 * _eye6(H), b, damping)
            pose = se3.compose(se3.exp(dx), pose)
            last_dx = torch.linalg.norm(dx)
            cost = torch.sum(r * r * w) / torch.clamp(torch.sum(w), min=1.0)
            n_in = torch.sum(w)
    fit = fitness(source, target, pose, max_range=1.0)
    return RegistrationResult(
        pose=se3.normalize(pose), num_inliers=n_in, error=cost, fitness=fit,
        converged=last_dx < tol,
    )


def fitness(
    source: PointCloud,
    target: voxel_grid.VoxelGrid,
    pose: Pose,
    max_range: float = 1.0,
    min_match: float = 0.5,
) -> torch.Tensor:
    """PCL `getFitnessScore(max_range)` analogue — the loop acceptance
    gate: point-to-plane distance to the nearest direct27 cell's plane
    (centroid distance for non-planar cells), averaged over matched
    points; `max_range^2` when fewer than `min_match` of the source
    points matched. Any leading batch shape (source (..., N, 3), target
    (..., H, 16), pose (...))."""
    tp = se3.apply(pose, source.xyz)
    found, cnt, mu, Cv = voxel_grid.lookup(target, tp, "direct27")
    dc2 = torch.sum((mu - tp[..., :, None, :]) ** 2, dim=-1)
    dc2 = torch.where(found, dc2, torch.inf)
    dc2_b, best = torch.min(dc2, dim=-1)
    mu_b, Cv_b = _select_best(best, mu, Cv)
    n, planar = _planarity(Cv_b)
    dp2 = torch.sum(n * (tp - mu_b), dim=-1) ** 2
    d2 = torch.where(planar, dp2, dc2_b)
    w = source.mask.to(torch.float32)
    mr2 = _f32_square(max_range)
    matched = (torch.isfinite(dc2_b) & (d2 < mr2)).to(torch.float32) * w
    n_matched = torch.sum(matched, dim=-1)
    mean_matched = torch.sum(torch.where(matched > 0, d2, 0.0), dim=-1) / torch.clamp(
        n_matched, min=1.0
    )
    frac = n_matched / torch.clamp(torch.sum(w, dim=-1), min=1.0)
    return torch.where(frac >= min_match, mean_matched, torch.full_like(mean_matched, mr2))
