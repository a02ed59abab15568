"""Point-cloud registration: VGICP, point-to-plane / point-to-point ICP,
GICP, LOAM feature ICP and the method selector (port of
`mr_slam_tpu/ops/registration.py`).

Correspondences come from `VoxelGrid` gathers; each Gauss-Newton step
accumulates a 6x6 system, solves it with the unrolled LDL^T and retracts
on SE(3). `lax.scan` loops become Python loops (the iteration counts are
static). The VGICP accumulation is the Hopper kernel
(`ops/hopper_vgicp.py`): `_gn_terms_from_rows` (points already
transformed) dispatches to it, and every inner step of `_vgicp_direct1`
launches it once on a CUDA tensor with the pose applied inside.

The public entry points (`vgicp`, `point_to_plane_icp`, `loam_icp`,
`point_to_point_icp`, `gicp`, `register_pair`), each a jitted program in
the reference, run through a runner of their key
(`runtime/register_graph`: CUDA-graph replays on the card), bit-equal to
their eager bodies `_<name>_eager`, which stay as the oracle. Each eager
body is a `*_raw` body (the GN steps, the pose's rotation not yet
projected onto SO(3), whose SVD syncs the host on the card), then
`se3.normalize`; a caller that runs inside a CUDA graph of its own
(loop verification, the odometry, the LIO update, the feature runner)
calls the raw or eager bodies, as a capture cannot hold another.

Ported: `RegistrationResult`, `_gn_update`, `_uncenter`, `_select_best`,
`_gn_terms_from_rows`, `_vgicp_direct1` (batched over a leading B; and
`_vgicp_direct1_raw`), `vgicp` (batched; direct1 without source
covariances runs the kernel, every other case the general matrix path,
`_vgicp_general` / `_vgicp_general_raw`), `point_to_plane_icp` (and
`point_to_plane_icp_raw`), `loam_icp` (and `loam_icp_raw`, with
`pooled_moments`, shared with the LIO update; the reference's `so3_hat`
is `so3.hat`), `point_to_point_icp`, `_regularized_covs`, `gicp` (both
on `_icp_loop_raw`), `fitness` and `register_pair`. The reference's
`_gn_terms_direct1` is the kernel's hash mode
(`hopper_vgicp.gn_accumulate` without `slot=`).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..devconst import const
from ..geometry import se3, so3
from ..geometry.se3 import Pose
from . import hopper_vgicp, linalg3, voxel_grid
from .pointcloud import PointCloud


class RegistrationResult(NamedTuple):
    pose: Pose                    # refined source->target transform
    num_inliers: torch.Tensor     # matched points at the final iterate
    error: torch.Tensor           # mean weighted residual cost
    fitness: torch.Tensor | None  # PCL-style fitness (mean sq dist, capped); None: *_raw
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
    (B, N, 3), target (B, H, 16), init (B,), source_covs (B, N, 3, 3).

    Per point p with covariance Cp matched to voxel (mu, Cv):
    r = mu - (R p + t), W = (Cv + R Cp R^T + 1e-6 I)^-1, cost r^T W r,
    J = [-I | hat(R p + t)]. Direct1 neighbours without source
    covariances (the loop-verification setup) take the fused
    `_vgicp_direct1` path and its Hopper kernel; every other case the
    general path, which matches each point to its nearest valid cell
    among the `neighbors` offsets. A `schedule` applies to the fused
    path only: with source covariances or other neighbours it raises
    (the reference ignores it there). Runs through the runner of its key
    (`runtime/register_graph`), bit-equal to `_vgicp_eager`."""
    from ..runtime import register_graph

    return register_graph.vgicp(source, target, init, source_covs, iters=iters,
                                max_corr_dist=max_corr_dist, damping=damping, tol=tol,
                                neighbors=neighbors, schedule=schedule)


def _direct1(source_covs: torch.Tensor | None, neighbors: str, schedule) -> bool:
    """Whether `vgicp` takes the fused direct1 path; a `schedule` applies
    to that path only."""
    direct1 = source_covs is None and neighbors == "direct1"
    if schedule is not None and not direct1:
        raise NotImplementedError(
            "schedule applies to direct1 VGICP without source covariances only")
    return direct1


def _vgicp_eager(
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
    """`vgicp` op by op: the oracle of its runner."""
    if _direct1(source_covs, neighbors, schedule):
        return _vgicp_direct1(
            source, target, init, iters=iters, max_corr_dist=max_corr_dist,
            damping=damping, tol=tol, schedule=schedule,
        )
    return _vgicp_general(source, target, init, source_covs, iters=iters,
                          max_corr_dist=max_corr_dist, damping=damping, tol=tol,
                          neighbors=neighbors)


def _left_jacobian(tp: torch.Tensor, sign: float) -> torch.Tensor:
    """(..., N, 3, 6) Jacobians [sign I | -sign hat(tp)] of the residual
    sign (R p + t) - target under a left se(3) update."""
    eye = torch.eye(3, dtype=tp.dtype, device=tp.device).expand(*tp.shape, 3)
    return torch.cat([sign * eye, -sign * so3.hat(tp)], dim=-1)


def _vgicp_general(
    source: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    source_covs: torch.Tensor | None,
    iters: int,
    max_corr_dist: float,
    damping: float,
    tol: float,
    neighbors: str,
) -> RegistrationResult:
    """The general matrix path of `vgicp`, batched over a leading B:
    `_vgicp_general_raw`, then `se3.normalize` of the pose, with the
    direct27 `fitness` at the unprojected pose, as the reference scores
    it."""
    res = _vgicp_general_raw(source, target, init, source_covs, iters, max_corr_dist, damping,
                             tol, neighbors)
    return res._replace(pose=se3.normalize(res.pose),
                        fitness=fitness(source, target, res.pose, max_range=1.0))


def _vgicp_general_raw(
    source: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    source_covs: torch.Tensor | None,
    iters: int,
    max_corr_dist: float,
    damping: float,
    tol: float,
    neighbors: str,
) -> RegistrationResult:
    """`_vgicp_general`'s GN steps: the pose's rotation not yet projected
    onto SO(3), no fitness scored (`fitness` is None)."""
    max_corr2 = _f32_square(max_corr_dist)
    xyz = source.xyz
    eye3 = torch.eye(3, dtype=xyz.dtype, device=xyz.device)
    if source_covs is None:
        source_covs = torch.zeros((*xyz.shape, 3), dtype=xyz.dtype, device=xyz.device)
    pose = init
    for _ in range(iters):
        tp = se3.apply(pose, xyz)                                      # (B, N, 3)
        found, _, mu, Cv = voxel_grid.lookup(target, tp, neighbors)
        # the nearest valid neighbour cell per point (first on ties)
        d2 = torch.where(found, torch.sum((mu - tp[..., :, None, :]) ** 2, dim=-1), torch.inf)
        d2_b, best = torch.min(d2, dim=-1)
        mu_b, Cv_b = _select_best(best, mu, Cv)
        w = (source.mask & torch.isfinite(d2_b) & (d2_b < max_corr2)).to(torch.float32)
        Rb = pose.R[..., None, :, :]
        W = linalg3.inv3(Cv_b + Rb @ source_covs @ Rb.transpose(-1, -2) + 1e-6 * eye3)
        r = mu_b - tp
        J = _left_jacobian(tp, -1.0)                                   # [-I | hat(tp)]
        WJ = W @ J
        H = torch.einsum("...nij,...nik,...n->...jk", J, WJ, w)
        b = -torch.einsum("...nij,...ni,...n->...j", WJ, r, w)
        dx = _gn_update(H + 1e-6 * _eye6(H), b, damping)
        pose = se3.compose(se3.exp(dx), pose)
        last_dx = torch.linalg.norm(dx, dim=-1)
        n_in = torch.sum(w, dim=-1)
        cost = torch.sum(torch.einsum("...ni,...nij,...nj->...n", r, W, r) * w, dim=-1) \
            / torch.clamp(n_in, min=1.0)
    return RegistrationResult(pose=pose, num_inliers=n_in, error=cost, fitness=None,
                              converged=last_dx < tol)


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
    leading B (the reference vmaps it over verify candidates):
    `_vgicp_direct1_raw`, then `se3.normalize` of the pose, with the
    full-cloud direct27 `fitness` at the unprojected pose, as the
    reference scores it."""
    res = _vgicp_direct1_raw(source, target, init, iters, max_corr_dist, damping, tol, inner,
                             schedule)
    return res._replace(pose=se3.normalize(res.pose),
                        fitness=fitness(source, target, res.pose, max_range=1.0))


def _vgicp_direct1_raw(
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
    """`_vgicp_direct1`'s association rounds and GN steps: the pose's
    rotation is not yet projected onto SO(3) (the caller runs
    `se3.normalize`, whose SVD syncs the host on the card) and no
    fitness is scored (`fitness` is None), so loop verification's CUDA
    graphs (`runtime/verify_graph.py`) end here and skip the direct27
    pass that nothing of theirs reads.

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
    return RegistrationResult(pose=pose, num_inliers=n_in, error=cost, fitness=None,
                              converged=last_dx < tol)


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
    Single cloud: source (N, 3), target (H, 16), init (). Runs through
    the runner of its key (`runtime/register_graph`), bit-equal to
    `_point_to_plane_icp_eager`."""
    from ..runtime import register_graph

    return register_graph.point_to_plane_icp(source, target, init, iters=iters,
                                             max_corr_dist=max_corr_dist, damping=damping,
                                             tol=tol, neighbors=neighbors, inner=inner,
                                             schedule=schedule)


def _point_to_plane_icp_eager(
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
    """`point_to_plane_icp` op by op: `point_to_plane_icp_raw`, then
    `se3.normalize` of the pose, with `fitness` scored at the unprojected
    pose, as the reference scores it."""
    res = point_to_plane_icp_raw(source, target, init, iters, max_corr_dist, damping, tol,
                                 neighbors, inner, schedule)
    return res._replace(pose=se3.normalize(res.pose),
                        fitness=fitness(source, target, res.pose, max_range=1.0))


def point_to_plane_icp_raw(
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
    """`point_to_plane_icp` up to its last step: the pose's rotation is
    the product of the GN steps, not yet projected onto SO(3). The
    projection (`so3.project`, an SVD that syncs the host on the card)
    is left to the caller, so the odometry's CUDA graphs
    (`runtime/frame_graph.py`) end here and the projection runs between
    them. No fitness is scored (`fitness` is None): the odometry does
    not read it."""
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
    return RegistrationResult(
        pose=pose, num_inliers=n_in, error=cost, fitness=None, converged=last_dx < tol,
    )


def pooled_moments(target: voxel_grid.VoxelGrid, tp: torch.Tensor):
    """(mean (N, 3), covariance (N, 3, 3), weight (N,)) of the Gaussian
    cells found around each point by `direct7`, pooled by count."""
    found, cnt, mu, Cv = voxel_grid.lookup(target, tp, "direct7")
    wk = torch.where(found, cnt, 0.0)
    wsum = torch.sum(wk, dim=-1)
    mu_p = torch.einsum("nk,nki->ni", wk, mu) / torch.clamp(wsum[:, None], min=1.0)
    M2 = Cv + mu[..., :, None] * mu[..., None, :]
    M2_p = torch.einsum("nk,nkij->nij", wk, M2) / torch.clamp(wsum[:, None, None], min=1.0)
    return mu_p, M2_p - mu_p[:, :, None] * mu_p[:, None, :], wsum


def loam_icp(
    corners: PointCloud,
    surfs: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    iters: int = 10,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
) -> RegistrationResult:
    """A-LOAM-style feature registration: surf points against planes
    (point-to-plane, LidarPlaneFactor) and corner points against lines
    (the perpendicular offset from the pooled cells' dominant axis,
    LidarEdgeFactor), both families in one 6x6 GN system per iteration,
    re-associated every iteration. Single cloud. Runs through the runner
    of its key (`runtime/register_graph`), bit-equal to
    `_loam_icp_eager`."""
    from ..runtime import register_graph

    return register_graph.loam_icp(corners, surfs, target, init, iters=iters,
                                   max_corr_dist=max_corr_dist, damping=damping, tol=tol)


def _loam_icp_eager(
    corners: PointCloud,
    surfs: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    iters: int = 10,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
) -> RegistrationResult:
    """`loam_icp` op by op: `loam_icp_raw`, then `se3.normalize` of the
    pose, with the surfs' `fitness` at the unprojected pose, as the
    reference scores it."""
    res = loam_icp_raw(corners, surfs, target, init, iters, max_corr_dist, damping, tol)
    return res._replace(pose=se3.normalize(res.pose),
                        fitness=fitness(surfs, target, res.pose, max_range=1.0))


def loam_icp_raw(
    corners: PointCloud,
    surfs: PointCloud,
    target: voxel_grid.VoxelGrid,
    init: Pose,
    iters: int = 10,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
) -> RegistrationResult:
    """`loam_icp`'s GN steps: the pose's rotation not yet projected onto
    SO(3), no fitness scored (`fitness` is None)."""
    max_corr2 = _f32_square(max_corr_dist)
    eye3 = torch.eye(3, dtype=corners.xyz.dtype, device=corners.xyz.device)
    pose = init
    dev = surfs.xyz.device
    last_dx = torch.full((), torch.inf, device=dev)
    cost = torch.zeros((), device=dev)
    n_in = torch.zeros((), device=dev)
    for _ in range(iters):
        # surf -> plane
        tp_s = se3.apply(pose, surfs.xyz)
        mu_p, Cp, wsum = pooled_moments(target, tp_s)
        n, planar = _planarity(Cp)
        d2s = torch.sum((mu_p - tp_s) ** 2, dim=-1)
        w_s = (surfs.mask & planar & (wsum >= 5) & (d2s < max_corr2)).to(torch.float32)
        r_s = torch.sum(n * (tp_s - mu_p), dim=-1)
        J_s = torch.cat([n, torch.linalg.cross(tp_s, n, dim=-1)], dim=-1)   # (Ns, 6)
        H = (J_s * w_s[:, None]).T @ J_s
        g = -(J_s.T @ (r_s * w_s))
        # corner -> line
        tp_c = se3.apply(pose, corners.xyz)
        mu_cp, Ccp, wsum_c = pooled_moments(target, tp_c)
        evc, Vc = linalg3.eigh3(Ccp + 1e-9 * eye3)
        d = Vc[..., :, 2]  # the line: the largest-eigenvalue axis
        linear = evc[..., 2] > 3.0 * torch.clamp(evc[..., 1], min=1e-9)
        d2c = torch.sum((mu_cp - tp_c) ** 2, dim=-1)
        w_c = (corners.mask & linear & (wsum_c >= 4) & (d2c < max_corr2)).to(torch.float32)
        diff = tp_c - mu_cp
        r_c = diff - d * torch.sum(d * diff, dim=-1, keepdim=True)        # (Nc, 3)
        P = eye3 - d[:, :, None] * d[:, None, :]
        J_c = torch.cat([P, -(P @ so3.hat(tp_c))], dim=-1)               # (Nc, 3, 6)
        H = H + torch.einsum("nri,nrj,n->ij", J_c, J_c, w_c)
        g = g - torch.einsum("nri,nr,n->i", J_c, r_c, w_c)
        dx = _gn_update(H + 1e-6 * _eye6(H), g, damping)
        pose = se3.compose(se3.exp(dx), pose)
        last_dx = torch.linalg.norm(dx)
        n_in = torch.sum(w_s) + torch.sum(w_c)
        cost = (torch.sum(r_s * r_s * w_s) + torch.sum(torch.sum(r_c * r_c, dim=-1) * w_c)) \
            / torch.clamp(n_in, min=1.0)
    return RegistrationResult(pose=pose, num_inliers=n_in, error=cost, fitness=None,
                              converged=last_dx < tol)


def _nearest(tp: torch.Tensor, target: PointCloud):
    """(d2 (..., N), idx (..., N), matched points (..., N, 3)): the
    nearest target point of each query, lower index first on ties."""
    from . import pointcloud

    d2, idx = pointcloud.knn(tp, target, 1)
    j = idx[..., 0]
    q = torch.gather(target.xyz, -2, j[..., None].expand(*j.shape, 3))
    return d2[..., 0], j, q


def _icp_loop_raw(source: PointCloud, init: Pose, iters: int, damping: float, tol: float,
                  associate) -> RegistrationResult:
    """GN on the residual r = (R p + t) - q with J = [I | -hat(R p + t)]
    and per-point weights M: `associate(tp, pose)` returns (q, M
    (..., N, 3, 3) or None for the identity, w (..., N)). The cost
    r^T M r is both the error and the fitness of the result. The pose's
    rotation is not yet projected onto SO(3) (`_projected` does)."""
    pose = init
    for _ in range(iters):
        tp = se3.apply(pose, source.xyz)
        q, M, w = associate(tp, pose)
        r = tp - q
        J = _left_jacobian(tp, 1.0)
        MJ = J if M is None else M @ J
        H = torch.einsum("...nai,...naj,...n->...ij", J, MJ, w)
        b = -torch.einsum("...nai,...na,...n->...i", MJ, r, w)
        dx = _gn_update(H + 1e-6 * _eye6(H), b, damping)
        pose = se3.compose(se3.exp(dx), pose)
        last_dx = torch.linalg.norm(dx, dim=-1)
        n_in = torch.sum(w, dim=-1)
        rr = torch.sum(r * r, dim=-1) if M is None else \
            torch.einsum("...na,...nab,...nb->...n", r, M, r)
        cost = torch.sum(rr * w, dim=-1) / torch.clamp(n_in, min=1.0)
    return RegistrationResult(pose=pose, num_inliers=n_in, error=cost, fitness=cost,
                              converged=last_dx < tol)


def _projected(res: RegistrationResult) -> RegistrationResult:
    """A raw result with its pose's rotation projected onto SO(3)."""
    return res._replace(pose=se3.normalize(res.pose))


def point_to_point_icp(
    source: PointCloud,
    target: PointCloud,
    init: Pose,
    iters: int = 20,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
) -> RegistrationResult:
    """Classic point-to-point ICP (the reference's PCL_ICP option):
    brute-force nearest neighbours (`pointcloud.knn`), residual = the
    matched offset, GN on se(3). Any leading batch of clouds; meant for
    loop-verification sizes (<= ~8k points a side). Runs through the
    runner of its key (`runtime/register_graph`), bit-equal to
    `_point_to_point_icp_eager`."""
    from ..runtime import register_graph

    return register_graph.point_to_point_icp(source, target, init, iters=iters,
                                             max_corr_dist=max_corr_dist, damping=damping,
                                             tol=tol)


def _point_to_point_icp_eager(source: PointCloud, target: PointCloud, init: Pose,
                              iters: int = 20, max_corr_dist: float = 1.0,
                              damping: float = 1e-6, tol: float = 1e-4) -> RegistrationResult:
    """`point_to_point_icp` op by op."""
    return _projected(_point_to_point_icp_raw(source, target, init, iters, max_corr_dist,
                                              damping, tol))


def _point_to_point_icp_raw(source: PointCloud, target: PointCloud, init: Pose,
                            iters: int = 20, max_corr_dist: float = 1.0,
                            damping: float = 1e-6, tol: float = 1e-4) -> RegistrationResult:
    """`point_to_point_icp`'s GN steps (`_icp_loop_raw`)."""
    max_corr2 = _f32_square(max_corr_dist)

    def associate(tp, pose):
        d2, _, q = _nearest(tp, target)
        return q, None, (source.mask & (d2 < max_corr2)).to(torch.float32)

    return _icp_loop_raw(source, init, iters, damping, tol, associate)


def _regularized_covs(pc: PointCloud, k: int = 10):
    """fast_gicp's covariance regularisation: per-point k-neighbourhood
    covariances with eigenvalues snapped to (1e-3, 1, 1), every local
    surface a plane of uniform confidence. Returns (covs (..., N, 3, 3),
    valid (..., N))."""
    from . import pointcloud

    _, cov, valid = pointcloud.covariances_knn(pc, k)
    eye = torch.eye(3, dtype=cov.dtype, device=cov.device)
    _, V = linalg3.eigh3(cov + 1e-9 * eye)
    snapped = const((1e-3, 1.0, 1.0), cov.device, cov.dtype)  # no host copy under capture
    return (V * snapped) @ V.transpose(-1, -2), valid


def gicp(
    source: PointCloud,
    target: PointCloud,
    init: Pose,
    iters: int = 20,
    max_corr_dist: float = 1.0,
    damping: float = 1e-6,
    tol: float = 1e-4,
    corr_k: int = 10,
) -> RegistrationResult:
    """Generalized ICP (plane-to-plane; the PCL_GICP / FAST_GICP options):
    cost d^T (C_b + R C_a R^T + 1e-6 I)^-1 d per nearest-neighbour
    correspondence, with `_regularized_covs` on both clouds. Any leading
    batch of clouds. Runs through the runner of its key
    (`runtime/register_graph`), bit-equal to `_gicp_eager`."""
    from ..runtime import register_graph

    return register_graph.gicp(source, target, init, iters=iters, max_corr_dist=max_corr_dist,
                               damping=damping, tol=tol, corr_k=corr_k)


def _gicp_eager(source: PointCloud, target: PointCloud, init: Pose, iters: int = 20,
                max_corr_dist: float = 1.0, damping: float = 1e-6, tol: float = 1e-4,
                corr_k: int = 10) -> RegistrationResult:
    """`gicp` op by op."""
    return _projected(_gicp_raw(source, target, init, iters, max_corr_dist, damping, tol,
                                corr_k))


def _gicp_raw(source: PointCloud, target: PointCloud, init: Pose, iters: int = 20,
              max_corr_dist: float = 1.0, damping: float = 1e-6, tol: float = 1e-4,
              corr_k: int = 10) -> RegistrationResult:
    """`gicp`'s covariances and GN steps (`_icp_loop_raw`)."""
    max_corr2 = _f32_square(max_corr_dist)
    Ca, va = _regularized_covs(source, corr_k)
    Cb, vb = _regularized_covs(target, corr_k)
    eye3 = torch.eye(3, dtype=Ca.dtype, device=Ca.device)

    def associate(tp, pose):
        d2, j, q = _nearest(tp, target)
        Cbj = torch.gather(Cb, -3, j[..., None, None].expand(*j.shape, 3, 3))
        vbj = torch.gather(vb, -1, j)
        Rb = pose.R[..., None, :, :]
        # the reference's jnp.linalg.inv: an LU inverse of each 3x3;
        # inv_ex skips the status check, a host sync on the card
        M = torch.linalg.inv_ex(Cbj + Rb @ Ca @ Rb.transpose(-1, -2) + 1e-6 * eye3).inverse
        return q, M, (source.mask & va & vbj & (d2 < max_corr2)).to(torch.float32)

    return _icp_loop_raw(source, init, iters, damping, tol, associate)


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


def register_pair(
    source: PointCloud,
    target: PointCloud,
    init: Pose,
    leaf: float = 0.5,
    table_size: int = 1 << 15,
    method: str = "vgicp",
    iters: int = 20,
    max_corr_dist: float = 1.0,
) -> RegistrationResult:
    """Registration selector for one (source, target) pair, the
    reference's `select_registration_method` + `ICPCheck` per candidate:

      "icp"            -> point-to-point (PCL_ICP)
      "gicp"           -> plane-to-plane GICP (PCL_GICP / FAST_GICP)
      "vgicp"          -> voxelized GICP (FAST_VGICP_CUDA, the
                          production default; the Hopper kernel at B = 1)
      "point_to_plane" -> plane residual against the voxel map

    Single clouds (N, 3), a single init. Fitness is scored against a
    permissive min_points=1 grid on every 4th source point (as
    `loopstage.verify_chunk` scores it). Runs through the runner of its
    key (`runtime/register_graph`), bit-equal to `_register_pair_eager`."""
    if method not in PAIR_METHODS:
        raise ValueError(f"unknown registration method {method!r}")
    from ..runtime import register_graph

    return register_graph.register_pair(source, target, init, leaf=leaf, table_size=table_size,
                                        method=method, iters=iters, max_corr_dist=max_corr_dist)


PAIR_METHODS = ("icp", "gicp", "vgicp", "point_to_plane")


def _register_pair_eager(
    source: PointCloud,
    target: PointCloud,
    init: Pose,
    leaf: float = 0.5,
    table_size: int = 1 << 15,
    method: str = "vgicp",
    iters: int = 20,
    max_corr_dist: float = 1.0,
) -> RegistrationResult:
    """`register_pair` op by op: the oracle of its runner."""
    if method == "icp":
        result = _point_to_point_icp_eager(source, target, init, iters=iters,
                                           max_corr_dist=max_corr_dist)
    elif method == "gicp":
        result = _gicp_eager(source, target, init, iters=iters, max_corr_dist=max_corr_dist)
    elif method == "vgicp":
        grid = voxel_grid.build(target, leaf, table_size, min_points=3, regularize="plane")
        res = _vgicp_eager(PointCloud(source.xyz[None], source.mask[None]),
                           voxel_grid.VoxelGrid(grid.packed[None], grid.leaf),
                           Pose(init.R[None], init.t[None]), iters=iters,
                           max_corr_dist=max_corr_dist)
        result = RegistrationResult(se3.index(res.pose, 0), *(x[0] for x in res[1:]))
    elif method == "point_to_plane":
        grid = voxel_grid.build(target, leaf, table_size, min_points=3, regularize="plane")
        result = _point_to_plane_icp_eager(source, grid, init, iters=iters,
                                           max_corr_dist=max_corr_dist)
    else:
        raise ValueError(f"unknown registration method {method!r}")
    fit_grid = voxel_grid.build(target, leaf, table_size, min_points=1)
    sub = PointCloud(source.xyz[::4], source.mask[::4])
    return result._replace(fitness=fitness(sub, fit_grid, result.pose))
