"""Closed-form batched 3x3 symmetric linear algebra, and the small PSD
solves of the Gauss-Newton and IEKF updates (port of
`mr_slam_tpu/ops/linalg3.py`: `det3`, `inv3`, `solve3`, `eigvalsh3`,
`eigh3`, `plane_fit`, `solve_psd`, `inv_psd_scaled`, `solve_psd_scaled`).

The same analytic formulas as the reference, element-wise over any batch
shape. `torch.linalg.eigh` is not used: it orders and signs degenerate
eigenvectors differently, and the plane regularization of
`voxel_grid.build` runs `eigh3` on every table row.
"""
from __future__ import annotations

import math

import torch

from ..devconst import const

_EPS = 1e-12


def det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3)."""
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def inv3(A: torch.Tensor) -> torch.Tensor:
    """Adjugate-based inverse of (..., 3, 3)."""
    c00 = A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1]
    c01 = A[..., 0, 2] * A[..., 2, 1] - A[..., 0, 1] * A[..., 2, 2]
    c02 = A[..., 0, 1] * A[..., 1, 2] - A[..., 0, 2] * A[..., 1, 1]
    c10 = A[..., 1, 2] * A[..., 2, 0] - A[..., 1, 0] * A[..., 2, 2]
    c11 = A[..., 0, 0] * A[..., 2, 2] - A[..., 0, 2] * A[..., 2, 0]
    c12 = A[..., 0, 2] * A[..., 1, 0] - A[..., 0, 0] * A[..., 1, 2]
    c20 = A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0]
    c21 = A[..., 0, 1] * A[..., 2, 0] - A[..., 0, 0] * A[..., 2, 1]
    c22 = A[..., 0, 0] * A[..., 1, 1] - A[..., 0, 1] * A[..., 1, 0]
    det = A[..., 0, 0] * c00 + A[..., 0, 1] * c10 + A[..., 0, 2] * c20
    inv_det = 1.0 / torch.where(torch.abs(det) < _EPS, torch.inf, det)
    adj = torch.stack(
        [
            torch.stack([c00, c01, c02], dim=-1),
            torch.stack([c10, c11, c12], dim=-1),
            torch.stack([c20, c21, c22], dim=-1),
        ],
        dim=-2,
    )
    return adj * inv_det[..., None, None]


def solve3(A: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve (..., 3, 3) @ x = (..., 3) through the adjugate inverse."""
    return (inv3(A) @ b[..., None])[..., 0]


def eigvalsh3(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of symmetric (..., 3, 3), ascending — trigonometric
    closed form (Smith 1961), branch-free."""
    a00, a11, a22 = A[..., 0, 0], A[..., 1, 1], A[..., 2, 2]
    a01, a02, a12 = A[..., 0, 1], A[..., 0, 2], A[..., 1, 2]
    q = (a00 + a11 + a22) / 3.0
    b00, b11, b22 = a00 - q, a11 - q, a22 - q
    p2 = (b00 * b00 + b11 * b11 + b22 * b22) / 6.0 + (
        a01 * a01 + a02 * a02 + a12 * a12
    ) / 3.0
    p = torch.sqrt(torch.clamp(p2, min=_EPS))
    detB = (
        b00 * (b11 * b22 - a12 * a12)
        - a01 * (a01 * b22 - a12 * a02)
        + a02 * (a01 * a12 - b11 * a02)
    )
    r = torch.clamp(detB / (2.0 * p * p * p), -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e_hi = q + 2.0 * p * torch.cos(phi)
    e_lo = q + 2.0 * p * torch.cos(phi + 2.0 * math.pi / 3.0)
    e_mid = 3.0 * q - e_hi - e_lo
    return torch.stack([e_lo, e_mid, e_hi], dim=-1)


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.linalg.cross(a, b, dim=-1)


def _eigvec(A: torch.Tensor, lam: torch.Tensor) -> torch.Tensor:
    """Eigenvector of symmetric 3x3 for eigenvalue lam via cross products
    of rows of (A - lam I) — picks the most independent pair."""
    eye = torch.eye(3, dtype=A.dtype, device=A.device)
    B = A - lam[..., None, None] * eye
    r0, r1, r2 = B[..., 0, :], B[..., 1, :], B[..., 2, :]
    cands = torch.stack([_cross(r0, r1), _cross(r0, r2), _cross(r1, r2)], dim=-2)
    norms = torch.sum(cands * cands, dim=-1)
    best = torch.argmax(norms, dim=-1)
    v = torch.gather(cands, -2, best[..., None, None].expand(*best.shape, 1, 3))[..., 0, :]
    n2 = torch.sum(v * v, dim=-1, keepdim=True)
    # Repeated eigenvalue: every row cross product vanishes; fall back to
    # a canonical axis (orthogonalized by the caller). The fallback
    # threshold and the normalizer must agree (see the reference).
    fallback = const((1.0, 0.0, 0.0), A.device).expand(v.shape)
    use_fallback = n2 <= 1e-30
    v = torch.where(use_fallback, fallback, v)
    n2 = torch.where(use_fallback, torch.ones_like(n2), n2)
    return v / torch.sqrt(n2)


def eigh3(A: torch.Tensor):
    """Eigen-decomposition of symmetric (..., 3, 3).

    Returns (w (..., 3) ascending, V (..., 3, 3) with columns =
    eigenvectors). Degenerate inputs get an orthonormal basis via
    Gram-Schmidt completion.
    """
    w = eigvalsh3(A)
    v0 = _eigvec(A, w[..., 0])
    v2 = _eigvec(A, w[..., 2])
    dot = torch.sum(v0 * v2, dim=-1, keepdim=True)
    v2o = v2 - dot * v0
    n2 = torch.sqrt(torch.clamp(torch.sum(v2o * v2o, dim=-1, keepdim=True), min=_EPS))
    ex = const((1.0, 0.0, 0.0), A.device).expand(v0.shape)
    ey = const((0.0, 1.0, 0.0), A.device).expand(v0.shape)
    alt = _cross(v0, ex)
    alt_n = torch.sqrt(torch.clamp(torch.sum(alt * alt, dim=-1, keepdim=True), min=_EPS))
    alt2 = _cross(v0, ey)
    alt2_n = torch.sqrt(torch.clamp(torch.sum(alt2 * alt2, dim=-1, keepdim=True), min=_EPS))
    alt = torch.where(alt_n > 0.1, alt / alt_n, alt2 / alt2_n)
    v2f = torch.where(n2 > 1e-4, v2o / n2, alt)
    v1 = _cross(v2f, v0)
    V = torch.stack([v0, v1, v2f], dim=-1)
    return w, V


def plane_fit(points: torch.Tensor, weights: torch.Tensor | None = None):
    """Least-squares plane through (..., K, 3) points: (normal (..., 3)
    unit, d (...,), mean (..., 3)) with plane n.x + d = 0 (FAST-LIO's
    `esti_plane`, A-LOAM's surf fit). The weighted moments sum over K
    in index order, as the reference's reductions do."""
    if weights is None:
        weights = torch.ones(points.shape[:-1], dtype=points.dtype, device=points.device)
    wsum = torch.clamp(torch.sum(weights, dim=-1, keepdim=True), min=_EPS)
    mean = torch.sum(points * weights[..., None], dim=-2) / wsum
    c = points - mean[..., None, :]
    d = c * weights[..., None]
    cov = d[..., 0, :, None] * c[..., 0, None, :]
    for k in range(1, points.shape[-2]):
        cov = cov + d[..., k, :, None] * c[..., k, None, :]
    _, V = eigh3(cov)
    normal = V[..., :, 0]  # the smallest-eigenvalue direction
    return normal, -torch.sum(normal * mean, dim=-1), mean


def solve_psd(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Unrolled LDL^T solve of (..., n, n) @ x = (..., n) for SMALL
    static n (the Gauss-Newton 6x6), no pivoting: the damped normal
    matrices it serves are PSD. Element-wise over the batch, as in the
    reference; on the card each scalar step is its own launch, so one
    6x6 solve costs ~200 launches whatever the batch size."""
    n = A.shape[-1]
    L = [[None] * n for _ in range(n)]
    D = [None] * n
    Dinv = [None] * n
    for j in range(n):
        d = A[..., j, j]
        for k in range(j):
            d = d - L[j][k] * L[j][k] * D[k]
        d = torch.where(d > eps, d, torch.full_like(d, eps))  # PSD guard
        D[j] = d
        Dinv[j] = 1.0 / d
        for i in range(j + 1, n):
            s = A[..., i, j]
            for k in range(j):
                s = s - L[i][k] * L[j][k] * D[k]
            L[i][j] = s * Dinv[j]
    y = [None] * n
    for i in range(n):
        s = b[..., i]
        for k in range(i):
            s = s - L[i][k] * y[k]
        y[i] = s
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i] * Dinv[i]
        for k in range(i + 1, n):
            s = s - L[k][i] * x[k]
        x[i] = s
    return torch.stack(x, dim=-1)


def _ldl_solve(A: torch.Tensor, B: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """LDL^T solve of (..., n, n) @ X = B (..., n, m) without pivoting,
    column by column: n steps of vector operations each for the
    factorization and the two substitutions, so an n x n system costs
    O(n) launches on the card (the element-wise unrolling of `solve_psd`
    costs O(n^3)). The pivots get `solve_psd`'s PSD guard."""
    n = A.shape[-1]
    L = torch.zeros_like(A)
    D = A.new_zeros(A.shape[:-1])
    for j in range(n):
        v = L[..., j, :j] * D[..., :j]
        d = A[..., j, j] - torch.sum(L[..., j, :j] * v, dim=-1)
        d = torch.where(d > eps, d, torch.full_like(d, eps))
        D[..., j] = d
        if j + 1 < n:
            col = A[..., j + 1:, j] - (L[..., j + 1:, :j] @ v[..., :, None])[..., 0]
            L[..., j + 1:, j] = col / d[..., None]
    Y = torch.empty_like(B)
    for i in range(n):
        Y[..., i, :] = B[..., i, :] - (L[..., i:i + 1, :i] @ Y[..., :i, :])[..., 0, :]
    X = torch.empty_like(B)
    Z = Y / D[..., :, None]
    for i in reversed(range(n)):
        X[..., i, :] = Z[..., i, :] - (L[..., i + 1:, i:i + 1].transpose(-1, -2)
                                       @ X[..., i + 1:, :])[..., 0, :]
    return X


def _jacobi(A: torch.Tensor, eps: float):
    """(D^-1/2 A D^-1/2, D^-1/2) with D = diag(A) clipped below at eps."""
    d = torch.sqrt(torch.clamp(torch.diagonal(A, dim1=-2, dim2=-1), min=eps))
    Dinv = 1.0 / d
    return A * Dinv[..., :, None] * Dinv[..., None, :], Dinv


# The scaled solves run in float64 and round to float32 once. In float32
# the scaling alone perturbs a cond ~1e6 system by ~cond * eps (the
# reference's solves lose 1e-3 to 8e-3 of the solution there); a 24x24
# float64 system costs the card nothing that shows.


def inv_psd_scaled(A: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """Symmetric-Jacobi-scaled inverse of an SPD matrix, D inv(DAD) D
    with D = diag(A)^-1/2 (the IEKF's information matrices mix ~1e8
    measurement blocks with ~1e2 prior blocks). The reference inverts
    the scaled matrix by LU; here the column-wise LDL^T solves it against
    the identity, which needs no cuSOLVER call and so no host sync."""
    As, Dinv = _jacobi(A.double(), eps)
    eye = torch.eye(A.shape[-1], dtype=As.dtype, device=A.device).expand(As.shape)
    return (_ldl_solve(As, eye) * Dinv[..., :, None] * Dinv[..., None, :]).to(A.dtype)


def solve_psd_scaled(A: torch.Tensor, b: torch.Tensor, eps: float = 1e-20) -> torch.Tensor:
    """`solve_psd` with the same symmetric Jacobi scaling, by the
    column-wise LDL^T (the reference unrolls its 24x24 solve)."""
    As, Dinv = _jacobi(A.double(), eps)
    return (_ldl_solve(As, (b.double() * Dinv)[..., None])[..., 0] * Dinv).to(A.dtype)
