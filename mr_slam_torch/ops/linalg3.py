"""Closed-form batched 3x3 symmetric linear algebra (port of
`mr_slam_tpu/ops/linalg3.py`).

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
