"""Batched SO(3) operations (port of `mr_slam_tpu/geometry/so3.py`).

Every function broadcasts over leading batch dimensions and works in
float32 on the device of its input.
"""
from __future__ import annotations

import torch

from ..ops import linalg3

_EPS = 1e-8


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    return torch.stack(
        [
            torch.stack([zeros, -wz, wy], dim=-1),
            torch.stack([wz, zeros, -wx], dim=-1),
            torch.stack([-wy, wx, zeros], dim=-1),
        ],
        dim=-2,
    )


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew -> (..., 3)."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], dim=-1)


def _eye_like(M: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=M.dtype, device=M.device).expand(M.shape)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues' formula, (..., 3) axis-angle -> (..., 3, 3) rotation,
    with Taylor fallbacks of sin(t)/t and (1-cos t)/t^2 near zero."""
    theta2 = torch.sum(w * w, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=_EPS))
    small = theta2 < 1e-8
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) rotation -> (..., 3) axis-angle. Safe near 0 and pi."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    cos_t = torch.clamp((trace - 1.0) * 0.5, -1.0, 1.0)
    theta = torch.arccos(cos_t)
    sin_t = torch.sin(theta)
    generic_scale = torch.where(
        sin_t < 1e-5,
        0.5 + theta * theta / 12.0,
        theta / torch.clamp(2.0 * sin_t, min=_EPS),
    )
    w_generic = generic_scale[..., None] * vee(R - R.transpose(-1, -2))
    # Near pi the antisymmetric part vanishes; use R ~= 2 a a^T - I:
    # dominant diagonal k, a_k = sqrt((R_kk + 1)/2),
    # a_j = (R_kj + R_jk) / (4 a_k). The overall sign is arbitrary at pi.
    diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
    dmax, k = torch.max(diag, dim=-1)
    sym = R + R.transpose(-1, -2)
    a_k = torch.sqrt(torch.clamp((dmax + 1.0) * 0.5, min=_EPS))
    row_k = torch.gather(
        sym, -2, k[..., None, None].expand(*k.shape, 1, 3)
    )[..., 0, :]
    axis = row_k / (4.0 * a_k[..., None])
    onehot = torch.nn.functional.one_hot(k, 3).bool()
    axis = torch.where(onehot, a_k[..., None], axis)
    axis = axis / torch.clamp(torch.linalg.norm(axis, dim=-1, keepdim=True), min=_EPS)
    w_pi = axis * theta[..., None]
    near_pi = cos_t < -1.0 + 1e-5
    return torch.where(near_pi[..., None], w_pi, w_generic)


def project(R: torch.Tensor) -> torch.Tensor:
    """Project (..., 3, 3) matrices onto SO(3) via SVD (chordal
    projection, `evaluation_utils.cpp:217-331` in the reference)."""
    U, _, Vt = torch.linalg.svd(R)
    det = linalg3.det3(U @ Vt)
    ones = torch.ones_like(det)
    D = torch.stack([ones, ones, det], dim=-1)
    return (U * D[..., None, :]) @ Vt


def quat_to_rot(q: torch.Tensor) -> torch.Tensor:
    """(..., 4) quaternion [w, x, y, z] -> (..., 3, 3)."""
    q = q / torch.clamp(torch.linalg.norm(q, dim=-1, keepdim=True), min=_EPS)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack(
        [
            torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)], dim=-1),
            torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)], dim=-1),
            torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)], dim=-1),
        ],
        dim=-2,
    )


def rot_to_quat(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 4) [w, x, y, z], branch-free (Shepperd): all
    four constructions, then the one whose pivot (trace or a diagonal
    entry) is largest; the sign makes w >= 0."""
    m00, m01, m02 = R[..., 0, 0], R[..., 0, 1], R[..., 0, 2]
    m10, m11, m12 = R[..., 1, 0], R[..., 1, 1], R[..., 1, 2]
    m20, m21, m22 = R[..., 2, 0], R[..., 2, 1], R[..., 2, 2]
    tr = m00 + m11 + m22
    qw = torch.stack(
        [1.0 + tr, 1.0 + m00 - m11 - m22, 1.0 - m00 + m11 - m22, 1.0 - m00 - m11 + m22],
        dim=-1,
    )
    qw = torch.sqrt(torch.clamp(qw, min=_EPS)) * 0.5
    # argmax keeps the first of equal pivots, as jnp.argmax does
    case = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    w0, x1, y2, z3 = qw[..., 0], qw[..., 1], qw[..., 2], qw[..., 3]
    qs = torch.stack(
        [
            torch.stack([w0, (m21 - m12) / (4 * w0), (m02 - m20) / (4 * w0), (m10 - m01) / (4 * w0)],
                        dim=-1),
            torch.stack([(m21 - m12) / (4 * x1), x1, (m01 + m10) / (4 * x1), (m02 + m20) / (4 * x1)],
                        dim=-1),
            torch.stack([(m02 - m20) / (4 * y2), (m01 + m10) / (4 * y2), y2, (m12 + m21) / (4 * y2)],
                        dim=-1),
            torch.stack([(m10 - m01) / (4 * z3), (m02 + m20) / (4 * z3), (m12 + m21) / (4 * z3), z3],
                        dim=-1),
        ],
        dim=-2,
    )
    q = torch.gather(qs, -2, case[..., None, None].expand(*case.shape, 1, 4))[..., 0, :]
    return q * torch.where(q[..., :1] < 0, -1.0, 1.0)


def rpy_to_rot(rpy: torch.Tensor) -> torch.Tensor:
    """(..., 3) roll/pitch/yaw (ZYX convention) -> rotation matrix."""
    r, p, y = rpy[..., 0], rpy[..., 1], rpy[..., 2]
    cr, sr = torch.cos(r), torch.sin(r)
    cp, sp = torch.cos(p), torch.sin(p)
    cy, sy = torch.cos(y), torch.sin(y)
    return torch.stack(
        [
            torch.stack([cy * cp, cy * sp * sr - sy * cr, cy * sp * cr + sy * sr], dim=-1),
            torch.stack([sy * cp, sy * sp * sr + cy * cr, sy * sp * cr - cy * sr], dim=-1),
            torch.stack([-sp, cp * sr, cp * cr], dim=-1),
        ],
        dim=-2,
    )


def rot_to_rpy(R: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) -> (..., 3) roll/pitch/yaw (ZYX)."""
    sy = torch.sqrt(R[..., 0, 0] ** 2 + R[..., 1, 0] ** 2)
    roll = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    pitch = torch.atan2(-R[..., 2, 0], sy)
    yaw = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.stack([roll, pitch, yaw], dim=-1)


def yaw_rot(yaw: torch.Tensor) -> torch.Tensor:
    """(...,) yaw angle -> (..., 3, 3) rotation about z."""
    c, s = torch.cos(yaw), torch.sin(yaw)
    zeros = torch.zeros_like(c)
    ones = torch.ones_like(c)
    return torch.stack(
        [
            torch.stack([c, -s, zeros], dim=-1),
            torch.stack([s, c, zeros], dim=-1),
            torch.stack([zeros, zeros, ones], dim=-1),
        ],
        dim=-2,
    )
