"""Batched SE(3) poses as an (R, t) NamedTuple (port of
`mr_slam_tpu/geometry/se3.py`, every function of it). Every op
broadcasts over leading dims."""
from __future__ import annotations

from typing import NamedTuple

import torch

from . import so3


class Pose(NamedTuple):
    """Rigid transform: x_world = R @ x_local + t.

    R: (..., 3, 3) rotation, t: (..., 3) translation.
    """

    R: torch.Tensor
    t: torch.Tensor

    @property
    def batch_shape(self):
        return self.t.shape[:-1]

    def to(self, device) -> "Pose":
        return Pose(self.R.to(device), self.t.to(device))

    def matrix(self) -> torch.Tensor:
        """(..., 4, 4) homogeneous matrix."""
        top = torch.cat([self.R, self.t[..., :, None]], dim=-1)
        bottom = torch.zeros_like(top[..., :1, :])
        bottom[..., 0, 3] = 1.0
        return torch.cat([top, bottom], dim=-2)


def identity(batch_shape=(), dtype=torch.float32, device=None) -> Pose:
    R = torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3).clone()
    t = torch.zeros((*batch_shape, 3), dtype=dtype, device=device)
    return Pose(R, t)


def from_matrix(T: torch.Tensor) -> Pose:
    """(..., 4, 4) homogeneous matrix -> Pose."""
    return Pose(T[..., :3, :3], T[..., :3, 3])


def from_rt(R: torch.Tensor, t: torch.Tensor) -> Pose:
    return Pose(R, t)


def from_quat_trans(q: torch.Tensor, t: torch.Tensor) -> Pose:
    """q = (..., 4) [w, x, y, z]."""
    return Pose(so3.quat_to_rot(q), t)


def from_xyzrpy(v: torch.Tensor) -> Pose:
    """(..., 6) [x, y, z, roll, pitch, yaw], the reference's
    PointTypePose layout."""
    return Pose(so3.rpy_to_rot(v[..., 3:6]), v[..., 0:3])


def _mv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) @ (..., 3) -> (..., 3)."""
    return (R @ v[..., None])[..., 0]


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b (apply b first, then a)."""
    return Pose(a.R @ b.R, _mv(a.R, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    Rt = p.R.transpose(-1, -2)
    return Pose(Rt, -_mv(Rt, p.t))


def between(a: Pose, b: Pose) -> Pose:
    """a^{-1} ∘ b — gtsam's `Pose3::between`."""
    return compose(inverse(a), b)


def apply(p: Pose, xyz: torch.Tensor) -> torch.Tensor:
    """Transform points (..., N, 3) by pose (..., 3, 3)/(..., 3)."""
    return xyz @ p.R.transpose(-1, -2) + p.t[..., None, :]


def exp(xi: torch.Tensor) -> Pose:
    """se(3) exponential. xi = (..., 6) [rho, phi]; the translation uses
    the left Jacobian."""
    rho, phi = xi[..., 0:3], xi[..., 3:6]
    R = so3.exp(phi)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-12))
    small = theta2 < 1e-8
    W = so3.hat(phi)
    b = torch.where(small, 0.5 - theta2 / 24.0, (1.0 - torch.cos(theta)) / theta2)
    c = torch.where(
        small, 1.0 / 6.0 - theta2 / 120.0,
        (theta - torch.sin(theta)) / (theta2 * theta),
    )
    eye = torch.eye(3, dtype=xi.dtype, device=xi.device).expand(R.shape)
    V = eye + b[..., None, None] * W + c[..., None, None] * (W @ W)
    return Pose(R, _mv(V, rho))


def log(p: Pose) -> torch.Tensor:
    """SE(3) logarithm -> (..., 6) [rho, phi]."""
    phi = so3.log(p.R)
    theta2 = torch.sum(phi * phi, dim=-1)
    theta = torch.sqrt(torch.clamp(theta2, min=1e-12))
    small = theta2 < 1e-8
    W = so3.hat(phi)
    half_t = theta * 0.5
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half_t * torch.cos(half_t) / torch.clamp(torch.sin(half_t), min=1e-12))
        / torch.clamp(theta2, min=1e-12),
    )
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device).expand(W.shape)
    Vinv = eye - 0.5 * W + cot_term[..., None, None] * (W @ W)
    return torch.cat([_mv(Vinv, p.t), phi], dim=-1)


def interpolate(a: Pose, b: Pose, alpha: torch.Tensor) -> Pose:
    """Geodesic interpolation a * exp(alpha * log(a^-1 b)); alpha has
    the poses' batch shape."""
    d = log(between(a, b))
    return compose(a, exp(alpha[..., None] * d))


def normalize(p: Pose) -> Pose:
    """Re-orthonormalize rotation (drift control in long compositions)."""
    return Pose(so3.project(p.R), p.t)


def stack(poses: list[Pose]) -> Pose:
    return Pose(
        torch.stack([p.R for p in poses], dim=0),
        torch.stack([p.t for p in poses], dim=0),
    )


def index(p: Pose, i) -> Pose:
    return Pose(p.R[i], p.t[i])


def yaw_rot(yaw: torch.Tensor) -> torch.Tensor:
    """(...,) yaw -> (..., 3, 3) rotation about z (see `so3.yaw_rot`)."""
    return so3.yaw_rot(yaw)
