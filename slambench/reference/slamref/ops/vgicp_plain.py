"""VGICP Gauss-Newton accumulation: the hand-written Hopper kernel, its
wrapper, and its plain PyTorch twin.

Replaces the TPU kernel `mr_slam_tpu/ops/pallas_vgicp.py::_accum_kernel`
(`pallas_call` at `pallas_vgicp.py:269`), extended to the production
contract of `mr_slam_tpu/ops/registration.py::_gn_terms_from_rows`. The
reference kept its Pallas kernel off the production path only because
the TPU toolchain had no in-kernel dynamic gather; the card has one, so
here the kernel IS the registration accumulation: every inner GN step of
`registration._vgicp_direct1` (and so every loop-verify step) runs it.

Kernel: `mr_slam_torch/csrc/vgicp_accum.cu`, CUDA C++ for sm_90a, built
by `cuda_build` at first use and bound with ctypes. One launch per call:
each batch item is one thread-block cluster (`launch_shape`), each
thread walks its points with the voxel-row gather software-pipelined in
registers, and the 29 sums are reduced by warp shuffles, shared memory
and, across the cluster, by CTA rank 0 reading the other CTAs' sums
through distributed shared memory in rank order — no float atomics and
no second pass, so reruns are bit-identical. Two modes:

  hash mode  (`leaf` given) — the `_accum_kernel` / `gn_accumulate_batch`
             contract: floor(x / leaf), lowbias32 % H and the coordinate
             check in the kernel;
  slot mode  (`slot`, `found` given) — the cached-correspondence inner
             step of `_vgicp_direct1`: slot and found come from
             `voxel_grid.lookup_slots` at the start of an association
             round; the table does not change during registration, so
             `table[slot]` is exactly the cached row.

Both take an optional linearization `center` (B, 3) and an optional
`pose` (R (B, 3, 3), t (B, 3)): with a pose the kernel transforms each
point itself, x' = ((R00 x + R01 y) + R02 z) + t0 (and likewise for the
other rows); without one the points are taken as already transformed.

What bounds it: the bytes. At the main path's shapes (B = 8 verify
candidates x N = 16384 points) a call must read 18 B per point (point
12, mask 1, slot 4, found 1), 64 B per distinct row the found points
reference and the pose: a few MB, about a microsecond at HBM rate — less
than a launch. Hence one launch per call, the pose inside, no partial
buffer, and a wrapper that does no more host work than it must.

Numerics: the kernel is compiled with --fmad=false and evaluates the
transform and the per-point terms in the same order as the plain twin,
so the transformed points, `found`, the gates and the inlier count agree
exactly; only the order of the sums over points differs (tolerances in
the tests and `chip_smoke.py`). A point that needs no row (masked out,
or not found) adds zeros in both.

On a CPU tensor the wrapper runs the plain twin; on a CUDA tensor it
launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations


import torch

from ..devconst import const
from ..geometry.se3 import Pose
from . import voxel_grid

_TRI = [  # (row, col) order of the 21 upper-triangle integrands
    (0, 0), (0, 1), (0, 2), (0, 3), (0, 4), (0, 5),
    (1, 1), (1, 2), (1, 3), (1, 4), (1, 5),
    (2, 2), (2, 3), (2, 4), (2, 5),
    (3, 3), (3, 4), (3, 5),
    (4, 4), (4, 5),
    (5, 5),
]
_N_OUT = 44  # H (36, both triangles), b (6), cost, inliers



# --------------------------------------------------------------------------
# plain PyTorch twin
# --------------------------------------------------------------------------


def _terms_from_rows(tp, mask, rows, found, max_corr2, eps, center):
    """(B, N) per-point integrands summed over points -> H, b, cost, n.
    The arithmetic of `registration._gn_terms_from_rows`, batched."""
    xr, yr, zr = tp[..., 0], tp[..., 1], tp[..., 2]
    if center is None:
        x, y, z = xr, yr, zr
    else:
        x = xr - center[:, 0:1]
        y = yr - center[:, 1:2]
        z = zr - center[:, 2:3]
    mu0, mu1, mu2 = rows[..., 4], rows[..., 5], rows[..., 6]
    cxx = rows[..., 7] + eps
    cyy = rows[..., 8] + eps
    czz = rows[..., 9] + eps
    cxy, cxz, cyz = rows[..., 10], rows[..., 11], rows[..., 12]

    r0, r1, r2 = mu0 - xr, mu1 - yr, mu2 - zr
    d2 = r0 * r0 + r1 * r1 + r2 * r2
    w = (found & mask & (d2 < max_corr2)).to(torch.float32)

    a00 = cyy * czz - cyz * cyz
    a01 = cxz * cyz - cxy * czz
    a02 = cxy * cyz - cxz * cyy
    a11 = cxx * czz - cxz * cxz
    a12 = cxy * cxz - cxx * cyz
    a22 = cxx * cyy - cxy * cxy
    det = cxx * a00 + cxy * a01 + cxz * a02
    det_floor = torch.clamp(1e-5 * cxx * cyy * czz, min=1e-12)
    w = w * (det > det_floor).to(torch.float32)
    inv_det = w / torch.clamp(det, min=1e-30)
    w00, w01, w02 = a00 * inv_det, a01 * inv_det, a02 * inv_det
    w11, w12, w22 = a11 * inv_det, a12 * inv_det, a22 * inv_det

    u0 = w00 * r0 + w01 * r1 + w02 * r2
    u1 = w01 * r0 + w11 * r1 + w12 * r2
    u2 = w02 * r0 + w12 * r1 + w22 * r2

    D00 = z * w01 - y * w02
    D10 = z * w11 - y * w12
    D20 = z * w12 - y * w22
    D01 = -z * w00 + x * w02
    D11 = -z * w01 + x * w12
    D21 = -z * w02 + x * w22
    D02 = y * w00 - x * w01
    D12 = y * w01 - x * w11
    D22 = y * w02 - x * w12
    E00 = z * D10 - y * D20
    E01 = z * D11 - y * D21
    E02 = z * D12 - y * D22
    E11 = -z * D01 + x * D21
    E12 = -z * D02 + x * D22
    E22 = y * D02 - x * D12

    terms = torch.stack(
        [
            w00, w01, w02, -D00, -D01, -D02,
            w11, w12, -D10, -D11, -D12,
            w22, -D20, -D21, -D22,
            E00, E01, E02,
            E11, E12,
            E22,
            u0, u1, u2,
            y * u2 - z * u1, z * u0 - x * u2, x * u1 - y * u0,
            r0 * u0 + r1 * u1 + r2 * u2, w,
        ],
        dim=1,
    )  # (B, 29, N)
    return _assemble(torch.sum(terms, dim=-1))


def _assemble(acc: torch.Tensor):
    """(B, 29) sums -> (H (B, 6, 6), b (B, 6), cost (B,), inliers (B,))."""
    B = acc.shape[0]
    H = torch.zeros((B, 6, 6), dtype=acc.dtype, device=acc.device)
    rows = const(tuple(r for r, _ in _TRI), acc.device, torch.int64)
    cols = const(tuple(c for _, c in _TRI), acc.device, torch.int64)
    H[:, rows, cols] = acc[:, :21]
    H[:, cols, rows] = acc[:, :21]
    return H, acc[:, 21:27], acc[:, 27], acc[:, 28]


def transform_plain(pose: Pose, xyz: torch.Tensor) -> torch.Tensor:
    """x' = R p + t for xyz (B, N, 3), element by element in the kernel's
    order, ((R00 x + R01 y) + R02 z) + t0, so that on the card the
    transformed points are the kernel's bit for bit."""
    R, t = pose.R, pose.t
    x, y, z = xyz[..., 0], xyz[..., 1], xyz[..., 2]
    rows = [
        ((R[:, k, 0, None] * x + R[:, k, 1, None] * y) + R[:, k, 2, None] * z) + t[:, k, None]
        for k in range(3)
    ]
    return torch.stack(rows, dim=-1)


def gn_accumulate_plain(
    xyz, mask, table, leaf=None, slot=None, found=None,
    eps: float = 1e-6, max_corr2: float = 1.0, center=None, pose=None,
):
    """The plain PyTorch version of the kernel (both modes, with or
    without a pose): the CPU path, and the oracle the kernel is held to
    on the card."""
    _check_args(xyz, mask, table, leaf, slot, found, center, pose)
    tp = xyz if pose is None else transform_plain(pose, xyz)
    if slot is None:
        slot, found = voxel_grid.lookup_slots(voxel_grid.VoxelGrid(table, leaf), tp)
    rows = voxel_grid._gather_rows(table, slot.to(torch.int64)[..., None])[..., 0, :]
    rows = torch.where((mask & found)[..., None], rows, 0.0)  # the kernel reads no other row
    return _terms_from_rows(tp, mask, rows, found, max_corr2, eps, center)


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------


def _check_args(xyz, mask, table, leaf, slot, found, center, pose):
    """Shapes, types and devices; reads nothing back from the device."""
    if xyz.dim() != 3 or xyz.shape[-1] != 3 or xyz.dtype != torch.float32:
        raise ValueError(f"xyz must be (B, N, 3) float32, got {tuple(xyz.shape)} {xyz.dtype}")
    B, N = xyz.shape[:2]
    if mask.shape != (B, N) or mask.dtype != torch.bool:
        raise ValueError(f"mask must be ({B}, {N}) bool, got {tuple(mask.shape)} {mask.dtype}")
    if table.dim() != 3 or table.shape[0] != B or table.shape[-1] != 16 \
            or table.dtype != torch.float32:
        raise ValueError(f"table must be ({B}, H, 16) float32, got {tuple(table.shape)}")
    if (slot is None) == (leaf is None):
        raise ValueError("give either leaf (hash mode) or slot and found (slot mode)")
    if slot is not None:
        if found is None or slot.shape != (B, N) or found.shape != (B, N) \
                or found.dtype != torch.bool:
            raise ValueError("slot mode needs slot (B, N) and found (B, N) bool")
    if center is not None and (center.shape != (B, 3) or center.dtype != torch.float32):
        raise ValueError(f"center must be ({B}, 3) float32")
    if pose is not None and (pose.R.shape != (B, 3, 3) or pose.t.shape != (B, 3)
                             or pose.R.dtype != torch.float32 or pose.t.dtype != torch.float32):
        raise ValueError(f"pose must hold R ({B}, 3, 3) and t ({B}, 3) float32")
    tensors = [xyz, mask, table, slot, found, center]
    if pose is not None:
        tensors += [pose.R, pose.t]
    if any(t is not None and t.device != xyz.device for t in tensors):
        raise ValueError("all tensors must be on one device")
    return tensors




def gn_accumulate(xyz, mask, table, leaf=None, slot=None, found=None, eps: float = 1e-6,
                  max_corr2: float = 1.0, center=None, pose=None):
    """The accumulation on any device: `gn_accumulate_plain`."""
    return gn_accumulate_plain(xyz, mask, table, leaf, slot, found, eps, max_corr2, center, pose)
