"""Fused 5x5 terrain-feature stencil: the hand-written Hopper kernel, its
wrapper, and its plain PyTorch version.

Replaces the TPU kernel `mr_slam_tpu/ops/pallas_stencil.py::_kernel`
(`pallas_call` at `pallas_stencil.py:178`; called from `terrain_features`
:152, reached through `mapping/elevation.features_fused`). Per cell of
an (H, W) elevation grid, over its 5x5 window: the ten moment sums of
the valid cells, the closed-form plane fit -> slope and roughness, the
window max - min -> step, and the traversability blend.

Kernel: `mr_slam_torch/csrc/terrain_stencil.cu`, CUDA C++ for sm_90a,
built by `cuda_build` at first use and bound with ctypes. One launch of
a persistent grid: each block walks 32 x 32 tiles, with the next tile's
halo in flight (cp.async) while it computes the current one from shared
memory, and computes the window moments separably: 5-wide row sums of
the halo rows, then their u-weighted sums down each column (a thread
owns a strip of 4 cells); atan and the blend inside. It reads height and
valid once and writes the four layers once: 21 B per cell, its bound.
No atomics.

The plain version (`terrain_features_plain`, any odd window) is the
port of the reference's `elevation.features_xla` and the oracle the
kernel is held to; it takes the same separable sums in the same order
(`window_moments`), so the two agree bit for bit on the card. Both fit
the plane in window-local coordinates, not the reference's absolute
ones (see `mapping/elevation.py`): integer cell offsets (di, dj) about
the centre cell, scaled by the resolution only in the gradient, so the
xy moments are exact (`_closed_form`). At
the border, out-of-grid cells add nothing to the moments and are -inf
for the step's max, as in `features_xla` (the Pallas stripe pads with
z = 0 cells there instead, and is not followed).

On a CPU tensor the wrapper runs the plain version; on a CUDA tensor it
launches the kernel or raises — there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch
import torch.nn.functional as F

WINDOW = 5
_DET_FLOOR = float(np.float32(1e-9))

_launches = 0
_recorded = 0


def launch_count() -> int:
    """Kernel launches (one per `terrain_features` call on a CUDA tensor
    outside a CUDA-graph capture, plus those `add_launches` adds) since
    the last `reset_launch_count`."""
    return _launches


def recorded_count() -> int:
    """Calls made while their stream was capturing a CUDA graph, since
    the process started: a capture records the launch and runs nothing,
    so `launch_count` leaves them out."""
    return _recorded


def add_launches(n: int) -> None:
    """Count launches the wrapper did not make: a CUDA graph's replay
    runs the launches its capture recorded (`runtime/frame_graph.Segments`)."""
    global _launches
    _launches += n


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _inv(crit: float) -> float:
    """The float32 reciprocal of a critical value (exact as a Python
    float): the blend multiplies by it on every device."""
    return float(np.float32(1.0) / np.float32(crit))


# --------------------------------------------------------------------------
# plain PyTorch version
# --------------------------------------------------------------------------


def window_moments(height: torch.Tensor, valid: torch.Tensor, window: int = WINDOW):
    """The window sums of every cell, separably and in the kernel's
    order: row sums over the window's columns (w ascending) of the padded
    grid's rows, then their u-weighted sums over the window's rows (u
    ascending); a term whose weight is 0 is not added. Returns (S1, Su,
    Sw, Suu, Sww, Suw, Sz, Suz, Swz, Szz, zmax, zmin), each (H, W)
    float32; (u, w) are integer cell offsets, so the first six are exact
    integers. With z = 0 for invalid cells, v z = z and v z^2 = z^2."""
    H, W = height.shape
    p = window // 2
    v = valid.to(torch.float32)
    z = torch.where(valid, height, 0.0)
    pad = (p, p, p, p)
    vp = F.pad(v, pad)
    zp = F.pad(z, pad)
    zzp = zp * zp
    zmax_p = F.pad(z, pad, value=float("-inf"))
    zmin_p = F.pad(torch.where(valid, height, float("inf")), pad, value=float("inf"))

    # horizontal: the (H + 2p, W) row sums of every padded row
    A0 = A1 = A2 = Az = Awz = Azz = torch.zeros_like(vp[:, :W])
    mx = torch.full_like(A0, float("-inf"))
    mn = torch.full_like(A0, float("inf"))
    for w in range(-p, p + 1):
        cols = slice(p + w, p + w + W)
        vs, zs = vp[:, cols], zp[:, cols]
        A0 = A0 + vs
        if w:
            A1 = A1 + vs * float(w)
            A2 = A2 + vs * float(w * w)
        Az = Az + zs
        if w:
            Awz = Awz + zs * float(w)
        Azz = Azz + zzp[:, cols]
        mx = torch.maximum(mx, zmax_p[:, cols])
        mn = torch.minimum(mn, zmin_p[:, cols])

    # vertical: the window's rows, u-weighted
    S1 = Su = Sw = Suu = Sww = Suw = Sz = Suz = Swz = Szz = torch.zeros_like(z)
    zmax = torch.full_like(z, float("-inf"))
    zmin = torch.full_like(z, float("inf"))
    for u in range(-p, p + 1):
        rows = slice(p + u, p + u + H)
        S1 = S1 + A0[rows]
        if u:
            ua0 = A0[rows] * float(u)
            Su = Su + ua0
            Suu = Suu + ua0 * float(u)
            Suw = Suw + A1[rows] * float(u)
            Suz = Suz + Az[rows] * float(u)
        Sw = Sw + A1[rows]
        Sww = Sww + A2[rows]
        Sz = Sz + Az[rows]
        Swz = Swz + Awz[rows]
        Szz = Szz + Azz[rows]
        zmax = torch.maximum(zmax, mx[rows])
        zmin = torch.minimum(zmin, mn[rows])
    return S1, Su, Sw, Suu, Sww, Suw, Sz, Suz, Swz, Szz, zmax, zmin


def terrain_features_plain(
    height: torch.Tensor,
    valid: torch.Tensor,
    resolution,
    window: int = WINDOW,
    slope_crit: float = 0.6,
    rough_crit: float = 0.15,
    step_crit: float = 0.3,
):
    """(slope, roughness, step, traversability), each (H, W) float32.

    The window sums of `window_moments` (separable, in the kernel's
    order), then the closed form below, operation for operation as the
    kernel does it."""
    res = torch.as_tensor(resolution, dtype=torch.float32, device=height.device)
    return _closed_form(*window_moments(height, valid, window), valid, res,
                        slope_crit, rough_crit, step_crit)


def _closed_form(S1, Su, Sw, Suu, Sww, Suw, Sz, Suz, Swz, Szz, zmax, zmin, valid, res,
                 slope_crit, rough_crit, step_crit):
    """Plane fit from window sums in cell offsets (u, w) = (di, dj).

    With n-scaled central moments C = n * S_ab - S_a * S_b, the xy part
    (Cuu, Cww, Cuw and D = Cuu * Cww - Cuw^2) is integer-valued and exact
    in float32, so a window whose valid cells are collinear has D == 0
    exactly and a zero plane gradient, as in exact arithmetic. The
    reference's floor |det| < 1e-9 m^4 on det = D * res^4 / n^4 becomes
    a floor on D. Gradient a = (Cww * Cuz - Cuw * Cwz) / (D * res), b
    likewise; residual variance (Czz - (a Cuz + b Cwz) res) / n^2."""
    n = torch.clamp(S1, min=1.0)
    Cuu = n * Suu - Su * Su
    Cww = n * Sww - Sw * Sw
    Cuw = n * Suw - Su * Sw
    Cuz = n * Suz - Su * Sz
    Cwz = n * Swz - Sw * Sz
    Czz = n * Szz - Sz * Sz
    D = Cuu * Cww - Cuw * Cuw
    n2 = n * n
    r2 = res * res
    r4 = r2 * r2
    floor = n2 * n2 * _DET_FLOOR
    D_eff = torch.where(torch.abs(D) * r4 < floor, floor / r4, D)
    ac = (Cww * Cuz - Cuw * Cwz) / D_eff
    bc = (Cuu * Cwz - Cuw * Cuz) / D_eff
    a = ac / res
    b = bc / res
    slope = torch.atan(torch.sqrt(a * a + b * b))
    rough = torch.sqrt(torch.clamp((Czz - (ac * Cuz + bc * Cwz)) / n2, min=0.0))
    step = torch.where(torch.isfinite(zmin), zmax - zmin, 0.0)
    enough = S1 >= 3.0
    trav = 1.0 - torch.maximum(
        torch.maximum(slope * _inv(slope_crit), rough * _inv(rough_crit)),
        step * _inv(step_crit),
    )
    trav = torch.clamp(trav, 0.0, 1.0)
    trav = torch.where(enough & valid, trav, 0.5)
    return (
        torch.where(enough, slope, 0.0),
        torch.where(enough, rough, 0.0),
        step,
        trav,
    )


# --------------------------------------------------------------------------
# the kernel
# --------------------------------------------------------------------------


@functools.cache
def _lib() -> ctypes.CDLL:
    from . import cuda_build

    lib = cuda_build.load("terrain_stencil")
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.terrain_stencil_launch.argtypes = [p, p, p, i, i, i, f, f, f, p, p]
    lib.terrain_stencil_launch.restype = i
    return lib


def _check_args(height, valid, resolution):
    if height.dim() != 2 or height.dtype != torch.float32:
        raise ValueError(f"height must be (H, W) float32, got {tuple(height.shape)} {height.dtype}")
    if valid.shape != height.shape or valid.dtype != torch.bool:
        raise ValueError(f"valid must be {tuple(height.shape)} bool, got "
                         f"{tuple(valid.shape)} {valid.dtype}")
    if valid.device != height.device:
        raise ValueError("height and valid must be on one device")
    if isinstance(resolution, torch.Tensor) and resolution.numel() != 1:
        raise ValueError("resolution must be a scalar")


def terrain_features(
    height: torch.Tensor,
    valid: torch.Tensor,
    resolution,
    slope_crit: float = 0.6,
    rough_crit: float = 0.15,
    step_crit: float = 0.3,
):
    """The 5x5 stencil: height (H, W) float32, valid (H, W) bool,
    resolution a scalar (a 0-d float32 tensor on the grid's device is
    read there as it is, without a copy or a host sync). Returns (slope,
    roughness, step, traversability), each (H, W) float32, views of one
    (4, H, W) tensor.

    CPU tensors run `terrain_features_plain`; CUDA tensors launch the
    kernel (raising on any fault); other devices raise."""
    global _launches, _recorded
    _check_args(height, valid, resolution)
    crit = dict(slope_crit=slope_crit, rough_crit=rough_crit, step_crit=step_crit)
    if height.device.type == "cpu":
        return terrain_features_plain(height, valid, resolution, WINDOW, **crit)
    if height.device.type != "cuda":
        raise ValueError(f"terrain_features runs on cpu or cuda, not {height.device}")
    if not (height.is_contiguous() and valid.is_contiguous()):
        raise ValueError("terrain_features needs contiguous height and valid")
    dev = height.device
    res = resolution
    if not (isinstance(res, torch.Tensor) and res.dim() == 0 and res.dtype == torch.float32
            and res.device == dev):
        res = torch.as_tensor(resolution, dtype=torch.float32, device=dev).reshape(())
    H, W = height.shape
    if H > 65535 * 32:
        raise ValueError("more rows than the kernel grid holds")
    # interior rows take 16-byte height / 4-byte valid loads
    aligned = int(W % 4 == 0 and height.data_ptr() % 16 == 0 and valid.data_ptr() % 4 == 0)
    out = torch.empty((4, H, W), dtype=torch.float32, device=dev)
    args = (height.data_ptr(), valid.data_ptr(), res.data_ptr(), H, W, aligned,
            _inv(slope_crit), _inv(rough_crit), _inv(step_crit), out.data_ptr())
    if dev.index == torch.cuda.current_device():
        err = _lib().terrain_stencil_launch(*args, torch._C._cuda_getCurrentRawStream(dev.index))
        capturing = torch.cuda.is_current_stream_capturing()
    else:
        with torch.cuda.device(dev):
            err = _lib().terrain_stencil_launch(*args,
                                                torch._C._cuda_getCurrentRawStream(dev.index))
            capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"terrain_stencil launch failed: CUDA error {err}")
    if capturing:  # recorded into a graph: each replay launches it
        _recorded += 1
    else:
        _launches += 1
    return out[0], out[1], out[2], out[3]
