"""RING / RING++ place recognition: Radon sinograms + FFT correlation
(port of `mr_slam_tpu/loop/ring.py`).

  * `radon` is the bilinear rotate-and-sum transform: the BEV resampled
    onto n_angles rotated grids and summed down one axis. It is the
    port's lowering on every device: the reference takes the gather-free
    `radon_mxu` on a TPU, which lacks in-kernel gathers, and a GPU
    gathers freely. `radon_mxu` is ported as well, off the path.
  * `radon_backproject` is the exact adjoint of `radon`, taken as
    PyTorch's vector-Jacobian product of the linear transform; `fbp`
    filters and backprojects.
  * `describe` / `describe_ringpp` give the sinogram (RING) and its
    row-FFT magnitude (TIRING, translation invariant), per channel for
    RING++.
  * `correlate` / `correlate_multichannel` are the circular
    cross-correlation over the angle axis, queries against a database.
    The reference inverse-transforms every (query, entry, column) product
    and then sums over columns (and channels); both steps are linear, so
    here the spectra are first contracted over columns and channels (one
    complex matmul per angle frequency) and one (Q, D, A) inverse FFT
    follows. The same sum in another order: scores agree to float
    rounding, and a shift can differ only where two angles score within
    that rounding of each other.
  * `se2_hypotheses` / `solve_translation`: both yaw hypotheses and their
    least-squares translations, for seeding loop verification.

Every function takes leading batch dimensions. Angle grids are the
reference's `jnp.linspace` values (`angles`).
"""
from __future__ import annotations

import functools
import math
from typing import NamedTuple

import numpy as np
import torch

# radon gathers four (n_angles, size, size) taps per image; images are
# taken this many at a time (16 x 120^3 f32 = 110 MiB per tap)
RADON_CHUNK = 16


def angles(n: int, stop: float = math.pi) -> np.ndarray:
    """float32 `jnp.linspace(0, stop, n, endpoint=False)` as the reference
    computes it: i * (f32(stop) * (1 / n)), its constants folded."""
    f = np.float32
    return np.arange(n, dtype=f) * (f(stop) * (f(1.0) / f(n)))


@functools.lru_cache(maxsize=None)
def _thetas(n: int, device: torch.device) -> torch.Tensor:
    """`angles(n)` on `device`, copied once per device (a copy from the
    host waits for the stream); read-only."""
    return torch.from_numpy(angles(n)).to(device)


@functools.lru_cache(maxsize=None)
def _taps(n_angles: int, size: int, device: torch.device):
    """The bilinear taps of every rotated grid: flat pixel index (4, A *
    size * size) and weight (4, A * size * size), the weight 0 where the
    tap falls outside the image. Cached per device; read-only."""
    thetas = torch.from_numpy(angles(n_angles))
    c = (size - 1) / 2.0
    u = torch.arange(size, dtype=torch.float32) - c
    Y, X = torch.meshgrid(u, u, indexing="ij")
    cos, sin = torch.cos(thetas)[:, None, None], torch.sin(thetas)[:, None, None]
    xr = cos * X - sin * Y + c
    yr = sin * X + cos * Y + c
    x0 = torch.floor(xr).to(torch.int64)
    y0 = torch.floor(yr).to(torch.int64)
    dx, dy = xr - x0, yr - y0
    idx, wts = [], []
    for xi, yi, wt in ((x0, y0, (1 - dx) * (1 - dy)), (x0 + 1, y0, dx * (1 - dy)),
                       (x0, y0 + 1, (1 - dx) * dy), (x0 + 1, y0 + 1, dx * dy)):
        inb = (xi >= 0) & (xi < size) & (yi >= 0) & (yi < size)
        idx.append((torch.clamp(yi, 0, size - 1) * size + torch.clamp(xi, 0, size - 1)).reshape(-1))
        wts.append(torch.where(inb, wt, 0.0).reshape(-1))
    return torch.stack(idx).to(device), torch.stack(wts).to(device)


def _radon_chunk(img: torch.Tensor, n_angles: int) -> torch.Tensor:
    B, H, W = img.shape
    idx, wts = _taps(n_angles, W, img.device)
    flat = img.reshape(B, H * W)
    rot = flat[:, idx[0]] * wts[0]
    for t in range(1, 4):
        rot = rot + flat[:, idx[t]] * wts[t]
    return torch.sum(rot.reshape(B, n_angles, W, W), dim=-2)


def radon(bev: torch.Tensor, n_angles: int = 120) -> torch.Tensor:
    """Parallel-beam Radon transform (..., H, W) -> sinograms (...,
    n_angles, W): row theta sums the image rotated by theta down its
    column axis (bilinear samples, zero outside)."""
    batch = bev.shape[:-2]
    H, W = bev.shape[-2:]
    img = bev.reshape(-1, H, W)
    out = torch.cat([_radon_chunk(img[s:s + RADON_CHUNK], n_angles)
                     for s in range(0, img.shape[0], RADON_CHUNK)])
    return out.reshape(*batch, n_angles, W)


def radon_mxu(bev: torch.Tensor, n_angles: int = 120, upsize: int = 256) -> torch.Tensor:
    """The reference's gather-free Radon (its TPU lowering): the x-term of
    rho = (x - c) cos(theta) + (y - c) sin(theta) splatted with a linear
    kernel by one matmul per angle, the y-term applied as per-row FFT
    phase shifts, summed over rows. (..., H, W) -> (..., n_angles, W).
    Matches `radon` up to the splat-vs-gather interpolation kernel.
    `upsize` must exceed W + max|shift| (2W for a centred BEV)."""
    H, W = bev.shape[-2:]
    dev = bev.device
    thetas = _thetas(n_angles, dev)
    c, cy, cu = (W - 1) / 2.0, (H - 1) / 2.0, (upsize - 1) / 2.0
    x = torch.arange(W, dtype=torch.float32, device=dev) - c
    u = torch.arange(upsize, dtype=torch.float32, device=dev) - cu
    a = x[None, :, None] * torch.cos(thetas)[:, None, None]          # (A, W, 1)
    Cx = torch.clamp(1.0 - torch.abs(a - u[None, None, :]), min=0.0)  # (A, W, U)
    T = torch.einsum("...yx,axu->...ayu", bev, Cx)                  # (..., A, H, U)
    F = torch.fft.rfft(T, dim=-1)                                    # (..., A, H, K)
    y = torch.arange(H, dtype=torch.float32, device=dev) - cy
    b = y[None, :] * torch.sin(thetas)[:, None]                      # (A, H)
    k = torch.arange(F.shape[-1], dtype=torch.float32, device=dev)
    phase = torch.exp(-2j * math.pi * b[..., None] * k / upsize)
    G = torch.sum(F * phase, dim=-2)                                 # (..., A, K)
    full = torch.fft.irfft(G, n=upsize, dim=-1)                      # (..., A, U)
    lo = int(round(cu - c))
    return full[..., lo:lo + W]


def radon_backproject(sino: torch.Tensor, size: int) -> torch.Tensor:
    """The exact adjoint of `radon`: <radon(x), y> == <x,
    backproject(y)>, as PyTorch's vector-Jacobian product of the linear
    transform (the gather's transpose, a scatter-add). (..., A, W) ->
    (..., size, size)."""
    A = sino.shape[-2]
    zero = sino.new_zeros((*sino.shape[:-2], size, size))
    _, vjp = torch.func.vjp(lambda img: radon(img, n_angles=A), zero)
    return vjp(sino)[0]


def fbp(sino: torch.Tensor, size: int) -> torch.Tensor:
    """Filtered backprojection: Ram-Lak ramp along rho (in the frequency
    domain on a 2W zero-padded row), then `radon_backproject`, scaled by
    pi / (2 n_angles)."""
    A, W = sino.shape[-2:]
    n = 2 * W
    ramp = 2.0 * torch.abs(torch.fft.rfftfreq(n, device=sino.device))
    F = torch.fft.rfft(sino, n=n, dim=-1)
    filtered = torch.fft.irfft(F * ramp, n=n, dim=-1)[..., :W]
    return radon_backproject(filtered, size) * (math.pi / (2.0 * A))


def _unit(s: torch.Tensor, dims) -> torch.Tensor:
    return s / torch.clamp(torch.sqrt(torch.sum(s * s, dim=dims, keepdim=True)), min=1e-9)


class RingDescriptor(NamedTuple):
    sinogram: torch.Tensor  # (..., n_angles, W) RING
    tiring: torch.Tensor    # (..., n_angles, W) |FFT_row| — translation invariant


def describe(bev: torch.Tensor, n_angles: int = 120, channels: bool = False) -> RingDescriptor:
    """BEVs (..., H, W) -> RING + TIRING. `channels=True` reads the last
    three dims as (C, H, W) and averages the per-channel sinograms (the
    reference's 3-D input)."""
    sino = radon(bev, n_angles)
    if channels:
        sino = torch.mean(sino, dim=-3)
    sino = _unit(sino, (-2, -1))
    return RingDescriptor(sinogram=sino, tiring=torch.abs(torch.fft.fft(sino, dim=-1)))


class RingPPDescriptor(NamedTuple):
    sinograms: torch.Tensor  # (..., C, A, W) per-channel RING
    tirings: torch.Tensor    # (..., C, A, W) per-channel |FFT_row|


def describe_ringpp(feature_bev: torch.Tensor, n_angles: int = 120) -> RingPPDescriptor:
    """RING++: per-channel Radon of the eigen-feature BEVs (..., C, H, W)
    (`bev.eigen_feature_bev`), each channel normalized, per-channel row-FFT
    magnitudes. Matching sums correlation over channels."""
    sino = _unit(radon(feature_bev, n_angles), (-2, -1))
    return RingPPDescriptor(sinograms=sino, tirings=torch.abs(torch.fft.fft(sino, dim=-1)))


def _correlate(query: torch.Tensor, database: torch.Tensor, feat: int):
    """Shared body: the last `feat` dims (channels, angles, columns) are
    the descriptor, the angle axis is dim -2."""
    fq = torch.fft.fft(query, dim=-2)
    fd = torch.fft.fft(database, dim=-2)
    # sum over columns (and channels) before the inverse FFT over angles
    A = fq.shape[-2]
    lead = query.shape[:-feat]
    D = database.shape[0]
    q = fq.movedim(-2, 0).reshape(A, math.prod(lead), -1)           # (A, Q, F)
    d = fd.movedim(-2, 0).reshape(A, D, -1)                          # (A, D, F)
    spec = torch.conj(q) @ d.transpose(-1, -2)                       # (A, Q, D)
    score = torch.fft.ifft(spec.permute(1, 2, 0), dim=-1).real       # (Q, D, A)
    peak, shift = torch.max(score, dim=-1)
    dims = tuple(range(-feat, 0))
    qn = torch.sqrt(torch.sum(query * query, dim=dims)).reshape(-1, 1)
    dn = torch.sqrt(torch.sum(database * database, dim=dims))
    dist = 1.0 - peak / torch.clamp(qn * dn, min=1e-9)
    return dist.reshape(*lead, D), shift.reshape(*lead, D)


def correlate(query: torch.Tensor, database: torch.Tensor):
    """Circular cross-correlation over the angle axis between query
    TIRINGs (..., A, W) and a database (D, A, W). A relative yaw of phi
    shifts the rows by phi (mod pi), so the peak's index is the yaw up to
    the pi ambiguity. Returns (dist (..., D), shift (..., D)): dist =
    1 - peak / (|q| |d|), shift = the first best row offset."""
    return _correlate(query, database, 2)


def correlate_multichannel(query: torch.Tensor, database: torch.Tensor):
    """Multi-channel circular correlation: queries (..., C, A, W) against
    a database (D, C, A, W), scores summed over channels before the peak
    (`fast_corr_RINGplusplus`). Returns (dist (..., D), shift (..., D))."""
    return _correlate(query, database, 3)


def shift_to_yaw(shift: torch.Tensor, n_angles: int) -> torch.Tensor:
    """Row shift -> yaw radians (pi-periodic)."""
    return shift.to(torch.float32) * (math.pi / n_angles)


def _rows(sino: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """sino[..., idx[...], :] with idx (..., A)."""
    return torch.gather(sino, -2, idx[..., None].expand(*idx.shape, sino.shape[-1]))


def rotate_rows(sino: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Circularly shift sinogram rows (..., A, W) by `shift` (...,)."""
    A = sino.shape[-2]
    idx = (torch.arange(A, device=sino.device) + shift[..., None]) % A
    return _rows(sino, idx)


def align_sinogram(sino: torch.Tensor, shift: torch.Tensor) -> torch.Tensor:
    """Sinograms (..., A, W) of the underlying images rotated by yaw =
    shift * pi / A: rows shift by `shift`, and rows that wrap past
    [0, pi) flip their rho axis (R(theta + pi, rho) = R(theta, -rho))."""
    A = sino.shape[-2]
    raw = torch.arange(A, device=sino.device) - shift[..., None]
    rows = _rows(sino, raw % A)
    wrapped = (torch.div(raw, A, rounding_mode="floor") % 2) != 0
    return torch.where(wrapped[..., None], torch.flip(rows, dims=(-1,)), rows)


def se2_hypotheses(query_sino: torch.Tensor, cand_sino: torch.Tensor, shift: torch.Tensor,
                   bev_extent: float = 140.0):
    """Both yaw hypotheses with their translation solves (`main_RING.py:
    146-205` seeds GICP with (theta, t) and (theta - pi, t')). Hypothesis
    k maps query-frame points into candidate-frame points: p_cand =
    R(yaw_k) p_query + [xy_k, 0]. Sinograms (..., A, W), shift (...,).

    Returns (yaws (..., 2), xys (..., 2, 2), residuals (..., 2)); the
    lower residual is the better-supported hypothesis."""
    A = query_sino.shape[-2]
    aligned = align_sinogram(query_sino, shift)
    flipped = torch.flip(aligned, dims=(-1,))  # yaw - pi: every column flips
    xy, res = solve_translation(torch.stack([aligned, flipped], dim=-3),
                                cand_sino[..., None, :, :], bev_extent)
    yaw = shift.to(torch.float32) * (math.pi / A)
    return torch.stack([yaw, yaw - math.pi], dim=-1), xy, res


def solve_translation(query_sino: torch.Tensor, cand_sino: torch.Tensor,
                      bev_extent: float = 140.0):
    """Planar translation from row-aligned sinograms (..., A, W): per
    angle row a 1-D phase correlation gives the projection shift d(theta)
    ~ (x cos theta + y sin theta) W / extent; the confidence-weighted
    least-squares solve of [cos, sin] [x, y]^T = d gives (x, y) in
    metres. The 2x2 normal equations (damped by 1e-6 I) are solved in
    closed form, with no host sync. Returns (xy (..., 2), residual
    (...,))."""
    A, W = query_sino.shape[-2:]
    fq = torch.fft.fft(query_sino, dim=-1)
    fc = torch.fft.fft(cand_sino, dim=-1)
    corr = torch.fft.ifft(torch.conj(fq) * fc, dim=-1).real         # (..., A, W)
    peak, shift = torch.max(corr, dim=-1)
    d = torch.where(shift >= W // 2, shift - W, shift).to(torch.float32)
    conf = peak - torch.mean(corr, dim=-1)
    thetas = _thetas(A, query_sino.device)
    cos, sin = torch.cos(thetas), torch.sin(thetas)
    w = conf / torch.clamp(torch.sum(conf, dim=-1, keepdim=True), min=1e-9)
    a00 = torch.sum(cos * w * cos, dim=-1) + 1e-6
    a01 = torch.sum(cos * w * sin, dim=-1)
    a11 = torch.sum(sin * w * sin, dim=-1) + 1e-6
    b0 = torch.sum(cos * w * d, dim=-1)
    b1 = torch.sum(sin * w * d, dim=-1)
    det = a00 * a11 - a01 * a01
    px = (a11 * b0 - a01 * b1) / det
    py = (a00 * b1 - a01 * b0) / det
    xy = torch.stack([px, py], dim=-1) * (bev_extent / W)
    pred = cos * px[..., None] + sin * py[..., None]
    residual = torch.sqrt(torch.sum(w * (pred - d) ** 2, dim=-1))
    return xy, residual
