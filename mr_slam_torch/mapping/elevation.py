"""2.5D elevation mapping on the grid (port of
`mr_slam_tpu/mapping/elevation.py`).

The reference's GEM re-design (`elevation_mapping_periodical`'s
`G_pointsprocess` / `G_fuse` / `G_Mapfeature` / `G_Clear_map`) as
functions of an `ElevationMap` of tensors:

  * `process_points` — sensor-noise variance + per-cell lowest z, one
    scatter-min each (`scatter_reduce_(..., "amin")`: exact, order-free);
  * `fuse` — per-cell 1D Kalman update with a Mahalanobis-gated reset;
  * `shift` — roll-and-clear recentring of the rolling grid;
  * `features` — the 5x5 plane fit -> slope / roughness / step /
    traversability. On a CUDA tensor with the 5x5 window it launches the
    hand-written stencil kernel (`ops/hopper_stencil.py`); otherwise the
    plain PyTorch version runs, as the reference's own dispatch does.

Every function takes the map on any device and returns tensors on that
device; each is a plain PyTorch function (the reference's `jax.jit`
has no counterpart here). Window sums and maxima are sums and maxima
over shifted slices, never `conv2d` / `max_pool2d`: cuDNN would bring
TF32 and its algorithm choice onto a parity path.

Port notes:
  * `features_plain` fits the plane in window-local coordinates
    (integer cell offsets about the centre cell, scaled by the
    resolution in the gradient; `ops/hopper_stencil._closed_form`). The
    reference takes absolute grid coordinates, and `Sxx / n - mx^2` then
    cancels in float32 on wide maps (slope errors ~5e-2 rad beyond
    ~1800 columns); the fit is translation-invariant, so the local form
    is the same function without the cancellation.
  * The traversability blend multiplies by the float32 reciprocal of
    each critical value, as PyTorch's CUDA division by a Python scalar
    does anyway; the kernel does the same, so both agree on the card.
  * `fuse_color`'s scatter-add is `segment.scatter_sum` (fixed order).
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from ..devconst import const
from ..ops import segment
from ..ops.pointcloud import PointCloud

_F32 = torch.float32


class ElevationMap(NamedTuple):
    """Rolling local grid. height/variance (H, W) float32, valid (H, W)
    bool; origin (2,) float32 = world xy of the corner of cell (0, 0);
    resolution () float32 metres per cell (0.2 in the reference's
    detection_robot_1.yaml)."""

    height: torch.Tensor
    variance: torch.Tensor
    valid: torch.Tensor
    origin: torch.Tensor
    resolution: torch.Tensor

    @property
    def shape(self) -> tuple[int, int]:
        return tuple(self.height.shape)


def init(size: int = 60, resolution: float = 0.2, center=(0.0, 0.0), device=None) -> ElevationMap:
    """size=60 @ 0.2 m -> the reference's 12 m x 12 m local map."""
    half = size * resolution / 2.0
    return ElevationMap(
        height=torch.zeros((size, size), dtype=_F32, device=device),
        variance=torch.full((size, size), 1e6, dtype=_F32, device=device),
        valid=torch.zeros((size, size), dtype=torch.bool, device=device),
        origin=torch.tensor([center[0] - half, center[1] - half], dtype=_F32, device=device),
        resolution=torch.tensor(resolution, dtype=_F32, device=device),
    )


def sensor_variance(xyz_sensor: torch.Tensor, normal_factor: float = 0.002,
                    lateral_factor: float = 0.004) -> torch.Tensor:
    """Beam noise model: variance grows with squared range — the
    Jacobian-propagated laser model of `LaserSensorProcessor.cpp`
    collapsed to its dominant terms. xyz in the SENSOR frame."""
    d2 = torch.sum(xyz_sensor * xyz_sensor, dim=-1)
    return normal_factor + lateral_factor * d2


def structured_light_variance(xyz_sensor: torch.Tensor, normal_coeff: float = 0.002,
                              lateral_coeff: float = 0.004) -> torch.Tensor:
    """StructuredLightSensorProcessor model: depth noise grows with the
    square of the z-depth (Kinect-style), lateral with depth."""
    z = torch.abs(xyz_sensor[..., 2])
    return normal_coeff * z * z + lateral_coeff * z + 1e-4


def stereo_variance(xyz_sensor: torch.Tensor, focal: float = 500.0, baseline: float = 0.1,
                    disparity_sigma: float = 0.5) -> torch.Tensor:
    """StereoSensorProcessor model: sigma_z = z^2 * sigma_d / (f * b) —
    depth error from disparity quantisation."""
    z = torch.abs(xyz_sensor[..., 2])
    fb = float(np.float32(focal) * np.float32(baseline))  # the reference's f32 product
    s = z * z * disparity_sigma / fb
    return s * s + 1e-6


def perfect_variance(xyz_sensor: torch.Tensor) -> torch.Tensor:
    """PerfectSensorProcessor: ground-truth input, near-zero variance."""
    return torch.full(xyz_sensor.shape[:-1], 1e-6, dtype=_F32, device=xyz_sensor.device)


# name -> model, mirroring the sensor_processors/ plugin registry
SENSOR_MODELS = {
    "laser": sensor_variance,
    "structured_light": structured_light_variance,
    "stereo": stereo_variance,
    "perfect": perfect_variance,
}


def _cell_index(m: ElevationMap, xy: torch.Tensor, ok: torch.Tensor):
    """Flat cell index of world xy (..., 2) with H*W for points outside
    the grid or not `ok`: (flat (...), in-bounds mask (...))."""
    H, W = m.shape
    ij = torch.floor((xy - m.origin) / m.resolution).to(torch.int64)
    inb = ok & (ij[..., 0] >= 0) & (ij[..., 0] < H) & (ij[..., 1] >= 0) & (ij[..., 1] < W)
    flat = torch.where(inb, ij[..., 0] * W + ij[..., 1], H * W)
    return flat, inb


def process_points(m: ElevationMap, pc: PointCloud, variances: torch.Tensor):
    """Reduce a world-frame cloud to per-cell (lowest z, min variance) —
    `G_pointsprocess`'s transform + atomicMin pass. The variance is the
    smallest of the cell's points, not the winner's (as the reference).
    Returns (cell_z (H, W), cell_var (H, W), cell_hit (H, W))."""
    H, W = m.shape
    dev = m.height.device
    flat, inb = _cell_index(m, pc.xyz[:, :2], pc.mask)
    inf = torch.full((), float("inf"), dtype=_F32, device=dev)
    cell_z = torch.full((H * W + 1,), float("inf"), dtype=_F32, device=dev)
    cell_z.scatter_reduce_(0, flat, torch.where(inb, pc.xyz[:, 2], inf), "amin")
    cell_var = torch.full((H * W + 1,), float("inf"), dtype=_F32, device=dev)
    cell_var.scatter_reduce_(0, flat, torch.where(inb, variances.to(_F32), inf), "amin")
    hit = torch.isfinite(cell_z[: H * W])
    return (
        torch.where(hit, cell_z[: H * W], 0.0).reshape(H, W),
        torch.where(hit, cell_var[: H * W], 1e6).reshape(H, W),
        hit.reshape(H, W),
    )


def fuse(m: ElevationMap, pc: PointCloud, variances: torch.Tensor,
         mahalanobis_thresh: float = 5.0) -> ElevationMap:
    """One measurement update — `G_fuse` (`gpu_process.cu:477-537`): per
    cell, Kalman-blend the new height with the stored one; if the
    innovation's Mahalanobis distance exceeds the threshold, RESET to
    the new surface (dynamic obstacles / overhangs)."""
    cell_z, cell_var, hit = process_points(m, pc, variances)
    h0, v0, ok0 = m.height, m.variance, m.valid
    maha = torch.abs(cell_z - h0) / torch.sqrt(torch.clamp(v0 + cell_var, min=1e-9))
    consistent = maha <= mahalanobis_thresh
    v_sum = torch.clamp(v0 + cell_var, min=1e-9)
    h_new = (v0 * cell_z + cell_var * h0) / v_sum
    v_new = (v0 * cell_var) / v_sum
    blend = consistent & ok0
    h_out = torch.where(blend, h_new, cell_z)
    v_out = torch.where(blend, v_new, cell_var)
    return m._replace(
        height=torch.where(hit, h_out, h0),
        variance=torch.where(hit, v_out, v0),
        valid=ok0 | hit,
    )


def predict(m: ElevationMap, process_noise: float = 1e-4) -> ElevationMap:
    """Time update: inflate variance (`G_Mapvar_update` /
    RobotMotionMapUpdater)."""
    return m._replace(variance=m.variance + process_noise)


def _square(s):
    """s^2 in float32, for a tensor or a Python number."""
    if isinstance(s, torch.Tensor):
        s = s.to(_F32)
        return s * s
    return float(np.float32(s) * np.float32(s))


def _cell_centers(m: ElevationMap):
    """World x of each row's and y of each column's cell centre."""
    H, W = m.shape
    dev = m.height.device
    ci = (torch.arange(H, dtype=_F32, device=dev) + 0.5) * m.resolution + m.origin[0]
    cj = (torch.arange(W, dtype=_F32, device=dev) + 0.5) * m.resolution + m.origin[1]
    return ci, cj


def motion_update(m: ElevationMap, robot_xy: torch.Tensor, sigma_z=0.0,
                  sigma_tilt=0.0) -> ElevationMap:
    """Robot-motion variance update — `RobotMotionMapUpdater.cpp`
    re-derived: dvar(cell) = sigma_z^2 + (r(cell) * sigma_tilt)^2 with r
    the horizontal lever arm from the robot to the cell. Only valid
    cells are inflated."""
    ci, cj = _cell_centers(m)
    dx = ci[:, None] - robot_xy[0]
    dy = cj[None, :] - robot_xy[1]
    r2 = dx * dx + dy * dy
    dvar = _square(sigma_z) + r2 * _square(sigma_tilt)
    return m._replace(variance=torch.where(m.valid, m.variance + dvar, m.variance))


def shift(m: ElevationMap, new_center: torch.Tensor) -> ElevationMap:
    """Recenter the rolling grid on the robot — the ring-buffer shift
    (`G_Clear_map`) as a roll + clear of vacated rows/cols. The cell
    shift rounds half to even, as `jnp.round` does."""
    H, W = m.shape
    dev = m.height.device
    half = const((float(H), float(W)), dev) * m.resolution / 2.0
    new_origin_f = new_center.to(_F32) - half
    shift_cells = torch.round((new_origin_f - m.origin) / m.resolution).to(torch.int64)
    new_origin = m.origin + shift_cells.to(_F32) * m.resolution
    rows = torch.arange(H, device=dev)[:, None] + shift_cells[0]
    cols = torch.arange(W, device=dev)[None, :] + shift_cells[1]
    inb = (rows >= 0) & (rows < H) & (cols >= 0) & (cols < W)
    ri = torch.clamp(rows, 0, H - 1)
    ci = torch.clamp(cols, 0, W - 1)

    def take(a, fill):
        return torch.where(inb, a[ri, ci], fill)

    return ElevationMap(
        height=take(m.height, 0.0),
        variance=take(m.variance, 1e6),
        valid=take(m.valid, False),
        origin=new_origin,
        resolution=m.resolution,
    )


def _linspace_f32(start: float, stop: float, num: int) -> np.ndarray:
    """`jnp.linspace(start, stop, num)` in float32 bit for bit, as XLA
    compiles it: step = iota * f32(1 / (num - 1)), the stop term folded
    into iota * f32(stop * that reciprocal) and added to
    start * (1 - step) by one fused multiply-add; the exact endpoint
    appended. (The fused multiply-add is exact in float64 here: both
    products fit in 53 bits.)"""
    f32 = np.float32
    start, stop = f32(start), f32(stop)
    if num == 1:
        return np.array([start], np.float32)
    rcp = f32(1) / f32(num - 1)
    iota = np.arange(num - 1, dtype=np.float32)
    head = start * (f32(1) - iota * rcp)
    out = (iota.astype(np.float64) * np.float64(stop * rcp) + head).astype(np.float32)
    return np.concatenate([out, [stop]]).astype(np.float32)


def raytrace_clear(m: ElevationMap, sensor_origin: torch.Tensor, pc: PointCloud,
                   n_samples: int = 32, margin: float = 0.2,
                   variance_inflation: float = 10.0) -> ElevationMap:
    """Visibility clearing — `G_Raytracing` (`gpu_process.cu:706`): cells
    crossed by a beam BELOW the beam's height must not hold a surface
    above it; stale surfaces there get their variance inflated, and
    cells far above the beam are invalidated. Each beam is sampled at
    `n_samples` fixed fractions and the highest beam through each cell
    is one scatter-max."""
    H, W = m.shape
    dev = m.height.device
    fracs = const(tuple(float(f) for f in _linspace_f32(0.05, 0.92, n_samples)), dev)
    so = sensor_origin.to(_F32)
    pts = so[None, None, :] + fracs[None, :, None] * (pc.xyz[:, None, :] - so[None, None, :])
    flat, inb = _cell_index(m, pts[..., :2], pc.mask[:, None])
    beam_z = torch.where(inb, pts[..., 2], float("-inf")).reshape(-1)
    pass_z = torch.full((H * W + 1,), float("-inf"), dtype=_F32, device=dev)
    pass_z.scatter_reduce_(0, flat.reshape(-1), beam_z, "amax")
    pass_z = pass_z[: H * W].reshape(H, W)
    seen = torch.isfinite(pass_z)
    stale = seen & m.valid & (m.height > pass_z + margin)
    return m._replace(
        variance=torch.where(stale, m.variance * variance_inflation, m.variance),
        valid=m.valid & ~(stale & (m.height > pass_z + 3.0 * margin)),
    )


def _window_sums(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box sum with zero padding, separable: along each row, then
    along each column (the reference's two 1-D convolutions)."""
    p = k // 2
    H, W = x.shape
    xp = F.pad(x, (p, p))
    rows = xp[:, 0:W]
    for d in range(1, k):
        rows = rows + xp[:, d:d + W]
    rp = F.pad(rows, (0, 0, p, p))
    out = rp[0:H]
    for d in range(1, k):
        out = out + rp[d:d + H]
    return out


def interpolate_dense(m: ElevationMap, iterations: int = 2) -> ElevationMap:
    """Dense interpolation before the keyframe flush (`updateLocalMap`,
    `ElevationMapping.cpp:653-821`): fill holes from the 3x3 mean of
    valid neighbours, iterated; filled cells carry the neighbourhood's
    mean variance, inflated."""
    h, v, ok = m.height, m.variance, m.valid
    for _ in range(iterations):
        cnt = _window_sums(ok.to(_F32), 3)
        hs = _window_sums(torch.where(ok, h, 0.0), 3)
        vs = _window_sums(torch.where(ok, v, 0.0), 3)
        can = (~ok) & (cnt >= 3.0)
        denom = torch.clamp(cnt, min=1.0)
        h = torch.where(can, hs / denom, h)
        v = torch.where(can, 2.0 * vs / denom + 1e-3, v)
        ok = ok | can
    return m._replace(height=h, variance=v, valid=ok)


class TerrainFeatures(NamedTuple):
    slope: torch.Tensor           # rad
    roughness: torch.Tensor       # m (plane-fit residual std)
    step: torch.Tensor            # m (max height jump in window)
    traversability: torch.Tensor  # [0, 1], 1 = flat and smooth


def features(m: ElevationMap, window: int = 5, slope_crit: float = 0.6,
             rough_crit: float = 0.15, step_crit: float = 0.3) -> TerrainFeatures:
    """Terrain features — the dispatcher. On a CUDA tensor with the 5x5
    window: the hand-written stencil kernel (`features_fused`, which
    launches it or raises). Otherwise (CPU tensors, other windows) the
    plain version. Both compute `G_Mapfeature`'s plane-fit slope /
    roughness / step / traversability."""
    crit = dict(slope_crit=slope_crit, rough_crit=rough_crit, step_crit=step_crit)
    if window == 5 and m.height.device.type == "cuda":
        return features_fused(m, **crit)
    return features_plain(m, window, **crit)


def features_plain(m: ElevationMap, window: int = 5, slope_crit: float = 0.6,
                   rough_crit: float = 0.15, step_crit: float = 0.3) -> TerrainFeatures:
    """The plain PyTorch version (port of `features_xla`, in
    window-local coordinates): `G_Mapfeature` (`gpu_process.cu:547-665`)
    fits z = ax + by + c over each cell's k x k window of valid cells
    (out-of-grid cells add nothing), takes slope = atan |(a, b)|,
    roughness = residual std and step = window max - min (z = 0 for
    invalid in-grid cells in the max, valid cells only in the min), and
    blends them into a [0, 1] traversability."""
    from ..ops import hopper_stencil

    return TerrainFeatures(*hopper_stencil.terrain_features_plain(
        m.height, m.valid, m.resolution, window,
        slope_crit=slope_crit, rough_crit=rough_crit, step_crit=step_crit,
    ))


def features_fused(m: ElevationMap, slope_crit: float = 0.6, rough_crit: float = 0.15,
                   step_crit: float = 0.3) -> TerrainFeatures:
    """`features` with the 5x5 window through the stencil kernel's
    wrapper (`ops/hopper_stencil.terrain_features`): one pass that reads
    height and valid once and writes the four layers once."""
    from ..ops import hopper_stencil

    return TerrainFeatures(*hopper_stencil.terrain_features(
        m.height, m.valid, m.resolution,
        slope_crit=slope_crit, rough_crit=rough_crit, step_crit=step_crit,
    ))


def _dilate3(x: torch.Tensor) -> torch.Tensor:
    """3x3 max filter, -inf outside the grid."""
    H, W = x.shape
    p = F.pad(x, (1, 1, 1, 1), value=float("-inf"))
    out = p[0:H, 0:W]
    for di in range(3):
        for dj in range(3):
            if di or dj:
                out = torch.maximum(out, p[di:di + H, dj:dj + W])
    return out


def to_cloud(m: ElevationMap) -> PointCloud:
    """Flatten the grid into a masked world-frame cloud of cell centres —
    what `updateLocalMap` publishes as the grid part of a SubMap."""
    H, W = m.shape
    ci, cj = _cell_centers(m)
    xs = ci[:, None].expand(H, W)
    ys = cj[None, :].expand(H, W)
    xyz = torch.stack([xs, ys, m.height], dim=-1).reshape(-1, 3)
    return PointCloud(xyz, m.valid.reshape(-1))


# ---------------------------------------------------------------------------
# Colour / ortho-image layer (GEM's synchronized camera path)
# ---------------------------------------------------------------------------


class ColorGrid(NamedTuple):
    """Per-cell RGB accumulated as a weighted running mean."""

    rgb: torch.Tensor     # (H, W, 3) float32 in [0, 1]
    weight: torch.Tensor  # (H, W) float32


def init_color(size: int = 60, device=None) -> ColorGrid:
    return ColorGrid(
        rgb=torch.zeros((size, size, 3), dtype=_F32, device=device),
        weight=torch.zeros((size, size), dtype=_F32, device=device),
    )


def colorize_from_camera(xyz_world: torch.Tensor, cam_R: torch.Tensor, cam_t: torch.Tensor,
                         intrinsics: torch.Tensor, image: torch.Tensor):
    """Project world points (N, 3) into a pinhole camera (cam_R: world <-
    camera rotation, cam_t: camera position, intrinsics fx fy cx cy) and
    bilinearly sample per-point colours of `image` (Hi, Wi, 3). Returns
    (colors (N, 3), visible (N,)); points behind the camera or outside
    the frame are invisible."""
    Hi, Wi = image.shape[0], image.shape[1]
    fx, fy, cx, cy = intrinsics[0], intrinsics[1], intrinsics[2], intrinsics[3]
    p_cam = (xyz_world - cam_t) @ cam_R  # world -> camera: R^T (x - t)
    z = p_cam[:, 2]
    safe_z = torch.where(torch.abs(z) < 1e-6, 1e-6, z)
    u = fx * p_cam[:, 0] / safe_z + cx
    v = fy * p_cam[:, 1] / safe_z + cy
    visible = (z > 1e-3) & (u >= 0) & (u <= Wi - 1.0) & (v >= 0) & (v <= Hi - 1.0)
    u = torch.clamp(u, 0.0, Wi - 1.001)
    v = torch.clamp(v, 0.0, Hi - 1.001)
    u0 = torch.floor(u).to(torch.int64)
    v0 = torch.floor(v).to(torch.int64)
    du = (u - u0)[:, None]
    dv = (v - v0)[:, None]
    c00 = image[v0, u0]
    c01 = image[v0, u0 + 1]
    c10 = image[v0 + 1, u0]
    c11 = image[v0 + 1, u0 + 1]
    colors = (
        c00 * (1 - du) * (1 - dv) + c01 * du * (1 - dv)
        + c10 * (1 - du) * dv + c11 * du * dv
    )
    return colors, visible


def fuse_color(m: ElevationMap, cg: ColorGrid, pc: PointCloud, colors: torch.Tensor,
               visible: torch.Tensor) -> ColorGrid:
    """Scatter per-point colours into the grid as a weighted running
    mean (GEM keeps a colour layer beside height in the fused map)."""
    H, W = m.shape
    flat, ok = _cell_index(m, pc.xyz[:, :2], pc.mask & visible)
    w = ok.to(_F32)
    acc = segment.scatter_sum(H * W + 1, flat, colors * w[:, None], w)
    sum_rgb, sum_w = acc[:, :3], acc[:, 3]
    new_w = cg.weight + sum_w[: H * W].reshape(H, W)
    num = cg.rgb * cg.weight[..., None] + sum_rgb[: H * W].reshape(H, W, 3)
    rgb = num / torch.clamp(new_w[..., None], min=1e-9)
    return ColorGrid(rgb=rgb, weight=new_w)


def ortho_image(m: ElevationMap, cg: ColorGrid | None = None) -> torch.Tensor:
    """(H, W, 3) float32 top-down render — the `orthoImage` field of the
    reference's SubMap. Coloured cells use the camera layer, the rest a
    height shading, invalid cells black."""
    h = torch.where(m.valid, m.height, 0.0)
    lo = torch.min(torch.where(m.valid, h, float("inf")))
    hi = torch.max(torch.where(m.valid, h, float("-inf")))
    span = torch.clamp(hi - lo, min=1e-6)
    shade = torch.clamp((h - lo) / span, 0.0, 1.0)
    gray = shade[..., None].expand(*shade.shape, 3)
    if cg is not None:
        gray = torch.where((cg.weight > 0)[..., None], cg.rgb, gray)
    return torch.where(m.valid[..., None], gray, 0.0)


def fake_image(height: int = 480, width: int = 640, device=None) -> torch.Tensor:
    """Tools/Fake_img parity (`Tools/Fake_img/robot_N.py`): a black camera
    frame for robots without cameras."""
    return torch.zeros((height, width, 3), dtype=_F32, device=device)
