"""The elevation map of the port against the reference's
(`mapping/elevation.py`), function by function, on identical
world-frame clouds drawn with numpy (the scenes of `tests/test_mapping.py`).

Tolerances: `valid` bit-equal (cell indices are the same IEEE
subtract-and-divide in both); heights and variances rtol 1e-6 (XLA on
the CPU contracts a product and a sum into one fused multiply-add where
PyTorch rounds twice, e.g. the Kalman blend); shifted grids and the
raycast fractions exact; shifted origins and cell centres within an ulp
for the same reason."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.mapping import elevation as tel
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_tpu.mapping import elevation as jel
from tests.torch_parity import (
    cloud_to_jax, color_to_torch, emap_to_jax, emap_to_torch, to_jax,
)

RTOL = 1e-6


def cloud(xyz, drop=0.0, seed=0):
    """A port cloud of `xyz` (N, 3) with a `drop` fraction of slots
    masked out (and parked)."""
    xyz = np.asarray(xyz, np.float32)
    mask = np.random.default_rng(seed + 100).random(len(xyz)) >= drop
    return tpcl.park(tpcl.PointCloud(torch.from_numpy(xyz), torch.from_numpy(mask)))


def flat(seed, n=512, z=0.5, extent=5.0, noise=0.01, drop=0.1):
    rng = np.random.default_rng(seed)
    xy = rng.uniform(-extent, extent, (n, 2))
    zs = z + noise * rng.standard_normal((n, 1))
    return cloud(np.concatenate([xy, zs], -1), drop, seed)


def wall(seed, x=0.05, zlo=1.5, zhi=1.5, n=512):
    rng = np.random.default_rng(seed)
    y = rng.uniform(-5, 5, (n, 1))
    z = rng.uniform(zlo, zhi, (n, 1))
    return cloud(np.concatenate([np.full((n, 1), x), y, z], -1), 0.0, seed)


# (init kwargs, [cloud, ...]) — the fuse sequences of test_mapping.py
SCENES = {
    "flat_ground": (dict(size=60, resolution=0.2), lambda: [flat(0)]),
    "variance_shrinks": (dict(size=30, resolution=0.2),
                         lambda: [flat(i, extent=2.0) for i in range(5)]),
    "mahalanobis_reset": (dict(size=30, resolution=0.2),
                          lambda: [flat(0, extent=2.0, z=0.0)] * 4
                          + [flat(1, extent=2.0, z=2.0)]),
    "step_wall": (dict(size=60, resolution=0.2),
                  lambda: [flat(0, n=4096, z=0.0), wall(1)]),
    "tall_wall": (dict(size=60, resolution=0.2),
                  lambda: [flat(0, n=4096, z=0.0), wall(1, x=0.0, zlo=0.0, zhi=2.0)]),
    "scatter_3d": (dict(size=32, resolution=0.5),
                   lambda: [cloud(np.random.default_rng(5).uniform(-7, 7, (500, 3)))]),
}


def assert_maps_close(t, j):
    np.testing.assert_array_equal(t.valid.numpy(), np.asarray(j.valid))
    np.testing.assert_allclose(t.height.numpy(), np.asarray(j.height), rtol=RTOL, atol=1e-7)
    np.testing.assert_allclose(t.variance.numpy(), np.asarray(j.variance), rtol=RTOL)
    np.testing.assert_array_equal(t.origin.numpy(), np.asarray(j.origin))
    np.testing.assert_array_equal(t.resolution.numpy(), np.asarray(j.resolution))


def build(scene, model="laser"):
    kw, clouds = SCENES[scene]
    t = tel.init(**kw)
    j = jel.init(**kw)
    for pc in clouds():
        t = tel.fuse(t, pc, tel.SENSOR_MODELS[model](pc.xyz))
        jpc = cloud_to_jax(pc)
        j = jel.fuse(j, jpc, jel.SENSOR_MODELS[model](jpc.xyz))
    return t, j


@pytest.mark.parametrize("scene", sorted(SCENES))
def test_fuse_matches_reference(scene):
    t, j = build(scene)
    assert int(t.valid.sum()) > 0
    assert_maps_close(t, j)


def test_mahalanobis_reset_jumps_to_new_surface():
    t, _ = build("mahalanobis_reset")
    assert float(t.height[t.valid].median()) > 1.5


@pytest.mark.parametrize("model", sorted(tel.SENSOR_MODELS))
def test_sensor_models_match_reference(model):
    xyz = np.random.default_rng(3).uniform(-20, 20, (256, 3)).astype(np.float32)
    t = tel.SENSOR_MODELS[model](torch.from_numpy(xyz))
    j = jel.SENSOR_MODELS[model](jnp.asarray(xyz))
    np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=RTOL)
    assert (t > 0).all()


@pytest.mark.parametrize("model", ["laser", "stereo"])
def test_fuse_with_other_sensor_models(model):
    assert_maps_close(*build("step_wall", model))


# half-cell centres: at 0.25 m cells 0.125 and 0.375 are exact .5 shifts,
# which round half to even (0 and 2 cells)
@pytest.mark.parametrize("res,center", [
    (0.2, (1.0, 1.0)), (0.2, (-3.3, 2.5)), (0.2, (20.0, 0.0)),
    (0.25, (0.125, -0.125)), (0.25, (0.375, 0.625)),
])
def test_shift_matches_reference(res, center):
    t = tel.init(32, res)
    for pc in SCENES["step_wall"][1]():
        t = tel.fuse(t, pc, tel.sensor_variance(pc.xyz))
    c = np.asarray(center, np.float32)
    ts = tel.shift(t, torch.from_numpy(c))
    js = jel.shift(emap_to_jax(t), jnp.asarray(c))
    for name in ("height", "variance", "valid", "resolution"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(), np.asarray(getattr(js, name)))
    # origin + cells * res: XLA contracts it into one fused multiply-add
    np.testing.assert_allclose(ts.origin.numpy(), np.asarray(js.origin), rtol=2e-7)


def test_shift_preserves_world_anchoring():
    m = tel.init(size=30, resolution=0.2, center=(0, 0))
    m = tel.fuse(m, cloud([[1.0, 1.0, 0.7]]), torch.tensor([0.01]))
    m2 = tel.shift(m, torch.tensor([1.0, 1.0]))
    ij = np.floor((np.array([1.0, 1.0]) - m2.origin.numpy()) / 0.2).astype(int)
    assert bool(m2.valid[ij[0], ij[1]])
    np.testing.assert_allclose(float(m2.height[ij[0], ij[1]]), 0.7, atol=1e-5)


@pytest.mark.parametrize("noise", [1e-4, 0.05])
def test_predict_matches_reference(noise):
    t, j = build("step_wall")
    assert_maps_close(tel.predict(t, noise), jel.predict(j, noise))


@pytest.mark.parametrize("sigma_z,sigma_tilt,as_tensor", [
    (0.0, 0.05, False), (0.1, 0.0, False), (0.02, 0.03, True),
])
def test_motion_update_matches_reference(sigma_z, sigma_tilt, as_tensor):
    t, j = build("flat_ground")
    robot = np.array([0.3, -0.4], np.float32)
    sz, st = (torch.tensor(sigma_z), torch.tensor(sigma_tilt)) if as_tensor else (sigma_z, sigma_tilt)
    tm = tel.motion_update(t, torch.from_numpy(robot), sz, st)
    jm = jel.motion_update(j, jnp.asarray(robot), sigma_z, sigma_tilt)
    assert_maps_close(tm, jm)
    assert not torch.equal(tm.variance, t.variance)


@pytest.mark.parametrize("n", [2, 7, 32, 64])
def test_raytrace_fractions_equal_jnp_linspace(n):
    np.testing.assert_array_equal(
        tel._linspace_f32(0.05, 0.92, n), np.asarray(jnp.linspace(0.05, 0.92, n)))


def pillar_scene():
    m = tel.init(size=60, resolution=0.2)
    pillar = cloud([[3.0, 0.0, 2.0]] * 4)
    m = tel.fuse(m, pillar, tel.perfect_variance(pillar.xyz))
    ground = cloud([[5.0, y, 0.0] for y in (-0.1, 0.0, 0.1)])
    return m, np.array([0.0, 0.0, 0.5], np.float32), ground


def ground_scene():
    t, _ = build("step_wall")
    return t, np.array([0.0, 0.0, 1.0], np.float32), flat(9, n=2048, z=0.0, extent=6.0)


def wall_scene():
    t, _ = build("tall_wall")
    return t, np.array([-3.0, 0.5, 0.4], np.float32), flat(4, n=2048, z=0.0, extent=6.0)


@pytest.mark.parametrize("scene", [pillar_scene, ground_scene, wall_scene])
@pytest.mark.parametrize("n_samples", [8, 32])
def test_raytrace_clear_matches_reference(scene, n_samples):
    t, origin, pc = scene()
    tr = tel.raytrace_clear(t, torch.from_numpy(origin), pc, n_samples=n_samples)
    jr = jel.raytrace_clear(emap_to_jax(t), jnp.asarray(origin), cloud_to_jax(pc),
                            n_samples=n_samples)
    assert_maps_close(tr, jr)


def test_raytrace_clears_stale_pillar():
    m, origin, ground = pillar_scene()
    m2 = tel.raytrace_clear(m, torch.from_numpy(origin), ground)
    ij = np.floor((np.array([3.0, 0.0]) - m.origin.numpy()) / 0.2).astype(int)
    assert bool(m.valid[ij[0], ij[1]]) and not bool(m2.valid[ij[0], ij[1]])


@pytest.mark.parametrize("iterations", [1, 2])
def test_interpolate_dense_matches_reference(iterations):
    m = tel.init(size=30, resolution=0.2)
    pc = flat(3, n=200, z=1.0, extent=2.5, drop=0.0)
    m = tel.fuse(m, pc, tel.sensor_variance(pc.xyz))
    t = tel.interpolate_dense(m, iterations=iterations)
    j = jel.interpolate_dense(emap_to_jax(m), iterations=iterations)
    assert int(t.valid.sum()) > int(m.valid.sum())
    assert_maps_close(t, j)


@pytest.mark.parametrize("scene", ["flat_ground", "scatter_3d"])
def test_to_cloud_matches_reference(scene):
    t, _ = build(scene)
    tc, jc = tel.to_cloud(t), jel.to_cloud(emap_to_jax(t))
    np.testing.assert_array_equal(tc.mask.numpy(), np.asarray(jc.mask))
    # cell centres (i + 0.5) * res + origin: one fused multiply-add in XLA,
    # two roundings here — within an ulp of the coordinate (tens of metres)
    np.testing.assert_allclose(tc.xyz.numpy(), np.asarray(jc.xyz), rtol=0, atol=1e-6)


def look_at(eye, target):
    """(world <- camera rotation, camera position): optical axis +z from
    `eye` towards `target`, image x along the world's horizontal."""
    z = np.subtract(target, eye)
    z = z / np.linalg.norm(z)
    x = np.cross(z, [0.0, 0.0, 1.0])
    x = x / np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z], axis=1), eye


CAMERAS = {
    "down": (np.diag([1.0, -1.0, -1.0]), [0.0, 0.0, 10.0]),
    "up": (np.eye(3), [0.0, 0.0, 10.0]),
    "oblique": look_at([-9.0, 0.5, 6.0], [0.0, 0.0, 0.0]),
}


@pytest.mark.parametrize("camera", sorted(CAMERAS))
def test_color_layer_matches_reference(camera):
    t, j = build("scatter_3d")
    pc = SCENES["scatter_3d"][1]()[0]
    R, cam_t = (np.asarray(a, np.float32) for a in CAMERAS[camera])
    K = np.array([40.0, 40.0, 32.0, 24.0], np.float32)
    img = np.random.default_rng(8).random((48, 64, 3)).astype(np.float32)
    args = (R, cam_t, K, img)
    tcol, tvis = tel.colorize_from_camera(pc.xyz, *(torch.from_numpy(a) for a in args))
    jcol, jvis = jel.colorize_from_camera(to_jax(pc.xyz), *(jnp.asarray(a) for a in args))
    np.testing.assert_array_equal(tvis.numpy(), np.asarray(jvis))
    np.testing.assert_allclose(tcol.numpy(), np.asarray(jcol), rtol=1e-5, atol=1e-6)
    if camera == "up":
        assert int(tvis.sum()) == 0
    else:
        assert int(tvis.sum()) > 100
    tcg = tel.fuse_color(t, tel.init_color(32), pc, tcol, tvis)
    jcg = jel.fuse_color(j, jel.init_color(32), cloud_to_jax(pc), jcol, jvis)
    jcg = color_to_torch(jcg)
    np.testing.assert_array_equal(tcg.weight.numpy(), jcg.weight.numpy())
    np.testing.assert_allclose(tcg.rgb.numpy(), jcg.rgb.numpy(), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tel.ortho_image(t, tcg).numpy(),
        np.asarray(jel.ortho_image(emap_to_jax(t), jel.ColorGrid(*map(to_jax, tcg)))), rtol=RTOL)


def test_uniform_image_colors_cells_exactly():
    t, _ = build("scatter_3d")
    pc = SCENES["scatter_3d"][1]()[0]
    img = torch.ones((48, 64, 3)) * torch.tensor([0.2, 0.5, 0.8])
    R, cam_t = (torch.from_numpy(np.asarray(a, np.float32)) for a in CAMERAS["down"])
    cols, vis = tel.colorize_from_camera(pc.xyz, R, cam_t, torch.tensor([40.0, 40.0, 32.0, 24.0]), img)
    cg = tel.fuse_color(t, tel.init_color(32), pc, cols, vis)
    o = tel.ortho_image(t, cg).numpy()
    colored = (cg.weight > 0).numpy()
    assert colored.sum() > 0
    np.testing.assert_allclose(o[colored], np.broadcast_to([0.2, 0.5, 0.8], o[colored].shape),
                               atol=1e-5)


@pytest.mark.parametrize("scene", ["flat_ground", "tall_wall"])
def test_ortho_image_without_color_matches_reference(scene):
    t, _ = build(scene)
    o = tel.ortho_image(t)
    np.testing.assert_allclose(o.numpy(), np.asarray(jel.ortho_image(emap_to_jax(t))), rtol=RTOL)
    assert (o[~t.valid] == 0).all() and 0.0 < float(o.max()) <= 1.0


def test_fake_image_and_roundtrip_converters():
    assert tel.fake_image().shape == (480, 640, 3)
    assert np.asarray(jel.fake_image()).shape == tuple(tel.fake_image().shape)
    t, _ = build("flat_ground")
    back = emap_to_torch(emap_to_jax(t))
    for a, b in zip(t, back):
        assert torch.equal(a, b)
