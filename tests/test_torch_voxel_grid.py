"""Voxel-hash grid and voxel downsample of the port against the reference.

Slot layout (which slot holds which voxel, its coords, count and valid
flag) must be bit-equal: the port's hash is the reference's uint32
lowbias32 in masked int64. Moments (mean, covariance) agree within
1e-5: the clouds sit within +-6 m of the origin, where the f32 second
moments E[xx] are O(10) and the two packages' different scatter-add
orders move them by a few ulp."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.ops import pointcloud as tpcl, voxel_grid as tvg
from mr_slam_tpu.ops import pointcloud as jpcl, voxel_grid as jvg
from tests.torch_parity import cloud_to_jax, make_scans, structured_cloud, to_jax

MOMENT_TOL = 1e-5


def cloud(seed, n=3000, extent=6.0, frac_valid=0.9):
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-extent, extent, (n, 3)).astype(np.float32)
    # clustered structure so cells hold several points
    xyz[: n // 2] = np.round(xyz[: n // 2]) + 0.05 * rng.standard_normal((n // 2, 3))
    mask = rng.uniform(size=n) < frac_valid
    return tpcl.park(tpcl.PointCloud(torch.from_numpy(xyz.astype(np.float32)),
                                     torch.from_numpy(mask)))


def assert_same_grid(packed_t, packed_j):
    t = packed_t.numpy()
    j = np.asarray(packed_j)
    # layout: coords(0:3) count(3) valid(13) bit-equal
    np.testing.assert_array_equal(t[..., 0:4], j[..., 0:4])
    np.testing.assert_array_equal(t[..., 13], j[..., 13])
    # moments of VALID cells (lookups never read the others). An invalid
    # 1-2 point cell has a rank<=1 covariance whose plane regularization
    # runs eigh3 on a doubly degenerate spectrum: its result follows ulp
    # noise in the input, in the reference as much as in the port.
    valid = t[..., 13] > 0.5
    np.testing.assert_allclose(t[valid][:, 4:13], j[valid][:, 4:13], atol=MOMENT_TOL, rtol=0)


def test_hash_bit_equal_including_negative_coords():
    rng = np.random.default_rng(0)
    ijk = np.concatenate([
        rng.integers(-5000, 5000, (20000, 3)),
        np.array([[0, 0, 0], [-1, -1, -1], [2**30, 0, -(2**30)],
                  [2**31 - 1, -(2**31), 7], [-123456789, 987654321, -1]]),
    ]).astype(np.int32)
    for H in (1 << 13, 1 << 17, 12345):
        t = tvg._hash(torch.from_numpy(ijk), H).numpy()
        j = np.asarray(jvg._hash(jnp.asarray(ijk), H))
        np.testing.assert_array_equal(t, j)


@pytest.mark.parametrize("min_points", [1, 3])
@pytest.mark.parametrize("leaf", [0.5, 1.0, 0.37])
def test_build_matches_reference(min_points, leaf):
    pc = cloud(1)
    t = tvg.build(pc, leaf, 1 << 13, min_points=min_points)
    j = jvg.build(cloud_to_jax(pc), leaf, 1 << 13, min_points=min_points)
    assert_same_grid(t.packed, j.packed)


@pytest.mark.parametrize("leaf", [0.5, 1.0, 0.37])
@pytest.mark.parametrize("seed", [0, 1])
def test_build_plane_regularized_matches_reference(leaf, seed):
    """Plane regularization rebuilds each covariance from `eigh3`. Where
    a cell's spectrum has a (near-)repeated eigenvalue, the reference's
    closed form takes one eigenvector from the cross products of a
    near-rank-1 matrix and re-orthogonalizes the others against it: the
    result follows ulp noise of the input moments (which differ between
    the packages by summation order), in the reference as much as here.
    Those cells are held to the layout check; every cell with a
    well-separated spectrum (gaps above 5% of the largest eigenvalue)
    is held to 1e-5."""
    pc = structured_cloud(seed, 4096)
    t = tvg.build(pc, leaf, 1 << 13, min_points=3, regularize="plane").packed.numpy()
    j = np.asarray(jvg.build(cloud_to_jax(pc), leaf, 1 << 13, min_points=3,
                             regularize="plane").packed)
    raw = tvg.build(pc, leaf, 1 << 13, min_points=3)
    w = np.linalg.eigvalsh(raw.cov.numpy().astype(np.float64))
    gap = np.minimum(w[:, 1] - w[:, 0], w[:, 2] - w[:, 1])
    separated = (t[:, 13] > 0.5) & (gap > 0.05 * np.maximum(w[:, 2], 1e-12))
    assert separated.sum() > 50
    np.testing.assert_array_equal(t[:, :4], j[:, :4])
    np.testing.assert_array_equal(t[:, 13], j[:, 13])
    np.testing.assert_allclose(t[separated][:, 4:13], j[separated][:, 4:13],
                               atol=MOMENT_TOL, rtol=0)


def test_build_batched_equals_per_item():
    clouds = [cloud(s) for s in (2, 3, 4)]
    batched = tpcl.PointCloud(torch.stack([c.xyz for c in clouds]),
                              torch.stack([c.mask for c in clouds]))
    g = tvg.build(batched, 0.5, 1 << 12, min_points=3, regularize="plane")
    for k, c in enumerate(clouds):
        single = tvg.build(c, 0.5, 1 << 12, min_points=3, regularize="plane")
        np.testing.assert_array_equal(g.packed[k].numpy(), single.packed.numpy())


def test_insert_and_decay_match_reference():
    a, b = cloud(5), cloud(6)
    t = tvg.insert(tvg.empty(1.0, 1 << 12), a)
    j = jvg.insert(jvg.empty(1.0, 1 << 12), cloud_to_jax(a))
    assert_same_grid(t.packed, j.packed)
    t = tvg.insert(t, b)
    j = jvg.insert(j, cloud_to_jax(b))
    assert_same_grid(t.packed, j.packed)
    center = np.array([1.0, -2.0, 0.5], np.float32)
    t = tvg.decay(t, torch.from_numpy(center), 5.0)
    j = jvg.decay(j, jnp.asarray(center), 5.0)
    assert_same_grid(t.packed, j.packed)


def test_lookup_rows_and_slots_match_reference():
    pc = cloud(7)
    t = tvg.build(pc, 0.5, 1 << 13, min_points=3)
    j = jvg.build(cloud_to_jax(pc), 0.5, 1 << 13, min_points=3)
    q = cloud(8).xyz
    for nb in ("direct1", "direct7", "direct27"):
        rt, ft = tvg.lookup_rows(t, q, nb)
        rj, fj = jvg.lookup_rows(j, to_jax(q), nb)
        np.testing.assert_array_equal(ft.numpy(), np.asarray(fj))
        f = ft.numpy()
        np.testing.assert_allclose(rt.numpy()[f], np.asarray(rj)[f], atol=MOMENT_TOL, rtol=0)
    slot, found = tvg.lookup_slots(t, q)
    rows, f1 = jvg.lookup_rows(j, to_jax(q), "direct1")
    np.testing.assert_array_equal(found.numpy(), np.asarray(f1)[:, 0])
    # the slot addresses the same table row, bit for bit
    np.testing.assert_array_equal(t.packed[slot.long()].numpy(), rt_direct1(t, q))


def rt_direct1(grid, q):
    return tvg.lookup_rows(grid, q, "direct1")[0][:, 0].numpy()


BOUNDS = ((-150.0,) * 3, (150.0,) * 3)


@pytest.mark.parametrize("leaf", [0.5, 0.15])
def test_voxel_downsample_same_centroids_same_order_any_cloud(leaf):
    """The reference divides by a static `leaf`, which XLA turns into a
    multiply by the float32 reciprocal; the port multiplies by the same
    reciprocal, so even points within an ulp of a voxel face (a
    raycast scan has whole columns of them) land in the same cell."""
    pc = cloud(9, n=6000, extent=40.0)
    world = synthetic.default_world(0)
    traj = synthetic.circle_trajectory(2, radius=22.0, laps=0.02)
    scan = make_scans(world, traj, 1, seed=0, n_rings=16, n_azimuth=512)
    for c in (pc, tpcl.PointCloud(scan.xyz[0], scan.mask[0])):
        for cap in (4096, 1024):
            t = tpcl.voxel_downsample(c, leaf, cap, bounds=BOUNDS)
            j = jpcl.voxel_downsample(cloud_to_jax(c), leaf, cap, bounds=BOUNDS)
            np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
            np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz), atol=1e-5, rtol=0)


@pytest.mark.parametrize("leaf", [0.4, 0.15, 0.2])
def test_voxel_downsample_same_centroids_same_order_off_faces(leaf):
    """Leaves that are not powers of two, on points kept >= 10% of a leaf
    away from every voxel face."""
    rng = np.random.default_rng(10)
    cells = rng.integers(-200, 200, (5000, 3))
    frac = rng.uniform(0.1, 0.9, (5000, 3))
    lo = np.float32(-150.0)
    xyz = (lo + (cells + 400 + frac) * np.float32(leaf)).astype(np.float32)
    mask = rng.uniform(size=5000) < 0.95
    pc = tpcl.park(tpcl.PointCloud(torch.from_numpy(xyz), torch.from_numpy(mask)))
    t = tpcl.voxel_downsample(pc, leaf, 4096, bounds=BOUNDS)
    j = jpcl.voxel_downsample(cloud_to_jax(pc), leaf, 4096, bounds=BOUNDS)
    np.testing.assert_array_equal(t.mask.numpy(), np.asarray(j.mask))
    np.testing.assert_allclose(t.xyz.numpy(), np.asarray(j.xyz), atol=1e-4, rtol=0)


def test_voxel_downsample_batched_equals_per_item():
    clouds = [cloud(s, extent=30.0) for s in (11, 12)]
    batched = tpcl.PointCloud(torch.stack([c.xyz for c in clouds]),
                              torch.stack([c.mask for c in clouds]))
    out = tpcl.voxel_downsample(batched, 0.4, 2048)
    for k, c in enumerate(clouds):
        single = tpcl.voxel_downsample(c, 0.4, 2048)
        np.testing.assert_array_equal(out.xyz[k].numpy(), single.xyz.numpy())
        np.testing.assert_array_equal(out.mask[k].numpy(), single.mask.numpy())
