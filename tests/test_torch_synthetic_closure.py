"""The rest of the synthetic-data module against the reference:
`multi_robot_trajectories`, `perturb_trajectory`'s composition fed the
reference's own draws, and `scan_batch` (noise-free, so both packages
raycast the same rays)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic as tsyn
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_tpu.datasets import synthetic as jsyn
from tests.torch_parity import pose_to_jax, to_torch


def test_multi_robot_trajectories():
    """Within 5e-5 m / 1e-6 in R, not 1e-6 m: the reference takes the
    circle's angles in float32, the port's `circle_trajectory` rounds
    float64 angles once, and an ulp of a 7 rad angle is 3e-5 m on the
    30 m circle."""
    got = tsyn.multi_robot_trajectories(3, 20)
    ref = jsyn.multi_robot_trajectories(3, 20)
    assert got.t.shape == (3, 20, 3) and got.R.shape == (3, 20, 3, 3)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-6, rtol=0)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=5e-5, rtol=0)


@pytest.mark.parametrize("sigmas", [(0.02, 0.002), (0.05, 0.004)])
def test_perturb_with_the_reference_draws(sigmas):
    trans_sigma, rot_sigma = sigmas
    traj = tsyn.circle_trajectory(24, radius=10.0, laps=0.8)
    key = jax.random.PRNGKey(7)
    k1, k2 = jax.random.split(key)
    dt = trans_sigma * jax.random.normal(k1, (23, 3))
    dw = rot_sigma * jax.random.normal(k2, (23, 3))
    got = tsyn._perturb_with(traj, to_torch(dt), to_torch(dw))
    ref = jsyn.perturb_trajectory(key, pose_to_jax(traj), trans_sigma, rot_sigma)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(ref.t), atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(ref.R), atol=1e-5, rtol=0)
    assert float(torch.abs(got.t - traj.t).max()) > 0.05  # the drift is there


def test_perturb_trajectory_draws_then_composes():
    traj = tsyn.circle_trajectory(12, radius=10.0, laps=0.5)
    got = tsyn.perturb_trajectory(traj, 0.02, 0.002, rng=np.random.default_rng(3))
    rng = np.random.default_rng(3)
    dt = torch.from_numpy((0.02 * rng.standard_normal((11, 3))).astype(np.float32))
    dw = torch.from_numpy((0.002 * rng.standard_normal((11, 3))).astype(np.float32))
    want = tsyn._perturb_with(traj, dt, dw)
    assert torch.equal(got.t, want.t) and torch.equal(got.R, want.R)
    still = tsyn.perturb_trajectory(traj, 0.0, 0.0)
    np.testing.assert_allclose(still.t.numpy(), traj.t.numpy(), atol=1e-5)


def test_scan_batch_matches_the_reference():
    """Hit masks equal and points within 1e-5 m + 2e-6 of their range,
    on 3 frames at 16 x 256. Not 1e-5 m flat: a point goes to the world
    frame and back (sensor 20 m from the origin, hits up to 80 m out),
    and the two packages' matrix products round that trip ~10 ulp apart
    (4.96e-5 m at 46 m; the port's frame-by-frame numpy `scan` parts
    from the reference by 4.6e-5 m the same way)."""
    world = tsyn.default_world(3)
    jworld = jsyn.World(jnp.asarray(world.boxes))
    traj = tsyn.circle_trajectory(3, radius=20.0, laps=0.2)
    got = tsyn.scan_batch(world, traj, n_rings=16, n_azimuth=256, noise=0.0)
    keys = jax.random.split(jax.random.PRNGKey(0), 3)
    ref = jsyn.scan_batch(jworld, pose_to_jax(traj), keys, n_rings=16, n_azimuth=256, noise=0.0)
    assert got.xyz.shape == (3, 16 * 256, 3)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))
    assert int(got.mask.sum()) > 3 * 16 * 256 // 2
    ref_xyz = np.asarray(ref.xyz)
    err = np.abs(got.xyz.numpy() - ref_xyz).max(axis=-1)[got.mask.numpy()]
    rng = np.linalg.norm(ref_xyz, axis=-1)[got.mask.numpy()]
    assert np.all(err <= 1e-5 + 2e-6 * rng), (err.max(), (err / rng).max())


def test_scan_batch_is_scan_frame_by_frame():
    """One (T, R, A) noise draw is the frames' draws in sequence."""
    world = tsyn.default_world(5)
    traj = tsyn.circle_trajectory(3, radius=20.0, laps=0.2)
    got = tsyn.scan_batch(world, traj, n_rings=8, n_azimuth=128, rng=np.random.default_rng(9))
    rng = np.random.default_rng(9)
    for i in range(3):
        xyz, _, hit = tsyn.scan(world, tse3.index(traj, i), n_rings=8, n_azimuth=128, rng=rng)
        want = tsyn.scan_to_cloud(xyz, hit)
        assert torch.equal(got.mask[i], want.mask)
        np.testing.assert_allclose(got.xyz[i].numpy(), want.xyz.numpy(), atol=5e-6, rtol=0)
