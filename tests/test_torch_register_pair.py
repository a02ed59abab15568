"""The registration selector `register_pair` against the reference on
the reference's `TestMethodSelector` scene (ground + two walls, 4096
points): all four methods recover the true transform to 0.05 m / 0.02
rad in both packages, the packages agree to 1e-3 m, and fitness agrees
to 0.05 (the rule of `test_torch_loopstage.py`: fitness on the
permissive grid is decided by rounding noise in rank-1 cells).

The scene is the reference's own draw, reproduced bit for bit in numpy
by `chip_smoke.selector_scene` (jax.random's threefry, which the card's
smoke run needs without JAX). The reference draws each wall's two
in-plane coordinates from one key, so each wall is a dense diagonal
line. VGICP's recovery on this scene depends on the draw: on 20 numpy
draws of the same distribution (`default_rng(0..19)`) it ends within
0.05 m in 3, in both packages alike."""
import numpy as np
import pytest
import torch

from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_torch.ops import pointcloud as tpcl, registration as treg
from mr_slam_tpu.geometry import se3 as jse3
from mr_slam_tpu.ops import registration as jreg
from chip_smoke import selector_scene
from tests.torch_parity import cloud_to_jax, rot_diff_deg

TRUE = tse3.Pose(tso3.exp(torch.tensor([0.02, -0.01, 0.05])), torch.tensor([0.3, -0.2, 0.1]))


def test_selector_scene_is_the_references():
    from tests.test_registration import TestMethodSelector

    ref = TestMethodSelector()._scene()
    got = selector_scene()
    np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(ref.xyz))
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(ref.mask))


@pytest.fixture(scope="module")
def scene():
    target = selector_scene()
    return tpcl.transform(target, tse3.inverse(TRUE)), target


@pytest.mark.parametrize("method", ["icp", "gicp", "vgicp", "point_to_plane"])
def test_register_pair_matches_reference(scene, method):
    src, target = scene
    res = treg.register_pair(src, target, tse3.identity(), method=method, iters=25)
    ref = jreg.register_pair(cloud_to_jax(src), cloud_to_jax(target), jse3.identity(),
                             method=method, iters=25)
    for pose in (res.pose, ref.pose):
        R, t = np.asarray(pose.R), np.asarray(pose.t)
        np.testing.assert_allclose(t, TRUE.t.numpy(), atol=0.05)
        assert np.radians(rot_diff_deg(R, TRUE.R.numpy())) < 0.02
    # point_to_plane within 5e-3 m, not 1e-3: its cells on the walls'
    # noise-free lines are rank-1, so whether one counts as a plane
    # (lambda0 < 0.1 lambda1) is decided by f32 rounding in both
    # packages: 1263 against 1366 inliers, fixed points 3.0e-3 m apart,
    # each within 4e-3 m of the truth
    agree = 5e-3 if method == "point_to_plane" else 1e-3
    np.testing.assert_allclose(res.pose.t.numpy(), np.asarray(ref.pose.t), atol=agree)
    np.testing.assert_allclose(float(res.fitness), float(ref.fitness), atol=0.05)
    assert float(res.fitness) < 0.1


def test_register_pair_rejects_an_unknown_method(scene):
    src, target = scene
    with pytest.raises(ValueError):
        treg.register_pair(src, target, tse3.identity(), method="ndt")
