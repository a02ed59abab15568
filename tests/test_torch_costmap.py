"""The costmap of the port against the reference's
(`mapping/costmap.py`): the same int8 cost grids, bit for bit, from the
same elevation maps, features and clouds."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.mapping import costmap as tcm
from mr_slam_torch.mapping import elevation as tel
from mr_slam_tpu.mapping import costmap as jcm
from tests.test_torch_elevation import build
from tests.torch_parity import cloud_to_jax, costmap_to_jax, emap_to_jax, feats_to_jax


def test_cost_constants_match_reference():
    assert (tcm.FREE, tcm.LETHAL, tcm.UNKNOWN) == (int(jcm.FREE), int(jcm.LETHAL),
                                                   int(jcm.UNKNOWN))
    assert jcm.FREE.dtype == np.int8 and tcm.COST_DTYPE == torch.int8


@pytest.mark.parametrize("scene", ["step_wall", "tall_wall", "flat_ground", "scatter_3d"])
@pytest.mark.parametrize("thresh", [(0.4, 1.5), (0.7, 0.3)])
def test_from_elevation_matches_reference(scene, thresh):
    t, _ = build(scene)
    f = tel.features(t)
    travers, z = thresh
    tc = tcm.from_elevation(t, f, travers_thresh=travers, z_thresh=z)
    jc = jcm.from_elevation(emap_to_jax(t), feats_to_jax(f), travers_thresh=travers, z_thresh=z)
    assert tc.cost.dtype == torch.int8
    np.testing.assert_array_equal(tc.cost.numpy(), np.asarray(jc.cost))
    np.testing.assert_array_equal(tc.origin.numpy(), np.asarray(jc.origin))


def test_from_elevation_marks_wall():
    t, _ = build("tall_wall")
    cost = tcm.from_elevation(t, tel.features(t)).cost.numpy()
    valid = t.valid.numpy()
    assert (cost[valid] == 100).sum() > 10
    assert (cost[valid] == 0).sum() > 200
    assert (cost[~valid] == -1).all()


def rasterize_inputs(seed, n=2000):
    rng = np.random.default_rng(seed)
    xyz = np.concatenate([rng.uniform(-2, 12, (n, 2)), rng.uniform(-0.5, 3.0, (n, 1))], -1)
    mask = rng.random(n) > 0.1
    from mr_slam_torch.ops import pointcloud as tpcl

    pc = tpcl.park(tpcl.PointCloud(torch.from_numpy(xyz.astype(np.float32)),
                                   torch.from_numpy(mask)))
    return pc, torch.from_numpy(rng.random(n).astype(np.float32))


@pytest.mark.parametrize("seed,res,size", [(0, 0.5, 20), (1, 0.2, 48), (2, 0.25, 64)])
def test_rasterize_cloud_matches_reference(seed, res, size):
    pc, trav = rasterize_inputs(seed)
    origin = np.array([0.0, -1.0], np.float32)
    tc = tcm.rasterize_cloud(pc, trav, torch.from_numpy(origin), res, size)
    jc = jcm.rasterize_cloud(cloud_to_jax(pc), jnp.asarray(trav.numpy()), jnp.asarray(origin),
                             res, size)
    np.testing.assert_array_equal(tc.cost.numpy(), np.asarray(jc.cost))
    cost = tc.cost.numpy()
    assert (cost == 0).any() and (cost == 100).any()


def test_rasterize_cloud_marks_points():
    from mr_slam_torch.ops import pointcloud as tpcl

    pc = tpcl.PointCloud(torch.tensor([[1.0, 1.0, 0.0], [2.0, 2.0, 0.0], [3.0, 3.0, 2.5]]),
                         torch.ones(3, dtype=torch.bool))
    cost = tcm.rasterize_cloud(pc, torch.tensor([0.9, 0.2, 0.9]), torch.zeros(2), 0.5, 10).cost
    assert cost[2, 2] == 0 and cost[4, 4] == 100 and cost[6, 6] == 100 and cost[0, 0] == -1


@pytest.mark.parametrize("radius", [0, 1, 2, 3])
def test_inflate_matches_reference(radius):
    rng = np.random.default_rng(radius)
    cost = rng.choice(np.array([-1, 0, 100], np.int8), size=(17, 23), p=[0.3, 0.65, 0.05])
    cm = tcm.Costmap(torch.from_numpy(cost), torch.zeros(2), torch.tensor(0.5))
    t = tcm.inflate(cm, radius_cells=radius)
    j = jcm.inflate(costmap_to_jax(cm), radius_cells=radius)
    assert t.cost.dtype == torch.int8
    np.testing.assert_array_equal(t.cost.numpy(), np.asarray(j.cost))


def test_inflate_grows_an_obstacle():
    cost = torch.zeros((9, 9), dtype=torch.int8)
    cost[4, 4] = 100
    out = tcm.inflate(tcm.Costmap(cost, torch.zeros(2), torch.tensor(0.5)), radius_cells=2).cost
    assert out[2, 4] == 100 and out[6, 4] == 100 and out[0, 0] == 0
