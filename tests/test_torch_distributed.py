"""Edge-sharded chordal PGO of the port (`backend/distributed.py`) on 2
and 4 gloo ranks on the CPU, against the reference's `shard_map`
optimizer on as many virtual devices and against the port's own
single-process solve.

Tolerances: 1e-3 against the reference, as `test_torch_backend.py`
holds chordal (same CG iterations in f32 from the same start; the
scatter sums run in another order); 1e-4 against the port's single
process (the same arithmetic, only the all-reduce's order of summing
the ranks' partials differs); the ranks' poses bitwise equal (one
all-reduce gives every rank the same bits). The edge capacity (125)
divides by neither world size, so the padding runs too."""
import jax
import numpy as np
import pytest
import torch

from mr_slam_torch.backend import chordal as tch, distributed as tdist, factor_graph as tfg
from mr_slam_tpu.backend import distributed as jdist
from tests import torch_dist
from tests.test_backend import ate_rmse, build_circle_graph
from tests.torch_parity import graph_to_numpy, graph_to_torch, to_jax


@pytest.fixture(scope="module")
def circle():
    g, true, noisy = build_circle_graph(n=40, edge_cap=125)
    anchors = np.zeros(g.node_capacity, bool)
    anchors[0] = True
    return g, np.asarray(true.t), np.asarray(noisy.t), anchors


@pytest.fixture(scope="module", params=(2, 4), ids=("2ranks", "4ranks"))
def solved(request, circle, tmp_path_factory):
    g, _, _, anchors = circle
    world = request.param
    outs = torch_dist.run_ranks(torch_dist.distributed_pgo, world, tmp_path_factory.mktemp("pgo"),
                                graph_to_numpy(g), anchors, tch.PGOConfig())
    return world, outs


def test_ranks_bitwise_equal(solved):
    _, outs = solved
    for R, t in outs[1:]:
        assert np.array_equal(R, outs[0][0]) and np.array_equal(t, outs[0][1])


def test_matches_reference(solved, circle):
    g, _, _, anchors = circle
    world, outs = solved
    ref = jdist.optimize(g, to_jax(anchors), jax.make_mesh((world,), (jdist.AXIS,)))
    R, t = outs[0]
    np.testing.assert_allclose(t[:40], np.asarray(ref.t)[:40], atol=1e-3, rtol=0)
    np.testing.assert_allclose(R[:40], np.asarray(ref.R)[:40], atol=1e-3, rtol=0)


def test_matches_single_process(solved, circle):
    g, _, _, anchors = circle
    _, outs = solved
    single = tch.optimize(graph_to_torch(g), torch.from_numpy(anchors), tch.PGOConfig())
    R, t = outs[0]
    np.testing.assert_allclose(t[:40], single.t.numpy()[:40], atol=1e-4, rtol=0)
    np.testing.assert_allclose(R[:40], single.R.numpy()[:40], atol=1e-4, rtol=0)


def test_improves_ate(solved, circle):
    _, true_t, noisy_t, _ = circle
    _, outs = solved
    assert ate_rmse(outs[0][1][:40], true_t) < ate_rmse(noisy_t, true_t) * 0.5


@pytest.mark.parametrize("n_shards", (2, 3, 8))
def test_edge_sharding_pads(n_shards):
    g = tfg.init(8, 10)  # 10 edges: padded for 3 and 8 shards
    g2 = tdist.shard_edges(g, n_shards)
    E = g2.edge_capacity
    assert E % n_shards == 0 and E - 10 < n_shards
    assert g2.node_robot.shape[0] == 8 and g2.poses.t.shape[0] == 8
    assert not g2.edge_valid[10:].any() and not g2.edge_w_rot[10:].any()
    assert g2.edge_meas.R.shape == (E, 3, 3)
    # contiguous blocks, as shard_map cuts P(AXIS), covering every edge once
    g2 = g2._replace(edge_i=torch.arange(E))
    blocks = [tdist.edge_block(g2, n_shards, s).edge_i for s in range(n_shards)]
    assert torch.equal(torch.cat(blocks), torch.arange(E))
    assert {b.shape[0] for b in blocks} == {E // n_shards}
