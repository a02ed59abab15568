"""The pose-graph generator and the independent reference solver of the
port against the reference's, and the accuracy gate they exist for:
`chordal.optimize` within 1.1x the reference solver's ATE.

`multi_robot_graph` draws its odometry drift with numpy (the reference
with `jax.random`), but chooses its loops on the true geometry with the
reference's own numpy generator: for one seed both packages build the
same nodes and edges, and the same loop measurements."""
import numpy as np
import pytest
import torch

from mr_slam_torch.backend import chordal as tch, factor_graph as tfg
from mr_slam_torch.eval import graphgen as tgg, reference_solver as trs
from mr_slam_tpu.eval import graphgen as jgg, reference_solver as jrs
from tests.torch_parity import graph_to_jax, graph_to_numpy, graph_to_torch

# the reference-parity optimization budget (`tests/test_reference_solver.py`)
FULL = tch.PGOConfig(rot_cg_iters=120, gn_iters=30, pose_cg_iters=120)


def ate(t: torch.Tensor, true, n: int) -> float:
    return float(torch.sqrt(torch.mean(torch.sum((t[:n].cpu() - true.t) ** 2, dim=-1))))


@pytest.mark.parametrize("kw", [dict(n_robots=3, nodes_per_robot=20, loop_stride=5),
                                dict(n_robots=2, nodes_per_robot=40, loop_stride=4,
                                     min_separation=10, outlier_frac=0.2)],
                         ids=["3x20", "2x40_outliers"])
def test_graph_matches_reference(kw):
    g, true, anchors, node_of = tgg.multi_robot_graph(**kw, seed=0, device="cpu")
    jg, jtrue, janchors, jnode_of = jgg.multi_robot_graph(**kw, seed=0)
    a, b = graph_to_numpy(g), graph_to_numpy(jg)
    assert a["n_nodes"] == b["n_nodes"] and a["n_edges"] == b["n_edges"]
    assert a["capacity"] == b["capacity"]
    for key in ("edge_i", "edge_j", "kind", "robot"):
        np.testing.assert_array_equal(a[key], b[key])
    np.testing.assert_array_equal(a["w_rot"], b["w_rot"])
    np.testing.assert_array_equal(node_of, jnode_of)
    np.testing.assert_array_equal(anchors.numpy(), np.asarray(janchors))
    loops = a["kind"] != tfg.ODOM
    assert loops.sum() >= 5 and (a["kind"] == tfg.INTER_LOOP).any()
    # true poses within 5e-5 m, not 1e-5: the 30 m circle's float32
    # angles round an ulp apart in the two packages' linspace at some
    # lengths (20 here), 3e-5 m on the circle
    np.testing.assert_allclose(true.t.numpy(), np.asarray(jtrue.t), atol=5e-5, rtol=0)
    np.testing.assert_allclose(true.R.numpy(), np.asarray(jtrue.R), atol=1e-6, rtol=0)
    # the same loop noise (and outliers) on those poses
    np.testing.assert_allclose(a["meas_t"][loops], b["meas_t"][loops], atol=5e-5, rtol=0)
    np.testing.assert_allclose(a["meas_R"][loops], b["meas_R"][loops], atol=1e-5, rtol=0)
    # the odometry chains drift (from the port's own draws)
    assert ate(g.poses.t, true, a["n_nodes"]) > 0.05


def test_graph_roundtrips_between_packages():
    g, *_ = tgg.multi_robot_graph(2, 10, loop_stride=3, min_separation=4, seed=3, device="cpu")
    back = graph_to_numpy(graph_to_torch(graph_to_jax(g)))
    for key, val in graph_to_numpy(g).items():
        np.testing.assert_array_equal(np.asarray(back[key]), np.asarray(val), err_msg=key)


def test_reference_solver_matches_the_references():
    """The reference's graph carried to the port: both solvers land
    within 1e-5 m of each other (the same float64 problem)."""
    jg, jtrue, janchors, _ = jgg.multi_robot_graph(2, 24, loop_stride=4, min_separation=8,
                                                   seed=1)
    g = graph_to_torch(jg)
    got = trs.solve(g, torch.from_numpy(np.array(janchors)))
    want = jrs.solve(jg, janchors)
    n = g.n_nodes
    np.testing.assert_allclose(got.t.numpy()[:n], np.asarray(want.t)[:n], atol=1e-5, rtol=0)
    np.testing.assert_allclose(got.R.numpy()[:n], np.asarray(want.R)[:n], atol=1e-5, rtol=0)
    # nodes past n_nodes keep their input pose
    np.testing.assert_array_equal(got.t.numpy()[n:], g.poses.t.numpy()[n:])


def test_reference_solver_converges_and_keeps_anchors():
    g, true, anchors, node_of = tgg.multi_robot_graph(2, 30, loop_stride=4, min_separation=10,
                                                      seed=0, device="cpu")
    n = g.n_nodes
    opt = trs.solve(g, anchors)
    assert ate(opt.t, true, n) < 0.5 * ate(g.poses.t, true, n)
    for r in range(2):
        k = int(node_of[r, 0])
        assert float(torch.linalg.norm(opt.t[k] - g.poses.t[k])) < 1e-2


def test_chordal_within_1p1_of_the_reference_solver():
    """The accuracy gate at a CPU-test size (2 robots x 60; the
    reference's `test_small_graph_gate` graph)."""
    g, true, anchors, _ = tgg.multi_robot_graph(2, 60, loop_stride=10, min_separation=15,
                                                seed=2, device="cpu")
    n = g.n_nodes
    ours = ate(tch.optimize(g, anchors, FULL).t, true, n)
    ref = ate(trs.solve(g, anchors).t, true, n)
    assert ref < 0.5 * ate(g.poses.t, true, n)
    assert ours <= 1.1 * ref, (ours, ref)


@pytest.mark.slow
def test_510_node_multirobot_gate():
    """The headline gate on `multi_robot_graph(3, 170, loop_stride=12,
    seed=0)`, slow as in the reference."""
    g, true, anchors, _ = tgg.multi_robot_graph(3, 170, loop_stride=12, seed=0, device="cpu")
    n = g.n_nodes
    assert n >= 500
    ours = ate(tch.optimize(g, anchors, FULL).t, true, n)
    ref = ate(trs.solve(g, anchors).t, true, n)
    assert ref < 0.5 * ate(g.poses.t, true, n)
    assert ours <= 1.1 * ref, (ours, ref)
