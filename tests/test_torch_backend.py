"""Back-end of the port against the reference: chordal PGO on the
reference's synthetic multi-robot graphs (`eval/graphgen.py`), PCM
consistency and accept masks, and the factor-graph helpers.

Chordal bound: optimized positions within 1e-3 m of the reference's.
Both run the same CG iterations in f32 from the same start; only the
order of the scatter-add sums differs."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch import native
from mr_slam_torch.backend import chordal as tch, factor_graph as tfg, pcm as tpcm
from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_tpu.backend import chordal as jch, factor_graph as jfg, pcm as jpcm
from mr_slam_tpu.eval import graphgen
from tests.torch_parity import pose_to_jax, pose_to_torch, to_torch


def graph_to_torch(g: jfg.FactorGraph) -> tfg.FactorGraph:
    return tfg.FactorGraph(
        poses=pose_to_torch(g.poses), node_robot=to_torch(g.node_robot).long(),
        node_valid=to_torch(g.node_valid), n_nodes=int(g.n_nodes),
        edge_i=to_torch(g.edge_i).long(), edge_j=to_torch(g.edge_j).long(),
        edge_meas=pose_to_torch(g.edge_meas), edge_kind=to_torch(g.edge_kind).long(),
        edge_w_rot=to_torch(g.edge_w_rot), edge_w_trans=to_torch(g.edge_w_trans),
        edge_valid=to_torch(g.edge_valid), n_edges=int(g.n_edges),
    )


@pytest.mark.parametrize("seed,outliers", [(0, 0.0), (1, 0.1)])
def test_chordal_optimize_matches_reference(seed, outliers):
    g, true, anchors, node_of = graphgen.multi_robot_graph(
        n_robots=2, nodes_per_robot=40, radius=15.0, laps=1.5, loop_stride=8,
        min_separation=15, outlier_frac=outliers, seed=seed,
    )
    cfg = tch.PGOConfig()
    t = tch.optimize(graph_to_torch(g), to_torch(anchors), cfg)
    j = jch.optimize(g, anchors, jch.PGOConfig())
    valid = np.asarray(g.node_valid)
    np.testing.assert_allclose(t.t.numpy()[valid], np.asarray(j.t)[valid], atol=1e-3, rtol=0)
    np.testing.assert_allclose(t.R.numpy()[valid], np.asarray(j.R)[valid], atol=1e-3, rtol=0)


def test_rotation_init_matches_reference():
    g, *_ = graphgen.multi_robot_graph(n_robots=2, nodes_per_robot=30, seed=2)
    anchors = np.zeros(g.node_capacity, bool)
    anchors[0] = anchors[30] = True
    t = tch.rotation_init(graph_to_torch(g), torch.from_numpy(anchors), 60)
    j = jch.rotation_init(g, jnp.asarray(anchors), 60)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), atol=1e-4, rtol=0)


def loop_set(seed, L=12, n_bad=3):
    """L inter-robot loops between two drifting trajectories: consistent
    measurements plus `n_bad` gross outliers."""
    rng = np.random.default_rng(seed)
    ia = np.sort(rng.choice(60, L, replace=False))
    ib = np.sort(rng.choice(60, L, replace=False))
    ang_a = ia * 0.1
    ang_b = ib * 0.1 + 0.3
    pa = tse3.Pose(tso3.yaw_rot(torch.tensor(ang_a, dtype=torch.float32)),
                   torch.tensor(np.stack([10 * np.cos(ang_a), 10 * np.sin(ang_a), 0 * ang_a], 1),
                                dtype=torch.float32))
    pb = tse3.Pose(tso3.yaw_rot(torch.tensor(ang_b, dtype=torch.float32)),
                   torch.tensor(np.stack([10 * np.cos(ang_b), 10 * np.sin(ang_b), 0 * ang_b], 1),
                                dtype=torch.float32))
    meas = tse3.between(pa, pb)  # the cycle convention of consistency_matrix
    noise = tse3.exp(torch.tensor(rng.normal(0, 0.01, (L, 6)), dtype=torch.float32))
    meas = tse3.compose(noise, meas)
    bad = rng.choice(L, n_bad, replace=False)
    junk = tse3.exp(torch.tensor(rng.normal(0, 1.5, (n_bad, 6)), dtype=torch.float32))
    R, t = meas.R.clone(), meas.t.clone()
    R[bad] = tse3.compose(junk, tse3.index(meas, bad)).R
    t[bad] = tse3.compose(junk, tse3.index(meas, bad)).t
    return pa, pb, tse3.Pose(R, t), ia, ib, bad


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pcm_matches_reference(seed):
    pa, pb, meas, ia, ib, bad = loop_set(seed)
    valid = np.ones(len(ia), bool)
    kw = dict(threshold=2.204, idx_a=ia, idx_b=ib, odo_drift_t=0.02,
              odo_drift_r=0.002, step_len=2.0)
    M = tpcm.consistency_matrix(pa, pb, meas, torch.from_numpy(valid),
                                idx_a=torch.from_numpy(ia), idx_b=torch.from_numpy(ib),
                                odo_drift_t=0.02, odo_drift_r=0.002, step_len=2.0)
    jM = jpcm.consistency_matrix(pose_to_jax(pa), pose_to_jax(pb), pose_to_jax(meas),
                                 jnp.asarray(valid), idx_a=jnp.asarray(ia),
                                 idx_b=jnp.asarray(ib), odo_drift_t=0.02,
                                 odo_drift_r=0.002, step_len=2.0)
    # entries near the gate agree to 1e-3; the far ones (outlier cycles,
    # M ~ 1e3) are logs of large cycle rotations, where f32 arccos near
    # +-1 amplifies rounding, so they get 1e-2 relative
    M, jM = M.numpy(), np.asarray(jM)
    near = jM < 10.0
    np.testing.assert_allclose(M[near], jM[near], rtol=1e-3, atol=1e-3)
    np.testing.assert_allclose(M, jM, rtol=1e-2, atol=1e-3)
    keep = tpcm.filter_loops(pa, pb, meas, valid, **kw)
    jkeep = jpcm.filter_loops(pose_to_jax(pa), pose_to_jax(pb), pose_to_jax(meas), valid, **kw)
    np.testing.assert_array_equal(keep, jkeep)
    assert not keep[bad].any() and keep.sum() >= len(ia) - len(bad) - 1


def test_chi2_table_is_the_reference_s():
    """The chi2 thresholds of the reference's pcm_thresh table, key for
    key and value for value."""
    assert tpcm.CHI2_6DOF == jpcm.CHI2_6DOF
    assert list(tpcm.CHI2_6DOF) == list(jpcm.CHI2_6DOF)


def test_native_max_clique_is_exact():
    adj = np.zeros((6, 6), bool)
    for a, b in [(0, 1), (0, 2), (1, 2), (2, 3), (3, 4), (4, 5), (3, 5)]:
        adj[a, b] = adj[b, a] = True
    assert sorted(native.max_clique(adj).tolist()) in ([0, 1, 2], [3, 4, 5])
    assert native.max_clique(np.zeros((0, 0), bool)).size == 0


def test_factor_graph_batch_writes_and_overflow():
    g = tfg.init(5, 4)
    poses = tse3.exp(torch.randn(4, 6) * 0.1)
    g, idx = tfg.add_nodes_batch(g, poses, torch.zeros(4, dtype=torch.long))
    assert g.n_nodes == 4 and idx.tolist() == [0, 1, 2, 3]
    g, idx = tfg.add_nodes_batch(g, poses, torch.ones(4, dtype=torch.long))
    assert g.n_nodes == 5 and idx.tolist() == [4, 5, 6, 7]  # 5..7 dropped
    assert g.node_valid.all() and g.node_robot.tolist() == [0, 0, 0, 0, 1]
    g, _ = tfg.add_edges_batch(g, torch.tensor([0, 3]), torch.tensor([1, 4]),
                               tse3.index(poses, slice(0, 2)), tfg.INTER_LOOP, 10.0, 10.0)
    assert g.n_edges == 2
    assert tfg.connected_robots(g, 2).tolist() == [True, True]
    assert tfg.key_to_robot_id(tfg.robot_id_to_key(2, 17)) == (2, 17)
    assert tfg.robot_id_to_key(1, 5) == jfg.robot_id_to_key(1, 5)
