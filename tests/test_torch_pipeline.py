"""The slice end to end: `runtime.pipeline.run` of the port against the
reference's on the same scans — 2 robots on a radius-10 circle (phases
0 and 0.6 rad, 0.3 laps), 20 frames each, 16x512 rays with 2 mm of
point jitter (`torch_parity.jitter`), small capacities.

The products of a finished run (`build_elevation`, `compose_map`) are
compared on a result both packages share exactly: keyframes gated from
the same scans, ground-truth poses standing in for the optimized ones
(`torch_parity.slam_result_to_jax`).

Bounds: the reference finds >= 1 inter-robot loop; both packages accept
the same (robot, keyframe) loop pairs; per-robot keyframe ATE agrees
within 10% + 2 cm. Trajectories are compared by ATE, not pose by pose:
per-frame odometry poses differ by millimetres through the f32 moment
pooling of the point-to-plane association (see `test_torch_frontend`)."""
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import metrics as tmet
from mr_slam_torch.frontend import keyframes as tkf
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import pipeline as tpipe
from mr_slam_torch.runtime import config as tcfg
from mr_slam_tpu.eval import metrics as jmet
from mr_slam_tpu.runtime import config as jcfg
from mr_slam_tpu.runtime import pipeline as jpipe
from tests.torch_parity import (
    cloud_to_jax, costmap_to_torch, emap_to_torch, jitter, make_scans, pose_to_jax,
    slam_result_to_jax,
)

N = 20


def config(m):
    return m.SlamConfig(
        n_robots=2,
        odometry=m.OdometryCfg(table_size=1 << 14, scan_capacity=2048, insert_capacity=4096),
        keyframes=m.KeyframeCfg(dist_thresh=1.5, capacity=32, points_per_kf=2048),
        loops=m.LoopCfg(dist_thresh=0.4, min_separation=4, verify_capacity=4096,
                        fitness_thresh=0.3),
        pgo=m.PGOCfg(node_capacity=128, edge_capacity=256),
    )


@pytest.fixture(scope="module")
def runs():
    world = synthetic.default_world(0)
    trajs = [synthetic.circle_trajectory(N, radius=10.0, laps=0.3, phase=p) for p in (0.0, 0.6)]
    scans = [jitter(make_scans(world, t, N, seed=r, n_rings=16, n_azimuth=512), 0.002, 10 + r)
             for r, t in enumerate(trajs)]
    origins = [tse3.index(t, 0) for t in trajs]
    port = tpipe.run(scans, config(tcfg), origins=origins, device="cpu")
    ref = jpipe.run([cloud_to_jax(s) for s in scans], config(jcfg),
                    origins=[pose_to_jax(o) for o in origins])
    return trajs, port, ref


def loop_keys(res):
    return {(l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"]) for l in res.loops}


def test_same_accepted_loops(runs):
    _, port, ref = runs
    inter = [l for l in ref.loops if l["robot_a"] != l["robot_b"]]
    assert len(inter) >= 1, "the reference finds no inter-robot loop: scenario broken"
    assert loop_keys(port) == loop_keys(ref)


def test_keyframe_ate_matches_reference(runs):
    trajs, port, ref = runs
    for r in range(2):
        assert int(port.robots[r].store.count) == int(ref.robots[r].store.count)
        kf = port.robots[r].kf_frame_idx
        a_port = float(tmet.ate(port.optimized_trajectory(r),
                                tse3.index(trajs[r], torch.as_tensor(kf))).rmse)
        jkf = ref.robots[r].kf_frame_idx
        a_ref = float(jmet.ate(ref.optimized_trajectory(r),
                               pose_to_jax(tse3.index(trajs[r], torch.as_tensor(jkf)))).rmse)
        assert abs(a_port - a_ref) <= 0.1 * a_ref + 0.02, (r, a_port, a_ref)
        assert a_port < 0.3


def test_graph_matches_reference(runs):
    _, port, ref = runs
    assert port.graph.n_nodes == int(ref.graph.n_nodes)
    assert port.graph.n_edges == int(ref.graph.n_edges)
    np.testing.assert_array_equal(port.node_of, ref.node_of)


# --------------------------------------------------------------------------
# products of a finished run: merged elevation map, costmap, merged cloud
# --------------------------------------------------------------------------


def shared_result(n_frames=24, n_robots=2):
    """A port `SlamResult` whose optimized poses are the ground truth:
    keyframes gated every 1.5 m from 16x512 scans of a radius-10 circle
    (`keyframes.maybe_add`), nodes numbered robot by robot."""
    world = synthetic.default_world(0)
    robots, poses, node_of = [], [], -np.ones((n_robots, 16), np.int64)
    for r in range(n_robots):
        traj = synthetic.circle_trajectory(n_frames, radius=10.0, laps=0.5, phase=1.7 * r)
        scans = make_scans(world, traj, n_frames, seed=30 + r, n_rings=16, n_azimuth=512)
        store = tkf.init(16, 2048)
        for i in range(n_frames):
            store, _ = tkf.maybe_add(store, tpcl.PointCloud(scans.xyz[i], scans.mask[i]),
                                     tse3.index(traj, i), torch.tensor(float(i)),
                                     dist_thresh=1.5, leaf=0.2)
        K = int(store.count)
        kf_idx = store.stamps[:K].numpy().astype(np.int64)
        node_of[r, :K] = len(poses) + np.arange(K)
        poses += [tse3.index(traj, int(i)) for i in kf_idx]
        robots.append(tpipe.RobotResult(odom_poses=traj, store=store, kf_frame_idx=kf_idx))
    return tpipe.SlamResult(robots=robots, graph=None, opt_poses=tse3.stack(poses),
                            node_of=node_of, loops=[])


@pytest.fixture(scope="module")
def products():
    res = shared_result()
    jres = slam_result_to_jax(res)
    port = tpipe.build_elevation(res, tcfg.SlamConfig(), size=600)
    ref = jpipe.build_elevation(jres, jcfg.SlamConfig(), size=600)
    return res, jres, port, (emap_to_torch(ref[0]), None, costmap_to_torch(ref[2]))


def test_build_elevation_matches_reference(products):
    res, _, (tm, tf, tc), (jm, _, jc) = products
    assert all(int(r.store.count) >= 5 for r in res.robots)
    valid_t, valid_j = tm.valid.numpy(), jm.valid.numpy()
    n_valid = int(valid_j.sum())
    assert n_valid > 2000
    # a point an ulp from a cell face may land in the neighbour cell
    # (the keyframe transform is a matmul in both, summed in another order)
    differ = int((valid_t != valid_j).sum())
    assert differ <= 0.001 * n_valid, (differ, n_valid)
    both = valid_t & valid_j
    np.testing.assert_allclose(tm.height.numpy()[both], jm.height.numpy()[both], rtol=0, atol=1e-5)
    agree = float((tc.cost.numpy() == jc.cost.numpy()).mean())
    assert agree >= 0.995, agree


def test_build_elevation_costmap_has_free_and_lethal_cells(products):
    _, _, (tm, tf, tc), _ = products
    cost = tc.cost.numpy()
    assert (cost == 0).sum() > 100 and (cost == 100).sum() > 10
    assert (cost[~tm.valid.numpy()] == -1).all()
    assert tf.traversability.shape == (600, 600)


def test_compose_map_matches_reference(products):
    res, jres, _, _ = products
    t = tpipe.compose_map(res)
    j = jpipe.compose_map(jres)
    tm, jm = t.mask.numpy(), np.asarray(j.mask)
    assert tm.sum() == jm.sum() > 1000
    np.testing.assert_allclose(t.xyz.numpy()[tm], np.asarray(j.xyz)[jm], rtol=0, atol=1e-5)
