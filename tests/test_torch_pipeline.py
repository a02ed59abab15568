"""The slice end to end: `runtime.pipeline.run` of the port against the
reference's on the same scans — 2 robots on a radius-10 circle (phases
0 and 0.6 rad, 0.3 laps), 20 frames each, 16x512 rays with 2 mm of
point jitter (`torch_parity.jitter`), small capacities.

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
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.runtime import pipeline as tpipe
from mr_slam_torch.runtime import config as tcfg
from mr_slam_tpu.eval import metrics as jmet
from mr_slam_tpu.runtime import config as jcfg
from mr_slam_tpu.runtime import pipeline as jpipe
from tests.torch_parity import cloud_to_jax, jitter, make_scans, pose_to_jax

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
    port = tpipe.run(scans, config(tcfg), origins=origins)
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
