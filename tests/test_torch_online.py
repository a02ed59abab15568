"""The streaming entry point: `runtime.online.OnlineSlam` of the port
against the reference's on the same stream — 2 robots x 20 frames on
the radius-10 circle of `test_torch_pipeline.py` (phases 0 and 0.6 rad,
0.3 laps, 16x512 rays with 2 mm of jitter), interleaved as
`replay.synthetic_bag` stamps them (robot r's frame i at 0.1 i +
0.03 r), with GEM on, TF every 0.3 s and the merged map every 0.55 s.

Bounds: the same keyframe counts, `node_of` and accepted loop pairs;
keyframe ATE within 10 % + 2 cm; equal scheduler counters (TF
publishes, compose runs; shed frames under `map_every=3` and the
deadline monitor's counts, as `tests/test_scheduler.py` pins them for
the reference); one flushed GEM submap per keyframe in both; and
`global_elevation` on a shared state (the reference session's flushed
submaps, keyframe poses and optimized poses) within the elevation
tests' tolerance. The port runs on the CPU (`device="cpu"`)."""
import dataclasses

import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import metrics as tmet
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import config as tcfg
from mr_slam_torch.runtime import observability as tobs
from mr_slam_torch.runtime import online as tonline
from mr_slam_tpu.runtime import config as jcfg
from mr_slam_tpu.runtime import observability as jobs
from mr_slam_tpu.runtime import online as jonline
from tests.torch_parity import (
    cloud_to_jax, emap_to_torch, jitter, make_scans, pose_to_jax, to_torch,
)

N = 20


def config(m, **sched):
    return m.SlamConfig(
        n_robots=2,
        odometry=m.OdometryCfg(table_size=1 << 14, scan_capacity=2048, insert_capacity=4096),
        keyframes=m.KeyframeCfg(dist_thresh=1.5, capacity=32, points_per_kf=2048),
        loops=m.LoopCfg(dist_thresh=0.4, min_separation=4, verify_capacity=4096,
                        fitness_thresh=0.3),
        pgo=m.PGOCfg(node_capacity=128, edge_capacity=256),
        scheduler=m.SchedulerCfg(**sched),
    )


def stream(n=N, laps=0.3, n_robots=2):
    """(trajectories, [(stamp, robot, port cloud)]) in stamp order."""
    world = synthetic.default_world(0)
    trajs = [synthetic.circle_trajectory(n, radius=10.0, laps=laps, phase=p)
             for p in (0.0, 0.6)[:n_robots]]
    scans = [jitter(make_scans(world, t, n, seed=r), 0.002, 10 + r) for r, t in enumerate(trajs)]
    frames = sorted(
        (0.1 * i + 0.03 * r, r, tpcl.PointCloud(scans[r].xyz[i], scans[r].mask[i]))
        for r in range(n_robots) for i in range(n)
    )
    return trajs, frames


def run_both(cfg_kw, n=N, laps=0.3, n_robots=1, enable_gem=False, clear=True):
    """Both packages' sessions over one stream; returns (trajectories,
    port session, reference session, port counters, reference
    counters)."""
    trajs, frames = stream(n, laps, n_robots)
    port = tonline.OnlineSlam(config(tcfg, **cfg_kw), enable_gem=enable_gem, device="cpu")
    ref = jonline.OnlineSlam(config(jcfg, **cfg_kw), enable_gem=enable_gem)
    for r, t in enumerate(trajs):
        port.register_robot(r, tse3.index(t, 0))
        ref.register_robot(r, pose_to_jax(tse3.index(t, 0)))
    counters = []
    for sess, obs, conv in ((port, tobs, lambda c: c), (ref, jobs, cloud_to_jax)):
        obs.metrics.counters.clear()
        for stamp, r, cloud in frames:
            sess.add_frame(r, conv(cloud), stamp=stamp)
        counters.append(dict(obs.metrics.counters))
    return trajs, port, ref, counters[0], counters[1]


@pytest.fixture(scope="module")
def sessions():
    trajs, port, ref, pc, rc = run_both(
        dict(tf_period_s=0.3, compose_period_s=0.55), n_robots=2, enable_gem=True)
    return trajs, port, ref, port.result(), ref.result(), pc, rc


def loop_keys(res):
    return {(l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"]) for l in res.loops}


def test_same_keyframes_and_nodes(sessions):
    _, port, ref, pres, rres, _, _ = sessions
    for r in range(2):
        assert int(pres.robots[r].store.count) == int(rres.robots[r].store.count) >= 5
    assert port.node_of == ref.node_of
    np.testing.assert_array_equal(pres.node_of, rres.node_of)
    assert port.graph.n_nodes == int(ref.graph.n_nodes)
    assert port.graph.n_edges == int(ref.graph.n_edges)


def test_same_accepted_loops(sessions):
    _, _, _, pres, rres, _, _ = sessions
    inter = [l for l in rres.loops if l["robot_a"] != l["robot_b"]]
    assert len(inter) >= 1, "the reference accepts no inter-robot loop: scenario broken"
    assert loop_keys(pres) == loop_keys(rres)


def test_keyframe_ate_matches_reference(sessions):
    trajs, port, ref, pres, rres, _, _ = sessions
    from mr_slam_tpu.eval import metrics as jmet

    for r in range(2):
        # keyframe r of robot r was frame round((stamp - 0.03 r) / 0.1)
        K = int(pres.robots[r].store.count)
        frames = np.rint((pres.robots[r].store.stamps[:K].numpy() - 0.03 * r) / 0.1)
        true = tse3.index(trajs[r], torch.as_tensor(frames.astype(np.int64)))
        a_port = float(tmet.ate(pres.optimized_trajectory(r), true).rmse)
        a_ref = float(jmet.ate(rres.optimized_trajectory(r), pose_to_jax(true)).rmse)
        assert abs(a_port - a_ref) <= 0.1 * a_ref + 0.02, (r, a_port, a_ref)
        assert a_port < 0.3


def test_tf_and_compose_cadences_match_reference(sessions):
    _, port, ref, _, _, pc, rc = sessions
    for name in ("tf.publishes", "compose.runs"):
        assert pc[name] == rc[name] > 0, name
    assert port.tf.frames() == ref.tf.frames() == ["map", "robot_0/odom", "robot_1/odom"]
    assert bool(port.merged_map.mask.any())


def test_gem_flushes_one_submap_per_keyframe(sessions):
    _, port, ref, _, _, _, _ = sessions
    for r in range(2):
        K = port.kf_counts[r]
        assert len(port.robots[r]["gem_flushed"]) == len(ref.robots[r]["gem_flushed"]) == K
        assert [k for k, _ in port.robots[r]["gem_flushed"]] == list(range(K))


def test_session_files_cross_between_packages(sessions, tmp_path):
    """Each package's `save_session` of these sessions (loops, PCM
    candidates and exclude sets included) loads into the other."""
    from mr_slam_torch.runtime import checkpoint as tckpt
    from mr_slam_tpu.runtime import checkpoint as jckpt

    _, port, ref, _, _, _, _ = sessions
    tckpt.save_session(port, str(tmp_path / "port.npz"))
    jckpt.save_session(ref, str(tmp_path / "ref.npz"))
    into_ref = jckpt.load_session(str(tmp_path / "port.npz"))
    into_port = tckpt.load_session(str(tmp_path / "ref.npz"), device="cpu")
    for src, dst in ((port, into_ref), (ref, into_port)):
        assert dst.node_of == src.node_of and dst._searched == src._searched
        for name in ("loops", "_inter_candidates"):
            a, b = getattr(src, name), getattr(dst, name)
            assert len(a) == len(b) and len(b) >= 1, name
            for la, lb in zip(a, b):
                assert {k: v for k, v in la.items() if k != "rel"} == \
                    {k: v for k, v in lb.items() if k != "rel"}
                np.testing.assert_array_equal(np.asarray(la["rel"].R), np.asarray(lb["rel"].R))
                np.testing.assert_array_equal(np.asarray(la["rel"].t), np.asarray(lb["rel"].t))
        np.testing.assert_array_equal(np.asarray(dst.opt_poses.t), np.asarray(src.opt_poses.t))
    assert into_port.kf_counts == port.kf_counts


def test_global_elevation_matches_reference_on_shared_state(sessions):
    """The port's `global_elevation` on the reference session's flushed
    submaps, keyframe poses and optimized poses."""
    from mr_slam_torch.frontend import keyframes as tkf
    from mr_slam_torch.parallel import store as tstore

    _, port, ref, _, _, _, _ = sessions
    for r in range(2):
        port.robots[r]["gem_flushed"] = [
            (k, tpcl.PointCloud(to_torch(c.xyz), to_torch(c.mask)))
            for k, c in ref.robots[r]["gem_flushed"]
        ]
    s = ref.mstore.stores
    port.mstore = port.mstore._replace(stores=port.mstore.stores._replace(
        poses=tse3.Pose(to_torch(s.poses.R), to_torch(s.poses.t))))
    port.opt_poses = tse3.Pose(to_torch(ref.opt_poses.R), to_torch(ref.opt_poses.t))
    port._opt_n_nodes = ref._opt_n_nodes
    port.node_of = dict(ref.node_of)
    assert isinstance(port.mstore, tstore.MultiRobotStore)
    assert isinstance(port.mstore.stores, tkf.KeyframeStore)
    tm = port.global_elevation(size=200, center=(5.0, 3.0))
    jm = emap_to_torch(ref.global_elevation(size=200, center=(5.0, 3.0)))
    valid_t, valid_j = tm.valid.numpy(), jm.valid.numpy()
    n_valid = int(valid_j.sum())
    assert n_valid > 2000
    assert int((valid_t != valid_j).sum()) <= 0.001 * n_valid
    both = valid_t & valid_j
    np.testing.assert_allclose(tm.height.numpy()[both], jm.height.numpy()[both], rtol=0,
                               atol=1e-5)


# --------------------------------------------------------------------------
# every loop method through the session
# --------------------------------------------------------------------------

METHOD_GATES = dict(ring=0.04, ringpp=0.05, disco=0.4, m2dp=0.2, fasthist=0.01)


@pytest.mark.parametrize("method", list(METHOD_GATES))
def test_session_with_each_loop_method(method):
    """The stream of `sessions` (GEM off) with `LoopCfg.method` set
    (RING / RING++ cross-robot candidates verify from both SE(2) seeds):
    the same keyframes and nodes as the reference's session, the stored
    descriptors within the descriptor tests' bounds (DiSCO's spectra
    complex64 in both), >= 1 accepted loop in both, keyframe ATE within
    10 % + 2 cm (RING++: 5 cm) and < 0.3 m. Loop sets are not compared:
    among the near-equal descriptor distances of revisits on a small
    circle, rounding can pick another top-1 candidate, a true loop either
    way (the ATE bound holds them)."""
    from mr_slam_tpu.eval import metrics as jmet

    def cfg(m):
        c = config(m)
        return c.replace(loops=dataclasses.replace(c.loops, method=method,
                                                   dist_thresh=METHOD_GATES[method], bev_z_min=0.3))

    n_robots = 2
    trajs, frames = stream(N, 0.3, n_robots)
    port = tonline.OnlineSlam(cfg(tcfg), device="cpu")
    ref = jonline.OnlineSlam(cfg(jcfg))
    for r, t in enumerate(trajs):
        port.register_robot(r, tse3.index(t, 0))
        ref.register_robot(r, pose_to_jax(tse3.index(t, 0)))
    for stamp, r, cloud in frames:
        port.add_frame(r, cloud, stamp=stamp)
        ref.add_frame(r, cloud_to_jax(cloud), stamp=stamp)
    pres, rres = port.result(), ref.result()
    assert port.kf_counts == {r: int(c) for r, c in enumerate(ref.mstore.stores.count)}
    assert port.node_of == ref.node_of
    tol = dict(ringpp=5e-2, m2dp=5e-4, disco=1e-4).get(method, 1e-5)
    for name, got in port.mstore.descriptors.items():
        want = np.asarray(ref.mstore.descriptors[name])
        assert str(got.dtype).replace("torch.", "") == str(want.dtype), name
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=tol * max(np.abs(want).max(), 1e-30), err_msg=name)
    assert pres.loops and rres.loops, method
    # RING++'s descriptors part by up to 5e-2 (`test_torch_descriptors`),
    # enough to swap a retrieved candidate: its band is 10 % + 5 cm
    band = 0.05 if method == "ringpp" else 0.02
    for r in range(n_robots):
        K = port.kf_counts[r]
        kf_frames = np.rint((pres.robots[r].store.stamps[:K].numpy() - 0.03 * r) / 0.1)
        true = tse3.index(trajs[r], torch.as_tensor(kf_frames.astype(np.int64)))
        a_port = float(tmet.ate(pres.optimized_trajectory(r), true).rmse)
        a_ref = float(jmet.ate(rres.optimized_trajectory(r), pose_to_jax(true)).rmse)
        assert abs(a_port - a_ref) <= 0.1 * a_ref + band, (r, a_port, a_ref)
        assert a_port < 0.3


# --------------------------------------------------------------------------
# scheduler: two-rate shedding and the deadline monitor
# --------------------------------------------------------------------------


def test_map_every_sheds_as_reference():
    # small motion: only frame 0 registers a keyframe, so the
    # after-keyframe exemption covers frame 1 alone; of frames 1..11 the
    # multiples of 3 map and frame 1 is exempt -> 7 shed
    _, port, _, pc, rc = run_both(dict(map_every=3), n=12, laps=0.005)
    assert port.kf_counts[0] == 1
    assert pc["frontend.frames_shed"] == rc["frontend.frames_shed"] == 7


def test_deadline_monitor_counts_as_reference():
    # an impossible budget: every frame is over it; frames 2..7 shed
    _, _, _, pc, rc = run_both(dict(frame_budget_s=1e-9, shed=True), n=8, laps=0.005)
    assert pc["frontend.frames_over_budget"] == rc["frontend.frames_over_budget"] == 8
    assert pc["frontend.frames_shed"] == rc["frontend.frames_shed"] == 6


# --------------------------------------------------------------------------
# what the port leaves out, and the device rule
# --------------------------------------------------------------------------


def test_lio_front_end_raises():
    cfg = config(tcfg)
    lio = dataclasses.replace(cfg, odometry=tcfg.OdometryCfg(frontend="lio"))
    with pytest.raises(NotImplementedError, match="step 14"):
        tonline.OnlineSlam(lio, device="cpu").register_robot(0)
    overlay = dataclasses.replace(cfg, overlays=(
        tcfg.RobotOverlay(robot=1, odometry=tcfg.OdometryCfg(frontend="lio")),))
    sess = tonline.OnlineSlam(overlay, device="cpu")
    sess.register_robot(0)
    with pytest.raises(NotImplementedError, match="step 14"):
        sess.register_robot(1)


@pytest.mark.parametrize("kw", [dict(times=torch.zeros(8)), dict(imu=(None, None, None))])
def test_times_and_imu_raise(kw):
    sess = tonline.OnlineSlam(config(tcfg), device="cpu")
    cloud = tpcl.PointCloud(torch.zeros((8, 3)), torch.ones(8, dtype=torch.bool))
    with pytest.raises(NotImplementedError, match="step 14"):
        sess.add_frame(0, cloud, **kw)


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert tonline.OnlineSlam(config(tcfg)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            tonline.OnlineSlam(config(tcfg))
