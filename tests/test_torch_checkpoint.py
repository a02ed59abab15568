"""Checkpoint / resume (`runtime/checkpoint.py`) — the slice's function
for carrying state across, in both directions between the packages.

One robot with the config of `tests/test_session_resume.py` (GEM on),
8 frames of a radius-10 circle (16x256 rays, 2 mm jitter), cut at 4:

  * the port saves, loads into a fresh session and continues: the same
    optimized poses, odometry pose, keyframes, loops and GEM state as
    the uninterrupted port run, bit for bit;
  * a file written by the reference's `save_session` loads into the
    port, which continues the stream to the reference's keyframe count
    and loops, with keyframe ATE within 10 % + 2 cm of the reference's
    uninterrupted run;
  * a file written by the port loads into the reference's
    `load_session` with every leaf equal, and the reference continues it
    to its own uninterrupted keyframe count;
  * `save` / `restore` round-trip a tree with host-number leaves and
    raise on a shape mismatch or a missing leaf."""
import os

import jax
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import metrics as tmet
from mr_slam_torch.frontend import odometry as todo
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import checkpoint as tckpt
from mr_slam_torch.runtime import config as tcfg
from mr_slam_torch.runtime import online as tonline
from mr_slam_tpu.eval import metrics as jmet
from mr_slam_tpu.runtime import checkpoint as jckpt
from mr_slam_tpu.runtime import config as jcfg
from mr_slam_tpu.runtime import online as jonline
from tests.torch_parity import cloud_to_jax, jitter, make_scans, pose_to_jax

N, CUT = 8, 4


def config(m):
    return m.SlamConfig(
        odometry=m.OdometryCfg(scan_capacity=2048, insert_capacity=4096, table_size=1 << 15),
        keyframes=m.KeyframeCfg(dist_thresh=1.5, capacity=32, points_per_kf=2048),
        loops=m.LoopCfg(method="scancontext", dist_thresh=0.4, min_separation=4, candidates=2,
                        verify_capacity=4096, fitness_thresh=0.3),
        elevation=m.ElevationCfg(size=80, resolution=0.4),
    )


@pytest.fixture(scope="module")
def stream():
    world = synthetic.default_world(3)
    traj = synthetic.circle_trajectory(N, radius=10.0, laps=0.5)
    scans = jitter(make_scans(world, traj, N, seed=0, n_rings=16, n_azimuth=256), 0.002, 1)
    frames = [(tpcl.PointCloud(scans.xyz[i], scans.mask[i]), 0.1 * i) for i in range(N)]
    return traj, frames


def port_session(traj):
    s = tonline.OnlineSlam(config(tcfg), enable_gem=True, device="cpu")
    s.register_robot(0, tse3.index(traj, 0))
    return s


def ref_session(traj):
    s = jonline.OnlineSlam(config(jcfg), enable_gem=True)
    s.register_robot(0, pose_to_jax(tse3.index(traj, 0)))
    return s


def feed(sess, frames, jax_side=False):
    for cloud, stamp in frames:
        sess.add_frame(0, cloud_to_jax(cloud) if jax_side else cloud, stamp=stamp)


def ate(res, traj, package):
    K = int(res.robots[0].store.count)
    frames = np.rint(np.asarray(res.robots[0].store.stamps[:K]) / 0.1).astype(np.int64)
    true = tse3.index(traj, torch.as_tensor(frames))
    if package == "port":
        return float(tmet.ate(res.optimized_trajectory(0), true).rmse)
    return float(jmet.ate(res.optimized_trajectory(0), pose_to_jax(true)).rmse)


def loop_keys(res):
    return sorted((l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"]) for l in res.loops)


@pytest.fixture(scope="module")
def reference(stream, tmp_path_factory):
    """The reference's uninterrupted run, and its file saved at CUT."""
    traj, frames = stream
    whole = ref_session(traj)
    feed(whole, frames, jax_side=True)
    part = ref_session(traj)
    feed(part, frames[:CUT], jax_side=True)
    path = str(tmp_path_factory.mktemp("ref") / "sess.npz")
    jckpt.save_session(part, path)
    return whole, whole.result(), path


def test_port_resume_is_bit_identical(stream, tmp_path):
    traj, frames = stream
    whole = port_session(traj)
    feed(whole, frames)
    want = whole.result()
    part = port_session(traj)
    feed(part, frames[:CUT])
    path = os.path.join(tmp_path, "sess.npz")
    tckpt.save_session(part, path)
    feed(part, frames[CUT:CUT + 1])  # later writes must not reach the file
    resumed = tckpt.load_session(path, device="cpu")
    assert resumed.kf_counts == {0: int(resumed.mstore.stores.count[0])}
    feed(resumed, frames[CUT:])
    got = resumed.result()
    assert got.robots[0].store.count.item() == want.robots[0].store.count.item() >= 3
    assert loop_keys(got) == loop_keys(want)
    for a, b in zip(got.loops, want.loops):
        assert torch.equal(a["rel"].R, b["rel"].R) and torch.equal(a["rel"].t, b["rel"].t)
    assert torch.equal(got.opt_poses.R, want.opt_poses.R)
    assert torch.equal(got.opt_poses.t, want.opt_poses.t)
    assert torch.equal(got.robots[0].odom_poses.t, want.robots[0].odom_poses.t)
    assert resumed.node_of == whole.node_of
    gw, gr = whole.robots[0], resumed.robots[0]
    assert len(gr["gem_flushed"]) == len(gw["gem_flushed"]) == whole.kf_counts[0]
    assert torch.equal(gr["gem_local"].height, gw["gem_local"].height)
    em = resumed.global_elevation(size=128)
    assert torch.equal(em.height, whole.global_elevation(size=128).height)
    assert int(em.valid.sum()) > 100


def test_reference_file_continues_in_the_port(stream, reference):
    traj, frames = stream
    whole, want, path = reference
    sess = tckpt.load_session(path, device="cpu")
    assert sess.cfg == config(tcfg)
    assert sess.node_of == {(0, k): v for (_, k), v in jckpt.load_session(path).node_of.items()}
    feed(sess, frames[CUT:])
    got = sess.result()
    assert int(got.robots[0].store.count) == int(want.robots[0].store.count)
    assert loop_keys(got) == loop_keys(want)
    a_port, a_ref = ate(got, traj, "port"), ate(want, traj, "reference")
    assert abs(a_port - a_ref) <= 0.1 * a_ref + 0.02, (a_port, a_ref)


def test_port_file_loads_into_the_reference(stream, reference, tmp_path):
    traj, frames = stream
    whole, want, _ = reference
    part = port_session(traj)
    feed(part, frames[:CUT])
    path = os.path.join(tmp_path, "port.npz")
    tckpt.save_session(part, path)
    sess = jckpt.load_session(path)
    assert sess.node_of == part.node_of and sess._pending_kf == part._pending_kf
    for name, port_tree, ref_tree in (
        ("mstore", part.mstore, sess.mstore), ("graph", part.graph, sess.graph),
        ("odo", part.robots[0]["odo"], sess.robots[0]["odo"]),
        ("gem", part.robots[0]["gem_local"], sess.robots[0]["gem_local"]),
    ):
        pl = [tckpt.to_numpy(v) for _, v in tckpt.flatten(port_tree)]
        jl = [np.asarray(v) for v in jax.tree_util.tree_leaves(ref_tree)]
        assert len(pl) == len(jl), name
        for i, (a, b) in enumerate(zip(pl, jl)):
            np.testing.assert_array_equal(a, b, err_msg=f"{name}.{i}")
    assert len(sess.robots[0]["gem_flushed"]) == part.kf_counts[0]
    feed(sess, frames[CUT:], jax_side=True)
    assert int(sess.result().robots[0].store.count) == int(want.robots[0].store.count)


def test_save_restore_roundtrip_and_mismatch(tmp_path):
    ocfg = todo.OdometryConfig(table_size=1 << 8)
    state = todo.init(ocfg, device="cpu")
    state = state._replace(frame=5, pose=tse3.Pose(state.pose.R, torch.tensor([1.0, 2.0, 3.0])))
    path = os.path.join(tmp_path, "odo.npz")
    tckpt.save(path, state)
    back = tckpt.restore(path, todo.init(ocfg, device="cpu"))
    assert back.frame == 5 and isinstance(back.frame, int)
    assert back.grid.leaf == ocfg.map_leaf and isinstance(back.grid.leaf, float)
    assert torch.equal(back.pose.t, state.pose.t)
    with pytest.raises(ValueError, match="shape mismatch"):
        tckpt.restore(path, todo.init(todo.OdometryConfig(table_size=1 << 9), device="cpu"))
    with pytest.raises(KeyError, match="missing leaf"):
        tckpt.restore(path, {"other": torch.zeros(3)})
    # the reference reads the port's file
    jback = jckpt.restore(path, jax.tree.map(np.asarray, jax_odometry_state(ocfg)))
    assert int(jback.frame) == 5
    np.testing.assert_array_equal(np.asarray(jback.pose.t), [1.0, 2.0, 3.0])


def jax_odometry_state(ocfg):
    from mr_slam_tpu.frontend import odometry as jodo

    return jodo.init(jodo.OdometryConfig(table_size=ocfg.table_size))
