"""The loop budget (`LoopCfg.max_loops`) truncates the verified loops in
robot-pair order, inter-robot pairs first, before PCM: when the
verified loops outnumber the budget, the last inter-robot pairs and
every self pair lose theirs. The reference does this
(`mr_slam_tpu/runtime/pipeline.py:611-614`) and the port reproduces it
(`mr_slam_torch/runtime/pipeline.py`, `run_backend`). The 500-frame long
run meets it on the card: 580 verified loops cut to its 256.

Both packages' `run_backend` run on one set of keyframe stores (true
poses, every frame a keyframe) with their loop search replaced by the
same canned, exactly consistent loops, LOOPS_PER_PAIR a robot pair;
the budget keeps the first MAX_LOOPS of them. Bounds: both packages
keep the same loops; they are the first pairs' in pair order; the
`backend.loops_found` counter is the budget."""
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.frontend import keyframes as tkf
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import config as tcfg
from mr_slam_torch.runtime import loopstage as tloop
from mr_slam_torch.runtime import observability as tobs
from mr_slam_torch.runtime import pipeline as tpipe
from tests.torch_parity import make_scans, pose_to_jax, slam_result_to_jax

R, FRAMES, LOOPS_PER_PAIR, MAX_LOOPS = 3, 6, 2, 5


def config(m):
    return m.SlamConfig(
        n_robots=R,
        keyframes=m.KeyframeCfg(dist_thresh=1.0, capacity=8, points_per_kf=1024),
        loops=m.LoopCfg(max_loops=MAX_LOOPS),
        pgo=m.PGOCfg(rot_cg_iters=10, gn_iters=2, pose_cg_iters=10, node_capacity=32,
                     edge_capacity=64),
    )


def robots():
    """Port `RobotResult`s: every frame of a radius-10 circle a keyframe
    at its true pose, 16 x 128 scans."""
    world = synthetic.default_world(0)
    out = []
    for r in range(R):
        traj = synthetic.circle_trajectory(FRAMES, radius=10.0, laps=0.4, phase=2.0 * r)
        scans = make_scans(world, traj, FRAMES, seed=r, n_rings=16, n_azimuth=128)
        store = tkf.init(8, 1024)
        for i in range(FRAMES):
            store, _ = tkf.maybe_add(store, tpcl.PointCloud(scans.xyz[i], scans.mask[i]),
                                     tse3.index(traj, i), torch.tensor(float(i)),
                                     dist_thresh=1.0, leaf=0.2)
        kf_idx = store.stamps[: int(store.count)].numpy().astype(np.int64)
        out.append(tpipe.RobotResult(odom_poses=traj, store=store, kf_frame_idx=kf_idx))
    return out


def canned_search(stores, poses, to_rel):
    """A `search_pair_loops` stand-in: LOOPS_PER_PAIR loops a pair,
    keyframe k of robot a to keyframe k + 1 of robot b, each with the
    exact relative transform of the true poses (b <- a points); the
    robots are told apart by their store objects."""
    def search(store_a, descs_a, store_b, descs_b, cfg, same_robot, **_):
        ra = next(r for r, s in enumerate(stores) if s is store_a)
        rb = next(r for r, s in enumerate(stores) if s is store_b)
        out = []
        for k in range(LOOPS_PER_PAIR):
            a, b = tse3.index(poses[ra], k), tse3.index(poses[rb], k + 1)
            rel = tse3.compose(tse3.inverse(b), a)
            out.append(dict(kf_a=k, kf_b=k + 1, rel=to_rel(rel), fitness=0.05, desc_dist=0.1))
        return out
    return search


@pytest.fixture(scope="module")
def runs():
    from mr_slam_tpu.runtime import config as jcfg
    from mr_slam_tpu.runtime import loopstage as jloop
    from mr_slam_tpu.runtime import observability as jobs
    from mr_slam_tpu.runtime import pipeline as jpipe

    port_robots = robots()
    jrobots = slam_result_to_jax(tpipe.SlamResult(
        robots=port_robots, graph=None, opt_poses=port_robots[0].odom_poses,
        node_of=np.zeros((R, 1), np.int64), loops=[])).robots
    poses = [rr.store.poses for rr in port_robots]
    mp = pytest.MonkeyPatch()
    try:
        port_stores = [rr.store for rr in port_robots]
        mp.setattr(tloop, "search_pair_loops", canned_search(port_stores, poses, lambda p: p))
        tobs.metrics.counters.clear()
        port = tpipe.run_backend(port_robots, config(tcfg))
        port_found = tobs.metrics.counters["backend.loops_found"]
        j_stores = [rr.store for rr in jrobots]
        mp.setattr(jloop, "search_pair_loops", canned_search(j_stores, poses, pose_to_jax))
        jobs.metrics.counters.clear()
        ref = jpipe.run_backend(jrobots, config(jcfg))
        ref_found = jobs.metrics.counters["backend.loops_found"]
    finally:
        mp.undo()
    return port, port_found, ref, ref_found


def keys(res):
    return [(l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"]) for l in res.loops]


def test_budget_cuts_in_pair_order_as_the_reference_does(runs):
    port, port_found, ref, ref_found = runs
    assert port_found == ref_found == MAX_LOOPS
    assert sorted(keys(port)) == sorted(keys(ref))
    # the inter-robot pairs (1, 0), (2, 0), (2, 1) sweep first; the
    # budget of 5 keeps (1, 0)'s and (2, 0)'s loops and one of (2, 1)'s,
    # and no self pair keeps any
    pairs = [(1, 0), (1, 0), (2, 0), (2, 0), (2, 1)]
    assert sorted((a, b) for a, _, b, _ in keys(port)) == sorted(pairs)
    assert all(a != b for a, _, b, _ in keys(port))
