"""The session's tick through its runners (`OnlineSlam.add_frame`: the
front-end step, the keyframe gate and the GEM tick as segments of
`runtime/frame_graph`, CUDA graphs on the card) against the eager tick
it replaces (`OnlineSlam._add_frame_eager`, the oracle), bit for bit:
returned poses, keyframe counts after every frame, the store's rows,
descriptors and flags, accepted loops, optimized poses, the GEM grids
and their flushed submaps.

On the CPU the runners run their segments eagerly; `replayed` re-runs
every segment after its first call on the buffers it first saw, writing
into the outputs it first returned, as a CUDA graph replays, keyed by
runner and name (every robot's runner has segments of the same names),
and forgets a segment its runner drops (a gate rebound to a reallocated
store). So the CPU checks that each frame's state flows through the
static buffers, and that a robot joining past the store's allocated
rows moves the other runners' gates onto the new store.

Sizes: 16x512 rays, 3 robots x 12 frames on radius-10 circles (2 mm of
jitter), the config of `tests/test_torch_online.py`; LIO: 2 robots, 3
frames at rest then 9, 10 IMU samples a frame. The `gpu` tests hold the
captured graphs to the eager tick on the card (the card machine has no
JAX):

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_online_graph.py
"""
import dataclasses

import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import replay as trep, synthetic
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import checkpoint as tckpt
from mr_slam_torch.runtime import config as tcfg
from mr_slam_torch.runtime import frame_graph, online as tonline, verify_graph
from torch_parity import jitter, make_scans, rest_then_circle

N = 12
N_ROBOTS = 3
JOIN = 6  # robot 2's first frame in the joining case


class EagerSlam(tonline.OnlineSlam):
    """The session with the eager tick: the oracle."""

    add_frame = tonline.OnlineSlam._add_frame_eager


def config(frontend="scan2map", **sched):
    return tcfg.SlamConfig(
        n_robots=N_ROBOTS,
        odometry=tcfg.OdometryCfg(frontend=frontend, table_size=1 << 14, scan_capacity=2048,
                                  insert_capacity=4096),
        keyframes=tcfg.KeyframeCfg(dist_thresh=1.5, capacity=32, points_per_kf=2048),
        loops=tcfg.LoopCfg(dist_thresh=0.4, min_separation=4, verify_capacity=4096,
                           fitness_thresh=0.3),
        pgo=tcfg.PGOCfg(node_capacity=128, edge_capacity=256),
        elevation=tcfg.ElevationCfg(size=60, resolution=0.4),
        scheduler=tcfg.SchedulerCfg(tf_period_s=0.3, **sched),
    )


def make_stream(laps):
    """Robot r's frame i stamped 0.1 i + 0.03 r, with its origin on frame
    0 and point times drawn in [0, 0.1)."""
    world = synthetic.default_world(0)
    trajs = [synthetic.circle_trajectory(N, radius=10.0, laps=laps, phase=p)
             for p in (0.0, 0.6, 1.2)]
    scans = [jitter(make_scans(world, t, N, seed=r), 0.002, 10 + r) for r, t in enumerate(trajs)]
    rng = np.random.default_rng(5)
    frames = [trep.Frame(stamp=0.1 * i + 0.03 * r, robot=r,
                         scan=tpcl.PointCloud(scans[r].xyz[i], scans[r].mask[i]),
                         origin=tse3.index(trajs[r], 0) if i == 0 else None,
                         times=torch.from_numpy(rng.uniform(0.0, 0.1, scans[r].mask[i].shape)
                                                .astype(np.float32)))
              for r in range(N_ROBOTS) for i in range(N)]
    return sorted(frames, key=lambda f: f.stamp)


@pytest.fixture(scope="module")
def stream():
    """1.6 m a frame: every frame adds a keyframe, and loops close."""
    return make_stream(0.3)


@pytest.fixture(scope="module")
def lio_stream():
    world = synthetic.default_world(0)
    trajs = [rest_then_circle(3, N - 3, radius=10.0, laps=0.15, phase=p) for p in (0.0, 0.6)]
    return trep.synthetic_bag(world, trajs, N, with_imu=True)


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    elif isinstance(dst, dict):
        for k in dst:
            _copy_into(dst[k], src[k])
    elif isinstance(dst, tuple):
        for d, s in zip(dst, src):
            _copy_into(d, s)


@pytest.fixture
def replayed(monkeypatch):
    """`Segments.run` as graph replays, per runner: the first call of a
    runner's segment runs it and keeps the buffer dict it saw and the
    outputs it gave; every later call runs it on those buffers and
    writes the results into those outputs. `Segments.drop` forgets the
    segment, as it forgets a graph. Starts from no verify runner."""
    calls = {}

    def run(self, name, fn, bufs):
        key = (self, name)
        if key not in calls:
            calls[key] = (dict(bufs), fn(bufs))
            return calls[key][1]
        seen, out = calls[key]
        _copy_into(out, fn(seen))
        return out

    def drop(self, name):
        return calls.pop((self, name), None) is not None

    verify_graph.clear()
    monkeypatch.setattr(frame_graph.Segments, "run", run)
    monkeypatch.setattr(frame_graph.Segments, "drop", drop)
    yield calls
    verify_graph.clear()


def feed(sess, frames, with_times=False):
    """Stream `frames` into `sess`; returns the returned poses and each
    frame's robot keyframe count after it."""
    poses, counts = [], []
    for f in frames:
        if f.robot not in sess.robots:
            sess.register_robot(f.robot, f.origin)
        poses.append(sess.add_frame(f.robot, f.scan, stamp=f.stamp,
                                    times=f.times if with_times else None, imu=f.imu))
        counts.append(sess.kf_counts[f.robot])
    return poses, counts


def assert_same_session(got, want, got_feed=None, want_feed=None):
    """Two sessions bit for bit (and what their streams returned)."""
    if got_feed is not None:
        (gp, gc), (wp, wc) = got_feed, want_feed
        assert gc == wc
        for a, b in zip(gp, wp):
            assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
    assert got.kf_counts == want.kf_counts and got.node_of == want.node_of
    gs, ws = got.mstore.stores, want.mstore.stores
    for f in ("xyz", "mask", "stamps", "count"):
        assert torch.equal(getattr(gs, f), getattr(ws, f)), f
    for f in ("poses", "last_pose"):
        assert torch.equal(getattr(gs, f).R, getattr(ws, f).R), f
        assert torch.equal(getattr(gs, f).t, getattr(ws, f).t), f
    assert torch.equal(got.mstore.desc_valid, want.mstore.desc_valid)
    for name, d in got.mstore.descriptors.items():
        assert torch.equal(d, want.mstore.descriptors[name]), name
    for r, rs in want.robots.items():
        gr = got.robots[r]
        for a, b in zip(tckpt.flatten(gr["odo"]), tckpt.flatten(rs["odo"])):
            assert a[0] == b[0] and (torch.equal(a[1], b[1]) if isinstance(a[1], torch.Tensor)
                                     else a[1] == b[1]), (r, a[0])
        if "gem_local" in rs:
            for f in ("height", "variance", "valid", "origin"):
                assert torch.equal(getattr(gr["gem_local"], f), getattr(rs["gem_local"], f)), f
            assert len(gr["gem_flushed"]) == len(rs["gem_flushed"]) == want.kf_counts[r]
            for (ka, ca), (kb, cb) in zip(gr["gem_flushed"], rs["gem_flushed"]):
                assert ka == kb and torch.equal(ca.xyz, cb.xyz) and torch.equal(ca.mask, cb.mask)
    gres, wres = got.result(), want.result()
    assert torch.equal(gres.opt_poses.R, wres.opt_poses.R)
    assert torch.equal(gres.opt_poses.t, wres.opt_poses.t)
    assert len(gres.loops) == len(wres.loops)
    for la, lb in zip(gres.loops, wres.loops):
        assert {k: v for k, v in la.items() if k != "rel"} == \
            {k: v for k, v in lb.items() if k != "rel"}
        assert torch.equal(la["rel"].R, lb["rel"].R) and torch.equal(la["rel"].t, lb["rel"].t)
    for r in want.robots:
        assert torch.equal(gres.robots[r].odom_poses.t, wres.robots[r].odom_poses.t)


def both(cfg, frames, enable_gem=False, with_times=False):
    graphs = tonline.OnlineSlam(cfg, enable_gem=enable_gem, device="cpu")
    eager = EagerSlam(cfg, enable_gem=enable_gem, device="cpu")
    return graphs, eager, feed(graphs, frames, with_times), feed(eager, frames, with_times)


@pytest.mark.parametrize("with_times", [False, True])
def test_scan2map_session_equals_eager(stream, replayed, with_times):
    """GEM off, with and without point times: every segment of every
    robot's runner replays from its second frame on."""
    graphs, eager, gf, ef = both(config(), stream, with_times=with_times)
    assert_same_session(graphs, eager, gf, ef)
    assert sum(eager.kf_counts.values()) >= 12 and eager.loops
    names = {name for s, name in replayed if isinstance(name, str)}
    assert {"coarse", "fine", "insert", "commit", "coarse_insert", "decay"} <= names
    assert len({s for s, _ in replayed}) >= N_ROBOTS  # one runner a robot (and the verify runner)
    stats = graphs.graph_stats()
    assert sorted(stats) == list(range(N_ROBOTS)) and all(s["frames"] == N for s in stats.values())


def test_map_every_shedding_equals_eager(replayed):
    """`map_every=3` at 0.5 m a frame (a keyframe every few frames):
    shed frames skip the insert, decay and coarse insert segments
    (deterministic, unlike the wall-clock deadline)."""
    from mr_slam_torch.runtime import observability as tobs

    tobs.metrics.counters.clear()
    graphs, eager, gf, ef = both(config(map_every=3), make_stream(0.1))
    assert tobs.metrics.counters["frontend.frames_shed"] >= 2 * 6  # both sessions
    assert_same_session(graphs, eager, gf, ef)


def test_gem_session_equals_eager(stream, replayed):
    """GEM on: the first tick without and the later ones with the
    motion update, on the runner's static map buffers."""
    graphs, eager, gf, ef = both(config(), stream, enable_gem=True)
    assert_same_session(graphs, eager, gf, ef)
    names = {name for _, name in replayed}
    assert {"gem_motion", "gem_moved"} <= names  # "gem", the first tick, runs eagerly


def test_lio_session_equals_eager(lio_stream, replayed):
    """LIO robots with GEM on: frame 0 gates the origin, later frames
    step the filter on their packet, the sweep end taken from it."""
    cfg = config("lio")
    graphs, eager, gf, ef = both(cfg, lio_stream, enable_gem=True)
    assert_same_session(graphs, eager, gf, ef)
    assert graphs.robots[0]["odo"].frame == N - 1
    assert {"step_first", "step"} <= {name for _, name in replayed}  # "origin" runs eagerly


def joining(stream):
    """Robots 0 and 1 from frame 0, robot 2 from frame JOIN on (its first
    frame carrying its origin)."""
    origin = next(f.origin for f in stream if f.robot == 2)
    return [dataclasses.replace(f, origin=origin) if f.robot == 2 else f
            for f in stream if f.robot < 2 or f.stamp >= 0.1 * JOIN]


def join_sessions(stream, dev):
    """The joining stream through a runner session and an eager one,
    robots 0 and 1 registered before it starts."""
    sessions = (tonline.OnlineSlam(config(), device=dev), EagerSlam(config(), device=dev))
    feeds = []
    for sess in sessions:
        for r in (0, 1):
            sess.register_robot(r, next(f.origin for f in stream if f.robot == r))
        feeds.append(feed(sess, joining(stream)))
    return sessions, feeds


def test_robot_joining_mid_session_recaptures_the_gate(stream, replayed):
    """Robots 0 and 1 stream (their runners captured), then robot 2
    joins: the store grows from 2 to 4 rows, and the older runners move
    their gates onto the new tensors."""
    (graphs, eager), feeds = join_sessions(stream, "cpu")
    assert graphs.mstore.desc_valid.shape[0] == 4
    assert_same_session(graphs, eager, *feeds)
    stats = graphs.graph_stats()
    assert stats[0]["gate_recaptures"] == stats[1]["gate_recaptures"] == 1
    assert stats[2]["gate_recaptures"] == 0


def test_resume_equals_uninterrupted(stream, replayed, tmp_path):
    """A mid-stream save / load / continue (GEM on) through fresh
    runners built from the restored state, against the uninterrupted
    runner session and the eager one."""
    cfg = config()
    half = len(stream) // 2
    whole, eager, gf, ef = both(cfg, stream, enable_gem=True)
    part = tonline.OnlineSlam(cfg, enable_gem=True, device="cpu")
    feed(part, stream[:half])
    path = str(tmp_path / "session.npz")
    tckpt.save_session(part, path)
    resumed = tckpt.load_session(path, device="cpu")
    assert not resumed.graph_stats()
    rest = feed(resumed, stream[half:])
    assert_same_session(whole, eager, gf, ef)
    assert_same_session(resumed, whole, rest, (gf[0][half:], gf[1][half:]))
    assert all(s["frames"] == N - N // 2 for s in resumed.graph_stats().values())


def test_returned_pose_is_not_rewritten(stream, replayed):
    """The pose `add_frame` returns keeps its value after the next frame
    rewrites the runner's buffers (so does a result's odometry pose)."""
    sess = tonline.OnlineSlam(config(), device="cpu")
    mine = [f for f in stream if f.robot == 0][:3]
    sess.register_robot(0, mine[0].origin)
    first = sess.add_frame(0, mine[0].scan, stamp=mine[0].stamp)
    second = sess.add_frame(0, mine[1].scan, stamp=mine[1].stamp)
    kept = (second.R.clone(), second.t.clone())
    odom = sess.result().robots[0].odom_poses
    odom_t = odom.t.clone()
    sess.add_frame(0, mine[2].scan, stamp=mine[2].stamp)
    assert torch.equal(second.R, kept[0]) and torch.equal(second.t, kept[1])
    assert torch.equal(odom.t, odom_t)
    assert not torch.equal(first.t, sess.robots[0]["odo"].pose.t)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runners capture CUDA graphs only there")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_scan2map_gem_graphs_equal_eager_on_card(stream, card):
    """scan2map with GEM on: the graph session against the eager one on
    the card, and every runner replays."""
    cfg = config()
    graphs = tonline.OnlineSlam(cfg, enable_gem=True, device=card)
    eager = EagerSlam(cfg, enable_gem=True, device=card)
    assert_same_session(graphs, eager, feed(graphs, stream, True), feed(eager, stream, True))
    for s in graphs.graph_stats().values():
        assert s["captures"] >= 8 and s["replays"] >= 4 * (N - 1)


@pytest.mark.gpu
def test_lio_graphs_equal_eager_on_card(lio_stream, card):
    cfg = config("lio")
    graphs = tonline.OnlineSlam(cfg, enable_gem=True, device=card)
    eager = EagerSlam(cfg, enable_gem=True, device=card)
    assert_same_session(graphs, eager, feed(graphs, lio_stream), feed(eager, lio_stream))
    for s in graphs.graph_stats().values():
        assert s["captures"] >= 3 and s["replays"] >= 2 * (N - 2)


@pytest.mark.gpu
def test_robot_joining_recaptures_on_card(stream, card):
    """The store's reallocation on the card: the older runners' gate
    graphs are captured anew, and the session stays bit-equal."""
    (graphs, eager), feeds = join_sessions(stream, card)
    assert_same_session(graphs, eager, *feeds)
    stats = graphs.graph_stats()
    assert stats[0]["gate_recaptures"] == stats[1]["gate_recaptures"] == 1
