"""The port's tracer and the online session's spans and counters
(`mr_slam_torch/runtime/observability.py`).

- The key rule: a dotted name is its own key, a bare name nests under
  the open span's key, and a span's self time is its total less its
  children's.
- A short scan2map and LIO `OnlineSlam` session (and a batch
  `pipeline.run`) keep the keys the benchmark and the examples read,
  one span a call of what each wraps.
- Each `sync.<site>` counter moves, frame by frame, by the host waits
  its site makes for the work the frame did.
- `loops.corrected` counts each loop a solve kept once.
- Under `torch.profiler`, with the benchmark's mirror of the spans, each
  new sub-span's range lies inside its parent's.

Sizes: 16x512 rays, 3 robots x 12 frames at 1.6 m a frame on radius-10
circles (every frame adds a keyframe, loops close); LIO: 2 robots, 3
frames at rest then 9. The `gpu` test holds the counters to
`torch.cuda.set_sync_debug_mode("warn")` on the card:

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_observability.py
"""
import collections
import sys
import time
import warnings
from pathlib import Path

import pytest
import torch

from mr_slam_torch.backend import pcm
from mr_slam_torch.datasets import replay as trep, synthetic
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import config as tcfg
from mr_slam_torch.runtime import loopstage, online as tonline, pipeline as tpl
from mr_slam_torch.runtime import observability as obs
from mr_slam_torch.runtime import solve_graph, verify_graph
from torch_parity import jitter, make_scans, rest_then_circle

N = 12
N_ROBOTS = 3
SVD_SYNCS = 2  # host waits of one `so3.project` on the card
# the keys the benchmark reads (`slambench/harness.py`, `drive.py`, `metrics/`)
BENCH_KEYS = ("online.frontend", "online.compose", "online.pcm", "online.solve",
              "loop.retrieve", "loop.verify")


def config(frontend="scan2map"):
    return tcfg.SlamConfig(
        n_robots=N_ROBOTS,
        odometry=tcfg.OdometryCfg(frontend=frontend, table_size=1 << 14, scan_capacity=2048,
                                  insert_capacity=4096),
        keyframes=tcfg.KeyframeCfg(dist_thresh=1.5, capacity=32, points_per_kf=2048),
        loops=tcfg.LoopCfg(dist_thresh=0.4, min_separation=4, verify_capacity=4096,
                           fitness_thresh=0.3),
        pgo=tcfg.PGOCfg(node_capacity=128, edge_capacity=256, rot_cg_iters=10, gn_iters=3,
                        pose_cg_iters=10),
        scheduler=tcfg.SchedulerCfg(tf_period_s=0.3, compose_period_s=0.5),
    )


@pytest.fixture(scope="module")
def scans():
    world = synthetic.default_world(0)
    trajs = [synthetic.circle_trajectory(N, radius=10.0, laps=0.3, phase=p)
             for p in (0.0, 0.6, 1.2)]
    return trajs, [jitter(make_scans(world, t, N, seed=r), 0.002, 10 + r)
                   for r, t in enumerate(trajs)]


@pytest.fixture(scope="module")
def stream(scans):
    trajs, clouds = scans
    frames = [trep.Frame(stamp=0.1 * i + 0.03 * r, robot=r,
                         scan=tpcl.PointCloud(clouds[r].xyz[i], clouds[r].mask[i]),
                         origin=tse3.index(trajs[r], 0) if i == 0 else None)
              for r in range(N_ROBOTS) for i in range(N)]
    return sorted(frames, key=lambda f: f.stamp)


@pytest.fixture(scope="module")
def lio_stream():
    world = synthetic.default_world(0)
    trajs = [rest_then_circle(3, N - 3, radius=10.0, laps=0.15, phase=p) for p in (0.0, 0.6)]
    return trep.synthetic_bag(world, trajs, N, with_imu=True)


@pytest.fixture
def fresh():
    """Empty tracer and counters, and no runner of an earlier session."""
    obs.tracer.stats.clear()
    obs.metrics.counters.clear()
    verify_graph.clear()
    solve_graph.clear()
    yield
    verify_graph.clear()
    solve_graph.clear()


def test_dotted_names_are_keys_and_bare_names_nest():
    t = obs.Tracer()
    for _ in range(2):
        with t.span("robot0"):
            with t.span("frontend"):
                with t.span("online.frontend.project"):
                    time.sleep(0.001)
            with t.span("loop.verify"):
                pass
    with t.span("backend.associate"):
        with t.span("pairs"):
            pass
    st = t.stats
    assert set(st) == {"robot0", "robot0.frontend", "online.frontend.project", "loop.verify",
                       "backend.associate", "backend.associate.pairs"}
    assert all(st[k].count == 2 for k in ("robot0", "robot0.frontend", "loop.verify"))
    assert st["robot0.frontend"].child_s == st["online.frontend.project"].total_s
    assert st["robot0"].child_s == pytest.approx(
        st["robot0.frontend"].total_s + st["loop.verify"].total_s, rel=1e-12)
    assert st["online.frontend.project"].child_s == 0.0
    for s in st.values():
        assert s.self_s == s.total_s - s.child_s and s.self_s >= 0.0
    rep = t.report()
    assert rep["robot0"]["self_ms"] == pytest.approx(1e3 * st["robot0"].self_s / 2)
    assert rep["robot0.frontend"]["mean_ms"] >= 1.0  # holds the 1 ms sleep


class Calls:
    """Counts the calls of wrapped functions and methods."""

    def __init__(self, monkeypatch):
        self.n = collections.Counter()
        self.mp = monkeypatch

    def wrap(self, owner, name, key=None, before=None):
        fn = getattr(owner, name)
        key = key or name

        def counted(*a, **kw):
            self.n[key] += 1
            if before is not None:
                before(*a, **kw)
            return fn(*a, **kw)

        self.mp.setattr(owner, name, counted)


def _watch(monkeypatch):
    """Wrap what the spans and sync sites follow, to count it apart."""
    calls = Calls(monkeypatch)
    calls.wrap(tonline.OnlineSlam, "compose_map")
    calls.wrap(tpl, "pcm_gate_inter_loops", "pcm")
    calls.wrap(pcm, "filter_loops")
    calls.wrap(loopstage, "retrieve")
    calls.wrap(loopstage, "search_pair_loops", "pairs")
    calls.wrap(verify_graph.Runner, "__call__", "chunks")
    calls.wrap(tonline.OnlineSlam, "optimize", "optimize",
               before=lambda sess: calls.n.update(with_loops=int(bool(sess.loops))))
    return calls


def _sync_counts() -> dict:
    return {k: v for k, v in obs.metrics.counters.items() if k.startswith("sync.")}


def _delta(after: dict, before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in after.items() if v != before.get(k, 0)}


def _covered(sess) -> int:
    """Robots whose keyframes all lie in the last solve: compose reads
    their optimized poses through one index copied to the card."""
    n = 0
    for r in sess.robots:
        K = sess.kf_counts[r]
        ids = [sess.node_of.get((r, k), -1) for k in range(K)]
        if K and sess.opt_poses is not None and all(0 <= i < sess._opt_n_nodes for i in ids):
            n += 1
    return n


def expected_syncs(sess, robot, frame, kf_added, d_spans, d_calls, d_counters) -> dict:
    """The host waits of one frame by site, from what the frame did."""
    want = {
        "sync.frontend.gate": 1,
        "sync.frontend.project": 2 * SVD_SYNCS if sess.robots[robot]["frontend"] == "scan2map"
        and frame > 0 else 0,
        "sync.keyframe.valid": kf_added,
        "sync.tf": 2 * d_counters.get("tf.publishes", 0),
        "sync.loop.count": 2 * d_calls["pairs"],
        "sync.loop.query": d_calls["pairs"],
        "sync.loop.retrieve": 6 * d_spans.get("loop.retrieve", 0),
        "sync.loop.chunk": 3 * d_calls["chunks"],
        "sync.loop.fitness": d_calls["chunks"],
        "sync.verify.project": 2 * SVD_SYNCS * d_calls["chunks"],
        "sync.pcm": 4 * d_calls["filter_loops"],
        "sync.solve.loops": 3 * d_calls["with_loops"],
        "sync.solve.anchors": d_calls["optimize"],
        "sync.solve.project": 2 * SVD_SYNCS * d_calls["optimize"],
        "sync.solve.end": d_spans.get("online.solve", 0),
        "sync.compose.ids": _covered(sess) * d_calls["compose_map"],
        "sync.compose.end": d_calls["compose_map"],
    }
    return {k: v for k, v in want.items() if v}


def run_session(frames, cfg, calls, device="cpu", check_frame=None):
    """Feed `frames` into a new session frame by frame; `check_frame`
    sees each frame's deltas. Returns the session and the frames fed."""
    sess = tonline.OnlineSlam(cfg, device=device)
    for f in frames:
        if f.robot not in sess.robots:
            sess.register_robot(f.robot, f.origin)
        frame, kf0 = sess.robots[f.robot]["frame"], sess.kf_counts[f.robot]
        spans0 = {k: v.count for k, v in obs.tracer.stats.items()}
        counters0, n0 = dict(obs.metrics.counters), collections.Counter(calls.n)
        scan = tpcl.PointCloud(f.scan.xyz.to(device), f.scan.mask.to(device))
        imu = None if f.imu is None else tuple(x.to(device) for x in f.imu)
        sess.add_frame(f.robot, scan, stamp=f.stamp, imu=imu)
        if check_frame is not None:
            d_spans = _delta({k: v.count for k, v in obs.tracer.stats.items()}, spans0)
            d_counters = _delta(dict(obs.metrics.counters), counters0)
            d_calls = collections.Counter(calls.n)
            d_calls.subtract(n0)
            check_frame(sess, f.robot, frame, sess.kf_counts[f.robot] - kf0, d_spans, d_calls,
                        d_counters)
    return sess


@pytest.mark.parametrize("frontend", ["scan2map", "lio"])
def test_session_keeps_the_benchmark_keys_and_counts_syncs_by_site(
        frontend, stream, lio_stream, fresh, monkeypatch):
    frames = stream if frontend == "scan2map" else lio_stream
    calls = _watch(monkeypatch)
    seen = collections.Counter()

    def check(sess, robot, frame, kf_added, d_spans, d_calls, d_counters):
        want = expected_syncs(sess, robot, frame, kf_added, d_spans, d_calls, d_counters)
        got = {k: v for k, v in d_counters.items() if k.startswith("sync.")}
        assert got == want, (robot, frame)
        seen.update(got)

    sess = run_session(frames, config(frontend), calls, check_frame=check)
    st = obs.tracer.stats
    assert st["online.frontend"].count == len(frames)
    assert st["online.frontend.gate_read"].count == len(frames)
    count = {k: v.count for k, v in st.items()}
    assert count.get("online.compose") == calls.n["compose_map"] > 0
    assert count.get("loop.retrieve") == calls.n["retrieve"] > 0
    assert count.get("loop.verify", 0) == calls.n["chunks"]
    assert count.get("online.pcm", 0) == calls.n["pcm"]
    assert count.get("online.solve", 0) == count.get("online.solve.prepare", 0) == \
        calls.n["optimize"]
    if frontend == "scan2map":  # candidates verify, loops are kept and solved
        assert calls.n["chunks"] and calls.n["pcm"] and calls.n["optimize"]
        assert all(k in st for k in BENCH_KEYS)
    assert st["online.keyframe"].count == st["online.describe"].count == sum(sess.kf_counts.values())
    assert st["online.loop_stage"].count >= st["online.solve"].count
    assert st["online.tf"].count == obs.metrics.counters["tf.publishes"] > 0
    if frontend == "scan2map":
        assert st["online.frontend.project"].count == 2 * (len(frames) - N_ROBOTS)
    else:
        assert "online.frontend.project" not in st
    # spans inside the loop stage keep their own keys
    assert not any(k.startswith("online.loop_stage.") or k.startswith("online.keyframe.")
                   for k in st)
    assert seen["sync.loop.retrieve"] and seen["sync.tf"]
    assert seen["sync.solve.project"] or frontend == "lio"
    assert "sync.solve.plan" not in seen  # the CPU's index plan reads nothing back


def test_loops_corrected_counts_each_kept_loop_once(stream, fresh, monkeypatch):
    kept = set()
    optimize = tonline.OnlineSlam.optimize

    def recorded(sess):
        kept.update((l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"]) for l in sess.loops)
        return optimize(sess)

    monkeypatch.setattr(tonline.OnlineSlam, "optimize", recorded)
    t0 = time.perf_counter()
    sess = run_session(stream, config(), Calls(monkeypatch))
    res = sess.result()
    c = obs.metrics.counters
    assert kept and c["loops.corrected"] == len(kept)
    assert {(l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"]) for l in res.loops} <= kept
    assert 0.0 < c["loops.correction_s"] < len(kept) * (time.perf_counter() - t0)


def test_batch_pipeline_keeps_its_keys(scans, fresh, monkeypatch):
    trajs, clouds = scans
    calls = Calls(monkeypatch)
    calls.wrap(loopstage, "retrieve")
    tpl.run(clouds, config(), [tse3.index(t, 0) for t in trajs], device="cpu")
    st = obs.tracer.stats
    for key in [f"robot{r}.frontend" for r in range(N_ROBOTS)] + [
            "backend.prepare", "backend.graph", "backend.associate", "backend.pcm",
            "backend.solve"]:
        assert st[key].count == 1, key
    assert st["loop.retrieve"].count == calls.n["retrieve"] > 0
    # the runners' projections keep their key inside each robot's front-end
    assert st["online.frontend.project"].count == 2 * N_ROBOTS * (N - 1)
    assert all(st[f"robot{r}.frontend"].child_s > 0.0 for r in range(N_ROBOTS))


NESTED = (("online.frontend.project", "online.frontend"),
          ("online.frontend.gate_read", "online.frontend"),
          ("online.describe", "online.keyframe"),
          ("loop.retrieve", "online.loop_stage"),
          ("loop.verify", "online.loop_stage"),
          ("online.pcm", "online.loop_stage"),
          ("online.solve", "online.loop_stage"),
          ("online.solve.prepare", "online.solve"),
          ("online.solve.project", "online.solve"))


def test_profiler_ranges_of_sub_spans_lie_in_their_parents(stream, fresh, monkeypatch):
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from slambench import trace

    trace.mirror_spans(obs.tracer)
    try:
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
            run_session(stream[:15], config(), Calls(monkeypatch))
    finally:
        del obs.tracer.span  # the class's span again
    ranges = collections.defaultdict(list)
    for e in prof.events():
        if e.name.startswith(trace.SPAN_PREFIXES):
            ranges[e.name].append((e.time_range.start, e.time_range.end))
    for child, parent in NESTED:
        assert ranges[child], child
        for s, t in ranges[child]:
            assert any(ps <= s and t <= pt for ps, pt in ranges[parent]), (child, parent)
    assert len(ranges["online.frontend"]) == 15
    assert "span" not in vars(obs.tracer)


VISIBLE = ("sync.frontend.", "sync.keyframe.", "sync.tf", "sync.loop.", "sync.verify.project",
           "sync.pcm", "sync.solve.loops", "sync.solve.anchors", "sync.solve.plan",
           "sync.solve.project", "sync.compose.ids", "sync.gem.")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sync debug mode watches the card")
    return torch.device("cuda", 0)


def _stack() -> str:
    import traceback

    return " < ".join(f"{Path(f.filename).name}:{f.lineno}" for f in
                      reversed(traceback.extract_stack()) if "mr_slam_torch" in f.filename)


@pytest.mark.gpu
def test_sync_counters_match_the_sync_debug_mode_on_card(stream, card, fresh):
    """Warm frames on the card: each frame's synchronizing operations, as
    `torch.cuda.set_sync_debug_mode("warn")` reports them, equal the
    frame's `sync.*` increments at the sites it sees (not the explicit
    `torch.cuda.synchronize` / stream syncs: `sync.*.end`, `.close`,
    `.drop`). A first session warms the process (device constants,
    library handles, every runner key); a second one on the same frames
    is watched after its robots' first frames."""
    frames = [trep.Frame(stamp=f.stamp, robot=f.robot, origin=f.origin, scan=tpcl.PointCloud(
        f.scan.xyz.to(card), f.scan.mask.to(card))) for f in stream]
    seen = []

    def show(message, *a, **kw):
        if "synchroniz" in str(message):
            seen.append(_stack())

    per_site = collections.Counter()
    for watched in (False, True):
        sess = tonline.OnlineSlam(config(), device=card)
        for j, f in enumerate(frames):
            if f.robot not in sess.robots:
                sess.register_robot(f.robot, f.origin)
            watch = watched and j >= N_ROBOTS
            before = _sync_counts()
            seen.clear()
            with warnings.catch_warnings():
                warnings.simplefilter("always")
                warnings.showwarning = show
                if watch:
                    torch.cuda.set_sync_debug_mode("warn")
                try:
                    sess.add_frame(f.robot, f.scan, stamp=f.stamp)
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            if not watch:
                continue
            d = _delta(_sync_counts(), before)
            visible = sum(v for k, v in d.items() if k.startswith(VISIBLE))
            assert len(seen) == visible, (j, d, collections.Counter(seen))
            per_site.update(d)
    assert per_site["sync.frontend.project"] and per_site["sync.loop.retrieve"]
    assert per_site["sync.solve.plan"] and per_site["sync.solve.project"]
