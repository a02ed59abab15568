"""Loop verification's segmented runner (`runtime/verify_graph`), which
replays CUDA graphs on the card, against the eager chunk it replaces
(`loopstage._verify_chunk_eager`) and against the reference's compiled
chunk (`mr_slam_tpu.runtime.loopstage.verify_chunk`).

The runner calls the same stages on the same values as the eager chunk,
so on one device the two agree bit for bit, in `rel` and `fit`. On the
CPU the runner runs its segments eagerly; `replayed` re-runs every
segment after its first call on the buffers it first saw, writing into
the outputs it first returned, as a CUDA graph replays, so the CPU
checks that a second pair's stores flow through the static buffers.
Against the reference the bounds are `tests/test_torch_loopstage.py`'s:
relative poses of accepted loops within 1 cm and 0.1 deg, fitness
within 0.05 and on the same side of the gate.

Sizes: two robots' stores of 8 keyframes of 256 points (3.4 m apart on
the radius-25 ring road of world 0, at 16x256 rays; robot 1 0.6 m
behind robot 0),
`verify_capacity` 1024, chunks of CHUNK = 8 with padded rows. The `gpu`
tests compare the captured graphs with the eager chunk on the card (the
card machine has no JAX):

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_verify_graph.py
"""
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.frontend import keyframes as tkf
from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_torch.ops import hopper_vgicp, pointcloud as tpcl, registration as treg
from mr_slam_torch.ops import voxel_grid as tvg
from mr_slam_torch.runtime import frame_graph, loopstage as tls, pipeline as tpipe
from mr_slam_torch.runtime import verify_graph
from mr_slam_torch.runtime.config import KeyframeCfg, LoopCfg, SlamConfig
from torch_parity import make_scans, rot_err_deg, structured_cloud

N_KF, POINTS = 8, 256
KF_KW = dict(dist_thresh=1.0, capacity=N_KF, points_per_kf=POINTS)
LOOP_KW = dict(method="scancontext", dist_thresh=0.4, min_separation=2, candidates=2,
               odom_radius=12.0, verify_capacity=1024, fitness_thresh=0.3)
CFG = SlamConfig(keyframes=KeyframeCfg(**KF_KW), loops=LoopCfg(**LOOP_KW))
RING_KW = dict(LOOP_KW, method="ring", bev_z_min=0.3)
RING_CFG = SlamConfig(keyframes=CFG.keyframes, loops=LoopCfg(**RING_KW))
# robot 1 drives robot 0's arc 0.6 m behind it
ROBOT1_PHASE = -0.6 / 25.0
# (kf_a, kf_b) rows of a chunk: overlapping keyframes (the same place
# across the robots, neighbours within one), far pairs, then padding as
# `search_pair_loops` pads
PAIRS = ((3, 3), (5, 4), (6, 6), (2, 1), (7, 0))
OTHER = ((1, 1), (4, 3), (0, 7), (6, 2))
CASES = ("same_robot", "yaw", "ring")


def _store(seed: int, phase: float) -> tkf.KeyframeStore:
    world = synthetic.default_world(0)
    traj = synthetic.circle_trajectory(N_KF, radius=25.0, laps=0.15, phase=phase)
    scans = make_scans(world, traj, N_KF, seed=seed, n_rings=16, n_azimuth=256)
    store = tkf.init(N_KF, POINTS)
    for i in range(N_KF):
        store, _ = tkf.maybe_add(store, tpcl.PointCloud(scans.xyz[i], scans.mask[i]),
                                 tse3.index(traj, i), torch.tensor(0.1 * i), dist_thresh=0.5,
                                 leaf=0.4)
    assert int(store.count) == N_KF
    return store


@pytest.fixture(scope="module")
def stores():
    return _store(0, 0.0), _store(1, ROBOT1_PHASE)


def chunk(pairs, yaw=None, dev="cpu"):
    pairs = (list(pairs) + [(0, 0)] * tls.CHUNK)[: tls.CHUNK]
    ia = torch.tensor([p[0] for p in pairs], device=dev)
    ib = torch.tensor([p[1] for p in pairs], device=dev)
    yaw = torch.zeros(tls.CHUNK, device=dev) if yaw is None else yaw.to(dev)
    return ia, ib, yaw


def case_args(case, stores, dev="cpu"):
    """(store_a, store_b, cfg, same_robot, descs_a, descs_b) of a case."""
    a, b = (tuple(_to(s, dev) for s in stores))
    if case == "same_robot":
        return a, a, CFG, True, None, None
    if case == "yaw":
        return a, b, CFG, False, None, None
    return (a, b, RING_CFG, False, tpipe.compute_descriptors(a, RING_CFG),
            tpipe.compute_descriptors(b, RING_CFG))


def ring_yaw(args, ia, ib):
    _, _, cfg, _, da, db = args
    if da is None:
        return None
    _, yaw = tpipe._descriptor_distances(da, ia, db, cfg)
    return yaw.gather(1, ib[:, None])[:, 0]


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    return x


def assert_same(got, want):
    (rel, fit), (wrel, wfit) = got, want
    assert torch.equal(rel.R, wrel.R) and torch.equal(rel.t, wrel.t)
    assert torch.equal(fit, wfit)


def run_chunks(args, chunks, dev="cpu"):
    """Each chunk through one runner and through the eager oracle."""
    sa, sb, cfg, same, da, db = args
    verify = verify_graph.verifier(sa, sb, cfg, same, da, db)
    out = []
    for pairs in chunks:
        ia, ib, _ = chunk(pairs, dev=dev)
        ia, ib, yaw = chunk(pairs, ring_yaw(args, ia, ib), dev)
        out.append((verify(ia, ib, yaw),
                    tls._verify_chunk_eager(sa, sb, ia, ib, yaw, cfg, same, da, db)))
    return verify, out


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
    """`Segments.run` as a graph replays: the first call of a segment
    runs it and keeps the buffer dict it saw and the outputs it gave;
    every later call runs it on those buffers and writes the results
    into those outputs. Starts from no runner."""
    calls = {}

    def run(self, name, fn, bufs):
        if name not in calls:
            calls[name] = (dict(bufs), fn(bufs))
            return calls[name][1]
        seen, out = calls[name]
        _copy_into(out, fn(seen))
        return out

    verify_graph.clear()
    monkeypatch.setattr(frame_graph.Segments, "run", run)
    yield calls
    verify_graph.clear()


@pytest.mark.parametrize("case", CASES)
def test_runner_equals_eager_chunk(stores, case):
    """Two chunks of one pair (the runner's eager first chunk, then its
    segments' runs), padded rows included, bit for bit."""
    verify_graph.clear()
    _, out = run_chunks(case_args(case, stores), [PAIRS, OTHER])
    for got, want in out:
        assert_same(got, want)


@pytest.mark.parametrize("case", CASES)
def test_replayed_segments_equal_eager_chunk(stores, replayed, case):
    """Chunks replayed on the buffers the segments first saw: a second
    pair's stores (robot 1's, seen from robot 0 and the other way round)
    reach them through the static buffers."""
    run_chunks(case_args(case, stores), [PAIRS, OTHER, PAIRS])
    _, out = run_chunks(case_args(case, stores[::-1]), [OTHER, PAIRS])
    for got, want in out:
        assert_same(got, want)
    assert set(replayed) == {"coarse", "fine", "score"}
    assert len(verify_graph.stats()) == 1  # one key: the second pair reused the runner


def test_replay_catches_a_swapped_buffer(stores, replayed):
    """A buffer rebound to a new tensor, not written with `copy_`, leaves
    the replays on the old one: the harness then differs from the eager
    chunk (the check the test above relies on)."""
    sa, sb, cfg, same, da, db = case_args("yaw", stores)
    verify, _ = run_chunks((sa, sa, cfg, same, da, db), [PAIRS, OTHER])
    verify.b["b_xyz"] = torch.empty_like(verify.b["b_xyz"])
    _, out = run_chunks((sa, sb, cfg, same, da, db), [PAIRS])
    (rel, fit), (wrel, wfit) = out[0]
    assert not (torch.equal(rel.t, wrel.t) and torch.equal(fit, wfit))


def test_runner_keeps_at_most_max_runners(stores):
    """Stores of another capacity are another key; the least recently
    used runner goes first."""
    verify_graph.clear()
    sa = stores[0]
    for extra in range(verify_graph.MAX_RUNNERS + 1):
        grown = tkf.KeyframeStore(
            xyz=torch.cat([sa.xyz, sa.xyz[:extra]]), mask=torch.cat([sa.mask, sa.mask[:extra]]),
            poses=tse3.Pose(torch.cat([sa.poses.R, sa.poses.R[:extra]]),
                            torch.cat([sa.poses.t, sa.poses.t[:extra]])),
            stamps=sa.stamps, count=sa.count, last_pose=sa.last_pose)
        got = verify_graph.verifier(grown, grown, CFG, True)(*chunk(PAIRS))
        assert_same(got, tls._verify_chunk_eager(sa, sa, *chunk(PAIRS), CFG, True))
    shapes = [s["store_a"][0] for s in verify_graph.stats()]
    assert shapes == [N_KF + k for k in range(1, verify_graph.MAX_RUNNERS + 1)]
    verify_graph.clear()


def test_search_pair_loops_through_the_runner(stores, monkeypatch):
    """`search_pair_loops` verifies through one verifier a call, whose
    chunks equal the eager oracle's, and accepts loops."""
    store = stores[0]
    descs = tpipe.compute_descriptors(store, CFG)
    seen = []
    make = verify_graph.verifier

    def spy(*args, **kw):
        verify = make(*args, **kw)

        def checked(ia, ib, yaw):
            got = verify(ia, ib, yaw)
            assert_same(got, tls._verify_chunk_eager(*args[:2], ia, ib, yaw, *args[2:]))
            seen.append(ia)
            return got
        return checked

    monkeypatch.setattr(verify_graph, "verifier", spy)
    loops = tls.search_pair_loops(store, descs, store, descs, CFG, same_robot=True)
    assert seen and all(ia.shape == (tls.CHUNK,) for ia in seen)
    assert loops and all(l["fitness"] < CFG.loops.fitness_thresh for l in loops)


def test_vgicp_direct1_is_raw_then_normalized_and_scored():
    """`_vgicp_direct1` is its raw GN steps, then `se3.normalize`, with the
    full-cloud fitness at the raw pose, bit for bit."""
    src = structured_cloud(2, 1024)
    grid = tvg.build(structured_cloud(3, 4096), 0.5, 1 << 13, min_points=3, regularize="plane")
    B = 2
    source = tpcl.PointCloud(src.xyz.expand(B, -1, -1), src.mask.expand(B, -1))
    target = tvg.VoxelGrid(grid.packed.expand(B, -1, -1), grid.leaf)
    init = tse3.Pose(tso3.exp(torch.tensor([[0.01, -0.02, 0.05], [0.0, 0.02, -0.04]])),
                     torch.tensor([[0.2, -0.1, 0.05], [-0.1, 0.15, 0.0]]))
    res = treg._vgicp_direct1(source, target, init, iters=12)
    raw = treg._vgicp_direct1_raw(source, target, init, iters=12)
    assert raw.fitness is None
    assert torch.equal(res.pose.R, tse3.normalize(raw.pose).R)
    assert torch.equal(res.pose.t, raw.pose.t)
    assert torch.equal(res.fitness, treg.fitness(source, target, raw.pose, max_range=1.0))
    for a, b in ((res.error, raw.error), (res.num_inliers, raw.num_inliers),
                 (res.converged, raw.converged)):
        assert torch.equal(a, b)
    assert not torch.equal(raw.pose.R, res.pose.R)  # the projection moved the rotation


@pytest.fixture(scope="module")
def circle_store():
    """`tests/test_torch_loopstage.py`'s revisit store (one robot on a
    closed radius-10 circle, 32 x 4096), where the registrations are
    well posed enough for a bound against the reference: at 256 points a
    keyframe the fitness of one- and two-point cells is f32 noise."""
    world = synthetic.default_world(3)
    n = 20
    traj = synthetic.circle_trajectory(n, radius=10.0, laps=1.0)
    scans = make_scans(world, traj, n, seed=0, n_rings=16, n_azimuth=512)
    store = tkf.init(32, 4096)
    for i in range(n):
        store, _ = tkf.maybe_add(store, tpcl.PointCloud(scans.xyz[i], scans.mask[i]),
                                 tse3.index(traj, i), torch.tensor(0.1 * i), dist_thresh=1.0,
                                 leaf=0.2)
    return store


@pytest.mark.parametrize("case", ["same_robot", "ring"])
def test_runner_matches_reference_chunk(circle_store, case):
    """The runner's second chunk (its segments' run) against the
    reference's compiled chunk on the same store, pairs and yaw guesses
    as `tests/test_torch_loopstage.py`'s checks: its revisits, other
    pairs and padding, same-robot from the odometry seeds, cross-robot
    from both RING seeds."""
    import jax.numpy as jnp

    from mr_slam_tpu.frontend import keyframes as jkf
    from mr_slam_tpu.runtime import loopstage as jls, pipeline as jpipe
    from mr_slam_tpu.runtime.config import KeyframeCfg as JKeyframeCfg
    from mr_slam_tpu.runtime.config import LoopCfg as JLoopCfg
    from mr_slam_tpu.runtime.config import SlamConfig as JSlamConfig
    from torch_parity import pose_to_jax, to_jax

    store = circle_store
    jstore = jkf.KeyframeStore(
        xyz=to_jax(store.xyz), mask=to_jax(store.mask), poses=pose_to_jax(store.poses),
        stamps=to_jax(store.stamps), count=jnp.int32(int(store.count)),
        last_pose=pose_to_jax(store.last_pose))
    kw = dict(keyframes=dict(dist_thresh=1.0, capacity=32, points_per_kf=4096),
              loops=dict(method="scancontext", dist_thresh=0.4, min_separation=4, candidates=2,
                         verify_capacity=8192, fitness_thresh=0.3))
    if case == "ring":
        kw["loops"].update(method="ring", bev_z_min=0.3)
    cfg = SlamConfig(keyframes=KeyframeCfg(**kw["keyframes"]), loops=LoopCfg(**kw["loops"]))
    jcfg = JSlamConfig(keyframes=JKeyframeCfg(**kw["keyframes"]), loops=JLoopCfg(**kw["loops"]))
    K = int(store.count)
    descs = tpipe.compute_descriptors(store, cfg)
    if case == "same_robot":
        pairs, same, da, jda = [(K - 1, 1), (K - 2, 0), (K - 1, 2), (K - 2, 1)], True, None, None
    else:
        pairs, same = [(K - 1, 1), (K - 2, 0), (K - 1, 0), (K - 3, 1)], False
        da, jda = descs, jpipe.compute_descriptors(jstore, jcfg)
    ia, ib, yaw = chunk(pairs)
    if da is not None:
        yaw = ring_yaw((store, store, cfg, same, da, da), ia, ib)
    verify = verify_graph.verifier(store, store, cfg, same, da, da)
    verify(ia, ib, yaw)  # the runner's eager first chunk
    rel, fit = verify(ia, ib, yaw)
    jrel, jfit = jls.verify_chunk(jstore, jstore, to_jax(ia.int()), to_jax(ib.int()),
                                  to_jax(yaw), jcfg, same, descs_a=jda, descs_b=jda)
    gate = cfg.loops.fitness_thresh
    accepted = fit.numpy() < gate
    np.testing.assert_array_equal(accepted, np.asarray(jfit) < gate)
    np.testing.assert_allclose(fit.numpy(), np.asarray(jfit), atol=0.05)
    assert accepted[:2].all(), fit
    np.testing.assert_allclose(rel.t.numpy()[accepted], np.asarray(jrel.t)[accepted], atol=0.01)
    for a, b in zip(rel.R.numpy()[accepted], np.asarray(jrel.R)[accepted]):
        assert rot_err_deg(a, b) < 0.1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runner captures CUDA graphs only there")
    verify_graph.clear()
    yield torch.device("cuda", 0)
    verify_graph.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("case", CASES)
def test_graphs_equal_eager_chunk_on_card(stores, card, case):
    """Three chunks of one pair (eager, captured and replayed, replayed),
    then a second pair's, against the eager chunk bit for bit; the VGICP
    launch count of the graphs equals the eager chunks'."""
    args = case_args(case, stores, card)
    hopper_vgicp.reset_launch_count()
    verify, out = run_chunks(args, [PAIRS, OTHER, PAIRS], card)
    for got, want in out:
        assert_same(got, want)
    assert verify.stats()["captures"] == 3 and verify.stats()["replays"] == 6
    # the runner's and the oracle's launches: equal halves
    assert hopper_vgicp.launch_count() == 2 * 3 * 30
    _, out = run_chunks(case_args(case, stores[::-1], card), [OTHER], card)
    assert_same(*out[0])
