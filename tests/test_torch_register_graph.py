"""The registration entry points' runners (`runtime/register_graph`),
which replay CUDA graphs on the card, against the eager bodies they
replace (`registration._<name>_eager`) and against the reference's
jitted programs (`mr_slam_tpu.ops.registration`).

A runner calls the same raw bodies on the same values as the eager
body, so on one device the two agree bit for bit: pose, inliers, error,
fitness and converged. On the CPU a runner runs its segments eagerly;
`replayed` re-runs every segment after its first call on the buffers it
first saw, writing into the outputs it first returned, as a CUDA graph
replays, so the CPU checks that a second input of the same key flows
through the static buffers. Callers that run inside a CUDA graph of
their own (loop verification, the odometry, the LIO update, the feature
runner) must not reach a runner: a capture cannot hold another.
Against the reference the bounds are the existing tests' on the same
inputs: `tests/test_torch_register_pair.py`'s for `register_pair` on
the selector scene (the recovered transform within 0.05 m / 0.02 rad in
both packages, the packages within 1e-3 m, point_to_plane 5e-3 m, and
fitness within 0.05), `tests/test_torch_registration_general.py`'s for
ICP and GICP (1e-4 m / 1e-4 rad, inliers equal, errors within 1e-8) and
`tests/test_torch_features.py`'s for `loam_icp` (1e-4 m, 1e-3 deg).

Sizes: the reference tests' structured scene (`torch_parity.structured_cloud`,
1024 points; VGICP batched as B = 2), `torch_parity.room`'s features for
`loam_icp`, and the reference's selector scene (4096 points) for
`register_pair` with VGICP and point_to_plane; with ICP and GICP on the
structured scene, as their brute-force k-NN takes 0.9 s an iteration at
4096 points on one CPU thread. The `gpu` tests run the runners on the card against the
eager bodies there (the card machine has no JAX):

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_register_graph.py
"""
import functools

import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.frontend import odometry as todo
from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_torch.ops import hopper_vgicp, pointcloud as tpcl, registration as treg
from mr_slam_torch.ops import voxel_grid as tvg
from mr_slam_torch.runtime import frame_graph, loopstage as tls, register_graph, verify_graph
from chip_smoke import selector_scene
from torch_parity import make_scans, rest_then_circle, room, rot_diff_deg, structured_cloud

TRUE = tse3.Pose(tso3.exp(torch.tensor([0.01, -0.02, 0.04])), torch.tensor([0.2, -0.1, 0.05]))
SECOND = tse3.Pose(tso3.exp(torch.tensor([-0.02, 0.01, -0.06])), torch.tensor([-0.3, 0.15, 0.0]))
# another init of the same key: what `replayed` must carry to the segments
MOVED = tse3.Pose(tso3.exp(torch.tensor([0.0, 0.01, -0.03])), torch.tensor([0.1, 0.05, -0.02]))
# the selector scene's transform (the reference's `TestMethodSelector`)
SCENE_TRUE = tse3.Pose(tso3.exp(torch.tensor([0.02, -0.01, 0.05])), torch.tensor([0.3, -0.2, 0.1]))
PAIR_ITERS = 25  # the reference test's


def _to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_to(v, dev) for v in x))
    return x


@functools.lru_cache(maxsize=None)
def _clouds():
    """The CPU inputs every case draws from, built once."""
    tgt = structured_cloud(3, 1024)
    srcs = [tpcl.transform(tgt, tse3.inverse(p)) for p in (TRUE, SECOND)]
    grid = tvg.build(tgt, 0.5, 1 << 12, min_points=3, regularize="plane")
    planes, lines = room(0, 2000, 100)
    loam_grid = tvg.insert(tvg.empty(1.0, 1 << 13), tpcl.make(torch.cat([planes, lines])))
    planes, lines = room(1, 300, 20)
    scene = selector_scene()
    return dict(
        tgt=tgt, src=srcs[0],
        batch=tpcl.PointCloud(torch.stack([s.xyz for s in srcs]), torch.stack([s.mask for s in srcs])),
        tables=tvg.VoxelGrid(torch.stack([grid.packed] * 2), grid.leaf),
        covs=torch.stack([treg._regularized_covs(s, 10)[0] for s in srcs]),
        p2p_grid=tvg.insert(tvg.empty(1.0, 1 << 12), tgt),
        loam_grid=loam_grid,
        surfs=tpcl.make(tse3.apply(tse3.inverse(TRUE), planes)),
        corners=tpcl.make(tse3.apply(tse3.inverse(TRUE), lines)),
        scene=scene, scene_src=tpcl.transform(scene, tse3.inverse(SCENE_TRUE)))


def case(name: str, dev="cpu", moved: bool = False):
    """(public entry point, its eager body, args, kwargs) of a case;
    `moved`: another init of the same key."""
    c = {k: _to(v, dev) for k, v in _clouds().items()}
    one = _to(MOVED if moved else tse3.identity(), dev)
    two = tse3.Pose(one.R.expand(2, 3, 3).contiguous(), one.t.expand(2, 3).contiguous())
    if name.startswith("vgicp"):
        kw = dict(iters=8)
        if name == "vgicp_schedule":
            kw = dict(schedule=((2, 4), (3, 2), (3, 1)))
        elif name == "vgicp_direct7":
            kw = dict(iters=5, neighbors="direct7")
        elif name == "vgicp_direct27_covs":
            kw = dict(iters=5, neighbors="direct27", source_covs=c["covs"])
        return treg.vgicp, treg._vgicp_eager, (c["batch"], c["tables"], two), kw
    if name == "point_to_plane_icp":
        return (treg.point_to_plane_icp, treg._point_to_plane_icp_eager,
                (c["src"], c["p2p_grid"], one), dict(iters=6, inner=2))
    if name == "loam_icp":
        return (treg.loam_icp, treg._loam_icp_eager,
                (c["corners"], c["surfs"], c["loam_grid"], one), dict(iters=4))
    if name == "point_to_point_icp":
        return (treg.point_to_point_icp, treg._point_to_point_icp_eager,
                (c["src"], c["tgt"], one), dict(iters=8))
    if name == "gicp":
        return treg.gicp, treg._gicp_eager, (c["src"], c["tgt"], one), dict(iters=8)
    method = name[len("register_pair_"):]
    if method in ("icp", "gicp"):  # brute-force k-NN: 0.9 s an iteration at 4096 points
        return (treg.register_pair, treg._register_pair_eager, (c["src"], c["tgt"], one),
                dict(method=method, iters=8))
    return (treg.register_pair, treg._register_pair_eager, (c["scene_src"], c["scene"], one),
            dict(method=method, iters=PAIR_ITERS))


CASES = ("vgicp_direct1", "vgicp_schedule", "vgicp_direct7", "vgicp_direct27_covs",
         "point_to_plane_icp", "loam_icp", "point_to_point_icp", "gicp",
         *(f"register_pair_{m}" for m in treg.PAIR_METHODS))


def assert_same(got: treg.RegistrationResult, want: treg.RegistrationResult):
    assert torch.equal(got.pose.R, want.pose.R) and torch.equal(got.pose.t, want.pose.t)
    for f in ("num_inliers", "error", "fitness", "converged"):
        assert torch.equal(getattr(got, f), getattr(want, f)), f


@pytest.fixture
def fresh():
    register_graph.clear()
    yield
    register_graph.clear()


def _copy_into(dst, src):
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
    else:
        for k in dst:
            _copy_into(dst[k], src[k])


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

    register_graph.clear()
    monkeypatch.setattr(frame_graph.Segments, "run", run)
    yield calls
    register_graph.clear()


@pytest.mark.parametrize("name", CASES)
def test_runner_equals_eager_body(fresh, name):
    """Three calls of one key (the runner's eager first call, then its
    segments' runs) against the eager body, bit for bit."""
    public, eager, args, kw = case(name)
    want = eager(*args, **kw)
    for _ in range(3):
        assert_same(public(*args, **kw), want)
    (runner,) = register_graph.stats()
    assert runner["calls"] == 3 and runner["entry"] == public.__name__


@pytest.mark.parametrize("name", CASES)
def test_replayed_segments_equal_eager_body(replayed, name):
    """Calls replayed on the buffers the segments first saw: another init
    of the same key reaches them through the static buffers."""
    public, eager, args, kw = case(name)
    _, _, moved, _ = case(name, moved=True)
    want = eager(*args, **kw)
    want_moved = eager(*moved, **kw)
    assert not torch.equal(want_moved.error, want.error)
    for a, w in ((args, want), (args, want), (moved, want_moved), (args, want)):
        assert_same(public(*a, **kw), w)
    assert set(replayed) == ({"reg", "score"} if name.startswith("register_pair") else {"gn"})
    assert [s["calls"] for s in register_graph.stats()] == [4]  # one key


def test_replay_catches_a_rebound_buffer(replayed):
    """A buffer rebound to a new tensor, not written with `copy_`, leaves
    the replays on the old one: the harness then differs from the eager
    body (the check the test above relies on)."""
    public, eager, args, kw = case("point_to_point_icp")
    _, _, moved, _ = case("point_to_point_icp", moved=True)
    for _ in range(2):
        public(*args, **kw)
    (runner,) = register_graph._runners.values()
    runner.b["R0"] = torch.empty_like(runner.b["R0"])
    assert not torch.equal(public(*moved, **kw).error, eager(*moved, **kw).error)


def test_new_shape_makes_new_runner(fresh):
    """A cloud of another length is another key (no padding), and the
    least recently used runner goes first."""
    src, tgt = _clouds()["src"], _clouds()["tgt"]
    lengths = [1024 - k for k in range(register_graph.MAX_RUNNERS + 1)]
    for n in lengths:
        s = tpcl.PointCloud(src.xyz[:n].contiguous(), src.mask[:n].contiguous())
        got = treg.point_to_point_icp(s, tgt, tse3.identity(), iters=3)
        assert_same(got, treg._point_to_point_icp_eager(s, tgt, tse3.identity(), iters=3))
    runners = register_graph.stats()
    assert [r["calls"] for r in runners] == [1] * register_graph.MAX_RUNNERS
    treg.point_to_point_icp(src, tgt, tse3.identity(), iters=3)  # evicted: a new runner
    assert [r["calls"] for r in register_graph.stats()] == [1] * register_graph.MAX_RUNNERS
    treg.point_to_point_icp(src, tgt, tse3.identity(), iters=4)  # another static argument
    assert len(register_graph.stats()) == register_graph.MAX_RUNNERS


class _Held:
    """A runner stand-in whose graph pool holds `n` bytes on `device`."""

    def __init__(self, n: int, device: str):
        self.n, self.device, self.closed = n, torch.device(device), False

    def held_bytes(self) -> int:
        return self.n

    def stats(self) -> dict:
        return dict(pool_bytes=self.n)

    def close(self) -> None:
        self.closed = True


def test_cache_keeps_graph_pools_under_budget():
    """With a pool budget the cache drops the least recently used runners
    of a device while their pools sum to more than it, keeps the most
    recently used one whatever its pool, and leaves other devices'
    runners alone."""
    cache = frame_graph.RunnerCache(4, pool_budget=lambda dev: 100)
    made = {}

    def get(key, n=0, device="cuda"):
        cache.get(key, lambda: made.setdefault(key, _Held(n, device)))
        return [s["key"] for s in cache.stats(lambda k: dict(key=k))]

    assert get("a", 60) == ["a"]
    assert get("cpu", 0, "cpu") == ["a", "cpu"]
    assert get("b", 30) == ["a", "cpu", "b"]
    assert get("c", 50) == ["cpu", "b", "c"] and made["a"].closed  # 140 > 100
    assert get("b") == ["cpu", "c", "b"]
    assert get("d", 500) == ["cpu", "d"] and made["b"].closed and made["c"].closed
    made["d"].n = 40  # a smaller pool: room for another
    assert get("e", 50) == ["cpu", "d", "e"]
    made["e"].n = 70  # its capture grew the pool
    cache.trim()
    assert get("e") == ["cpu", "e"] and not made["cpu"].closed


# --------------------------------------------------------------------------
# callers that run inside CUDA graphs of their own
# --------------------------------------------------------------------------


def _verify():
    from test_torch_verify_graph import CFG, _store, chunk

    store = _store(0, 0.0)
    ia, ib, yaw = chunk(((3, 3), (5, 4)))
    verify_graph.clear()
    try:
        verify = verify_graph.verifier(store, store, CFG, True)
        for _ in range(2):
            verify(ia, ib, yaw)
        tls._verify_chunk_eager(store, store, ia, ib, yaw, CFG, True)
    finally:
        verify_graph.clear()


def _scan2map():
    world = synthetic.default_world(0)
    traj = synthetic.circle_trajectory(3, radius=25.0, laps=0.05)
    scans = make_scans(world, traj, 3, seed=1, n_rings=16, n_azimuth=256)
    frame_graph.scan2map(scans, todo.OdometryConfig(table_size=1 << 14), tse3.index(traj, 0))


def _lio():
    from mr_slam_torch.frontend import lio as tlio

    world = synthetic.default_world(0)
    traj = rest_then_circle(1, 2, radius=10.0, laps=0.05, phase=0.0)
    scans = make_scans(world, traj, 3, seed=2, n_rings=16, n_azimuth=256)
    imu = synthetic.imu_for_trajectory(traj, frame_dt=0.1, n_sub=10)
    frame_graph.lio(scans, imu, tlio.LioConfig(table_size=1 << 14, scan_capacity=1024,
                                               insert_capacity=2048), tse3.index(traj, 0))


def _loam():
    from test_torch_feature_graph import images

    traj, xyz, hit = images(3)
    frame_graph.loam(xyz, hit, todo.OdometryConfig(table_size=1 << 14), tse3.index(traj, 0))


@pytest.mark.parametrize("caller", ["verify", "scan2map", "lio", "loam"])
def test_callers_inside_graphs_reach_no_runner(monkeypatch, caller):
    """Loop verification (the runner and the eager chunk), the scan2map
    and LIO front-ends and the feature runner call raw or eager bodies
    only."""
    def refuse(*args, **kw):
        raise AssertionError("a caller inside a CUDA graph reached a registration runner")

    monkeypatch.setattr(register_graph, "_call", refuse)
    with pytest.raises(AssertionError):  # the patch is live
        treg.point_to_point_icp(_clouds()["src"], _clouds()["tgt"], tse3.identity(), iters=1)
    dict(verify=_verify, scan2map=_scan2map, lio=_lio, loam=_loam)[caller]()


# --------------------------------------------------------------------------
# against the reference
# --------------------------------------------------------------------------


@pytest.mark.parametrize("method", ["vgicp", "point_to_plane"])
def test_register_pair_runner_matches_reference(fresh, method):
    """`register_pair`'s runner (its second call: the segments' runs) on
    the selector scene against the reference's jitted `register_pair`."""
    from mr_slam_tpu.geometry import se3 as jse3
    from mr_slam_tpu.ops import registration as jreg
    from tests.torch_parity import cloud_to_jax

    _, _, args, kw = case(f"register_pair_{method}")
    treg.register_pair(*args, **kw)
    res = treg.register_pair(*args, **kw)
    src, target, _ = args
    ref = jreg.register_pair(cloud_to_jax(src), cloud_to_jax(target), jse3.identity(), **kw)
    for pose in (res.pose, ref.pose):
        np.testing.assert_allclose(np.asarray(pose.t), SCENE_TRUE.t.numpy(), atol=0.05)
        assert np.radians(rot_diff_deg(np.asarray(pose.R), SCENE_TRUE.R.numpy())) < 0.02
    agree = 5e-3 if method == "point_to_plane" else 1e-3
    np.testing.assert_allclose(res.pose.t.numpy(), np.asarray(ref.pose.t), atol=agree)
    np.testing.assert_allclose(float(res.fitness), float(ref.fitness), atol=0.05)


@pytest.mark.parametrize("method", ["point_to_point_icp", "gicp"])
def test_icp_runner_matches_reference(fresh, method):
    """ICP's and GICP's runners (their second call) against the
    reference on `tests/test_torch_registration_general.py`'s inputs."""
    from mr_slam_tpu.geometry import se3 as jse3
    from mr_slam_tpu.ops import registration as jreg
    from tests.torch_parity import cloud_to_jax

    target = structured_cloud(3, 1536)
    source = tpcl.transform(target, tse3.inverse(TRUE))
    getattr(treg, method)(source, target, tse3.identity(), iters=20)
    res = getattr(treg, method)(source, target, tse3.identity(), iters=20)
    ref = getattr(jreg, method)(cloud_to_jax(source), cloud_to_jax(target), jse3.identity(),
                                iters=20)
    np.testing.assert_allclose(res.pose.t.numpy(), np.asarray(ref.pose.t), atol=1e-4, rtol=0)
    assert np.radians(rot_diff_deg(res.pose.R.numpy(), np.asarray(ref.pose.R))) < 1e-4
    assert float(res.num_inliers) == float(ref.num_inliers)
    np.testing.assert_allclose(float(res.error), float(ref.error), atol=1e-8)
    np.testing.assert_allclose(res.pose.t.numpy(), TRUE.t.numpy(), atol=1e-3)


def test_loam_runner_matches_reference(fresh):
    """`loam_icp`'s runner (its second call) against the reference on
    `tests/test_torch_features.py`'s inputs."""
    from mr_slam_tpu.ops import registration as jreg
    from tests.torch_parity import cloud_to_jax, grid_to_jax, pose_to_jax, to_torch

    planes, lines = room(0, 20000, 400)
    grid = tvg.insert(tvg.empty(1.0, 1 << 14), tpcl.make(torch.cat([planes, lines])))
    true = tse3.Pose(tso3.exp(torch.tensor([0.01, -0.02, 0.05])), torch.tensor([0.3, -0.2, 0.05]))
    planes, lines = room(1, 600, 30)
    surfs = tpcl.make(tse3.apply(tse3.inverse(true), planes))
    corners = tpcl.make(tse3.apply(tse3.inverse(true), lines))
    treg.loam_icp(corners, surfs, grid, tse3.identity(), iters=3)
    got = treg.loam_icp(corners, surfs, grid, tse3.identity(), iters=3)
    want = jreg.loam_icp(cloud_to_jax(corners), cloud_to_jax(surfs), grid_to_jax(grid),
                         pose_to_jax(tse3.identity()), iters=3)
    assert float(torch.linalg.norm(got.pose.t - to_torch(want.pose.t))) <= 1e-4
    assert rot_diff_deg(got.pose.R, want.pose.R) <= 1e-3
    assert float(got.num_inliers) == float(want.num_inliers) > 800


# --------------------------------------------------------------------------
# on the card
# --------------------------------------------------------------------------


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runners capture CUDA graphs only there")
    register_graph.clear()
    yield torch.device("cuda", 0)
    register_graph.clear()


@pytest.mark.gpu
@pytest.mark.parametrize("name", CASES)
def test_graphs_equal_eager_body_on_card(card, name):
    """Three calls of one key (eager, captured and replayed, replayed)
    against the eager body on the card, bit for bit, with the VGICP
    kernel's launches of each call equal to the eager body's."""
    public, eager, args, kw = case(name, card)
    counts = []
    for _ in range(3):
        hopper_vgicp.reset_launch_count()
        got = public(*args, **kw)
        torch.cuda.synchronize()
        counts.append(hopper_vgicp.launch_count())
        hopper_vgicp.reset_launch_count()
        assert_same(got, eager(*args, **kw))
        torch.cuda.synchronize()
        counts.append(hopper_vgicp.launch_count())
    assert len(set(counts)) == 1, counts
    uses_kernel = name in ("vgicp_direct1", "vgicp_schedule", "register_pair_vgicp")
    assert (counts[0] > 0) == uses_kernel
    (runner,) = register_graph.stats()
    segments = 2 if name.startswith("register_pair") else 1
    assert runner["captures"] == segments and runner["replays"] == 2 * segments


@pytest.mark.gpu
def test_kept_graph_pools_stay_under_budget_on_card(card):
    """GICP against targets of several lengths (a key each, each called
    eagerly, captured and replayed): the graph pools that the kept
    runners hold stay within the card's budget, the runner just used
    excepted, and the last replay is the eager body's bit for bit."""
    budget = register_graph._pool_budget(card)
    full = _to(structured_cloud(3, 20480), card)
    src = _to(tpcl.transform(structured_cloud(4, 20480), tse3.inverse(TRUE)), card)
    init = _to(tse3.identity(), card)
    kept = []
    for n in (20480, 19968, 19456, 18944):
        tgt = tpcl.PointCloud(full.xyz[:n].contiguous(), full.mask[:n].contiguous())
        for _ in range(3):
            got = treg.gicp(src, tgt, init, iters=2)
        held = [r["pool_bytes"] for r in register_graph.stats()]
        assert held[-1] > 0 and sum(held) <= max(budget, held[-1]), (held, budget)
        kept.append(len(held))
    assert_same(got, treg._gicp_eager(src, tgt, init, iters=2))
    if 2 * held[-1] > budget:  # two such pools do not fit: one runner is kept
        assert kept == [1, 1, 1, 1], kept
