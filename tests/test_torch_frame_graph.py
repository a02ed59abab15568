"""The front-ends' segmented frame runner (`runtime/frame_graph`), which
replays CUDA graphs on the card, against the eager frame loops it
replaces (`pipeline._frontend_scan2map`, `_frontend_lio`, loops of
`odometry.step`) and against the reference's fused `lax.scan`
(`mr_slam_tpu.runtime.pipeline._frontend_fused`).

The runner calls the same stages on the same values as the eager loop,
so on one device the two agree bit for bit: poses, keyframe store and
keyframe flags. On the CPU the runner runs its segments eagerly;
`replayed` re-runs every segment after its first call on the buffers
it first saw, writing into the outputs it first returned, as a CUDA
graph replays, so the CPU checks that every frame's state flows
through the static buffers. Against the reference the bound is
`tests/test_torch_frontend.py`'s: ATE within 10 % + 2 cm, keyframe
count within +-1 (f32 summation order differs between the packages).

Sizes: 16x512 rays, `table_size=1 << 16`, 12 frames, so that the fine
decay (frame 7) and a coarse insert past the first four (frame 8) both
run. The `gpu` tests compare the captured graphs with the eager loop on
the card (the card machine has no JAX):

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_frame_graph.py
"""
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import metrics as tmet
from mr_slam_torch.frontend import keyframes as tkf, odometry as todo
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl, registration as treg, voxel_grid as tvg
from mr_slam_torch.runtime import frame_graph, pipeline as tpipe
from mr_slam_torch.runtime.config import KeyframeCfg, OdometryCfg, SlamConfig
from torch_parity import jitter, make_scans, rest_then_circle

N_FRAMES = 12
LIO_FRAMES = 6
SHED = (False, False, True, False, True, True, False, True, False, False, True, False)


@pytest.fixture(scope="module")
def sequence():
    world = synthetic.default_world(0)
    traj = synthetic.circle_trajectory(N_FRAMES, radius=25.0, laps=0.1)
    scans = make_scans(world, traj, N_FRAMES, seed=1, n_rings=16, n_azimuth=512)
    t_rel = torch.from_numpy(np.random.default_rng(3).uniform(
        0.0, 0.1, scans.mask.shape).astype(np.float32))
    return traj, scans, t_rel


@pytest.fixture(scope="module")
def lio_sequence():
    world = synthetic.default_world(0)
    traj = rest_then_circle(2, LIO_FRAMES - 2, radius=10.0, laps=0.1, phase=0.0)
    scans = jitter(make_scans(world, traj, LIO_FRAMES, seed=2, n_rings=16, n_azimuth=512), 0.002, 5)
    imu = synthetic.imu_for_trajectory(traj, frame_dt=0.1, n_sub=10)
    t_rel = torch.from_numpy(np.random.default_rng(4).uniform(
        0.0, 0.1, scans.mask.shape).astype(np.float32))
    return traj, scans, imu, t_rel


def config():
    return SlamConfig(odometry=OdometryCfg(table_size=1 << 16),
                      keyframes=KeyframeCfg(capacity=16, points_per_kf=2048))


def lio_config():
    return SlamConfig(odometry=OdometryCfg(frontend="lio", table_size=1 << 15, scan_capacity=2048,
                                           insert_capacity=4096),
                      keyframes=KeyframeCfg(dist_thresh=0.5, capacity=8, points_per_kf=2048))


def to(x, dev):
    if isinstance(x, torch.Tensor):
        return x.to(dev)
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(to(v, dev) for v in x))
    if isinstance(x, tuple):
        return tuple(to(v, dev) for v in x)
    return x


def assert_same_frontend(poses, store, added, want):
    w_poses, w_store, w_added = want
    assert torch.equal(poses.R, w_poses.R) and torch.equal(poses.t, w_poses.t)
    for f in ("xyz", "mask", "stamps", "count"):
        assert torch.equal(getattr(store, f), getattr(w_store, f)), f
    assert torch.equal(store.poses.R, w_store.poses.R) and torch.equal(store.poses.t, w_store.poses.t)
    assert torch.equal(store.last_pose.t, w_store.last_pose.t)
    assert torch.equal(added, w_added)


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
    into those outputs."""
    calls = {}

    def run(self, name, fn, bufs):
        if name not in calls:
            calls[name] = (dict(bufs), fn(bufs))
            return calls[name][1]
        seen, out = calls[name]
        _copy_into(out, fn(seen))
        return out

    monkeypatch.setattr(frame_graph.Segments, "run", run)
    return calls


def scan2map_pair(traj, scans, t_rel, dev):
    cfg = config()
    scans, origin = to(scans, dev), to(tse3.index(traj, 0), dev)
    times = None if t_rel is None else t_rel.to(dev)
    want = tpipe._frontend_scan2map(scans, cfg, origin, times)
    got = tpipe.run_frontend(scans, cfg, origin, times=times)
    added = torch.zeros(N_FRAMES, dtype=torch.bool)
    added[torch.as_tensor(got.kf_frame_idx)] = True
    return got, added.to(dev), want


def lio_pair(seq, with_times, dev):
    traj, scans, imu, t_rel = seq
    cfg = lio_config()
    scans, imu, origin = to(scans, dev), to(imu, dev), to(tse3.index(traj, 0), dev)
    times = t_rel.to(dev) if with_times else None
    want = tpipe._frontend_lio(scans, imu, cfg, origin, times)
    got = tpipe.run_frontend(scans, cfg, origin, imu=imu, times=times)
    added = torch.zeros(LIO_FRAMES, dtype=torch.bool)
    added[torch.as_tensor(got.kf_frame_idx)] = True
    return got, added.to(dev), want


@pytest.mark.parametrize("with_times", [False, True])
def test_scan2map_runner_equals_eager_loop(sequence, with_times):
    traj, scans, t_rel = sequence
    got, added, want = scan2map_pair(traj, scans, t_rel if with_times else None, "cpu")
    assert_same_frontend(got.odom_poses, got.store, added, want)
    assert int(got.store.count) >= 3


@pytest.mark.parametrize("with_times", [False, True])
def test_scan2map_replayed_segments_equal_eager_loop(sequence, replayed, with_times):
    traj, scans, t_rel = sequence
    got, added, want = scan2map_pair(traj, scans, t_rel if with_times else None, "cpu")
    assert_same_frontend(got.odom_poses, got.store, added, want)
    assert {"coarse", "fine", "insert", "decay", "coarse_insert", "commit"} <= set(replayed)


@pytest.mark.parametrize("runner", ["eager", "replayed"])
def test_scan2map_with_shed_equals_step_loop(sequence, request, runner):
    """`shed` frames skip the fine insert, the decay and the coarse
    insert, in the runner as in `odometry.step(shed=True)`."""
    if runner == "replayed":
        request.getfixturevalue("replayed")
    traj, scans, _ = sequence
    cfg, origin = todo.OdometryConfig(table_size=1 << 16), tse3.index(traj, 0)
    gate = dict(dist_thresh=2.0, leaf=0.2)
    state, store = todo.init(cfg, origin), tkf.init(16, 2048)
    poses, added = [], []
    for i in range(N_FRAMES):
        scan = tpcl.PointCloud(scans.xyz[i], scans.mask[i])
        state, _ = todo.step(state, scan, cfg, shed=SHED[i])
        store, add = tkf.maybe_add(store, scan, state.pose, torch.full((), float(i)), **gate)
        poses.append(state.pose)
        added.append(add)
    got = frame_graph.scan2map(scans, cfg, origin, store=tkf.init(16, 2048), gate=gate, shed=SHED)
    assert_same_frontend(got.poses, got.store, got.added, (tse3.stack(poses), store,
                                                             torch.stack(added)))
    assert torch.equal(got.state.grid.packed, state.grid.packed)
    assert torch.equal(got.state.coarse_grid.packed, state.coarse_grid.packed)


def test_odometry_run_equals_step_loop(sequence):
    """`odometry.run` (the runner with diagnostics) against its former
    loop of `odometry.step`: poses, costs, inliers and final maps."""
    traj, scans, _ = sequence
    cfg = todo.OdometryConfig(table_size=1 << 16)
    state = todo.init(cfg, tse3.index(traj, 0))
    poses, errs, inls = [], [], []
    for i in range(N_FRAMES):
        state, diag = todo.step(state, tpcl.PointCloud(scans.xyz[i], scans.mask[i]), cfg)
        poses.append(state.pose)
        errs.append(diag["error"])
        inls.append(diag["inliers"])
    final, got, diag = todo.run(scans, cfg, tse3.index(traj, 0))
    want = tse3.stack(poses)
    assert torch.equal(got.R, want.R) and torch.equal(got.t, want.t)
    assert torch.equal(diag["error"], torch.stack(errs))
    assert torch.equal(diag["inliers"], torch.stack(inls))
    assert torch.equal(final.grid.packed, state.grid.packed)
    assert torch.equal(final.prev_pose.t, state.prev_pose.t) and final.frame == state.frame


@pytest.mark.parametrize("with_times", [False, True])
def test_lio_runner_equals_eager_loop(lio_sequence, with_times):
    got, added, want = lio_pair(lio_sequence, with_times, "cpu")
    assert_same_frontend(got.odom_poses, got.store, added, want)
    assert int(got.store.count) >= 2


def test_lio_replayed_segment_equals_eager_loop(lio_sequence, replayed):
    got, added, want = lio_pair(lio_sequence, True, "cpu")
    assert_same_frontend(got.odom_poses, got.store, added, want)
    assert set(replayed) == {"step_first", "step"}


def test_point_to_plane_icp_is_raw_then_projected(sequence):
    """The public ICP is its raw GN steps, then `se3.normalize`, with the
    fitness scored at the raw pose; the raw steps score none."""
    traj, scans, _ = sequence
    pc = tpcl.voxel_downsample(tpcl.PointCloud(scans.xyz[0], scans.mask[0]), 0.4, 4096)
    grid = tvg.insert(tvg.empty(1.0, 1 << 14), pc)
    init = tse3.Pose(tse3.exp(torch.tensor([0.2, -0.1, 0.05, 0.01, 0.02, 0.03])).R,
                     torch.tensor([0.2, -0.1, 0.05]))
    raw = treg.point_to_plane_icp_raw(pc, grid, init, iters=6, inner=2)
    res = treg.point_to_plane_icp(pc, grid, init, iters=6, inner=2)
    assert torch.equal(res.pose.R, tse3.normalize(raw.pose).R)
    assert torch.equal(res.pose.t, raw.pose.t) and raw.fitness is None
    assert torch.equal(res.fitness, treg.fitness(pc, grid, raw.pose))
    assert not torch.equal(raw.pose.R, res.pose.R)  # the projection moved the rotation


def test_runner_matches_reference_fused_scan(sequence):
    """The runner against the reference's `_frontend_fused` (one
    `lax.scan`) on the same scans."""
    from mr_slam_tpu.eval import metrics as jmet
    from mr_slam_tpu.runtime import config as jcfg
    from mr_slam_tpu.runtime import pipeline as jpipe
    from torch_parity import cloud_to_jax, pose_to_jax

    traj, scans, _ = sequence
    origin = tse3.index(traj, 0)
    got = tpipe.run_frontend(scans, config(), origin)
    jposes, jstore, jadded = jpipe._frontend_fused(
        cloud_to_jax(scans), jcfg.SlamConfig(odometry=jcfg.OdometryCfg(table_size=1 << 16),
                                              keyframes=jcfg.KeyframeCfg(capacity=16,
                                                                         points_per_kf=2048)),
        pose_to_jax(origin))
    a_port = float(tmet.ate(got.odom_poses, traj).rmse)
    a_ref = float(jmet.ate(jposes, pose_to_jax(traj)).rmse)
    assert abs(a_port - a_ref) <= 0.1 * a_ref + 0.02, (a_port, a_ref)
    assert a_port < 0.2
    assert abs(int(got.store.count) - int(jstore.count)) <= 1
    assert abs(len(got.kf_frame_idx) - int(np.sum(np.asarray(jadded)))) <= 1


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runner captures CUDA graphs only there")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("with_times", [False, True])
def test_scan2map_graphs_equal_eager_on_card(sequence, card, with_times):
    traj, scans, t_rel = sequence
    got, added, want = scan2map_pair(traj, scans, t_rel if with_times else None, card)
    assert_same_frontend(got.odom_poses, got.store, added, want)
    run = frame_graph.scan2map(to(scans, card), todo.OdometryConfig(table_size=1 << 16),
                               to(tse3.index(traj, 0), card))
    # frames 1-11 replay coarse, fine, insert and commit; the coarse
    # insert runs at frames 1-4 and 8, the decay at frame 7
    assert run.stats["captures"] == 6
    assert run.stats["replays"] == 4 * (N_FRAMES - 1) + 5 + 1


@pytest.mark.gpu
@pytest.mark.parametrize("with_times", [False, True])
def test_lio_graphs_equal_eager_on_card(lio_sequence, card, with_times):
    got, added, want = lio_pair(lio_sequence, with_times, card)
    assert_same_frontend(got.odom_poses, got.store, added, want)


@pytest.mark.gpu
def test_failed_capture_raises_on_card(card):
    """A segment that syncs the host cannot be captured: the runner
    raises instead of running it eagerly."""
    segs = frame_graph.Segments(card, "frontend")
    bufs = dict(x=torch.ones(4, device=card))
    with segs.on_stream(), pytest.raises(RuntimeError):
        segs.run("sync", lambda b: dict(n=int(b["x"].sum().item())), bufs)
