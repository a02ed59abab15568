"""A-LOAM feature odometry's frame runner (`runtime/frame_graph.Loam`,
behind `frontend/feature_odometry.run`), which replays CUDA graphs on
the card, against the loop of `feature_odometry.step` it replaces
(`feature_odometry._run_eager`) and against the reference's `run` (one
`lax.scan` of the jitted `step`).

The runner calls the same stages on the same values as `step`, so on
one device the two agree bit for bit: poses, errors, inliers and the
final maps. On the CPU the runner runs its segments eagerly; `replayed`
re-runs every segment after its first call on the buffers it first saw,
writing into the outputs it first returned, as a CUDA graph replays, so
the CPU checks that every frame's state flows through the static
buffers. Against the reference the bound is `tests/test_torch_features.py`'s:
keyframe-free ATE within 1.25 x the reference's + 0.05 m.

Sizes: 6 frames of the reference test's road (radius 25 m, 16x512 rays,
range images by `preprocess.to_range_image`), `table_size=1 << 16`. The
`gpu` test compares the captured graphs with the loop of `step` on the
card (the card machine has no JAX):

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_feature_graph.py
"""
import functools

import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import metrics as tmet
from mr_slam_torch.frontend import feature_odometry as tfo, odometry as todo
from mr_slam_torch.frontend import preprocess as tpre
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import frame_graph
from torch_parity import make_scans

N = 6
MODEL = tpre.LidarModel(n_rings=16, fov_up=15.0, fov_down=-25.0)  # the raycaster's FOV
CONFIG = todo.OdometryConfig(table_size=1 << 16)


@functools.lru_cache(maxsize=None)
def images(n: int = N):
    """(traj, (n, 16, 512, 3) range images, (n, 16, 512) hits) of the
    reference test's road, in the body frame, binned in the sensor
    frame."""
    world = synthetic.default_world(0)
    traj = synthetic.circle_trajectory(12, radius=25.0, laps=0.06)
    traj = tse3.Pose(traj.R[:n], traj.t[:n])
    scans = make_scans(world, traj, n, seed=0, n_rings=16, n_azimuth=512)
    up = torch.tensor([0.0, 0.0, 0.8])
    xyz, hit = [], []
    for i in range(n):
        img, h, _ = tpre.to_range_image(
            tpcl.park(tpcl.PointCloud(scans.xyz[i] - up, scans.mask[i])), MODEL, 512)
        xyz.append(torch.where(h[..., None], img + up, img))
        hit.append(h)
    return traj, torch.stack(xyz), torch.stack(hit)


def _to(x, dev):
    return tuple(v.to(dev) if isinstance(v, torch.Tensor) else
                 tse3.Pose(v.R.to(dev), v.t.to(dev)) for v in x)


def assert_same_run(got, want):
    (state, poses, diag), (w_state, w_poses, w_diag) = got, want
    assert torch.equal(poses.R, w_poses.R) and torch.equal(poses.t, w_poses.t)
    for k in ("error", "inliers"):
        assert torch.equal(diag[k], w_diag[k]), k
    assert torch.equal(state.grid.packed, w_state.grid.packed)
    assert torch.equal(state.coarse_grid.packed, w_state.coarse_grid.packed)
    assert torch.equal(state.prev_pose.t, w_state.prev_pose.t) and state.frame == w_state.frame


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


@pytest.mark.parametrize("harness", ["eager", "replayed"])
def test_run_equals_step_loop(request, harness):
    """`run` through the runner (frame 0 eager, then the segments' runs;
    under `replayed`, replays on the buffers of their first call) against
    the loop of `step`, bit for bit."""
    if harness == "replayed":
        request.getfixturevalue("replayed")
    traj, xyz, hit = images()
    origin = tse3.index(traj, 0)
    want = tfo._run_eager(xyz, hit, CONFIG, origin)
    assert_same_run(tfo.run(xyz, hit, CONFIG, origin), want)
    assert float(want[2]["inliers"][-1]) > 50


def test_runner_segments_and_stats():
    """Frame 0 runs `first` and `maintain`; every later frame `coarse`,
    `loam` and `maintain` (eagerly on the CPU: no capture, no replay)."""
    traj, xyz, hit = images()
    out = frame_graph.loam(xyz, hit, CONFIG, tse3.index(traj, 0))
    assert out.stats["frames"] == N and out.stats["captures"] == 0
    assert out.store is None and out.error.shape == (N,) and float(out.error[0]) == 0.0


def test_run_matches_reference():
    """The runner against the reference's `run` on the same range images."""
    from mr_slam_tpu.eval import metrics as jmet
    from mr_slam_tpu.frontend import feature_odometry as jfo, odometry as jodo
    from tests.torch_parity import pose_to_jax, to_jax

    traj, xyz, hit = images()
    _, poses, _ = tfo.run(xyz, hit, CONFIG, tse3.index(traj, 0))
    _, jposes, _ = jfo.run(to_jax(xyz), to_jax(hit), jodo.OdometryConfig(table_size=1 << 16),
                           pose_to_jax(tse3.index(traj, 0)))
    a_port = float(tmet.ate(poses, traj).rmse)
    a_ref = float(jmet.ate(jposes, pose_to_jax(traj)).rmse)
    assert a_port <= 1.25 * a_ref + 0.05, (a_port, a_ref)


@pytest.mark.gpu
def test_graphs_equal_step_loop_on_card():
    """The runner on the card (frame 0 eager, frame 1 captures, frames 2-5
    replay) against the loop of `step` there, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the runner captures CUDA graphs only there")
    dev = torch.device("cuda", 0)
    traj, xyz, hit = _to(images(), dev)
    origin = tse3.index(traj, 0)
    want = tfo._run_eager(xyz, hit, CONFIG, origin)
    out = frame_graph.loam(xyz, hit, CONFIG, origin)
    assert_same_run((out.state, out.poses, dict(error=out.error, inliers=out.inliers)), want)
    assert out.stats["captures"] == 3 and out.stats["replays"] == 3 * (N - 1)
