"""The long run (`mr_slam_torch.examples.bench_longrun`, the port of
`examples/bench_longrun.py`) against the reference's `pipeline.run` on
the same numpy scans, at a CPU size: 3 robots x 12 frames (24 in the
slow tier) at 16 x 256 rays, the long run's config, world and roads.

Tolerances (those of `chip_smoke.py`'s long-run phase, keyframes one
tighter): per robot, keyframe ATE <= 1.25 x the reference's + 0.05 m
and keyframe counts within +-1; the loop counts (all, and inter-robot)
equal. Trajectories are compared by ATE, not pose by pose: the f32
odometry parts by millimetres between the packages (see
`test_torch_frontend`)."""
import importlib

import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.examples import bench_longrun
from mr_slam_torch.ops import pointcloud as pcl
from mr_slam_torch.runtime import observability as obs
from tests.torch_parity import longrun_config_jax, longrun_reference

R, RINGS, AZIMUTH = 3, 16, 256
REFERENCE_KEYS = {"frames", "robots", "rays", "laps", "wall_s", "frontend_fps", "keyframes",
                  "loops", "inter_robot_loops", "ate_rmse_m", "stage_ms", "counters"}


@pytest.fixture(scope="module", params=[12, pytest.param(24, marks=pytest.mark.slow)])
def runs(request):
    """(T, `run`'s record on the CPU, the robots' front-end span totals,
    the reference's `longrun_reference` on the same scans)."""
    T = request.param
    out = bench_longrun.run(T, R, RINGS, AZIMUTH, device="cpu")
    fe_s = [obs.tracer.stats[f"robot{r}.frontend"].total_s for r in range(R)]
    return T, out, fe_s, longrun_reference(T, RINGS, AZIMUTH, R)


def test_longrun_matches_reference(runs):
    _, out, _, (ref_ates, ref_kfs, ref_inter, ref_loops) = runs
    for r in range(R):
        assert abs(out["keyframes"][r] - ref_kfs[r]) <= 1, (r, out["keyframes"], ref_kfs)
        assert out["ate_rmse_m"][r] <= 1.25 * ref_ates[r] + 0.05, (r, out["ate_rmse_m"], ref_ates)
    assert (out["loops"], out["inter_robot_loops"]) == (ref_loops, ref_inter)


def test_run_returns_the_reference_s_record(runs):
    """`run` returns the reference's keys plus `device`, and its front-end
    rate is R * T over the summed `robot<r>.frontend` spans."""
    T, out, fe_s, _ = runs
    assert set(out) == REFERENCE_KEYS | {"device"}
    assert out["frontend_fps"] == round(R * T / sum(fe_s), 2)
    assert (out["frames"], out["robots"], out["rays"]) == (T, R, f"{RINGS}x{AZIMUTH}")
    assert out["laps"] == round(2.3 * T / 500, 2) and len(out["ate_rmse_m"]) == R
    assert out["stage_ms"]["robot0.frontend"] > 0 and "backend.solve" in out["stage_ms"]
    assert "keyframes.capacity_saturated" not in out["counters"]
    assert out["device"].startswith("cpu")


def test_config_is_the_reference_s():
    for n in (1, 3):
        assert bench_longrun.config(n).to_json() == longrun_config_jax(n).to_json()


def test_chunked_scans_equal_one_draw():
    """CHUNK-frame raycasts drawing from one generator give the scans of
    one call over the whole road from a fresh generator."""
    n = 60
    assert n > bench_longrun.CHUNK
    trajs, scans = bench_longrun.scenario(n, 2, 8, 64)
    world = synthetic.default_world(7, extent=60.0, n_boxes=36)
    for r, traj in enumerate(trajs):
        whole = synthetic.scan_batch(world, traj, n_rings=8, n_azimuth=64,
                                     noise=bench_longrun.NOISE, rng=np.random.default_rng(r))
        assert torch.equal(scans[r].mask, whole.mask)
        assert torch.equal(scans[r].xyz, whole.xyz)


def test_roads_are_the_reference_s():
    """The trajectories are the reference's `circle_trajectory` calls
    (`examples/bench_longrun.py:60-66`). The reference forms the angle
    in float32 and the port in float64: at 2.3 laps (14.5 rad) an ulp
    of the float32 angle is 9.5e-7 rad, 2.1e-5 m on the 22 m circle,
    so positions agree to a few such ulps."""
    jsyn = importlib.import_module("mr_slam_tpu.datasets.synthetic")
    for n, r_count in ((500, 3), (120, 3), (24, 2)):
        trajs = bench_longrun.trajectories(n, r_count)
        for r, traj in enumerate(trajs):
            ref = jsyn.circle_trajectory(n, radius=22.0, laps=2.3 * n / 500.0,
                                         phase=2 * np.pi * r / r_count, ccw=(r % 2 == 0))
            np.testing.assert_allclose(traj.t.numpy(), np.asarray(ref.t), atol=1e-4)
            np.testing.assert_allclose(traj.R.numpy(), np.asarray(ref.R), atol=1e-5)


def test_run_on_the_card_raises_without_one():
    if torch.cuda.is_available():
        pytest.skip("checks the refusal on a machine without a card")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_longrun.run(T=2, R=1, rings=8, azimuth=64)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bench_longrun.timed_run([pcl.PointCloud(torch.zeros(1, 4, 3), torch.ones(1, 4, dtype=bool))],
                                bench_longrun.trajectories(1, 1), bench_longrun.config(1), "cuda")
