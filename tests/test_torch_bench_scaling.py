"""The port's scaling bench (`mr_slam_torch.examples.bench_scaling`)
against the reference's `examples/bench_scaling.py`: its config and
roads, and its record's keys from a run of 1 and 2 worker processes on
the CPU (3 frames a robot, one timed run)."""
import dataclasses
import importlib.util
from pathlib import Path

import numpy as np
import pytest

from mr_slam_torch.examples import bench_scaling
from tests import torch_parity  # noqa: F401  (one PyTorch thread, as in the workers)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def reference():
    spec = importlib.util.spec_from_file_location("reference_bench_scaling",
                                                  ROOT / "examples" / "bench_scaling.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_config_is_the_reference_s(reference):
    for n in (1, 2, 4):
        ref = dataclasses.replace(reference.CFG, n_robots=n)
        assert bench_scaling.config(n).to_json() == ref.to_json()
    assert bench_scaling.frames() == reference.T


@pytest.mark.parametrize("n", (1, 2, 4))
def test_roads_are_the_reference_s(n):
    """Robot r of n: the reference's `circle_trajectory(T, radius=22.0,
    laps=0.3, phase=2 pi r / n)` (`examples/bench_scaling.py:37-39`).
    The reference forms the angle in float32 and the port in float64: an
    ulp of a float32 angle near 2 pi is 4.8e-7 rad, 1.0e-5 m on the 22 m
    circle, so positions agree to a few such ulps."""
    from mr_slam_tpu.datasets import synthetic as jsyn

    T = bench_scaling.frames()
    for r, traj in enumerate(bench_scaling.trajectories(n, T)):
        ref = jsyn.circle_trajectory(T, radius=22.0, laps=0.3, phase=2 * np.pi * r / n)
        np.testing.assert_allclose(traj.t.numpy(), np.asarray(ref.t), atol=5e-5)
        np.testing.assert_allclose(traj.R.numpy(), np.asarray(ref.R), atol=5e-6)


def test_inputs_are_16x512_scans_of_each_robot():
    rec = bench_scaling.inputs(2, 3)
    assert rec["xyz"].shape == (2, 3, 16 * 512, 3) and rec["mask"].shape == (2, 3, 16 * 512)
    assert rec["mask"].mean() > 0.5
    np.testing.assert_array_equal(rec["origin_t"][1],
                                  bench_scaling.trajectories(2, 3)[1].t[0].numpy())


def test_record_has_the_reference_s_keys(tmp_path):
    out = bench_scaling.measure(2, T=3, device="cpu", reps=1, log_dir=tmp_path)
    assert set(out) == {"fps_1", "fps_2", "efficiency_2", "fps_n", "n", "efficiency",
                        "cpu_cores", "layout"}
    assert out["n"] == 2 and out["fps_n"] == out["fps_2"] and out["fps_1"] > 0
    # efficiency = fps_n / (n fps_1) before the rates were rounded to 0.01
    ratio = out["fps_n"] / (2 * out["fps_1"])
    slack = 5e-4 + ratio * (0.005 / out["fps_n"] + 0.005 / out["fps_1"])
    assert abs(out["efficiency"] - ratio) <= slack, (out, ratio)
    assert out["layout"].startswith("2 CPU processes")
