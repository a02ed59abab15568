"""Scaling bench (the port's counterpart of `examples/bench_scaling.py`):
front-end frames/s of 1 robot in 1 process against 2 and N robots in 2
and N processes, one robot a process. The reference's N devices become
N `multihost_worker` processes of one group in MRSLAM_BENCH mode:

    python -m mr_slam_torch.examples.bench_scaling [--n N] [--device cpu]
        (BENCH_FRAMES frames a robot, 10 by default)

The reference's scenario: world 7, robot r of n on a radius-22 m
circle at phase 2 pi r / n, 0.3 laps over BENCH_FRAMES frames, 16 x 512
rays (range noise from `np.random.default_rng(r)` in place of the
reference's `jax.random` keys), and its config (`config`). Each
measurement is one warm-up, then REPS timed runs; the slowest rank sets
the wall.

efficiency = fps_n / (n fps_1), efficiency_2 = fps_2 / (2 fps_1). Prints
one JSON line with the reference's keys (fps_1, fps_2, efficiency_2,
fps_n, n, efficiency, cpu_cores) and `layout`: how the processes share
the hardware (on one card they split its SMs and the host's cores).
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
from pathlib import Path

import numpy as np

from mr_slam_torch.examples import multihost_worker as worker

REPS = 3


def frames() -> int:
    return int(os.environ.get("BENCH_FRAMES", "10"))


def config(n_robots: int):
    """The reference bench's `CFG` for `n_robots` robots."""
    from mr_slam_torch.runtime.config import KeyframeCfg, OdometryCfg, SlamConfig

    return SlamConfig(
        n_robots=n_robots,
        odometry=OdometryCfg(table_size=1 << 15, scan_capacity=2048, insert_capacity=8192),
        keyframes=KeyframeCfg(capacity=16, points_per_kf=4096),
    )


def trajectories(n_robots: int, T: int):
    from mr_slam_torch.datasets import synthetic

    return [synthetic.circle_trajectory(T, radius=22.0, laps=0.3,
                                        phase=2 * np.pi * r / max(n_robots, 1))
            for r in range(n_robots)]


def inputs(n_robots: int, T: int) -> dict:
    """The scenario of `n_robots` robots as an MRSLAM_INPUT record."""
    from mr_slam_torch.datasets import synthetic

    world = synthetic.default_world(7)
    trajs = trajectories(n_robots, T)
    clouds = [synthetic.scan_batch(world, t, n_rings=16, n_azimuth=512,
                                   rng=np.random.default_rng(r)) for r, t in enumerate(trajs)]
    return dict(
        xyz=np.stack([c.xyz.numpy() for c in clouds]),
        mask=np.stack([c.mask.numpy() for c in clouds]),
        origin_R=np.stack([t.R[0].numpy() for t in trajs]),
        origin_t=np.stack([t.t[0].numpy() for t in trajs]),
        cfg=np.array(config(n_robots).to_json()),
    )


def fps(n_robots: int, T: int, device: str, log_dir: Path, reps: int = REPS) -> float:
    """Front-end frames/s of `n_robots` robots in as many processes."""
    out = log_dir / f"n{n_robots}"
    out.mkdir(parents=True, exist_ok=True)
    np.savez(out / "input.npz", **inputs(n_robots, T))
    rec = worker.bench(n_robots, n_robots, T, device, reps=reps, log_dir=out,
                       input_path=out / "input.npz")
    return rec["bench_fps"]


def measure(n: int, T: int | None = None, device: str = "cuda", reps: int = REPS,
            log_dir=None) -> dict:
    """The bench's record for 1, 2 (when n >= 2) and n processes."""
    T = frames() if T is None else T
    log_dir = Path(log_dir or tempfile.mkdtemp(prefix="mrslam-scaling-"))
    fps_1 = fps(1, T, device, log_dir, reps)
    out = {"fps_1": round(fps_1, 2)}
    fps_2 = None
    if n >= 2:
        fps_2 = fps(2, T, device, log_dir, reps)
        out.update(fps_2=round(fps_2, 2), efficiency_2=round(fps_2 / (2 * fps_1), 3))
    fps_n = fps_1 if n == 1 else fps_2 if n == 2 else fps(n, T, device, log_dir, reps)
    out.update(fps_n=round(fps_n, 2), n=n, efficiency=round(fps_n / (n * fps_1), 3),
               cpu_cores=os.cpu_count(), layout=worker.card_note(n, device))
    return out


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=4, help="robots (and processes) of the largest run")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(measure(a.n, device=a.device)))


if __name__ == "__main__":
    main()
