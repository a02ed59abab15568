"""Long-horizon full-pipeline benchmark (the port's counterpart of
`examples/bench_longrun.py`): 500 frames x 3 robots at 64 x 1024 rays
with 3 cm range noise, the scale the NCLT multi-robot demos run at, on
the synthetic courtyard world with exact ground truth.

    python -m mr_slam_torch.examples.bench_longrun       (FRAMES / ROBOTS resize it)
    FRAMES=24 python -m mr_slam_torch.examples.bench_longrun --device cpu --rings 16 --azimuth 256

Per robot: a multi-lap ring road through the shared world, robots
starting at phase 2 pi r / R and driving in alternating directions, so
they overlap everywhere. Prints, last, one JSON line: front-end frames/s,
end-to-end wall, loop counts, keyframe ATE RMSE of the optimized
trajectories against the truth, the stage-time breakdown and the
counters.

Where it differs from the reference:
  * The scans are drawn with numpy: robot r's range noise comes from
    `np.random.default_rng(r)`, raycast in chunks of CHUNK frames as the
    reference dispatches them. `standard_normal` draws one chunk after
    another, so the chunked draws equal one (T, rings, azimuth) draw
    from the same generator. The reference draws with `jax.random`
    keys, whose output cannot be reproduced here, so this is the port's
    own scene; a parity check feeds the same arrays to both packages.
  * The port's `pipeline.run` nests each front-end span under its robot
    (`robot<r>.frontend`), where the reference's reads `frontend`. So
    `frontend_fps` is R * T over the sum of the `robot<r>.frontend`
    totals, and `stage_ms` carries the port's span names.
  * `device` (a key the reference lacks) names the card and its power
    limit as `nvidia-smi` prints them.
  * On a card, a 3-frame run first loads the kernels and libraries, so
    the timed wall holds no one-time start-up.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import time

import numpy as np
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import metrics
from mr_slam_torch.geometry import se3
from mr_slam_torch.ops import hopper_vgicp
from mr_slam_torch.ops import pointcloud as pcl
from mr_slam_torch.runtime import observability as obs
from mr_slam_torch.runtime import pipeline
from mr_slam_torch.runtime.config import KeyframeCfg, LoopCfg, OdometryCfg, PGOCfg, SlamConfig
from mr_slam_torch.runtime.online import resolve_device

CHUNK = 50  # frames per raycast call, as the reference dispatches them
NOISE = 0.03  # range noise (m)


def config(R: int) -> SlamConfig:
    """The reference long run's `SlamConfig` for R robots."""
    return SlamConfig(
        n_robots=R,
        odometry=OdometryCfg(scan_capacity=8192, insert_capacity=16384),
        keyframes=KeyframeCfg(dist_thresh=2.0, capacity=256, points_per_kf=4096),
        loops=LoopCfg(dist_thresh=0.75, min_separation=8, candidates=2,
                      fitness_thresh=0.15, max_loops=256),
        # the reference's optimization budget for production-scale graphs
        pgo=PGOCfg(rot_cg_iters=120, gn_iters=30, pose_cg_iters=120,
                   node_capacity=1024, edge_capacity=4096),
    )


def laps(T: int) -> float:
    """Laps of a T-frame road: ~0.64 m of arc a frame, the 500-frame
    operating point, so a shorter run shrinks the route rather than
    stretching each step."""
    return 2.3 * T / 500.0


def trajectories(T: int, R: int) -> list[se3.Pose]:
    """Robot r's road: radius 22 m at phase 2 pi r / R, counter-clockwise
    for even r. CPU poses (T,)."""
    return [synthetic.circle_trajectory(T, radius=22.0, laps=laps(T), phase=2 * np.pi * r / R,
                                        ccw=(r % 2 == 0))
            for r in range(R)]


def scenario(T: int = 500, R: int = 3, rings: int = 64, azimuth: int = 1024, device="cpu"):
    """(trajectories, per-robot scans (T, rings * azimuth) on `device`):
    world 7 of extent 60 m with 36 boxes, each robot's scans raycast on
    `device` CHUNK frames at a time with 3 cm of range noise from
    `np.random.default_rng(r)`."""
    dev = torch.device(device)
    world = synthetic.default_world(7, extent=60.0, n_boxes=36)
    trajs = trajectories(T, R)
    scans = []
    for r, traj in enumerate(trajs):
        rng = np.random.default_rng(r)
        parts = [synthetic.scan_batch(world, se3.index(traj, slice(i, min(i + CHUNK, T))).to(dev),
                                      n_rings=rings, n_azimuth=azimuth, noise=NOISE, rng=rng)
                 for i in range(0, T, CHUNK)]
        scans.append(pcl.PointCloud(torch.cat([p.xyz for p in parts]),
                                    torch.cat([p.mask for p in parts])))
    return trajs, scans


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def timed_run(scans, trajs, cfg: SlamConfig, device):
    """`pipeline.run` on `device` with the tracer's stats and the counters
    cleared first; returns (result, wall s)."""
    dev = resolve_device(device)
    origins = [se3.index(t, 0) for t in trajs]
    obs.tracer.stats.clear()
    obs.metrics.counters.clear()
    _sync(dev)
    t0 = time.perf_counter()
    res = pipeline.run(scans, cfg, origins=origins, device=dev)
    _sync(dev)
    return res, time.perf_counter() - t0


def keyframe_ates(res, trajs) -> list[float]:
    """Per robot: ATE RMSE (m) of the optimized keyframe poses against
    the true poses of their frames."""
    out = []
    for r, traj in enumerate(trajs):
        est = res.optimized_trajectory(r)
        true_kf = se3.index(traj, torch.as_tensor(res.robots[r].kf_frame_idx))
        out.append(float(metrics.ate(se3.Pose(est.R.cpu(), est.t.cpu()), true_kf).rmse))
    return out


def device_note(device) -> str:
    """The card's name and power limit as `nvidia-smi` prints them (its
    name alone without `nvidia-smi`), or the CPU's core count."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return f"cpu, {os.cpu_count()} cores"
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    try:
        lines = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip().splitlines()
        return lines[index].strip()
    except (OSError, subprocess.CalledProcessError, IndexError):
        return torch.cuda.get_device_name(index)


def summary(res, trajs, wall: float, rings: int, azimuth: int, device) -> dict:
    """The reference's result record (its keys and rounding) plus `device`,
    read from the tracer and counters of the run that gave `res`."""
    R, T = len(trajs), trajs[0].t.shape[0]
    fe_s = [obs.tracer.stats[f"robot{r}.frontend"].total_s
            for r in range(R) if f"robot{r}.frontend" in obs.tracer.stats]
    return {
        "frames": T, "robots": R, "rays": f"{rings}x{azimuth}",
        "laps": round(laps(T), 2),
        "wall_s": round(wall, 1),
        "frontend_fps": round(R * T / sum(fe_s), 2) if len(fe_s) == R else None,
        "keyframes": [int(rr.store.count) for rr in res.robots],
        "loops": len(res.loops),
        "inter_robot_loops": sum(1 for l in res.loops if l["robot_a"] != l["robot_b"]),
        "ate_rmse_m": [round(a, 3) for a in keyframe_ates(res, trajs)],
        "stage_ms": {k: round(v.total_s * 1e3, 1) for k, v in sorted(obs.tracer.stats.items())},
        "counters": {k: int(v) for k, v in sorted(obs.metrics.counters.items())},
        "device": device_note(device),
    }


def run(T: int = 500, R: int = 3, rings: int = 64, azimuth: int = 1024,
        device="cuda") -> dict:
    """The long run on `device` (the card unless the caller passes
    device="cpu"; a missing card raises): the scans raycast there, then
    one timed `pipeline.run`. Returns `summary`'s record."""
    dev = resolve_device(device)
    cfg = config(R)
    print(f"raycasting {R} x {T} frames at {rings}x{azimuth}...", flush=True)
    trajs, scans = scenario(T, R, rings, azimuth, dev)
    if dev.type == "cuda":  # warm-up: kernels and libraries loaded outside the timed run
        pipeline.run([pcl.PointCloud(s.xyz[:3], s.mask[:3]) for s in scans], cfg,
                     origins=[se3.index(t, 0) for t in trajs], device=dev)
    res, wall = timed_run(scans, trajs, cfg, dev)
    return summary(res, trajs, wall, rings, azimuth, dev)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rings", type=int, default=64)
    ap.add_argument("--azimuth", type=int, default=1024)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    T = int(os.environ.get("FRAMES", "500"))
    R = int(os.environ.get("ROBOTS", "3"))
    hopper_vgicp.reset_launch_count()
    out = run(T, R, a.rings, a.azimuth, a.device)
    if torch.device(a.device).type == "cuda":
        print(f"peak device memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB, "
              f"vgicp_accum launches {hopper_vgicp.launch_count()} by batch "
              f"{dict(sorted(hopper_vgicp.launches_by_batch().items()))} (the warm-up and the "
              "run)", flush=True)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
