#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mr_slam_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

  1. card    — requires a CUDA device; prints `nvidia-smi`'s name and
               power limit.
  2. build   — compiles the hand-written kernel (`csrc/vgicp_accum.cu`)
               with nvcc from this checkout and prints ptxas' register /
               shared-memory report; builds the native max-clique solver.
  3. kernel  — the VGICP accumulation kernel against its plain PyTorch
               version on the card at the loop-verify shapes (B = 8
               candidates x N = 16384 points; tables of 8192 and 32768
               rows built by `voxel_grid.build`), both modes, with and
               without a linearization center; two launches must be
               bit-identical; CUDA-event times of both versions.
  4. main    — `runtime.pipeline.run` on the card: 3 robots on the ring
               road of `tests/test_multirobot.py` (radius 22 m, 0.55
               laps, phases 2 pi r / 3, 40 frames each), 32x1024-ray
               scans raycast on the host with numpy from fixed seeds,
               `SlamConfig(n_robots=3)` defaults except the loop gates
               (min_separation 6 from that test, the descriptor gate
               0.75 of the reference's 64x1024 long run; see DESC_GATE).
               Checks: the kernel launched, >= 1 inter-robot
               loop, per-robot keyframe ATE < 1 m and within
               1.25 x the JAX reference + 0.05 m (JAX_REF_ATE). Prints
               stage times, frames/s, peak device memory, loop counts,
               and whether a second run gives bit-identical poses.

The second-to-last line is the kernels' JSON record, the last line
`{"ok": true, "device": {...}}`.
"""
from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np

# Keyframe ATE (m) of `mr_slam_tpu.runtime.pipeline.run` on the CPU for
# the identical scans and config of `scenario()`, per robot: the
# correctness reference of phase 4 (JAX on CPU; recorded in PERF.md).
# That run accepts 24 inter-robot loops.
JAX_REF_ATE = (0.04725401848554611, 0.03672850877046585, 0.05712500587105751)

N_ROBOTS, N_FRAMES, RINGS, AZIMUTH = 3, 40, 32, 1024
# A world whose ring road no box touches (numpy worlds differ from the
# reference tests' jax.random ones, so the seed is the port's own).
WORLD_SEED = 136
# ScanContext gate. At 32x1024 rays a keyframe holds more occupied
# 0.2 m voxels than the default points_per_kf (4096) keeps, so each
# stored keyframe is the scan's rear slab (lowest x first), half of its
# descriptor columns are empty and even two scans from one pose lie
# ~0.55 apart: the test's 0.3 gate never fires. 0.75 is the gate the
# reference's own 64x1024 long run uses (`examples/bench_longrun.py`).
DESC_GATE = 0.75
VERIFY_B, VERIFY_N = 8, 16384
TOL = dict(H=(2e-3, 1e-3), b=(1e-2, 0.1), cost=(1e-3, 0.0))


def log(*args):
    print(*args, flush=True)


def scenario():
    """(trajectories, per-robot CPU scan clouds, SlamConfig) of phase 4."""
    import torch

    from mr_slam_torch.datasets import synthetic
    from mr_slam_torch.geometry import se3
    from mr_slam_torch.ops import pointcloud as pcl
    from mr_slam_torch.runtime.config import LoopCfg, SlamConfig

    world = synthetic.default_world(WORLD_SEED)
    trajs, scans = [], []
    for r in range(N_ROBOTS):
        traj = synthetic.circle_trajectory(
            N_FRAMES, radius=22.0, laps=0.55, phase=2 * math.pi * r / 3
        )
        rng = np.random.default_rng(r)
        clouds = []
        for i in range(N_FRAMES):
            xyz, _, hit = synthetic.scan(
                world, se3.index(traj, i), n_rings=RINGS, n_azimuth=AZIMUTH,
                noise=0.01, rng=rng,
            )
            clouds.append(synthetic.scan_to_cloud(xyz, hit))
        trajs.append(traj)
        scans.append(pcl.PointCloud(torch.stack([c.xyz for c in clouds]),
                                    torch.stack([c.mask for c in clouds])))
    cfg = SlamConfig(n_robots=N_ROBOTS, loops=LoopCfg(dist_thresh=DESC_GATE, min_separation=6))
    return trajs, scans, cfg


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device (torch.cuda.is_available() is false)")
    import mr_slam_torch  # noqa: F401  (fails outside a checkout of the repo)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(f"[card] {smi}")
    log(f"[card] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


def phase_build():
    from mr_slam_torch import native
    from mr_slam_torch.ops import cuda_build

    t0 = time.perf_counter()
    path = cuda_build.build("vgicp_accum")
    dt = time.perf_counter() - t0
    log(f"[build] {path.name} in {dt:.1f} s")
    for line in cuda_build.build_log("vgicp_accum").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"[build] ptxas: {line.strip()}")
    native.load()
    log("[build] native max-clique solver loaded")


def _cuda_ms(fn, iters):
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def verify_inputs(dev):
    """Loop-verify shaped inputs: B merged-submap-like clouds of the
    synthetic world (8 scans each, voxelized to N), plane-regularized
    coarse (leaf 2, 8192 rows) and fine (leaf 0.5, 32768 rows) tables of
    them, and the clouds moved by small seeded poses."""
    import torch

    from mr_slam_torch.datasets import synthetic
    from mr_slam_torch.geometry import se3
    from mr_slam_torch.ops import pointcloud as pcl, voxel_grid

    world = synthetic.default_world(7)
    rng = np.random.default_rng(1234)
    clouds = []
    for b in range(VERIFY_B):
        traj = synthetic.circle_trajectory(8, radius=22.0, laps=0.05, phase=0.7 * b)
        parts = []
        for i in range(8):
            xyz, _, hit = synthetic.scan(world, se3.index(traj, i), 32, 1024, rng=rng)
            c = pcl.transform(synthetic.scan_to_cloud(xyz, hit), se3.index(traj, i))
            parts.append(c)
        merged = pcl.PointCloud(torch.cat([p.xyz for p in parts]), torch.cat([p.mask for p in parts]))
        merged = pcl.PointCloud(merged.xyz.to(dev), merged.mask.to(dev))
        clouds.append(pcl.voxel_downsample(merged, 0.4, VERIFY_N))
    target = pcl.PointCloud(torch.stack([c.xyz for c in clouds]), torch.stack([c.mask for c in clouds]))
    coarse = voxel_grid.build(target, 2.0, 1 << 13, min_points=3, regularize="plane")
    fine = voxel_grid.build(target, 0.5, 1 << 15, min_points=3, regularize="plane")
    xi = torch.as_tensor(rng.normal(0, [0.1, 0.1, 0.02, 0.005, 0.005, 0.02], (VERIFY_B, 6)),
                         dtype=torch.float32, device=dev)
    tp = se3.apply(se3.exp(xi), target.xyz).contiguous()
    mask = target.mask.contiguous()
    return tp, mask, {"coarse": coarse, "fine": fine}


def phase_kernel(dev):
    import torch

    from mr_slam_torch.ops import hopper_vgicp, voxel_grid

    tp, mask, grids = verify_inputs(dev)
    log(f"[kernel] inputs: tp {tuple(tp.shape)}, valid points/item "
        f"{mask.sum(1).min().item()}..{mask.sum(1).max().item()}, tables "
        + ", ".join(f"{k} {tuple(g.packed.shape)}" for k, g in grids.items()))
    center = tp[:, ::97].mean(dim=1).contiguous()
    record = None
    for gname, grid in grids.items():
        table = grid.packed.contiguous()
        slot, found = voxel_grid.lookup_slots(grid, tp)
        for mode in ("hash", "slot"):
            for cen in (None, center):
                kw = dict(leaf=grid.leaf) if mode == "hash" else dict(slot=slot, found=found)
                kw.update(center=cen, max_corr2=1.0)
                out = hopper_vgicp.gn_accumulate(tp, mask, table, **kw)
                again = hopper_vgicp.gn_accumulate(tp, mask, table, **kw)
                ref = hopper_vgicp.gn_accumulate_plain(tp, mask, table, **kw)
                torch.cuda.synchronize()
                errs = {}
                for name, a, r in zip(("H", "b", "cost"), out[:3], ref[:3]):
                    rtol, atol = TOL[name]
                    ok = torch.allclose(a, r, rtol=rtol, atol=atol)
                    errs[name] = (a - r).abs().max().item()
                    if not ok:
                        raise AssertionError(f"{gname}/{mode}/center={cen is not None}: {name} "
                                             f"max abs err {errs[name]} beyond rtol {rtol} atol {atol}")
                if not torch.equal(out[3], ref[3]):
                    raise AssertionError(f"inliers differ: {out[3].tolist()} vs {ref[3].tolist()}")
                if not all(torch.equal(x, y) for x, y in zip(out, again)):
                    raise AssertionError("two launches are not bit-identical")
                k_ms = _cuda_ms(lambda: hopper_vgicp.gn_accumulate(tp, mask, table, **kw), 200)
                p_ms = _cuda_ms(lambda: hopper_vgicp.gn_accumulate_plain(tp, mask, table, **kw), 20)
                tag = f"{gname}/{mode}/{'center' if cen is not None else 'origin'}"
                log(f"[kernel] {tag}: ok; max abs err H {errs['H']:.3g} (|H| max "
                    f"{out[0].abs().max().item():.3g}) b {errs['b']:.3g} cost {errs['cost']:.3g}; "
                    f"inliers {out[3].sum().item():.0f} equal; bit-identical rerun; "
                    f"kernel {k_ms:.4f} ms, plain {p_ms:.4f} ms")
                if gname == "fine" and mode == "slot" and cen is not None:  # the main path's call
                    record = dict(max_abs_err=max(errs.values()), ms=k_ms, plain_ms=p_ms)
    return record


def _ate(res, trajs, r):
    import torch

    from mr_slam_torch.eval import metrics
    from mr_slam_torch.geometry import se3

    kf_idx = torch.as_tensor(res.robots[r].kf_frame_idx)
    true_kf = se3.index(trajs[r], kf_idx)
    est = res.optimized_trajectory(r)
    return float(metrics.ate(se3.Pose(est.R.cpu(), est.t.cpu()), true_kf).rmse)


def phase_main(dev):
    import torch

    from mr_slam_torch.geometry import se3
    from mr_slam_torch.ops import hopper_vgicp
    from mr_slam_torch.ops import pointcloud as pcl
    from mr_slam_torch.runtime import observability as obs
    from mr_slam_torch.runtime import pipeline

    t0 = time.perf_counter()
    trajs, scans, cfg = scenario()
    log(f"[main] scans raycast on the host in {time.perf_counter() - t0:.1f} s: "
        f"{N_ROBOTS} robots x {N_FRAMES} frames x {RINGS}x{AZIMUTH} rays")
    scans = [pcl.PointCloud(s.xyz.to(dev), s.mask.to(dev)) for s in scans]
    origins = [se3.index(t, 0).to(dev) for t in trajs]

    def run():
        obs.tracer.stats.clear()
        obs.metrics.counters.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = pipeline.run(scans, cfg, origins=origins)
        torch.cuda.synchronize()
        return res, time.perf_counter() - t

    pipeline.run([pcl.PointCloud(s.xyz[:3], s.mask[:3]) for s in scans], cfg, origins=origins)
    torch.cuda.synchronize()  # warm-up: first-call overheads out of the timed run
    torch.cuda.reset_peak_memory_stats()
    hopper_vgicp.reset_launch_count()
    res, wall = run()
    launches = hopper_vgicp.launch_count()
    peak = torch.cuda.max_memory_allocated()
    spans = obs.tracer.report()
    counters = dict(obs.metrics.counters)
    log(f"[main] pipeline.run wall {wall:.3f} s; peak device memory {peak / 2**20:.1f} MiB; "
        f"vgicp_accum launches {launches}")
    for r in range(N_ROBOTS):
        s = spans[f"robot{r}.frontend"]
        log(f"[main] robot {r} front-end {s['total_s']:.3f} s = {N_FRAMES / s['total_s']:.1f} frames/s, "
            f"{int(res.robots[r].store.count)} keyframes")
    for name in ("backend.prepare", "backend.graph", "backend.associate", "backend.pcm",
                 "backend.solve"):
        log(f"[main] {name} {spans[name]['total_s']:.3f} s")
    inter = [l for l in res.loops if l["robot_a"] != l["robot_b"]]
    log(f"[main] loops: candidates {counters.get('loops.candidates', 0):.0f}, verified "
        f"{counters.get('loops.verified', 0):.0f}, accepted after PCM {len(res.loops)} "
        f"({len(inter)} inter-robot), PCM rejected {counters.get('backend.pcm_rejected', 0):.0f}")
    ates = [_ate(res, trajs, r) for r in range(N_ROBOTS)]
    log(f"[main] keyframe ATE per robot (m): {[round(a, 4) for a in ates]}; JAX reference "
        f"{JAX_REF_ATE}")
    res2, wall2 = run()
    same = torch.equal(res.opt_poses.t, res2.opt_poses.t) and torch.equal(res.opt_poses.R, res2.opt_poses.R)
    log(f"[main] second run wall {wall2:.3f} s; optimized poses bit-identical across runs: {same}")

    if launches <= 0:
        raise AssertionError("the VGICP kernel was not launched on the main path")
    if not inter:
        raise AssertionError(f"no inter-robot loop accepted (all: {len(res.loops)})")
    for r, a in enumerate(ates):
        if not a < 1.0:
            raise AssertionError(f"robot {r} keyframe ATE {a:.3f} m >= 1.0 m")
        if JAX_REF_ATE is not None and not a <= 1.25 * JAX_REF_ATE[r] + 0.05:
            raise AssertionError(f"robot {r} ATE {a:.3f} m beyond 1.25 x JAX {JAX_REF_ATE[r]} + 0.05")
    return launches


def main() -> int:
    import torch

    smi = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    kernel = phase_kernel(dev)
    launches = phase_main(dev)
    print(json.dumps({"kernels": [dict(
        name="vgicp_accum", route="cuda", source="mr_slam_torch/csrc/vgicp_accum.cu",
        replaces="mr_slam_tpu/ops/pallas_vgicp.py:77", launches=launches, **kernel,
    )]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
