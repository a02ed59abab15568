#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`mr_slam_torch`) on one CUDA card.

    python3 chip_smoke.py

Phases (each prints its own lines; any failure exits non-zero):

  1. card    — requires a CUDA device; prints `nvidia-smi`'s name and
               power limit.
  2. build   — compiles the hand-written kernels (`csrc/vgicp_accum.cu`,
               `csrc/terrain_stencil.cu`) with nvcc from this checkout,
               both at once, and prints ptxas' register / shared-memory /
               spill report of each; builds the native max-clique solver.
  3. kernel  — the VGICP accumulation kernel against its plain PyTorch
               version on the card at the loop-verify shapes (B = 8
               candidates x N = 16384 points; tables of 8192 and 32768
               rows built by `voxel_grid.build`): hash and slot mode,
               with and without a linearization center, the points
               moved by `pose=` inside the kernel or taken as
               transformed; then the main path's call and hash mode at
               the first bench cell's batch (B = 64 x N = 4096, 2^14-row
               tables, `bench_batch_inputs`). H, b and cost within TOL,
               inliers equal, two launches bit-identical.
  4. stencil — the terrain-stencil kernel against its plain version at
               2048^2 (the reference's bench size) and 4096^2, on the
               bench's random field and on smooth terrain with 80 % valid
               cells: step and the enough mask exact, the other layers
               within STENCIL_ATOL, a bit-identical rerun, and both
               within 1e-3 (rad / m) of a float64 evaluation on the
               256^2 far corner.
  5. main    — `runtime.pipeline.run` on the card: 3 robots on the ring
               road of `tests/test_multirobot.py` (radius 22 m, 0.55
               laps, phases 2 pi r / 3, 40 frames each), 32x1024-ray
               scans raycast on the host with numpy from fixed seeds,
               `SlamConfig(n_robots=3)` defaults except the loop gates
               (min_separation 6 from that test, the descriptor gate
               0.75 of the reference's 64x1024 long run; see DESC_GATE).
               Checks: the VGICP kernel launched, >= 1 inter-robot loop,
               per-robot keyframe ATE < 1 m and within 1.25 x the JAX
               reference + 0.05 m (JAX_REF_ATE), and a second run gives
               bit-identical optimized poses. Prints stage times,
               frames/s, peak device memory and loop counts.
  6. map     — the products of phase 5's result on the card:
               `pipeline.compose_map` and `pipeline.build_elevation(size=
               600)`. Checks: the stencil kernel launched, the costmap
               has free and lethal cells, valid / free / lethal counts
               within 5 % of the reference map's (JAX_REF_MAP), the
               kernel's lethal cells within 0.1 % of a float64
               classification of the same map (`lethal64`), a second
               build bit-identical, and the kernel against its plain
               version on that 600^2 grid. Then robot 0's 40 frames
               through the reference's per-frame GEM tick (shift,
               predict, motion_update, fuse; `runtime/online.py:400-421`)
               on an `ElevationCfg()` grid, features and costmap on the
               last grid, which must be centred on the robot; stage
               times.

  7. online  — the streaming entry point on the card: phase 5's scans
               through `datasets.replay.replay` as one interleaved stream
               (robot r's frame i stamped 0.1 i + 0.03 r) into
               `runtime.online.OnlineSlam(cfg, enable_gem=True,
               device=cuda)` with the reference launch's rates (a loop
               stage every 3 keyframes, TF at 10 Hz, the merged map at
               3 Hz). Checks: the VGICP kernel launched, >= 1
               inter-robot loop, per-robot keyframe ATE < 1 m and within
               1.25 x the JAX reference session + 0.05 m
               (JAX_REF_ONLINE_ATE), map -> robot_r/odom in the TF buffer
               for every robot, a merged map with points, one flushed GEM
               submap per keyframe. Then the session's map product
               (`global_elevation(size=600)`, features through the
               stencil kernel, costmap with free and lethal cells, the
               kernel against its plain version on that grid); a resume
               (`checkpoint.save_session` at the stream's midpoint,
               `load_session(device=cuda)` into a fresh session, the rest
               of the stream) bit-identical to the uninterrupted session
               in optimized poses, keyframe counts and accepted loops;
               and the real-format chain at production scan size
               (`sequence_artifact.generate`: 2 robots x 24 frames at
               64x1024 rays, 0.3 laps, under `mr_slam_torch/build/`;
               `run_session(device=cuda)`: 48 frames, ATE < 0.5 m).
               Prints add_frame frames/s per robot, the online span
               totals, loop stages, peak device memory, the host syncs
               per frame and their sites (`count_syncs`), the
               checkpoint's size and save / load walls, and the
               real-format walls.

Every kernel check of phases 3, 4 and 6 prints, for its shape, the
device time (`graph_ms`: calls captured in a CUDA graph, replays timed
with CUDA events), the eager call time (`_cuda_ms`), the plain
version's time, and the bound (`bound`: bytes over the HBM rate or f32
operations over the f32 peak, whichever is larger) with the device
time's share of it.

The last three lines are the kernels' JSON record (the launch counts of
the main path's runs of phases 5 and 6 plus the online session's of
phase 7; the times, error and bound of
each kernel at the main path's shape: VGICP's fine/slot/center/pose
call at B = 8, the stencil at the 600^2 map grid), the card's name and
power limit as `nvidia-smi` prints them, and `{"ok": true, "device":
{...}}`.
"""
from __future__ import annotations

import collections
import json
import math
import subprocess
import sys
import time
from typing import NamedTuple

import numpy as np

# Keyframe ATE (m) of `mr_slam_tpu.runtime.pipeline.run` on the CPU for
# the identical scans and config of `scenario()`, per robot: the
# correctness reference of phase 5 (JAX on CPU; recorded in PERF.md).
# That run accepts 24 inter-robot loops.
JAX_REF_ATE = (0.04725401848554611, 0.03672850877046585, 0.05712500587105751)
# Cell counts of the global map of that reference run, the correctness
# reference of phase 6 (JAX on CPU; PERF.md): valid cells of
# `mr_slam_tpu.runtime.pipeline.build_elevation(result, cfg, size=600)`,
# free and lethal cells of that elevation map classified through the
# window-local plane fit (`features_plain` + `costmap.from_elevation`;
# a float64 fit gives the same counts). The reference's own costmap
# has 4479 lethal cells (355 lethal there only, 5 only here): its
# absolute-coordinate moments cancel in float32 and put slope errors of
# up to 1.57 rad on that map, a defect the port does not copy.
# Re-record the counts whenever the scenario changes.
JAX_REF_MAP = dict(valid=60664, free=56535, lethal=4129)
# Keyframe ATE (m) of `mr_slam_tpu.runtime.online.OnlineSlam` on the CPU
# over the identical stream and config of phase 7 (`online_frames`,
# `online_config`; GEM on), per robot: the correctness reference of
# phase 7, recorded with `tests/torch_parity.online_reference()`. That
# session accepts JAX_REF_ONLINE_LOOPS inter-robot loops. Re-record both
# whenever the scenario or the session's cadences change.
JAX_REF_ONLINE_ATE = (0.13014179468154907, 0.08666271716356277, 0.18259571492671967)
JAX_REF_ONLINE_LOOPS = 24
# the reference launch's rates (`global_manager.launch`): TF at 10 Hz,
# the merged map at 3 Hz; a loop stage every 3 keyframes (the default)
ONLINE_TF_PERIOD_S, ONLINE_COMPOSE_PERIOD_S = 0.1, 1.0 / 3.0
# the real-format chain of phase 7 (the bench's `realformat` stage at
# 64x1024 rays, ~1.8 m of arc per frame)
REAL_ROBOTS, REAL_FRAMES, REAL_RINGS, REAL_AZIMUTH, REAL_LAPS = 2, 24, 64, 1024, 0.3
MAP_SIZE = 600
STENCIL_SIZES = (2048, 4096)
# kernel vs plain on the card: the same float32 operations in the same
# order (--fmad=false); only the math library's atanf may part by an ulp
STENCIL_ATOL = 1e-6

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
    """(trajectories, per-robot CPU scan clouds, SlamConfig) of phase 5."""
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


KERNELS = ("vgicp_accum", "terrain_stencil")


def phase_build():
    from concurrent.futures import ThreadPoolExecutor

    from mr_slam_torch import native
    from mr_slam_torch.ops import cuda_build

    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:  # one nvcc per source, all at once
        paths = list(pool.map(cuda_build.build, KERNELS))
    log(f"[build] {', '.join(p.name for p in paths)} in {time.perf_counter() - t0:.1f} s")
    for name in KERNELS:
        for line in cuda_build.build_log(name).splitlines():
            if any(k in line for k in ("registers", "spill", "Compiling entry")):
                log(f"[build] {name} ptxas: {line.strip()}")
    native.load()
    log("[build] native max-clique solver loaded")


def _cuda_ms(fn, iters):
    """Eager call time: CUDA events around `iters` back-to-back calls,
    so the wrapper's host work is in it whenever it exceeds the kernel."""
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


def graph_ms(fn, calls=100, replays=5):
    """Device time per call: `calls` calls captured in one CUDA graph,
    its replays timed with CUDA events. The host's wrapper work runs only
    at capture, so what is left is the kernels and the gaps between
    graph nodes. Inputs stay in L2 from call to call where they fit, as
    they do across the inner GN steps of one registration."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * calls)


# The H100 SXM's published peaks (NVIDIA's data sheet, 700 W): HBM3 rate
# and float32 outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
VGICP_OPS_PER_POINT = 200   # gates, adjugate inverse, 29 integrands
STENCIL_OPS_PER_CELL = 200  # separable moments, closed form, blend


def bound(n_bytes, n_ops):
    """(bound_ms, bound_by): the larger of bytes over HBM rate and f32
    operations over the f32 peak."""
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def vgicp_bound(mask, table, slot=None, found=None, leaf=None, xyz=None, pose=None,
                center=None, **_):
    """Bound of one accumulation call, each byte counted once: per point
    xyz 12 + mask 1 (+ slot 4 + found 1 in slot mode), 64 B per distinct
    table row the inputs need (slot mode: the found slots of valid
    points; hash mode: the hashed slots of valid points, whose rows
    decide `found`), the pose (48 B) and center (12 B) per item, and the
    (B, 44) f32 result."""
    import torch

    from mr_slam_torch.ops import voxel_grid

    B, N = mask.shape
    if slot is None:
        if pose is not None:
            from mr_slam_torch.ops.hopper_vgicp import transform_plain

            xyz = transform_plain(pose, xyz)
        slot, found = voxel_grid.lookup_slots(voxel_grid.VoxelGrid(table, leaf), xyz)
        need = mask
        per_point = 13
    else:
        need = mask & found
        per_point = 18
    rows = sum(int(torch.unique(slot[b][need[b]]).numel()) for b in range(B))
    n_bytes = B * N * per_point + 64 * rows + B * 44 * 4
    n_bytes += B * 48 * (pose is not None) + B * 12 * (center is not None)
    return bound(n_bytes, B * N * VGICP_OPS_PER_POINT) + (rows,)


def stencil_bound(H, W):
    """Bound of one stencil call: height 4 B + valid 1 B read, four f32
    layers written, 21 B per cell."""
    return bound(21 * H * W, STENCIL_OPS_PER_CELL * H * W)


class VerifyInputs(NamedTuple):
    xyz: object    # (B, N, 3) source points
    mask: object   # (B, N) bool
    pose: object   # se3.Pose (B,) that moves them
    tp: object     # (B, N, 3) se3.apply(pose, xyz)
    grids: dict    # name -> voxel_grid.VoxelGrid (B, H, 16)


def verify_inputs(dev):
    """Loop-verify shaped inputs: B merged-submap-like clouds of the
    synthetic world (8 scans each, voxelized to N), plane-regularized
    coarse (leaf 2, 8192 rows) and fine (leaf 0.5, 32768 rows) tables of
    them, and small seeded poses that move the clouds."""
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
    pose = se3.exp(xi)
    pose = se3.Pose(pose.R.contiguous(), pose.t.contiguous())
    xyz = target.xyz.contiguous()
    return VerifyInputs(xyz, target.mask.contiguous(), pose, se3.apply(pose, xyz).contiguous(),
                        {"coarse": coarse, "fine": fine})


BENCH_B, BENCH_N, BENCH_ROWS = 64, 4096, 1 << 14


def bench_batch_inputs(dev):
    """The first bench cell's batch, as the reference bench builds it
    (`bench.py:726-779`, drawn here with numpy): 64 targets of 4096
    points (ground, two walls, 1 cm noise), plane-regularized 2^14-row
    tables at leaf 0.5, and sources moved off them by seed-sized poses
    (0.15 m / 0.03 rad normal); `pose` maps each source onto its target."""
    import torch

    from mr_slam_torch.geometry import se3
    from mr_slam_torch.ops import pointcloud as pcl, voxel_grid

    rng = np.random.default_rng(4321)
    n3 = BENCH_N // 4
    ground = np.concatenate([rng.uniform(-25, 25, (BENCH_B, BENCH_N - 2 * n3, 2)),
                             np.zeros((BENCH_B, BENCH_N - 2 * n3, 1))], axis=-1)
    wall1 = np.concatenate([rng.uniform(-25, 25, (BENCH_B, n3, 1)), np.full((BENCH_B, n3, 1), 12.0),
                            rng.uniform(0, 5, (BENCH_B, n3, 1))], axis=-1)
    wall2 = np.concatenate([np.full((BENCH_B, n3, 1), -10.0), rng.uniform(-25, 25, (BENCH_B, n3, 1)),
                            rng.uniform(0, 5, (BENCH_B, n3, 1))], axis=-1)
    xyz = np.concatenate([ground, wall1, wall2], axis=1)
    xyz = xyz + 0.01 * rng.standard_normal(xyz.shape)
    target = pcl.PointCloud(torch.as_tensor(xyz, dtype=torch.float32, device=dev),
                            torch.ones((BENCH_B, BENCH_N), dtype=torch.bool, device=dev))
    grid = voxel_grid.build(target, 0.5, BENCH_ROWS, min_points=3, regularize="plane")
    xi = np.concatenate([0.15 * rng.standard_normal((BENCH_B, 3)),
                         0.03 * rng.standard_normal((BENCH_B, 3))], axis=-1)
    pose = se3.exp(torch.as_tensor(xi, dtype=torch.float32, device=dev))
    pose = se3.Pose(pose.R.contiguous(), pose.t.contiguous())
    src = se3.apply(se3.inverse(pose), target.xyz).contiguous()
    return VerifyInputs(src, target.mask, pose, se3.apply(pose, src).contiguous(), {"bench": grid})


def _times_line(tag, t):
    return (f"{tag}: device {t['device_ms']:.5f} ms, call {t['ms']:.5f} ms, plain "
            f"{t['plain_ms']:.4f} ms; bound {t['bound_ms']:.5f} ms ({t['bound_by']}), "
            f"device at {100 * t['bound_ms'] / t['device_ms']:.1f} % of it")


def check_vgicp(tag, xyz, mask, table, kw):
    """The kernel against its plain version on the card: H, b, cost
    within TOL, inliers equal, a bit-identical rerun; then the device,
    call and plain times and the bound. Returns the record."""
    import torch

    from mr_slam_torch.ops import hopper_vgicp

    def call():
        return hopper_vgicp.gn_accumulate(xyz, mask, table, **kw)

    def plain():
        return hopper_vgicp.gn_accumulate_plain(xyz, mask, table, **kw)

    out, again, ref = call(), call(), plain()
    torch.cuda.synchronize()
    errs = {}
    for name, a, r in zip(("H", "b", "cost"), out[:3], ref[:3]):
        rtol, atol = TOL[name]
        errs[name] = (a - r).abs().max().item()
        if not torch.allclose(a, r, rtol=rtol, atol=atol):
            raise AssertionError(f"{tag}: {name} max abs err {errs[name]} beyond rtol {rtol} "
                                 f"atol {atol}")
    if not torch.equal(out[3], ref[3]):
        raise AssertionError(f"{tag}: inliers differ: {out[3].tolist()} vs {ref[3].tolist()}")
    if not all(torch.equal(x, y) for x, y in zip(out, again)):
        raise AssertionError(f"{tag}: two launches are not bit-identical")
    b_ms, b_by, _ = vgicp_bound(mask, table, xyz=xyz, **kw)
    t = dict(max_abs_err=max(errs.values()), ms=_cuda_ms(call, 200), device_ms=graph_ms(call),
             plain_ms=_cuda_ms(plain, 10), bound_ms=b_ms, bound_by=b_by, library_ms=None)
    log(f"[kernel] {tag}: ok; max abs err H {errs['H']:.3g} (|H| max "
        f"{out[0].abs().max().item():.3g}) b {errs['b']:.3g} cost {errs['cost']:.3g}; inliers "
        f"{out[3].sum().item():.0f} equal; bit-identical rerun")
    log(_times_line(f"[kernel] {tag}", t))
    return t


def phase_kernel(dev):
    """Every mode of the VGICP kernel against its plain version: hash and
    slot, with and without a center, points moved by `pose=` inside the
    kernel or taken as transformed, on the coarse and fine tables at the
    loop-verify batch; then the main path's call and hash mode at the
    first bench cell's batch (B = 64). Returns the main path's record
    (fine table, slot mode, center, pose)."""
    from mr_slam_torch.ops import voxel_grid

    vi = verify_inputs(dev)
    log(f"[kernel] inputs: xyz {tuple(vi.xyz.shape)}, valid points/item "
        f"{vi.mask.sum(1).min().item()}..{vi.mask.sum(1).max().item()}, tables "
        + ", ".join(f"{k} {tuple(g.packed.shape)}" for k, g in vi.grids.items()))
    center = vi.tp[:, ::97].mean(dim=1).contiguous()
    record = None
    for gname, grid in vi.grids.items():
        table = grid.packed.contiguous()
        slot, found = voxel_grid.lookup_slots(grid, vi.tp)
        for mode in ("hash", "slot"):
            for cen in (None, center):
                for posed in (False, True):
                    kw = dict(leaf=grid.leaf) if mode == "hash" else dict(slot=slot, found=found)
                    kw.update(center=cen, max_corr2=1.0, pose=vi.pose if posed else None)
                    tag = (f"B={VERIFY_B} {gname}/{mode}/{'center' if cen is not None else 'origin'}"
                           f"/{'pose' if posed else 'transformed'}")
                    t = check_vgicp(tag, vi.xyz if posed else vi.tp, vi.mask, table, kw)
                    if gname == "fine" and mode == "slot" and cen is not None and posed:
                        record = t  # the call of every inner GN step of loop verification
    bi = bench_batch_inputs(dev)
    grid = bi.grids["bench"]
    slot, found = voxel_grid.lookup_slots(grid, bi.tp)
    center = bi.tp.mean(dim=1).contiguous()
    for tag, kw in ((f"B={BENCH_B} bench/slot/center/pose", dict(slot=slot, found=found, center=center)),
                    (f"B={BENCH_B} bench/hash/origin/pose", dict(leaf=grid.leaf))):
        check_vgicp(tag, bi.xyz, bi.mask, grid.packed, dict(kw, pose=bi.pose))
    return record


def stencil_inputs(kind: str, size: int, res: float = 0.2):
    """(height, valid) numpy: the reference bench's random field
    (`bench.py:223`: N(0, 1) heights, 80 % valid) or smooth rolling
    terrain with 1 cm noise and 80 % valid cells."""
    rng = np.random.default_rng({"random": 0, "terrain": 1}[kind])
    if kind == "random":
        return (rng.normal(0, 1, (size, size)).astype(np.float32),
                rng.random((size, size)) > 0.2)
    ii = np.arange(size, dtype=np.float32)[:, None] * res
    jj = np.arange(size, dtype=np.float32)[None, :] * res
    h = 0.3 * np.sin(ii / 3.0) + 0.25 * np.cos(jj / 4.0) \
        + 0.01 * rng.standard_normal((size, size))
    return h.astype(np.float32), rng.random((size, size)) < 0.8


def features64(height, valid, res: float):
    """(slope, roughness, step, enough) of the 5x5 window in float64:
    the plane fit in window-local metre coordinates with the reference's
    formulas and det floor, and the window's max - min."""
    H, W = height.shape
    v = valid.astype(np.float64)
    z = np.where(valid, height, 0.0).astype(np.float64)
    vp, zp = np.pad(v, 2), np.pad(z, 2)
    zmax_p = np.pad(z, 2, constant_values=-np.inf)
    zmin_p = np.pad(np.where(valid, height, np.inf).astype(np.float64), 2, constant_values=np.inf)
    S = np.zeros((10, H, W))
    zmax, zmin = np.full((H, W), -np.inf), np.full((H, W), np.inf)
    r = float(np.float32(res))
    for di in range(-2, 3):
        for dj in range(-2, 3):
            win = np.s_[2 + di:2 + di + H, 2 + dj:2 + dj + W]
            vs, zs = vp[win], zp[win]
            x, y = di * r, dj * r
            S += np.stack([vs, vs * x, vs * y, vs * zs, vs * x * x, vs * y * y, vs * x * y,
                           vs * x * zs, vs * y * zs, vs * zs * zs])
            zmax, zmin = np.maximum(zmax, zmax_p[win]), np.minimum(zmin, zmin_p[win])
    n = np.maximum(S[0], 1.0)
    mx, my, mz = S[1] / n, S[2] / n, S[3] / n
    cxx, cyy, cxy = S[4] / n - mx * mx, S[5] / n - my * my, S[6] / n - mx * my
    cxz, cyz, czz = S[7] / n - mx * mz, S[8] / n - my * mz, S[9] / n - mz * mz
    det = cxx * cyy - cxy * cxy
    det = np.where(np.abs(det) < 1e-9, 1e-9, det)
    a = (cyy * cxz - cxy * cyz) / det
    b = (cxx * cyz - cxy * cxz) / det
    enough = S[0] >= 3
    slope = np.where(enough, np.arctan(np.sqrt(a * a + b * b)), 0.0)
    rough = np.where(enough, np.sqrt(np.maximum(czz - (a * cxz + b * cyz), 0.0)), 0.0)
    step = np.where(np.isfinite(zmin), zmax - zmin, 0.0)
    return slope, rough, step, enough


def lethal64(height, valid, res: float, travers_thresh: float, z_thresh: float = 1.5,
             crit=(0.6, 0.15, 0.3)):
    """Lethal cells of `costmap.from_elevation` with the features taken
    in float64 (`features64`) and the default blend."""
    slope, rough, step, enough = features64(height, valid, res)
    trav = 1.0 - np.maximum(np.maximum(slope / crit[0], rough / crit[1]), step / crit[2])
    trav = np.where(enough & valid, np.clip(trav, 0.0, 1.0), 0.5)
    return valid & ((trav < travers_thresh) | (height > z_thresh))


def _window_count(valid):
    """Valid cells in each 5x5 window (exact integer sums)."""
    import torch
    import torch.nn.functional as F

    H, W = valid.shape
    vp = F.pad(valid.to(torch.int32), (2, 2, 2, 2))
    return sum(vp[2 + di:2 + di + H, 2 + dj:2 + dj + W]
               for di in range(-2, 3) for dj in range(-2, 3))


def check_stencil(tag, height, valid, res):
    """The kernel against the plain version on the card: step and the
    enough mask exact, the other layers within STENCIL_ATOL, a
    bit-identical rerun; then the device, call and plain times and the
    bound. Returns (record, kernel layers, plain layers)."""
    import torch

    from mr_slam_torch.ops import hopper_stencil

    def call():
        return hopper_stencil.terrain_features(height, valid, res)

    def plain():
        return hopper_stencil.terrain_features_plain(height, valid, res)

    out, again, ref = call(), call(), plain()
    torch.cuda.synchronize()
    names = ("slope", "roughness", "step", "traversability")
    errs = {n: (a - b).abs().max().item() for n, a, b in zip(names, out, ref)}
    if not torch.equal(out[2], ref[2]):
        raise AssertionError(f"{tag}: step differs from the plain version by {errs['step']}")
    enough = _window_count(valid) >= 3
    for name, layer, empty in zip(names, out, (0.0, 0.0, None, 0.5)):
        if empty is None:
            continue
        unknown = ~enough if name != "traversability" else ~(enough & valid)
        if not bool((layer[unknown] == empty).all()):
            raise AssertionError(f"{tag}: {name} does not follow the enough mask")
    bad = {n: e for n, e in errs.items() if not e <= STENCIL_ATOL}
    if bad:
        raise AssertionError(f"{tag}: kernel vs plain beyond {STENCIL_ATOL}: {bad}")
    if not all(torch.equal(a, b) for a, b in zip(out, again)):
        raise AssertionError(f"{tag}: two launches are not bit-identical")
    H, W = height.shape
    b_ms, b_by = stencil_bound(H, W)
    t = dict(max_abs_err=max(errs.values()), ms=_cuda_ms(call, 50),
             device_ms=graph_ms(call, calls=50), plain_ms=_cuda_ms(plain, 5), bound_ms=b_ms,
             bound_by=b_by, library_ms=None)
    exact = sum(e == 0.0 for e in errs.values())
    log(f"[stencil] {tag}: ok; max abs err " + " ".join(f"{n} {e:.3g}" for n, e in errs.items())
        + f" ({exact}/4 layers bit-equal); bit-identical rerun; device "
        f"{21 * H * W / (t['device_ms'] * 1e-3) / 1e9:.1f} GB/s at 21 B/cell")
    log(_times_line(f"[stencil] {tag}", t))
    return t, out, ref


def phase_stencil(dev):
    import torch

    res = torch.tensor(0.2, device=dev)
    worst = 0.0
    for size in STENCIL_SIZES:
        for kind in ("random", "terrain"):
            h, v = stencil_inputs(kind, size)
            t, out, ref = check_stencil(
                f"{kind} {size}x{size}", torch.from_numpy(h).to(dev), torch.from_numpy(v).to(dev),
                res)
            worst = max(worst, t["max_abs_err"])
            # conditioning: the far corner (256^2, 2 cells of halo) against float64
            c = slice(size - 258, size)
            s64, r64 = features64(h[c, c], v[c, c], 0.2)[:2]
            for name, layers in (("kernel", out), ("plain", ref)):
                ds = np.abs(layers[0][c, c].cpu().numpy() - s64)[2:, 2:].max()
                dr = np.abs(layers[1][c, c].cpu().numpy() - r64)[2:, 2:].max()
                log(f"[stencil] {kind} {size}x{size} far corner, {name} vs float64: "
                    f"slope {ds:.3g} rad, roughness {dr:.3g} m")
                if not (ds < 1e-3 and dr < 1e-3):
                    raise AssertionError(f"{kind} {size}: {name} far-corner error beyond 1e-3")
            del out, ref
    return worst


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
    from mr_slam_torch.ops import hopper_stencil, hopper_vgicp
    from mr_slam_torch.ops import pointcloud as pcl
    from mr_slam_torch.runtime import observability as obs
    from mr_slam_torch.runtime import pipeline

    t0 = time.perf_counter()
    trajs, host_scans, cfg = scenario()
    log(f"[main] scans raycast on the host in {time.perf_counter() - t0:.1f} s: "
        f"{N_ROBOTS} robots x {N_FRAMES} frames x {RINGS}x{AZIMUTH} rays")
    scans = [pcl.PointCloud(s.xyz.to(dev), s.mask.to(dev)) for s in host_scans]
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
    hopper_stencil.reset_launch_count()
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
    if not same:
        raise AssertionError("two pipeline.run calls gave different optimized poses")
    if not inter:
        raise AssertionError(f"no inter-robot loop accepted (all: {len(res.loops)})")
    for r, a in enumerate(ates):
        if not a < 1.0:
            raise AssertionError(f"robot {r} keyframe ATE {a:.3f} m >= 1.0 m")
        if JAX_REF_ATE is not None and not a <= 1.25 * JAX_REF_ATE[r] + 0.05:
            raise AssertionError(f"robot {r} ATE {a:.3f} m beyond 1.25 x JAX {JAX_REF_ATE[r]} + 0.05")
    return launches, res, scans, cfg, trajs, host_scans


def _synced(fn, timers, name):
    """fn() with the device synchronised, its wall time added to timers."""
    import torch

    t = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    timers[name] = timers.get(name, 0.0) + time.perf_counter() - t
    return out


def gem_ticks(res, scans, cfg, dev):
    """Robot 0's frames through the reference's per-frame GEM tick
    (`runtime/online.py:400-421`): shift to the robot, predict, the
    motion-drift variance update, fuse the frame; then features and
    costmap on the final local grid."""
    import torch

    from mr_slam_torch.geometry import se3
    from mr_slam_torch.mapping import costmap, elevation
    from mr_slam_torch.ops import pointcloud as pcl

    e = cfg.elevation
    odo = res.robots[0].odom_poses
    first = se3.index(odo, 0)
    m = elevation.init(e.size, e.resolution, center=(float(first.t[0]), float(first.t[1])),
                       device=dev)
    timers: dict[str, float] = {}
    last = None
    for i in range(N_FRAMES):
        pose = se3.index(odo, i)
        m = _synced(lambda: elevation.shift(m, pose.t[:2]), timers, "shift")
        m = _synced(lambda: elevation.predict(m), timers, "predict")
        if last is not None:
            dt = float(torch.linalg.norm(pose.t - last.t))
            c = (torch.trace(last.R.T @ pose.R) - 1.0) / 2.0
            drot = float(torch.arccos(torch.clamp(c, -1.0, 1.0)))
            m = _synced(lambda: elevation.motion_update(
                m, pose.t[:2], sigma_z=e.drift_z * dt, sigma_tilt=e.drift_tilt * drot),
                timers, "motion_update")
        last = pose
        scan = pcl.PointCloud(scans[0].xyz[i], scans[0].mask[i])
        m = _synced(lambda: elevation.fuse(m, pcl.transform(scan, pose),
                                           elevation.sensor_variance(scan.xyz)), timers, "fuse")
    feats = _synced(lambda: elevation.features(m), timers, "features")
    cm = _synced(lambda: costmap.from_elevation(m, feats, travers_thresh=e.travers_thresh),
                 timers, "costmap")
    center = m.origin.cpu().numpy() + e.size * e.resolution / 2
    off = float(np.linalg.norm(center - last.t[:2].cpu().numpy()))
    n_valid = int(m.valid.sum())
    cost = cm.cost.cpu().numpy()
    log(f"[map] GEM ticks, robot 0, {N_FRAMES} frames on a {e.size}x{e.size} grid: "
        + ", ".join(f"{k} {v * 1e3 / N_FRAMES:.3f} ms/frame" if k not in ("features", "costmap")
                    else f"{k} {v * 1e3:.3f} ms" for k, v in timers.items())
        + f"; {n_valid} valid cells, free {(cost == 0).sum()}, lethal {(cost == 100).sum()}; "
        f"grid centre {off:.3f} m from the robot")
    if not off < 2 * e.resolution + 1e-3:
        raise AssertionError(f"local grid not centred on the robot ({off:.3f} m off)")
    if not n_valid > 100:
        raise AssertionError(f"local grid holds only {n_valid} valid cells")


def phase_map(res, scans, cfg, dev):
    import torch

    from mr_slam_torch.ops import hopper_stencil, hopper_vgicp
    from mr_slam_torch.runtime import observability as obs
    from mr_slam_torch.runtime import pipeline

    torch.cuda.synchronize()
    t = time.perf_counter()
    merged = pipeline.compose_map(res)
    torch.cuda.synchronize()
    log(f"[map] compose_map {time.perf_counter() - t:.3f} s: {int(merged.mask.sum())} points "
        f"at leaf 0.5")

    obs.tracer.stats.clear()
    hopper_stencil.reset_launch_count()
    hopper_vgicp.reset_launch_count()
    emap, feats, cm = pipeline.build_elevation(res, cfg, size=MAP_SIZE)
    launches = hopper_stencil.launch_count()
    compose_s = obs.tracer.report()["backend.compose"]["total_s"]
    cost = cm.cost
    counts = dict(valid=int(emap.valid.sum()), free=int((cost == 0).sum()),
                  lethal=int((cost == 100).sum()))
    gaps = {k: counts[k] / JAX_REF_MAP[k] - 1.0 for k in counts}
    log(f"[map] build_elevation (span backend.compose) {compose_s:.3f} s; terrain_stencil "
        f"launches {launches}; cells {counts}, reference map {JAX_REF_MAP}, gap "
        + ", ".join(f"{k} {100 * g:+.2f} %" for k, g in gaps.items()))
    again = pipeline.build_elevation(res, cfg, size=MAP_SIZE)
    same = all(torch.equal(a, b) for x, y in zip((emap, feats, cm), again) for a, b in zip(x, y))
    log(f"[map] second build_elevation bit-identical: {same}")
    t, _, _ = check_stencil(f"build_elevation grid {MAP_SIZE}x{MAP_SIZE}", emap.height,
                            emap.valid, emap.resolution)
    # the card's own map classified with float64 features: the kernel's
    # lethal cells must agree within 0.1 % (evidence beside the band above,
    # which also moves with the trajectories)
    l64 = lethal64(emap.height.cpu().numpy(), emap.valid.cpu().numpy(),
                   float(emap.resolution), cfg.elevation.travers_thresh)
    lk = (cost == 100).cpu().numpy()
    gap64 = counts["lethal"] / max(int(l64.sum()), 1) - 1.0
    log(f"[map] lethal cells, kernel {counts['lethal']} vs float64 fit of the same map "
        f"{int(l64.sum())} ({100 * gap64:+.3f} %; {int((lk & ~l64).sum())} lethal only in the "
        f"kernel's, {int((l64 & ~lk).sum())} only in the float64 one)")
    if launches <= 0:
        raise AssertionError("the stencil kernel was not launched by build_elevation")
    if not (counts["free"] > 100 and counts["lethal"] > 10):
        raise AssertionError(f"costmap lacks free or lethal cells: {counts}")
    if not all(abs(g) <= 0.05 for g in gaps.values()):
        raise AssertionError(f"cell counts beyond 5 % of the reference map: {gaps}")
    if not abs(gap64) <= 0.001:
        raise AssertionError(f"kernel lethal cells {100 * gap64:+.3f} % off the float64 fit")
    if not same:
        raise AssertionError("two build_elevation calls differ")
    gem_ticks(res, scans, cfg, dev)
    return launches, t


# --------------------------------------------------------------------------
# phase 7: the online session
# --------------------------------------------------------------------------


def online_config(cfg):
    """Phase 5's config with the reference launch's cadences."""
    from mr_slam_torch.runtime.config import SchedulerCfg

    return cfg.replace(scheduler=SchedulerCfg(tf_period_s=ONLINE_TF_PERIOD_S,
                                              compose_period_s=ONLINE_COMPOSE_PERIOD_S))


def online_frames(trajs, scans):
    """Phase 5's host scans as one interleaved stream of replay frames:
    robot r's frame i stamped 0.1 i + 0.03 r (as `synthetic_bag` stamps
    them), its first frame carrying its origin."""
    from mr_slam_torch.datasets.replay import Frame
    from mr_slam_torch.geometry import se3
    from mr_slam_torch.ops import pointcloud as pcl

    frames = [
        Frame(stamp=0.1 * i + 0.03 * r, robot=r,
              scan=pcl.PointCloud(scans[r].xyz[i], scans[r].mask[i]),
              origin=se3.index(trajs[r], 0) if i == 0 else None)
        for r in range(len(trajs)) for i in range(scans[r].xyz.shape[0])
    ]
    frames.sort(key=lambda f: f.stamp)
    return frames


def online_ate(store, opt_t, node_ids, traj, r):
    """Keyframe ATE (m) of robot r: keyframe k was frame
    round((stamp - 0.03 r) / 0.1); `opt_t` (N, 3) host optimized
    positions, `node_ids` the keyframes' nodes, `store` the robot's
    (stamps, count) on the host."""
    stamps, K = store
    frames = np.rint((np.asarray(stamps[:K], np.float64) - 0.03 * r) / 0.1).astype(np.int64)
    true = np.asarray(traj.t)[frames]
    est = np.asarray(opt_t)[np.asarray(node_ids[:K])]
    return float(np.sqrt(np.mean(np.sum((est - true) ** 2, axis=-1))))


def _same_result(a, b) -> bool:
    """Optimized poses, keyframe counts and accepted loops bit-identical."""
    import torch

    if not (torch.equal(a.opt_poses.R, b.opt_poses.R) and torch.equal(a.opt_poses.t, b.opt_poses.t)):
        return False
    if [int(x.store.count) for x in a.robots] != [int(x.store.count) for x in b.robots]:
        return False
    if not np.array_equal(a.node_of, b.node_of) or len(a.loops) != len(b.loops):
        return False
    keys = ("robot_a", "kf_a", "robot_b", "kf_b")
    return all(
        all(la[k] == lb[k] for k in keys) and torch.equal(la["rel"].R, lb["rel"].R)
        and torch.equal(la["rel"].t, lb["rel"].t)
        for la, lb in zip(a.loops, b.loops)
    )


def count_syncs(fn):
    """Run fn() with PyTorch's CUDA sync debug mode on. Returns a Counter
    of the synchronizing calls it reported, by the Python 'file:line'
    that made them."""
    import os
    import warnings

    import torch

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return collections.Counter(
        f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
        if "synchroniz" in str(w.message))


def count_frame_syncs(sess, frames):
    """Feed `frames` to `sess` one add_frame at a time, counting the
    host syncs of each (`count_syncs`). Returns [(sites, busy)] per
    frame, `busy` when the frame added a keyframe or fired a loop stage,
    TF or the merged map."""
    from mr_slam_torch.runtime import observability as obs

    def state():
        return (sum(sess.kf_counts.values()), len(sess._pending_kf),
                obs.metrics.counters.get("tf.publishes", 0),
                obs.metrics.counters.get("compose.runs", 0))

    out = []
    for f in frames:
        if f.robot not in sess.robots:
            sess.register_robot(f.robot, f.origin)
        before = state()
        sites = count_syncs(lambda: sess.add_frame(f.robot, f.scan, stamp=f.stamp))
        out.append((sites, before != state()))
    return out


def phase_online(dev, trajs, host_scans, cfg):
    """The online session on the card (see the module docstring).
    Returns (VGICP launches of the stream, stencil launches of the
    session's map, the stencil's max abs error on that map)."""
    import os

    import torch

    from mr_slam_torch.datasets import replay, sequence_artifact
    from mr_slam_torch.mapping import costmap, elevation
    from mr_slam_torch.ops import hopper_stencil, hopper_vgicp
    from mr_slam_torch.runtime import checkpoint, online
    from mr_slam_torch.runtime import observability as obs

    ocfg = online_config(cfg)
    frames = online_frames(trajs, host_scans)
    n_robots = len(trajs)
    out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "mr_slam_torch", "build",
                           "online")
    os.makedirs(out_dir, exist_ok=True)

    # ---- 1. the session stream --------------------------------------
    sess = online.OnlineSlam(ocfg, enable_gem=True, device=dev)
    add_s = dict.fromkeys(range(n_robots), 0.0)
    stages = [0]
    add_frame, loop_stage = sess.add_frame, sess.run_loop_stage

    def timed_add(robot, scan, **kw):
        t = time.perf_counter()
        pose = add_frame(robot, scan, **kw)
        add_s[robot] += time.perf_counter() - t
        return pose

    def counted_stage():
        stages[0] += 1
        return loop_stage()

    sess.add_frame, sess.run_loop_stage = timed_add, counted_stage
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    obs.tracer.stats.clear()
    obs.metrics.counters.clear()
    hopper_vgicp.reset_launch_count()
    hopper_stencil.reset_launch_count()
    t = time.perf_counter()
    n_fed = replay.replay(frames, sess)
    res = sess.result()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    vgicp_launches = hopper_vgicp.launch_count()
    stream_stencil = hopper_stencil.launch_count()
    peak = torch.cuda.max_memory_allocated()
    spans = obs.tracer.report()
    counters = dict(obs.metrics.counters)
    log(f"[online] replay of {n_fed} frames + result() wall {wall:.3f} s; peak device memory "
        f"{peak / 2**20:.1f} MiB; vgicp_accum launches {vgicp_launches}, terrain_stencil "
        f"{stream_stencil}; loop stages {stages[0]} ({spans.get('online.solve', {}).get('count', 0)} "
        f"solved)")
    for r in range(n_robots):
        n_r = sum(f.robot == r for f in frames)
        log(f"[online] robot {r}: add_frame {add_s[r]:.3f} s = {n_r / add_s[r]:.1f} frames/s, "
            f"{sess.kf_counts[r]} keyframes")
    log("[online] spans (total s / count): " + ", ".join(
        f"{k} {spans[k]['total_s']:.3f} / {spans[k]['count']}"
        for k in ("online.frontend", "online.gem", "loop.retrieve", "loop.verify", "online.pcm",
                  "online.solve", "online.compose")
        if k in spans))
    inter = [l for l in res.loops if l["robot_a"] != l["robot_b"]]
    log(f"[online] loops: candidates {counters.get('loops.candidates', 0):.0f}, verified "
        f"{counters.get('loops.verified', 0):.0f}, accepted after PCM {len(res.loops)} "
        f"({len(inter)} inter-robot), PCM rejected {counters.get('online.pcm_rejected', 0):.0f}; "
        f"TF publishes {counters.get('tf.publishes', 0):.0f}, compose runs "
        f"{counters.get('compose.runs', 0):.0f}")

    # ---- 2. the session's checks --------------------------------------
    opt_t = res.opt_poses.t.cpu().numpy()
    ates = [online_ate((res.robots[r].store.stamps.cpu().numpy(), int(res.robots[r].store.count)),
                       opt_t, res.node_of[r], trajs[r], r) for r in range(n_robots)]
    log(f"[online] keyframe ATE per robot (m): {[round(a, 4) for a in ates]}; JAX reference "
        f"session {JAX_REF_ONLINE_ATE} ({JAX_REF_ONLINE_LOOPS} inter-robot loops)")
    if vgicp_launches <= 0:
        raise AssertionError("the VGICP kernel was not launched during the online stream")
    if not inter:
        raise AssertionError(f"the online session accepted no inter-robot loop (all: {len(res.loops)})")
    for r, a in enumerate(ates):
        if not a < 1.0:
            raise AssertionError(f"online robot {r} keyframe ATE {a:.3f} m >= 1.0 m")
        if not a <= 1.25 * JAX_REF_ONLINE_ATE[r] + 0.05:
            raise AssertionError(f"online robot {r} ATE {a:.3f} m beyond 1.25 x JAX "
                                 f"{JAX_REF_ONLINE_ATE[r]} + 0.05")
    missing = [r for r in range(n_robots) if not sess.tf.can_transform("map", f"robot_{r}/odom")]
    if missing:
        raise AssertionError(f"no map -> robot_r/odom in the TF buffer for robots {missing}")
    if sess.merged_map is None or not bool(sess.merged_map.mask.any()):
        raise AssertionError("the composed merged map has no points")
    flushed = [len(sess.robots[r]["gem_flushed"]) for r in range(n_robots)]
    if flushed != [sess.kf_counts[r] for r in range(n_robots)]:
        raise AssertionError(f"GEM flushed {flushed} submaps for keyframes {sess.kf_counts}")
    log(f"[online] TF frames {sess.tf.frames()}; merged map {int(sess.merged_map.mask.sum())} "
        f"points; GEM submaps per robot {flushed}")

    # ---- 3. the map product ------------------------------------------
    hopper_stencil.reset_launch_count()
    torch.cuda.synchronize()
    t = time.perf_counter()
    emap = sess.global_elevation(size=MAP_SIZE)
    torch.cuda.synchronize()
    t_compose = time.perf_counter() - t
    feats = elevation.features(emap)
    cm = costmap.from_elevation(emap, feats, travers_thresh=cfg.elevation.travers_thresh)
    torch.cuda.synchronize()
    t_map = time.perf_counter() - t
    map_stencil = hopper_stencil.launch_count()
    cost = cm.cost
    counts = dict(valid=int(emap.valid.sum()), free=int((cost == 0).sum()),
                  lethal=int((cost == 100).sum()))
    log(f"[online] global_elevation({MAP_SIZE}) {t_compose:.3f} s, + features + costmap "
        f"{t_map:.3f} s; terrain_stencil launches {map_stencil}; cells {counts}")
    if map_stencil <= 0:
        raise AssertionError("the stencil kernel was not launched on the session's map")
    if not (counts["free"] > 100 and counts["lethal"] > 10):
        raise AssertionError(f"the session's costmap lacks free or lethal cells: {counts}")
    st, _, _ = check_stencil(f"online global_elevation grid {MAP_SIZE}x{MAP_SIZE}", emap.height,
                             emap.valid, emap.resolution)

    # ---- 4. resume (its first half also counts the host syncs) ----------
    half = len(frames) // 2
    first = online.OnlineSlam(ocfg, enable_gem=True, device=dev)
    syncs = count_frame_syncs(first, frames[:half])
    plain = sorted(sum(s.values()) for s, busy in syncs if not busy)
    every = sorted(sum(s.values()) for s, _ in syncs)
    log(f"[online] host syncs per add_frame (torch.cuda sync debug mode, first {half} frames): "
        f"{plain[:1] + plain[-1:]} (min, max) on the {len(plain)} frames that add no keyframe "
        f"and fire no cadence; {every[:1] + every[-1:]} over all frames, {sum(every)} in all")
    sites = sum((s for s, busy in syncs if not busy), collections.Counter())
    log(f"[online] their sites on those frames (calls): {dict(sites.most_common())}")
    path = os.path.join(out_dir, "session.npz")
    torch.cuda.synchronize()
    t = time.perf_counter()
    checkpoint.save_session(first, path)
    t_save = time.perf_counter() - t
    t = time.perf_counter()
    resumed = checkpoint.load_session(path, device=dev)
    torch.cuda.synchronize()
    t_load = time.perf_counter() - t
    replay.replay(frames[half:], resumed)
    same = _same_result(resumed.result(), res)
    log(f"[online] checkpoint at frame {half} of {len(frames)}: {os.path.getsize(path) / 2**20:.2f} "
        f"MiB, save_session {t_save:.3f} s, load_session {t_load:.3f} s; resumed session "
        f"bit-identical to the uninterrupted one: {same}")
    if not same:
        raise AssertionError("the resumed session differs from the uninterrupted one")

    # ---- 5. the real-format chain ----------------------------------------
    root = os.path.join(out_dir, "realformat")
    t = time.perf_counter()
    sequence_artifact.generate(root, frames=REAL_FRAMES, robots=REAL_ROBOTS, n_rings=REAL_RINGS,
                               n_azimuth=REAL_AZIMUTH, laps=REAL_LAPS)
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    out = sequence_artifact.run_session(root, device=dev)
    torch.cuda.synchronize()
    t_run = time.perf_counter() - t
    log(f"[online] real-format chain, {REAL_ROBOTS} robots x {REAL_FRAMES} frames at "
        f"{REAL_RINGS}x{REAL_AZIMUTH}: generate {t_gen:.3f} s, run_session {t_run:.3f} s; {out}")
    if out["frames"] != REAL_ROBOTS * REAL_FRAMES:
        raise AssertionError(f"run_session read {out['frames']} frames")
    if not out["ate_rmse_m"] < 0.5:
        raise AssertionError(f"real-format ATE {out['ate_rmse_m']} m >= 0.5 m")
    return vgicp_launches, stream_stencil + map_stencil, st["max_abs_err"]


def main() -> int:
    import torch

    smi = phase_card()
    dev = torch.device("cuda", 0)
    phase_build()
    vgicp = phase_kernel(dev)
    stencil_err = phase_stencil(dev)
    vgicp_launches, res, scans, cfg, trajs, host_scans = phase_main(dev)
    stencil_launches, stencil = phase_map(res, scans, cfg, dev)
    del res, scans
    online_vgicp, online_stencil, online_err = phase_online(dev, trajs, host_scans, cfg)
    log(f"[online] launches on the main paths: vgicp_accum {vgicp_launches} (phase 5) + "
        f"{online_vgicp} (phase 7), terrain_stencil {stencil_launches} (phase 6) + "
        f"{online_stencil} (phase 7)")
    vgicp_launches += online_vgicp
    stencil_launches += online_stencil
    stencil["max_abs_err"] = max(stencil["max_abs_err"], stencil_err, online_err)
    print(json.dumps({"kernels": [
        dict(name="vgicp_accum", route="cuda", source="mr_slam_torch/csrc/vgicp_accum.cu",
             replaces="mr_slam_tpu/ops/pallas_vgicp.py:77", launches=vgicp_launches, **vgicp),
        dict(name="terrain_stencil", route="cuda", source="mr_slam_torch/csrc/terrain_stencil.cu",
             replaces="mr_slam_tpu/ops/pallas_stencil.py:71", launches=stencil_launches,
             **stencil),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
