#!/usr/bin/env python3
"""Device, call and plain times of the port's two hand-written kernels on
one CUDA card, beside their bounds.

    python3 kernel_times.py [--tree DIR] [--tag NAME] [--clusters] [--json PATH]

`--tree` names the checkout whose `mr_slam_torch` is measured (default:
this one), so that two commits can be compared in one run on one card:
unpack the other commit into an ignored directory (`git archive <sha> |
tar -x -C build/parent`) and run parent, change, change, parent. The
inputs are `chip_smoke.py`'s, from fixed seeds, so every tree sees the
same data.

For each shape it prints one line and, at the end, one JSON object (also
written to the file `--json` names):

  device_ms  100 calls captured in a CUDA graph, replays timed with CUDA
             events (`chip_smoke.graph_ms`): the kernels without the
             wrapper's host work;
  kernel_ms  the kernels' own duration from `torch.profiler`'s CUDA
             records (`kernel_ms`), without the gaps between them;
  call_ms    200 eager wrapper calls back to back (`chip_smoke._cuda_ms`);
  plain_ms   the plain PyTorch version, eager;
  bound_ms   the larger of the bytes over the HBM rate and the f32
             operations over the f32 peak (`chip_smoke.bound`), and
             `share` = bound_ms / device_ms.

Shapes: VGICP at the loop-verify batch (B = 8 x N = 16384; fine and
coarse tables; slot mode with a center, the main path's call, and hash
mode), the per-step pair of the GN loop (the transform and the call:
`se3.apply` then the call without a pose, or the call with `pose=` where
the tree's wrapper takes one), and the first bench cell's batch (B = 64
x N = 4096, 2^14 rows); the stencil at 600^2 (the size of the map
grid), 2048^2 and 4096^2 (`chip_smoke.stencil_inputs`). With
`--clusters`, the main path's VGICP call at each cluster size (1 to 16
CTAs per batch item) and block size (128 to 512 threads) at both VGICP
shapes, and at its own launch shape on the first 0 to 16384 points of
each cloud (the kernel's fixed cost against its cost per point).
"""
from __future__ import annotations

import argparse
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def kernel_ms(fn, keys=("accum_kernel", "finalize_kernel", "terrain_kernel"), calls=50):
    """The kernels' own duration per call: `torch.profiler`'s CUDA kernel
    records whose names hold one of `keys`, summed over `calls` eager
    calls and divided by them. None if the profiler saw no kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and any(k in e.name for k in keys)]
    return sum(us) / calls / 1e3 if us else None


def _row(name, device_ms, call_ms, plain_ms, bound_ms, bound_by, **extra):
    row = dict(name=name, device_ms=device_ms, call_ms=call_ms, plain_ms=plain_ms,
               bound_ms=bound_ms, bound_by=bound_by, share=bound_ms / device_ms, **extra)
    print(f"[times] {name}: device {device_ms:.5f} ms, kernel {extra.get('kernel_ms')} ms, "
          f"call {call_ms:.5f} ms, plain "
          f"{plain_ms if plain_ms is None else round(plain_ms, 4)} ms, bound {bound_ms:.5f} ms "
          f"({bound_by}), share of bound {row['share']:.3f}", flush=True)
    return row


def vgicp_rows(sm, dev):
    from mr_slam_torch.geometry import se3
    from mr_slam_torch.ops import hopper_vgicp, voxel_grid

    has_pose = "pose" in inspect.signature(hopper_vgicp.gn_accumulate).parameters
    vi = sm.verify_inputs(dev)
    rows = []
    for tag, inp in (("B8xN16384", vi), ("B64xN4096", sm.bench_batch_inputs(dev))):
        center = inp.tp[:, ::97].mean(dim=1).contiguous()
        for gname, grid in inp.grids.items():
            table = grid.packed.contiguous()
            slot, found = voxel_grid.lookup_slots(grid, inp.tp)
            cases = {
                "slot/center": dict(slot=slot, found=found, center=center),
                "hash/origin": dict(leaf=grid.leaf),
            }
            for mode, kw in cases.items():
                def call():
                    return hopper_vgicp.gn_accumulate(inp.tp, inp.mask, table, **kw)

                def plain():
                    return hopper_vgicp.gn_accumulate_plain(inp.tp, inp.mask, table, **kw)

                b_ms, b_by, n_rows = sm.vgicp_bound(inp.mask, table, xyz=inp.tp, **kw)
                rows.append(_row(f"vgicp {tag} {gname} {mode}", sm.graph_ms(call),
                                 sm._cuda_ms(call, 200), sm._cuda_ms(plain, 10), b_ms, b_by,
                                 distinct_rows=n_rows, kernel_ms=kernel_ms(call)))
            # one inner GN step's accumulation as `_vgicp_direct1` runs it
            kw = dict(slot=slot, found=found, center=center)
            if has_pose:
                def step():
                    return hopper_vgicp.gn_accumulate(inp.xyz, inp.mask, table, pose=inp.pose,
                                                      **kw)
            else:
                def step():
                    tp = se3.apply(inp.pose, inp.xyz).contiguous()
                    return hopper_vgicp.gn_accumulate(tp, inp.mask, table, **kw)
            b_ms, b_by, n_rows = sm.vgicp_bound(inp.mask, table, pose=inp.pose, **kw)
            rows.append(_row(f"vgicp {tag} {gname} step (transform + slot/center)",
                             sm.graph_ms(step), sm._cuda_ms(step, 200), None, b_ms, b_by,
                             distinct_rows=n_rows, pose_in_kernel=has_pose,
                             kernel_ms=kernel_ms(step)))
    return rows


def cluster_rows(sm, dev):
    """The main path's call (slot mode, center, pose) at each cluster size
    and block size at both VGICP shapes, held to the plain version as in
    `chip_smoke.check_vgicp`; for the choice in `launch_shape`."""
    import torch

    from mr_slam_torch.ops import hopper_vgicp, voxel_grid

    rows = []
    for tag, inp in (("B8xN16384", sm.verify_inputs(dev)), ("B64xN4096", sm.bench_batch_inputs(dev))):
        gname = "fine" if "fine" in inp.grids else "bench"
        table = inp.grids[gname].packed.contiguous()
        slot, found = voxel_grid.lookup_slots(inp.grids[gname], inp.tp)
        center = inp.tp[:, ::97].mean(dim=1).contiguous()
        kw = dict(slot=slot, found=found, center=center, pose=inp.pose)
        ref = hopper_vgicp.gn_accumulate_plain(inp.xyz, inp.mask, table, **kw)
        b_ms, b_by, _ = sm.vgicp_bound(inp.mask, table, **kw)
        B, N = inp.mask.shape
        for threads in (128, 256, 512):
            for c in (1, 2, 4, 8, 16):
                def call():
                    return hopper_vgicp._launch(inp.xyz, inp.mask, table, None, slot, found,
                                                1e-6, 1.0, center, inp.pose, c, threads)

                out = call()
                H = out[:, :36].view(B, 6, 6)
                ok = torch.equal(out[:, 43], ref[3]) and all(
                    torch.allclose(a, r, rtol=sm.TOL[n][0], atol=sm.TOL[n][1])
                    for n, a, r in (("H", H, ref[0]), ("b", out[:, 36:42], ref[1]),
                                    ("cost", out[:, 42], ref[2])))
                rows.append(_row(f"vgicp {tag} {gname} slot/center/pose cluster {c} x {threads}",
                                 sm.graph_ms(call), sm._cuda_ms(call, 200), None, b_ms, b_by,
                                 cluster=c, threads=threads, kernel_ms=kernel_ms(call),
                                 chosen=(c, threads) == hopper_vgicp.launch_shape(B, N),
                                 agrees_with_plain=ok))
    # fixed cost against per-point cost: the main path's call on the first
    # n points of each B = 8 verify cloud, at its launch shape
    inp = sm.verify_inputs(dev)
    table = inp.grids["fine"].packed.contiguous()
    slot, found = voxel_grid.lookup_slots(inp.grids["fine"], inp.tp)
    center = inp.tp[:, ::97].mean(dim=1).contiguous()
    c, threads = hopper_vgicp.launch_shape(*inp.mask.shape)
    for n in (0, 256, 1024, 4096, 8192, 16384):
        xs, ms, ss, fs = (t[:, :n].contiguous() for t in (inp.xyz, inp.mask, slot, found))

        def call():
            return hopper_vgicp._launch(xs, ms, table, None, ss, fs, 1e-6, 1.0, center, inp.pose,
                                        c, threads)

        b_ms, b_by, _ = sm.vgicp_bound(ms, table, slot=ss, found=fs, pose=inp.pose,
                                       center=center)
        rows.append(_row(f"vgicp B8 fine slot/center/pose first {n} points, cluster {c} x "
                         f"{threads}", sm.graph_ms(call), sm._cuda_ms(call, 200), None, b_ms,
                         b_by, kernel_ms=kernel_ms(call), points=n))
    # the fixed cost alone (no points) at other launch shapes
    xs, ms, ss, fs = (t[:, :0].contiguous() for t in (inp.xyz, inp.mask, slot, found))
    for c, threads in ((1, 256), (16, 128), (16, 512), (2, 512)):
        def call():
            return hopper_vgicp._launch(xs, ms, table, None, ss, fs, 1e-6, 1.0, center, inp.pose,
                                        c, threads)

        rows.append(_row(f"vgicp B8 no points, cluster {c} x {threads}", sm.graph_ms(call),
                         sm._cuda_ms(call, 200), None, 1e-9, "bytes",
                         kernel_ms=kernel_ms(call), points=0))
    return rows


def stencil_rows(sm, dev):
    import torch

    from mr_slam_torch.ops import hopper_stencil

    res = torch.tensor(0.2, device=dev)
    rows = []
    for size, kind in ((600, "terrain"), (2048, "random"), (4096, "random")):
        h, v = sm.stencil_inputs(kind, size)
        h, v = torch.from_numpy(h).to(dev), torch.from_numpy(v).to(dev)

        def call():
            return hopper_stencil.terrain_features(h, v, res)

        def plain():
            return hopper_stencil.terrain_features_plain(h, v, res)

        b_ms, b_by = sm.stencil_bound(size, size)
        rows.append(_row(f"stencil {size}x{size} {kind}", sm.graph_ms(call, calls=50),
                         sm._cuda_ms(call, 50), sm._cuda_ms(plain, 3), b_ms, b_by,
                         kernel_ms=kernel_ms(call)))
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", default=str(HERE), help="checkout whose mr_slam_torch is timed")
    ap.add_argument("--tag", default="tree", help="name of this run in its JSON")
    ap.add_argument("--json", help="also write the JSON object to this file")
    ap.add_argument("--clusters", action="store_true",
                    help="also time the VGICP kernel at each cluster size (this tree's kernel)")
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: no CUDA device")
    import mr_slam_torch

    if Path(mr_slam_torch.__file__).resolve().parents[1] != tree:
        raise SystemExit(f"kernel_times: imported {mr_slam_torch.__file__}, not from {tree}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip()
    print(f"[times] tree {tree} ({args.tag}); card {smi}", flush=True)
    sm = _smoke()
    dev = torch.device("cuda", 0)
    rows = vgicp_rows(sm, dev) + stencil_rows(sm, dev)
    if args.clusters:
        rows += cluster_rows(sm, dev)
    out = dict(tag=args.tag, tree=str(tree), card=smi, rows=rows)
    if args.json:
        Path(args.json).write_text(json.dumps(out, indent=1))
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
