"""Multi-process scaling bench: front-end frames/s of 1 process with 1
robot against N processes with N robots, the worker processes of
`multihost_worker` in MRSLAM_BENCH mode, and the cores roof: N
independent 1-robot processes side by side with no group (the port's
counterpart of `examples/bench_multiprocess.py`):

    python -m mr_slam_torch.examples.bench_multiprocess [--processes N]
        [--frames T] [--device cpu]

efficiency = fps(N processes, N robots) / (N x fps(1 process, 1 robot));
efficiency_vs_cores_roof = fps(N processes) / fps(roof): the share the
group's coordination leaves, with contention for the hardware factored
out. On one card the N processes share its SMs, so this measures how
well they overlap there, not N cards. Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json
import os

from mr_slam_torch.examples import multihost_worker as worker


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--processes", type=int, default=2)
    ap.add_argument("--frames", type=int, default=64)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    one = worker.bench(1, 1, a.frames, a.device)
    many = worker.bench(a.processes, a.processes, a.frames, a.device)
    roof = worker.bench_roof(a.processes, a.frames, a.device)
    print(json.dumps({
        "fps_1proc": one["bench_fps"], "fps_nproc": many["bench_fps"], "fps_cores_roof": roof,
        "n_processes": a.processes, "frames": a.frames,
        "efficiency": many["bench_fps"] / (a.processes * one["bench_fps"]),
        "efficiency_vs_cores_roof": many["bench_fps"] / roof, "cpu_cores": os.cpu_count(),
        "split_ms_nproc": many["split_ms"],
        "layout": worker.card_note(a.processes, a.device), "device": many["device"],
    }))


if __name__ == "__main__":
    main()
