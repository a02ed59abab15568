"""Scaling bench: front-end frames/s of N robots run one after another
in one process (as `pipeline.run` runs them) against the same N robots
over N processes, one robot each, on the same device (the port's
counterpart of `examples/bench_scaling.py`, whose N virtual devices
become N processes):

    python -m mr_slam_torch.examples.bench_scaling [--robots N] [--frames T]
        [--device cpu]

On one card the N processes share its SMs: the speedup is what running
the robots' front-ends side by side buys over running them in turn.
Prints one JSON line.
"""
from __future__ import annotations

import argparse
import json

from mr_slam_torch.examples import multihost_worker as worker


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--robots", type=int, default=2)
    ap.add_argument("--frames", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    one = worker.bench(1, a.robots, a.frames, a.device)
    many = worker.bench(a.robots, a.robots, a.frames, a.device)
    print(json.dumps({
        "fps_1proc": one["bench_fps"], "fps_nproc": many["bench_fps"], "n": a.robots,
        "frames": a.frames, "speedup": many["bench_fps"] / one["bench_fps"],
        "layout": worker.card_note(a.robots, a.device), "device": many["device"],
    }))


if __name__ == "__main__":
    main()
