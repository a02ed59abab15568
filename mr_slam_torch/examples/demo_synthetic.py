"""End-to-end demo on the synthetic world, the Quick Demo analogue (the
port's counterpart of `examples/demo_synthetic.py`).

Runs a 3-robot SLAM session with loop closures, writes the
reference-layout artifacts (g2o graphs, merged map PCD, keyframe
directories), builds the elevation map and costmap (the terrain
stencil kernel on a CUDA device) and, where matplotlib imports, renders
PNGs of the map, the elevation layers and the costmap:

    python -m mr_slam_torch.examples.demo_synthetic [out_dir] [--device cpu]

On the card by default; `--device cpu` runs it on the CPU.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import math

import numpy as np
import torch


def main(out_dir: str = "demo_out", device="cuda") -> dict:
    from mr_slam_torch.datasets import synthetic
    from mr_slam_torch.eval import metrics, visualize
    from mr_slam_torch.geometry import se3
    from mr_slam_torch.runtime import persistence, pipeline
    from mr_slam_torch.runtime.config import LoopCfg, OdometryCfg, SlamConfig
    from mr_slam_torch.runtime.observability import tracer
    from mr_slam_torch.runtime.online import resolve_device

    dev = resolve_device(device)
    cfg = SlamConfig(
        n_robots=3,
        odometry=OdometryCfg(table_size=1 << 16),
        loops=LoopCfg(dist_thresh=0.3, min_separation=6, fitness_thresh=0.15),
    )
    world = synthetic.default_world(7)
    n = 40
    trajs = [
        synthetic.circle_trajectory(n, radius=22.0, laps=0.55, phase=2 * math.pi * r / 3)
        for r in range(3)
    ]

    print("raycasting scans...")
    with tracer.span("raycast"):
        scans = [synthetic.scan_batch(world, t.to(dev), n_rings=16, n_azimuth=512,
                                      rng=np.random.default_rng(r))
                 for r, t in enumerate(trajs)]

    print("running SLAM...")
    with tracer.span("slam"):
        res = pipeline.run(scans, cfg, origins=[se3.index(t, 0) for t in trajs], device=dev)

    inter = sum(1 for l in res.loops if l["robot_a"] != l["robot_b"])
    print(f"loops: {len(res.loops)} ({inter} inter-robot)")
    ates = []
    for r in range(3):
        kf_idx = torch.as_tensor(res.robots[r].kf_frame_idx)
        est = res.optimized_trajectory(r)
        a = float(metrics.ate(se3.Pose(est.R.cpu(), est.t.cpu()),
                              se3.index(trajs[r], kf_idx)).rmse)
        ates.append(a)
        print(f"robot {r}: {len(kf_idx)} keyframes, ATE {a:.3f} m")

    print("writing artifacts...")
    with tracer.span("artifacts"):
        persistence.save_artifacts(out_dir, res)
        emap, feats, cm = pipeline.build_elevation(res, cfg, size=700)
        plotted = importlib.util.find_spec("matplotlib") is not None
        if plotted:
            visualize.plot_map(f"{out_dir}/map.png", res)
            visualize.plot_elevation(f"{out_dir}/elevation.png", emap, feats)
            visualize.plot_costmap(f"{out_dir}/costmap.png", cm)
        else:
            print("matplotlib is not installed: skipped map.png, elevation.png, costmap.png")
    print(json.dumps(tracer.report()))
    print(f"done -> {out_dir}/")
    return dict(loops=len(res.loops), inter=inter, ate=ates, plotted=plotted,
                valid_cells=int(emap.valid.sum()))


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("out_dir", nargs="?", default="demo_out")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()
    main(args.out_dir, args.device)
