"""Offline pose-graph runner: read a .g2o file, optimize, write the
optimized graph (the port's counterpart of `examples/run_pgo_g2o.py`).

The reference system's offline driver
(`distributed_mapper/run_distributed_mapper.cpp`) loads per-robot g2o
files and runs the distributed-mapper scheme. Here one merged g2o file
(the format the manager's `savingPoseGraph` dumps,
`global_manager.cpp:188-212`) is read into a FactorGraph; robot
membership and edge kinds come from the gtsam key codec; each robot's
first node is anchored; then the centralized two-stage chordal + GN
optimizer or the decentralized Gauss-Seidel scheme runs:

    python -m mr_slam_torch.examples.run_pgo_g2o input.g2o [output.g2o]
        [--gauss-seidel] [--gn-iters N] [--no-robust] [--device cpu]

On the card by default. Prints one JSON line with the edge-residual
chi2 before and after.
"""
from __future__ import annotations

import argparse
import json

import numpy as np
import torch


def graph_chi2(g, poses) -> float:
    """Sum over valid edges of the weighted between-residual norms."""
    from mr_slam_torch.geometry import so3

    ei, ej = g.edge_i, g.edge_j
    Ri, ti, Rj, tj = poses.R[ei], poses.t[ei], poses.R[ej], poses.t[ej]
    Rij, tij = g.edge_meas.R, g.edge_meas.t
    r_rot = so3.log(Rij.transpose(-1, -2) @ (Ri.transpose(-1, -2) @ Rj))
    r_t = (Ri.transpose(-1, -2) @ (tj - ti)[..., None])[..., 0] - tij
    chi = g.edge_w_rot * torch.sum(r_rot * r_rot, dim=-1) \
        + g.edge_w_trans * torch.sum(r_t * r_t, dim=-1)
    return float(torch.sum(torch.where(g.edge_valid, chi, 0.0)))


def run(path: str, output: str | None = None, gauss_seidel: bool = False, gn_iters: int = 12,
        robust: bool = True, device="cuda") -> dict:
    from mr_slam_torch.backend import chordal, gauss_seidel as gs
    from mr_slam_torch.eval import g2o
    from mr_slam_torch.runtime.online import resolve_device

    dev = resolve_device(device)
    g = g2o.import_g2o(path, device=dev)
    n = g.n_nodes
    robots = g.node_robot[:n].cpu().numpy()
    n_robots = int(robots.max()) + 1 if n else 0
    # the reference's near-zero-noise prior on each robot's first pose
    # (`global_manager.cpp:347-357`)
    anchors = np.zeros(g.node_capacity, bool)
    for r in range(n_robots):
        idx = np.flatnonzero(robots == r)
        if idx.size:
            anchors[idx[0]] = True
    anchors = torch.as_tensor(anchors, device=dev)
    chi_pre = graph_chi2(g, g.poses)
    if gauss_seidel:
        opt = gs.optimize(g, anchors, max(n_robots, 1), gs.GSConfig())
    else:
        opt = chordal.optimize(g, anchors, chordal.PGOConfig(gn_iters=gn_iters,
                                                             robust_delta=1.0 if robust else 0.0))
    chi_post = graph_chi2(g, opt)
    if output:
        g2o.export_g2o(output, g._replace(poses=opt))
    return {"nodes": n, "edges": g.n_edges, "robots": n_robots,
            "optimizer": "gauss_seidel" if gauss_seidel else "chordal_gn",
            "chi2_pre": chi_pre, "chi2_post": chi_post, "output": output, "device": str(dev)}


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("input")
    ap.add_argument("output", nargs="?", default=None)
    ap.add_argument("--gauss-seidel", action="store_true",
                    help="the decentralized two-stage scheme instead of the centralized "
                         "chordal + GN optimizer")
    ap.add_argument("--gn-iters", type=int, default=12)
    ap.add_argument("--no-robust", action="store_true",
                    help="disable the Cauchy loop-edge weighting")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    print(json.dumps(run(a.input, a.output, a.gauss_seidel, a.gn_iters, not a.no_robust,
                         a.device)))


if __name__ == "__main__":
    main()
