"""Gauss-Seidel at `GSConfig()` on `chip_smoke.py`'s phase-10 graph
(`graphgen.multi_robot_graph(**chip_smoke.PGO_GRAPH)`): how far rounding
alone moves its ATE, card against CPU.

    python3 gs_rounding.py

Needs a CUDA card. Prints, for float32 and float64:
- whether the graph drawn on the card equals the one drawn on the CPU;
- the rotation stage's relaxed rotations X (25 sweeps): their largest
  gap card - CPU, before and after `so3.project`, and how many valid
  nodes' projections part from float64's by more than 1e-2, with the
  range of their singular values;
- the ATE of the pose stage run on each device from each device's
  rotation stage, and of the eager solve on each device;
then, in float32, the card's and the CPU's ATE on the graph drawn on the
CPU and on copies of it whose measurements are moved by -1, 0 or +1 ulp
(numpy seeds 1-4). CPU runs use one PyTorch thread, as the parity tests
do. `tests.torch_parity.gs_pgo_reference` gives the JAX package's ATE on
the CPU-drawn graph.
"""
from __future__ import annotations

import sys

import numpy as np
import torch

import chip_smoke as cs


def _graph(dev):
    from mr_slam_torch.eval import graphgen

    g, true, anchors, _ = graphgen.multi_robot_graph(**cs.PGO_GRAPH, device=dev)
    return g, true, anchors


def _astype(g, dtype):
    P = type(g.poses)
    return g._replace(poses=P(g.poses.R.to(dtype), g.poses.t.to(dtype)),
                      edge_meas=P(g.edge_meas.R.to(dtype), g.edge_meas.t.to(dtype)),
                      edge_w_rot=g.edge_w_rot.to(dtype), edge_w_trans=g.edge_w_trans.to(dtype))


def _ulp_moved(g, seed: int):
    """`g` with every measurement entry moved by -1, 0 or +1 ulp (float32),
    drawn from `np.random.default_rng(seed)`; seed 0 gives `g`."""
    if not seed:
        return g
    rng = np.random.default_rng(seed)

    def moved(x):
        a = x.cpu().numpy()
        k = rng.integers(-1, 2, size=a.shape)
        a = np.where(k > 0, np.nextafter(a, np.float32(np.inf)),
                     np.where(k < 0, np.nextafter(a, np.float32(-np.inf)), a))
        return torch.from_numpy(a).to(x.device)

    return g._replace(edge_meas=type(g.edge_meas)(moved(g.edge_meas.R), moved(g.edge_meas.t)))


def _rotation_stage(g, anchors, cfg, n_robots):
    from mr_slam_torch.backend import chordal, gauss_seidel as gs

    scatter = chordal.scatter_plan(g)
    X = g.poses.R
    for sweep in range(cfg.rot_sweeps):
        X = gs.rotation_sweep(X, sweep, g, anchors, n_robots, cfg, scatter)
    return X


def _pose_stage(g, anchors, cfg, n_robots, R):
    from mr_slam_torch.backend import chordal, gauss_seidel as gs
    from mr_slam_torch.geometry import so3
    from mr_slam_torch.geometry.se3 import Pose

    scatter = chordal.scatter_plan(g)
    R = torch.where(g.node_valid[:, None, None], R, g.poses.R)
    aw = anchors.to(torch.float32) * cfg.anchor_weight
    t = g.poses.t
    for sweep in range(cfg.pose_sweeps):
        R, t = gs.pose_sweep(R, t, sweep, g, aw, n_robots, cfg, scatter)
    return Pose(so3.project(R), t)


def main() -> int:
    from mr_slam_torch.backend import gauss_seidel as gs
    from mr_slam_torch.geometry import so3

    if not torch.cuda.is_available():
        print("gs_rounding.py needs a CUDA card", file=sys.stderr)
        return 1
    torch.set_num_threads(1)
    cuda, cpu = torch.device("cuda", 0), torch.device("cpu")
    cfg, R_ = gs.GSConfig(), cs.PGO_GRAPH["n_robots"]
    (g_card, _, a_card), (g_cpu, true, a_cpu) = _graph(cuda), _graph(cpu)
    n = int(g_cpu.n_nodes)
    valid = g_cpu.node_valid.numpy()[:n]

    def ate(t) -> float:
        d = t[:n].double().cpu().numpy() - true.t.numpy()
        return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))

    same = all(torch.equal(x.cpu(), y) for x, y in zip(cs._leaves(tuple(g_card)),
                                                       cs._leaves(tuple(g_cpu)))
               if isinstance(x, torch.Tensor))
    cs.log(f"[gs-rounding] {torch.cuda.get_device_name(0)}; the graph drawn on the card equals "
           f"the CPU's: {same}")
    X = {}
    for dt in (torch.float64, torch.float32):
        gc, gg = _astype(g_card, dt), _astype(g_cpu, dt)
        Xg, Xc = _rotation_stage(gc, a_card, cfg, R_), _rotation_stage(gg, a_cpu, cfg, R_)
        X[dt] = Xc
        Pg, Pc = so3.project(Xg), so3.project(Xc)
        line = (f"[gs-rounding] {str(dt)[6:]}: rotation stage X card - CPU max "
                f"{float((Xg.cpu() - Xc)[:n].abs().max()):.3e}, projected "
                f"{float((Pg.cpu() - Pc)[:n].abs().max()):.3e}")
        if dt == torch.float32:
            gap = (so3.project(Xc).double() - so3.project(X[torch.float64]))[:n].abs().amax(
                dim=(1, 2)).numpy()
            far = (gap > 1e-2) & valid
            sv = torch.linalg.svdvals(Xc[:n].double()).numpy()[far]
            line += (f"; on the CPU {int(far.sum())} of {int(valid.sum())} valid nodes' "
                     f"projections part from float64's by > 1e-2, their singular values "
                     f"{sv.min():.3g}-{sv.max():.3g}")
        cs.log(line)
        runs = {"card / card": _pose_stage(gc, a_card, cfg, R_, Pg),
                "CPU / CPU": _pose_stage(gg, a_cpu, cfg, R_, Pc),
                "CPU rotation stage / card pose stage": _pose_stage(gc, a_card, cfg, R_,
                                                                    Pc.to(cuda)),
                "card rotation stage / CPU pose stage": _pose_stage(gg, a_cpu, cfg, R_,
                                                                    Pg.cpu())}
        cs.log(f"[gs-rounding] {str(dt)[6:]} ATE (m), rotation / pose stage on: "
               + ", ".join(f"{k} {ate(v.t):.6f}" for k, v in runs.items())
               + f"; eager solve card {ate(gs._optimize_eager(gc, a_card, R_, cfg).t):.6f}, "
               f"CPU {ate(gs._optimize_eager(gg, a_cpu, R_, cfg).t):.6f}")
    for seed in range(5):
        h = _ulp_moved(g_cpu, seed)
        card = ate(gs._optimize_eager(cs._to(h, cuda), a_cpu.to(cuda), R_, cfg).t)
        host = ate(gs._optimize_eager(h, a_cpu, R_, cfg).t)
        cs.log(f"[gs-rounding] float32, the CPU-drawn graph, measurements moved by +-1 ulp "
               f"with seed {seed}: ATE card {card:.6f} m, CPU {host:.6f} m")
    return 0


if __name__ == "__main__":
    sys.exit(main())
