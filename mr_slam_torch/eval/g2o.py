"""g2o pose-graph interchange (port of `mr_slam_tpu/eval/g2o.py`:
`export_g2o`, `import_g2o`).

The reference system persists `writeG2o` dumps before and after
optimization (`global_manager.cpp:188-212`) with gtsam-style keys
(char('a' + robot) << 56 | index). This module reads and writes the same
VERTEX_SE3:QUAT / EDGE_SE3:QUAT text, so trajectories can be
cross-checked against gtsam tooling; `export_g2o` writes the reference
package's text for the same graph.
"""
from __future__ import annotations

import numpy as np
import torch

from ..backend import factor_graph as fg
from ..geometry import so3
from ..geometry.se3 import Pose


def export_g2o(path: str, g: fg.FactorGraph, max_index: int = 1 << 20) -> None:
    """Write the valid nodes and edges. Node ids use the gtsam key codec
    so per-robot graphs read back as the reference system's dumps do."""
    n_nodes, n_edges = g.n_nodes, g.n_edges
    poses_q = so3.rot_to_quat(g.poses.R[:n_nodes]).cpu().numpy()  # (N, wxyz)
    poses_t = g.poses.t[:n_nodes].cpu().numpy()
    robots = g.node_robot[:n_nodes].cpu().numpy()
    meas_q = so3.rot_to_quat(g.edge_meas.R[:n_edges]).cpu().numpy()
    meas_t = g.edge_meas.t[:n_edges].cpu().numpy()
    ei = g.edge_i[:n_edges].cpu().numpy()
    ej = g.edge_j[:n_edges].cpu().numpy()
    w_rot = g.edge_w_rot[:n_edges].cpu().numpy()
    w_trans = g.edge_w_trans[:n_edges].cpu().numpy()
    valid_e = g.edge_valid[:n_edges].cpu().numpy()

    # local per-robot indices for key encoding
    local_idx = np.zeros(n_nodes, np.int64)
    counters: dict[int, int] = {}
    for i in range(n_nodes):
        r = int(robots[i])
        local_idx[i] = counters.get(r, 0)
        counters[r] = counters.get(r, 0) + 1

    def key(i: int) -> int:
        return fg.robot_id_to_key(int(robots[i]), int(local_idx[i]))

    with open(path, "w") as f:
        for i in range(n_nodes):
            w, x, y, z = poses_q[i]
            tx, ty, tz = poses_t[i]
            f.write(
                f"VERTEX_SE3:QUAT {key(i)} {tx:.9f} {ty:.9f} {tz:.9f} "
                f"{x:.9f} {y:.9f} {z:.9f} {w:.9f}\n"
            )
        for e in range(n_edges):
            if not valid_e[e]:
                continue
            w, x, y, z = meas_q[e]
            tx, ty, tz = meas_t[e]
            # diagonal information: translation block w_trans, rotation w_rot
            info = np.zeros((6, 6))
            info[0, 0] = info[1, 1] = info[2, 2] = w_trans[e]
            info[3, 3] = info[4, 4] = info[5, 5] = w_rot[e]
            upper = " ".join(f"{info[r, c]:.9f}" for r in range(6) for c in range(r, 6))
            f.write(
                f"EDGE_SE3:QUAT {key(int(ei[e]))} {key(int(ej[e]))} "
                f"{tx:.9f} {ty:.9f} {tz:.9f} {x:.9f} {y:.9f} {z:.9f} {w:.9f} "
                f"{upper}\n"
            )


def import_g2o(path: str, node_capacity: int | None = None, edge_capacity: int | None = None,
               device=None) -> fg.FactorGraph:
    """Read a g2o file into a FactorGraph on `device` (the CPU when
    None). Handles gtsam-style keys via the codec; edge kinds are
    reconstructed from the keys (g2o carries no type tag)."""
    verts: list[tuple[int, np.ndarray, np.ndarray]] = []
    edges: list[tuple[int, int, np.ndarray, np.ndarray, float, float]] = []
    with open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "VERTEX_SE3:QUAT":
                tx, ty, tz, x, y, z, w = map(float, parts[2:9])
                verts.append((int(parts[1]), np.array([tx, ty, tz]), np.array([w, x, y, z])))
            elif parts[0] == "EDGE_SE3:QUAT":
                tx, ty, tz, x, y, z, w = map(float, parts[3:10])
                info = list(map(float, parts[10:31]))
                w_trans = info[0] if info else 1.0
                # info upper-triangular row-major: index of the (3,3) entry
                w_rot = info[18] if len(info) > 18 else 1.0
                edges.append((int(parts[1]), int(parts[2]), np.array([tx, ty, tz]),
                              np.array([w, x, y, z]), w_rot, w_trans))
    key_to_idx = {k: i for i, (k, _, _) in enumerate(verts)}
    n, e = len(verts), len(edges)
    g = fg.init(node_capacity or max(n, 1), edge_capacity or max(e, 1), device)
    dev = g.poses.t.device

    def f32(rows, width):
        arr = np.stack(rows) if rows else np.zeros((0, width))
        return torch.as_tensor(arr, dtype=torch.float32, device=dev)

    if n:
        robots = torch.as_tensor([max(fg.key_to_robot_id(v[0])[0], 0) for v in verts],
                                 device=dev)
        g, _ = fg.add_nodes_batch(
            g, Pose(so3.quat_to_rot(f32([v[2] for v in verts], 4)), f32([v[1] for v in verts], 3)),
            robots,
        )
    if e:
        def kind(ki: int, kj: int) -> int:
            ri, ii = fg.key_to_robot_id(ki)
            rj, ij = fg.key_to_robot_id(kj)
            if ri != rj:
                return fg.INTER_LOOP
            return fg.ODOM if abs(ii - ij) == 1 else fg.INTRA_LOOP

        def ints(vals):
            return torch.as_tensor(vals, dtype=torch.int64, device=dev)

        g, _ = fg.add_edges_batch(
            g, ints([key_to_idx[x[0]] for x in edges]), ints([key_to_idx[x[1]] for x in edges]),
            Pose(so3.quat_to_rot(f32([x[3] for x in edges], 4)), f32([x[2] for x in edges], 3)),
            ints([kind(x[0], x[1]) for x in edges]),
            torch.as_tensor([x[4] for x in edges], dtype=torch.float32, device=dev),
            torch.as_tensor([x[5] for x in edges], dtype=torch.float32, device=dev),
        )
    return g
