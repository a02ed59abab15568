"""Array-native multi-robot pose graph (port of
`mr_slam_tpu/backend/factor_graph.py`: `FactorGraph`, `init`,
`add_nodes_batch`, `add_edges_batch`, the gtsam key codec and
`connected_robots`).

Node and edge counts are host integers (the graph is built on the host
side of the pipeline); the reference's `mode="drop"` scatters become
writes of the in-range prefix, since PyTorch raises on out-of-range
indices.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..geometry import se3
from ..geometry.se3 import Pose

ODOM = 0
INTRA_LOOP = 1
INTER_LOOP = 2
PRIOR = 3


class FactorGraph(NamedTuple):
    """Fixed-capacity pose graph. Edges index the node arrays directly;
    edge weights are scalar information weights for rotation and
    translation."""

    poses: Pose
    node_robot: torch.Tensor
    node_valid: torch.Tensor
    n_nodes: int
    edge_i: torch.Tensor
    edge_j: torch.Tensor
    edge_meas: Pose
    edge_kind: torch.Tensor
    edge_w_rot: torch.Tensor
    edge_w_trans: torch.Tensor
    edge_valid: torch.Tensor
    n_edges: int

    @property
    def node_capacity(self) -> int:
        return self.node_robot.shape[0]

    @property
    def edge_capacity(self) -> int:
        return self.edge_i.shape[0]


def init(node_capacity: int, edge_capacity: int, device=None) -> FactorGraph:
    def zeros(n, dtype):
        return torch.zeros((n,), dtype=dtype, device=device)

    return FactorGraph(
        poses=se3.identity((node_capacity,), device=device),
        node_robot=zeros(node_capacity, torch.int64),
        node_valid=zeros(node_capacity, torch.bool),
        n_nodes=0,
        edge_i=zeros(edge_capacity, torch.int64),
        edge_j=zeros(edge_capacity, torch.int64),
        edge_meas=se3.identity((edge_capacity,), device=device),
        edge_kind=zeros(edge_capacity, torch.int64),
        edge_w_rot=zeros(edge_capacity, torch.float32),
        edge_w_trans=zeros(edge_capacity, torch.float32),
        edge_valid=zeros(edge_capacity, torch.bool),
        n_edges=0,
    )


def _put(buf: torch.Tensor, start: int, vals, k: int) -> torch.Tensor:
    """Copy of `buf` with rows start..start+k-1 set from the first k of
    `vals` (a tensor or a scalar)."""
    out = buf.clone()
    if k > 0:
        if isinstance(vals, torch.Tensor) and vals.dim() > 0:
            vals = vals[:k]
        out[start:start + k] = vals
    return out


def add_nodes_batch(g: FactorGraph, poses: Pose, robots: torch.Tensor):
    """Append a batch of nodes with one write each. Overflowing entries
    are dropped; the caller sees them as indices >= node_capacity.
    Returns (graph, idx (B,))."""
    B = robots.shape[0]
    idx = g.n_nodes + torch.arange(B, device=robots.device)
    k = min(max(g.node_capacity - g.n_nodes, 0), B)
    g2 = g._replace(
        poses=Pose(_put(g.poses.R, g.n_nodes, poses.R, k), _put(g.poses.t, g.n_nodes, poses.t, k)),
        node_robot=_put(g.node_robot, g.n_nodes, robots.to(torch.int64), k),
        node_valid=_put(g.node_valid, g.n_nodes, True, k),
        n_nodes=g.n_nodes + k,
    )
    return g2, idx


def add_edges_batch(
    g: FactorGraph,
    i: torch.Tensor,
    j: torch.Tensor,
    meas: Pose,
    kind,
    w_rot,
    w_trans,
):
    """Append a batch of edges. Scalar kind/weights broadcast;
    overflowing entries are dropped. Returns (graph, idx (B,))."""
    B = i.shape[0]
    idx = g.n_edges + torch.arange(B, device=i.device)
    k = min(max(g.edge_capacity - g.n_edges, 0), B)
    s = g.n_edges
    g2 = g._replace(
        edge_i=_put(g.edge_i, s, i.to(torch.int64), k),
        edge_j=_put(g.edge_j, s, j.to(torch.int64), k),
        edge_meas=Pose(_put(g.edge_meas.R, s, meas.R, k), _put(g.edge_meas.t, s, meas.t, k)),
        edge_kind=_put(g.edge_kind, s, kind, k),
        edge_w_rot=_put(g.edge_w_rot, s, w_rot, k),
        edge_w_trans=_put(g.edge_w_trans, s, w_trans, k),
        edge_valid=_put(g.edge_valid, s, True, k),
        n_edges=g.n_edges + k,
    )
    return g2, idx


def robot_id_to_key(robot: int, index: int) -> int:
    """gtsam-compatible key: char('a' + robot) << 56 | index."""
    return ((ord("a") + robot) << 56) | index


def key_to_robot_id(key: int) -> tuple[int, int]:
    """(robot, index) from a gtsam-style key (`Key2robotID`)."""
    return (key >> 56) - ord("a"), key & ((1 << 56) - 1)


def interrobot_edges_mask(g: FactorGraph) -> torch.Tensor:
    """(E,) bool — valid edges whose endpoints live on different robots."""
    return g.edge_valid & (g.node_robot[g.edge_i] != g.node_robot[g.edge_j])


def connected_robots(g: FactorGraph, n_robots: int) -> torch.Tensor:
    """(R,) bool — robots with at least one inter-robot edge."""
    inter = interrobot_edges_mask(g)
    ri = torch.where(inter, g.node_robot[g.edge_i], n_robots)
    rj = torch.where(inter, g.node_robot[g.edge_j], n_robots)
    seen = torch.zeros((n_robots + 1,), dtype=torch.bool, device=inter.device)
    seen[ri] = True
    seen[rj] = True
    return seen[:n_robots]
