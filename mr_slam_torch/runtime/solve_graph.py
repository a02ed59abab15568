"""The chordal solve replayed as CUDA graphs: the port's counterpart of
the reference's compiled `chordal.optimize`
(`mr_slam_tpu/backend/chordal.py:191-193`, one jitted program whose CG
loops are `lax.scan`s).

A runner holds static buffers for one key (device, node and edge
capacity, the scatter plan's width, `PGOConfig`, dtype): every array of
the `FactorGraph` that the solve reads (poses, `node_valid`, both edge
ends, measurements, kinds, weights, `edge_valid`), the anchors, the
plan's source table (`slots`, or the CPU plan's index) and the state
(R, t). Each solve copies its graph and plan in with `copy_` and runs
two segments of `frame_graph.Segments` on those buffers:

  rot   `chordal.rotation_cg` (the rotation CG stage) and the GN stage's
        anchor weights
        [so3.project, eager: its torch.linalg.svd syncs the host; the
         invalid nodes' rotations put back]
  gn    `chordal.gn_step`, writing (R, t) back with `copy_`; replayed
        `gn_iters` times
        [so3.project, eager]

A runner's first solve runs the segments eagerly on its buffers: that
run makes cuSOLVER's handle, cuBLAS's workspace, the device constants
and the plan's zero rows, which a capture cannot make. From its second
solve on, each segment is captured once and replayed: a default solve
(60 + 12 x 40 CG steps, ~20,000 kernels) is 13 replays. Replays launch
the eager kernels on the same inputs, so a solve equals
`chordal._optimize_eager` bit for bit. A failed capture raises: there is
no eager fallback on the card. On the CPU the segments run eagerly, in
the same order, on the same buffers.

The plan is built on the host once a solve (`chordal.scatter_plan`, a
read of the edge ends) and copied into the runner's table. Its width is
the largest node degree rounded up to a power of two, so the graphs of a
session whose loops raise the degree share a runner until the degree
crosses a bucket. At most MAX_RUNNERS runners are kept
(`frame_graph.RunnerCache`), the least recently used dropped first.
"""
from __future__ import annotations

import torch

from ..backend import chordal
from ..backend import factor_graph as fg
from ..geometry import so3
from ..geometry.se3 import Pose
from ..ops import segment
from . import frame_graph

MAX_RUNNERS = 4

_runners = frame_graph.RunnerCache(MAX_RUNNERS)

# the graph arrays a solve reads, by buffer name
_ARRAYS = dict(R0=lambda g: g.poses.R, t0=lambda g: g.poses.t,
               node_valid=lambda g: g.node_valid, edge_i=lambda g: g.edge_i,
               edge_j=lambda g: g.edge_j, meas_R=lambda g: g.edge_meas.R,
               meas_t=lambda g: g.edge_meas.t, edge_kind=lambda g: g.edge_kind,
               w_rot=lambda g: g.edge_w_rot, w_trans=lambda g: g.edge_w_trans,
               edge_valid=lambda g: g.edge_valid)


def _empty(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


class Runner:
    """The segments and static buffers of one key; `runner(g, anchors,
    plan)` solves `g` with `plan` (`chordal.scatter_plan(g)`)."""

    def __init__(self, g: fg.FactorGraph, anchors: torch.Tensor, plan: segment.ScatterPlan,
                 config: chordal.PGOConfig):
        self.config = config
        self.segs = frame_graph.Segments(g.poses.R.device)
        self.solves = 0
        b = {name: _empty(get(g)) for name, get in _ARRAYS.items()}
        b.update(anchors=_empty(anchors), R=_empty(g.poses.R), t=_empty(g.poses.t),
                 index=_empty(plan.index))
        if plan.padded:
            b["slots"] = _empty(plan.slots)
        self.b = b
        # the plan reads the runner's table (its zero rows are made by the
        # first, eager solve and kept)
        self.plan = segment.ScatterPlan(b["index"], g.node_capacity, padded=plan.padded,
                                        slots=b.get("slots"))
        # the solve reads node_robot for the node count only, n_nodes and
        # n_edges not at all
        self._node_robot = torch.zeros((g.node_capacity,), dtype=torch.int64,
                                       device=g.poses.R.device)

    def _graph(self, b: dict) -> fg.FactorGraph:
        return fg.FactorGraph(
            poses=Pose(b["R0"], b["t0"]), node_robot=self._node_robot,
            node_valid=b["node_valid"], n_nodes=0, edge_i=b["edge_i"], edge_j=b["edge_j"],
            edge_meas=Pose(b["meas_R"], b["meas_t"]), edge_kind=b["edge_kind"],
            edge_w_rot=b["w_rot"], edge_w_trans=b["w_trans"], edge_valid=b["edge_valid"],
            n_edges=0)

    def load(self, g: fg.FactorGraph, anchors: torch.Tensor, plan: segment.ScatterPlan) -> None:
        """Copy a solve's graph, anchors and plan into the buffers."""
        b = self.b
        for name, get in _ARRAYS.items():
            b[name].copy_(get(g))
        b["anchors"].copy_(anchors)
        b["index"].copy_(plan.index)
        if plan.padded:
            b["slots"].copy_(plan.slots)

    def _rot(self, b: dict) -> dict:
        X = chordal.rotation_cg(self._graph(b), b["anchors"], self.config.rot_cg_iters,
                                scatter=self.plan)
        return dict(X=X, aw=b["anchors"].to(torch.float32) * self.config.anchor_weight)

    def _gn(self, b: dict) -> dict:
        R, t = chordal.gn_step(b["R"], b["t"], self._graph(b), b["aw"], self.config, self.plan)
        b["R"].copy_(R)
        b["t"].copy_(t)
        return {}

    def __call__(self, g: fg.FactorGraph, anchors: torch.Tensor,
                 plan: segment.ScatterPlan) -> Pose:
        """The solve of `g`: optimized poses, tensors of their own."""
        b = self.b
        run = self.segs.eager if self.solves == 0 else self.segs.run
        with self.segs.on_stream():
            self.load(g, anchors, plan)
            b.update(run("rot", self._rot, b))
            R = so3.project(b["X"])
            b["R"].copy_(torch.where(b["node_valid"][:, None, None], R, b["R0"]))
            b["t"].copy_(b["t0"])
            for _ in range(self.config.gn_iters):
                run("gn", self._gn, b)
        self.solves += 1
        # the graphs rewrite the state at the next solve
        return Pose(so3.project(b["R"]), b["t"].clone())

    def stats(self) -> dict:
        s = self.segs
        return dict(solves=self.solves, captures=s.captures, replays=s.replays,
                    capture_s=s.capture_s, pool_bytes=s.pool_bytes())

    def close(self) -> None:
        """Release the graphs once their last replay has run."""
        self.segs.close(self.solves)


def solve(g: fg.FactorGraph, anchors: torch.Tensor,
          config: chordal.PGOConfig = chordal.PGOConfig()) -> Pose:
    """`chordal.optimize(g, anchors, config)` without a process group,
    through the runner of the solve's key."""
    plan = chordal.scatter_plan(g)
    width = plan.slots.shape[1] if plan.padded else None
    key = (g.poses.R.device, g.node_capacity, g.edge_capacity, width, config, g.poses.R.dtype)
    runner = _runners.get(key, lambda: Runner(g, anchors, plan, config))
    return runner(g, anchors, plan)


def stats() -> list[dict]:
    """Each kept runner's solves, captures, replays, capture seconds and
    graph-pool bytes, with its key's node and edge capacity, plan width
    (None: the CPU's index plan) and CG / GN / CG iterations, the least
    recently used first."""
    return _runners.stats(lambda k: dict(nodes=k[1], edges=k[2], width=k[3],
                                         iters=(k[4].rot_cg_iters, k[4].gn_iters,
                                                k[4].pose_cg_iters)))


def clear() -> None:
    """Drop every runner (their graphs and buffers)."""
    _runners.clear()
