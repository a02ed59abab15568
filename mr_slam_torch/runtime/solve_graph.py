"""The single-process pose-graph solves replayed as CUDA graphs: the
port's counterparts of the reference's compiled `chordal.optimize`
(`mr_slam_tpu/backend/chordal.py:191-193`, one jitted program whose CG
loops are `lax.scan`s) and `gauss_seidel.optimize`
(`mr_slam_tpu/backend/gauss_seidel.py:115-117`, one jitted program whose
sweeps are two `lax.scan`s).

A runner holds static buffers for one key (device, node and edge
capacity, the scatter plan's width, the config, dtype; Gauss-Seidel also
the robot count): every array of the `FactorGraph` that the solves read
(poses, `node_robot`, `node_valid`, both edge ends, measurements, kinds,
weights, `edge_valid`), the anchors, the plan's source table (`slots`,
or the CPU plan's index) and the state. Each solve copies its graph and
plan in with `copy_` and runs two segments of `frame_graph.Segments` on
those buffers. The chordal runner (`Runner`):

  rot   `chordal.rotation_cg` (the rotation CG stage) and the GN stage's
        anchor weights
        [so3.project, eager: its torch.linalg.svd syncs the host; the
         invalid nodes' rotations put back]
  gn    `chordal.gn_step`, writing (R, t) back with `copy_`; replayed
        `gn_iters` times
        [so3.project, eager]

The Gauss-Seidel runner (`GSRunner`):

  rot   `gauss_seidel.rotation_sweep`, writing X back with `copy_` and
        advancing the sweep counter (a 0-d int64 buffer the sweep's gate
        reads); replayed `rot_sweeps` times
        [so3.project, eager; the counter set back to 0]
  pose  `gauss_seidel.pose_sweep`, writing (R, t) back and advancing the
        counter; replayed `pose_sweeps` times
        [so3.project, eager]

A sweep is a segment of its own (~1,700 kernels at three robots),
not a whole stage, so a capture holds one sweep's kernels and the sweep
index lives on the device: a graph captured at sweep 0 gates the later
sweeps by the counter it advances, never by an index baked in at
capture.

A runner's first solve runs the segments eagerly on its buffers: that
run makes cuSOLVER's handle, cuBLAS's workspace, the device constants
and the plan's zero rows, which a capture cannot make. From its second
solve on, each segment is captured once and replayed: a default chordal
solve (60 + 12 x 40 CG steps, ~20,000 kernels) is 13 replays, a default
Gauss-Seidel solve (25 + 25 sweeps of three robots' 15-step block CGs,
~90,000 kernels) 50. Replays launch the eager kernels on the same
inputs, so a solve equals `chordal._optimize_eager` or
`gauss_seidel._optimize_eager` bit for bit. A failed capture raises:
there is no eager fallback on the card. On the CPU the segments run
eagerly, in the same order, on the same buffers.

The plan is built on the host once a solve (`chordal.scatter_plan`, a
read of the edge ends) and copied into the runner's table. Its width is
the largest node degree rounded up to a power of two, so the graphs of a
session whose loops raise the degree share a runner until the degree
crosses a bucket. At most MAX_RUNNERS runners of each solve are kept
(`frame_graph.RunnerCache`), the least recently used dropped first.
`prepare` builds the plan and finds the runner, and returns the solve
to run: `OnlineSlam.optimize` times that part as `online.solve.prepare`.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ..backend import chordal, gauss_seidel
from ..backend import factor_graph as fg
from ..geometry.se3 import Pose
from ..ops import segment
from . import frame_graph
from . import observability as obs

MAX_RUNNERS = 4

_runners = frame_graph.RunnerCache(MAX_RUNNERS)
_gs_runners = frame_graph.RunnerCache(MAX_RUNNERS)

# the solves' projections between replays: their sync site and span
PROJECT = ("solve.project", "online.solve.project")
# host waits of building a padded plan: the reads of its index and mask and
# its table's copy back to the card (`segment.ScatterPlan`)
PLAN_SYNCS = 3

# the graph arrays a solve reads, by buffer name
_ARRAYS = dict(R0=lambda g: g.poses.R, t0=lambda g: g.poses.t,
               node_robot=lambda g: g.node_robot, node_valid=lambda g: g.node_valid,
               edge_i=lambda g: g.edge_i, edge_j=lambda g: g.edge_j,
               meas_R=lambda g: g.edge_meas.R, meas_t=lambda g: g.edge_meas.t,
               edge_kind=lambda g: g.edge_kind, w_rot=lambda g: g.edge_w_rot,
               w_trans=lambda g: g.edge_w_trans, edge_valid=lambda g: g.edge_valid)


def _empty(x: torch.Tensor) -> torch.Tensor:
    return torch.empty(x.shape, dtype=x.dtype, device=x.device)


class _Solver:
    """The segments and static buffers of one key: the graph's arrays,
    the anchors, the plan's table and the state (R, t)."""

    def __init__(self, g: fg.FactorGraph, anchors: torch.Tensor, plan: segment.ScatterPlan):
        self.segs = frame_graph.Segments(g.poses.R.device, "solve")
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

    def _graph(self, b: dict) -> fg.FactorGraph:
        # the solves read n_nodes and n_edges nowhere
        return fg.FactorGraph(
            poses=Pose(b["R0"], b["t0"]), node_robot=b["node_robot"],
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

    def _run(self):
        """The segment runner of this solve: eager at the first."""
        return self.segs.eager if self.solves == 0 else self.segs.run

    def _result(self) -> Pose:
        self.solves += 1
        # the graphs rewrite the state at the next solve
        return Pose(frame_graph.project(self.b["R"], *PROJECT), self.b["t"].clone())

    def stats(self) -> dict:
        s = self.segs
        return dict(solves=self.solves, captures=s.captures, replays=s.replays,
                    capture_s=s.capture_s, pool_bytes=s.pool_bytes())

    def close(self) -> None:
        """Release the graphs once their last replay has run."""
        self.segs.close(self.solves)


class Runner(_Solver):
    """The chordal solve of one key; `runner(g, anchors, plan)` solves `g`
    with `plan` (`chordal.scatter_plan(g)`)."""

    def __init__(self, g: fg.FactorGraph, anchors: torch.Tensor, plan: segment.ScatterPlan,
                 config: chordal.PGOConfig):
        super().__init__(g, anchors, plan)
        self.config = config

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
        run = self._run()
        with self.segs.on_stream():
            self.load(g, anchors, plan)
            b.update(run("rot", self._rot, b))
            R = frame_graph.project(b["X"], *PROJECT)
            b["R"].copy_(torch.where(b["node_valid"][:, None, None], R, b["R0"]))
            b["t"].copy_(b["t0"])
            for _ in range(self.config.gn_iters):
                run("gn", self._gn, b)
        return self._result()


class GSRunner(_Solver):
    """The Gauss-Seidel solve of one key; `runner(g, anchors, plan)` solves
    `g` with `plan` (`chordal.scatter_plan(g)`)."""

    def __init__(self, g: fg.FactorGraph, anchors: torch.Tensor, plan: segment.ScatterPlan,
                 n_robots: int, config: gauss_seidel.GSConfig):
        super().__init__(g, anchors, plan)
        self.n_robots = n_robots
        self.config = config
        dev = g.poses.R.device
        self.b.update(X=_empty(g.poses.R),
                      aw=torch.empty(anchors.shape, dtype=torch.float32, device=dev),
                      sweep=torch.zeros((), dtype=torch.int64, device=dev))

    def _rot(self, b: dict) -> dict:
        X = gauss_seidel.rotation_sweep(b["X"], b["sweep"], self._graph(b), b["anchors"],
                                        self.n_robots, self.config, self.plan)
        b["X"].copy_(X)
        b["sweep"].add_(1)
        return {}

    def _pose(self, b: dict) -> dict:
        R, t = gauss_seidel.pose_sweep(b["R"], b["t"], b["sweep"], self._graph(b), b["aw"],
                                       self.n_robots, self.config, self.plan)
        b["R"].copy_(R)
        b["t"].copy_(t)
        b["sweep"].add_(1)
        return {}

    def __call__(self, g: fg.FactorGraph, anchors: torch.Tensor,
                 plan: segment.ScatterPlan) -> Pose:
        """The solve of `g`: optimized poses, tensors of their own."""
        b, cfg = self.b, self.config
        run = self._run()
        with self.segs.on_stream():
            self.load(g, anchors, plan)
            b["X"].copy_(b["R0"])
            b["sweep"].zero_()
            for _ in range(cfg.rot_sweeps):
                run("rot", self._rot, b)
            R = frame_graph.project(b["X"], *PROJECT)
            b["R"].copy_(torch.where(b["node_valid"][:, None, None], R, b["R0"]))
            b["t"].copy_(b["t0"])
            b["aw"].copy_(b["anchors"].to(torch.float32) * cfg.anchor_weight)
            b["sweep"].zero_()
            for _ in range(cfg.pose_sweeps):
                run("pose", self._pose, b)
        return self._result()


def _plan_key(g: fg.FactorGraph):
    """(plan, the key's device, capacities, plan width (None: the CPU's
    index plan) and dtype)."""
    plan = chordal.scatter_plan(g)
    if plan.padded:
        obs.metrics.inc("sync.solve.plan", PLAN_SYNCS)
    width = plan.slots.shape[1] if plan.padded else None
    return plan, (g.poses.R.device, g.node_capacity, g.edge_capacity, width, g.poses.R.dtype)


def prepare(g: fg.FactorGraph, anchors: torch.Tensor,
            config: chordal.PGOConfig = chordal.PGOConfig()) -> Callable[[], Pose]:
    """The solve of `g` ready to run: its plan built and the runner of its
    key found (or made). Calling the result solves."""
    plan, key = _plan_key(g)
    runner = _runners.get((*key, config), lambda: Runner(g, anchors, plan, config))
    return functools.partial(runner, g, anchors, plan)


def solve(g: fg.FactorGraph, anchors: torch.Tensor,
          config: chordal.PGOConfig = chordal.PGOConfig()) -> Pose:
    """`chordal.optimize(g, anchors, config)` without a process group,
    through the runner of the solve's key."""
    return prepare(g, anchors, config)()


def solve_gauss_seidel(g: fg.FactorGraph, anchors: torch.Tensor, n_robots: int,
                       config: gauss_seidel.GSConfig = gauss_seidel.GSConfig()) -> Pose:
    """`gauss_seidel.optimize(g, anchors, n_robots, config)` through the
    runner of the solve's key."""
    plan, key = _plan_key(g)
    runner = _gs_runners.get((*key, n_robots, config),
                             lambda: GSRunner(g, anchors, plan, n_robots, config))
    return runner(g, anchors, plan)


def _describe(key) -> dict:
    return dict(nodes=key[1], edges=key[2], width=key[3])


def stats() -> list[dict]:
    """Each kept chordal runner's solves, captures, replays, capture
    seconds and graph-pool bytes, with its key's node and edge capacity,
    plan width (None: the CPU's index plan) and CG / GN / CG iterations,
    the least recently used first."""
    return _runners.stats(lambda k: dict(_describe(k), iters=(k[5].rot_cg_iters, k[5].gn_iters,
                                                               k[5].pose_cg_iters)))


def gs_stats() -> list[dict]:
    """`stats()` of the kept Gauss-Seidel runners: `iters` are their
    rotation sweeps, pose sweeps and CG iterations a block, `robots` the
    robot count."""
    return _gs_runners.stats(lambda k: dict(_describe(k), robots=k[5], iters=(
        k[6].rot_sweeps, k[6].pose_sweeps, k[6].cg_iters)))


def clear() -> None:
    """Drop every runner (their graphs and buffers)."""
    _runners.clear()
    _gs_runners.clear()
