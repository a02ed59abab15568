"""Edge-sharded pose-graph optimization over a process group (port of
`mr_slam_tpu/backend/distributed.py`: `shard_edges`, `optimize`).

The reference keeps the two-stage chordal math of `chordal.py` and
solves each linear system jointly by CG whose matvec is data-parallel
over EDGES: node state (poses, (N, 6) CG vectors) is replicated on every
rank, the edge arrays are cut into one contiguous block a rank, and
every H x / gradient / diagonal scatter is summed over the ranks (one
all-reduce a matvec, `chordal._preduce`). Every rank then solves the
whole system and returns the same poses, bit for bit. The sums run in
another order than the single-process solve's, so the two agree to
rounding, not bitwise.

The reference's `edge_specs` (the `PartitionSpec`s of `shard_map`) has
no counterpart: `edge_block` cuts the rank's edges out directly.
"""
from __future__ import annotations

import torch

from ..geometry.se3 import Pose
from ..parallel import mesh
from . import chordal
from .factor_graph import FactorGraph

_EDGE_FIELDS = ("edge_i", "edge_j", "edge_kind", "edge_w_rot", "edge_w_trans", "edge_valid")


def _edges(g: FactorGraph, fn) -> FactorGraph:
    """`g` with `fn` applied to every edge array; node arrays untouched."""
    return g._replace(
        edge_meas=Pose(fn(g.edge_meas.R), fn(g.edge_meas.t)),
        **{name: fn(getattr(g, name)) for name in _EDGE_FIELDS},
    )


def shard_edges(g: FactorGraph, n_shards: int) -> FactorGraph:
    """Pad the edge arrays to a multiple of `n_shards` with invalid,
    zero-weight edges between node 0 and itself; they scatter nothing
    (`chordal.scatter_plan` leaves invalid edges out)."""
    pad = (-g.edge_capacity) % n_shards
    if not pad:
        return g
    return _edges(g, lambda x: torch.cat([x, x.new_zeros((pad, *x.shape[1:]))]))


def edge_block(g: FactorGraph, n_shards: int, index: int) -> FactorGraph:
    """Shard `index`'s contiguous block of a padded graph's edges, as
    `shard_map` splits an axis: edges [index * E / n, (index + 1) * E / n)."""
    rows = mesh.block(g.edge_capacity, n_shards, index)
    return _edges(g, lambda x: x[rows])


def optimize(
    g: FactorGraph,
    anchors: torch.Tensor,
    group,
    config: chordal.PGOConfig = chordal.PGOConfig(),
) -> Pose:
    """Two-stage chordal PGO with the edges sharded over the ranks of
    `group` (every rank passes the whole graph; each solves with its
    block of edges and the nodes replicated). Returns the same poses on
    every rank."""
    n = mesh.size(group)
    block = edge_block(shard_edges(g, n), n, mesh.rank(group))
    return chordal.optimize(block, anchors, config, group=group)
