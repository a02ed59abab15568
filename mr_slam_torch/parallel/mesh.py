"""Process meshes and the collectives the port runs over them (port of
`mr_slam_tpu/parallel/mesh.py`: `ROBOT_AXIS`, `SHARD_AXIS`,
`make_mesh`, `single_device_mesh`).

The reference lays its devices out as a `jax.sharding.Mesh` with two
named axes, robot and shard, and reduces over an axis with `psum` /
`all_gather` under `shard_map`. Here the mesh is a grid of
`torch.distributed` ranks, and each axis is a process group: the ranks
that share this rank's position on the other axis. An axis of size 1
has no group (`None`): every function of the port that takes
`group=None` then runs its single-process path unchanged.

`NamedSharding`, `robot_sharding`, `robot_shard_sharding`,
`replicated` and `shard_tree` have no counterpart: a PyTorch tensor
lives whole on one device, so there is no global array to describe.
Each rank holds the block it owns, and `block` says which block that is.

`all_reduce` and `all_gather` are the only collectives the port runs.
Each records its calls, bytes and host seconds under
`comm.<name>.{calls,bytes,s}` in `runtime.observability.metrics`.
Gloo takes both on CPU and CUDA tensors (the latter through host
copies); NCCL takes only CUDA tensors, so callers build what they send
on the rank's device.
"""
from __future__ import annotations

import time
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist

ROBOT_AXIS = "robot"
SHARD_AXIS = "shard"


@dataclass(frozen=True)
class Mesh:
    """A (robot, shard) grid of ranks and this rank's group on each axis
    (None where the axis has size 1)."""

    ranks: np.ndarray          # (n_robots, n_shards) global ranks
    robot_group: object        # ranks[:, j] for this rank's column j
    shard_group: object        # ranks[i, :] for this rank's row i

    @property
    def shape(self) -> dict[str, int]:
        return {ROBOT_AXIS: self.ranks.shape[0], SHARD_AXIS: self.ranks.shape[1]}

    def group(self, axis: str):
        return {ROBOT_AXIS: self.robot_group, SHARD_AXIS: self.shard_group}[axis]

    def index(self, axis: str) -> int:
        """This rank's position along `axis` (0 for a rank outside the
        mesh, which owns nothing)."""
        pos = np.argwhere(self.ranks == _rank())
        return int(pos[0][0 if axis == ROBOT_AXIS else 1]) if len(pos) else 0


def _rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def make_mesh(n_robots: int = 1, n_shards: int = 1, ranks=None) -> Mesh:
    """A (robot, shard) mesh over the first n_robots * n_shards of
    `ranks` (default: every rank of the default group); raises
    ValueError when there are too few. Every rank of the default group
    must call it, in the same order, since a process group is created by
    all of them together; ranks left out get no group."""
    ranks = list(ranks if ranks is not None else range(_world()))
    need = n_robots * n_shards
    if len(ranks) < need:
        raise ValueError(f"need {need} ranks, have {len(ranks)}")
    grid = np.array(ranks[:need]).reshape(n_robots, n_shards)
    me = _rank()
    robot_group = shard_group = None
    if n_robots > 1:
        for j in range(n_shards):
            g = dist.new_group([int(r) for r in grid[:, j]])
            if me in grid[:, j]:
                robot_group = g
    if n_shards > 1:
        for i in range(n_robots):
            g = dist.new_group([int(r) for r in grid[i, :]])
            if me in grid[i, :]:
                shard_group = g
    return Mesh(grid, robot_group, shard_group)


def single_device_mesh() -> Mesh:
    """The 1 x 1 mesh: both groups None."""
    return Mesh(np.array([[_rank()]]), None, None)


def size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def rank(group) -> int:
    return 0 if group is None else dist.get_rank(group)


def block(n: int, parts: int, index: int) -> slice:
    """The contiguous block of `n` items that part `index` of `parts`
    owns: ceil(n / parts) items a part, the last ones fewer (or none).
    A contiguous split is how `shard_map` cuts an axis."""
    per = -(-n // parts)
    return slice(min(index * per, n), min((index + 1) * per, n))


def _record(name: str, x: torch.Tensor, t0: float) -> None:
    from ..runtime import observability as obs

    obs.metrics.inc(f"comm.{name}.calls")
    obs.metrics.inc(f"comm.{name}.bytes", x.numel() * x.element_size())
    obs.metrics.inc(f"comm.{name}.s", time.perf_counter() - t0)


def all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the ranks of `group`, in place (and returned).
    For a fixed group the sum's order is fixed, and every rank gets the
    same bits."""
    t0 = time.perf_counter()
    dist.all_reduce(x, group=group)
    _record("all_reduce", x, t0)
    return x


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(size(group), *x.shape): every rank's `x` in rank order, on x's
    device. Bool tensors travel as bytes."""
    if x.dtype == torch.bool:
        return all_gather(x.view(torch.uint8), group).view(torch.bool)
    t0 = time.perf_counter()
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(size(group))]
    dist.all_gather(parts, x, group=group)
    out = torch.stack(parts)
    _record("all_gather", out, t0)
    return out
