"""Scatter-adds that sum in a fixed order on every device.

`Tensor.index_add_` on a CUDA tensor adds with float atomics, so the
order of the additions into one slot, and with it the rounding, changes
from run to run; the reference's XLA scatter-add does not. Every
scatter-add of the port goes through this module instead:

  * `index_add` / `scatter_sum` — on a CPU tensor `index_add_`, which
    adds in index order; on a CUDA tensor `index_put_(...,
    accumulate=True)`, which PyTorch implements by a stable sort of the
    indices and one pass over each run of equal indices (the path
    `torch.use_deterministic_algorithms` routes `index_add_` to). Both
    add each slot's values in their original order, onto the base.
  * `ScatterPlan` — one index vector scattered into many times (the
    chordal solve's edge endpoints, fixed through a solve). On the card
    the plan lists each slot's sources once, padded to the largest
    count, and a scatter becomes a gather and a sum over that axis: no
    sort per call. On the CPU it is `index_add_`.

Scatter-min/max (`scatter_reduce_` with "amin"/"amax") are exact and
need no such care, and neither are integer counts (`count`): integer
additions give the same sum in any order, so a plain `index_add_`
serves on every device.
"""
from __future__ import annotations

import numpy as np
import torch


def _add_into(out: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    if out.device.type == "cuda":
        return out.index_put_((index,), values, accumulate=True)
    return out.index_add_(0, index, values)


def index_add(base: torch.Tensor, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """`base.index_add(0, index, values)` (a new tensor) with each slot's
    values added in index order, bit-stable across runs on the card."""
    return _add_into(base.clone(), index, values)


def scatter_sum(n: int, index: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """zeros((n, *values.shape[1:])) with values[k] added at index[k]."""
    return _add_into(values.new_zeros((n, *values.shape[1:])), index, values)


def count(n: int, index: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """int32 counts (n,) of the entries of `index` where `keep` is true."""
    out = torch.zeros((n,), dtype=torch.int32, device=index.device)
    return out.index_add_(0, index.reshape(-1), keep.reshape(-1).to(torch.int32))


class ScatterPlan:
    """Scatter-sums through one fixed `index` (M,) into `n` slots.

    Sources with `keep` (M,) False are left out of the padded plan; their
    values must be zero (the chordal solve's unused edge slots, whose
    weights are zero), so leaving them out changes at most the sign of
    a zero. `padded` defaults to "on the card"; the CPU tests set it to
    run the card's algorithm here. Building a padded plan reads the
    index on the host once. Its width is the largest count rounded up to
    a power of two, at least 4: the gather-sum adds a row's sources in
    order and the zero row's columns after them leave the sum's bits as
    they are (checked on the card, `tests/test_torch_solve_graph.py`),
    and plans of a growing graph keep one shape for longer. `slots`: a
    plan's (n, width) table built before (a runner's buffer, which it
    rewrites for each solve): the plan reads it and builds none."""

    def __init__(self, index: torch.Tensor, n: int, keep: torch.Tensor | None = None,
                 padded: bool | None = None, slots: torch.Tensor | None = None):
        self.index = index
        self.n = n
        self.padded = index.device.type == "cuda" if padded is None else padded
        self._pad: dict = {}
        if not self.padded:
            return
        if slots is not None:
            self.slots = slots
            return
        idx = index.cpu().numpy()
        m = len(idx)
        src = np.arange(m) if keep is None else np.flatnonzero(keep.cpu().numpy())
        order = src[np.argsort(idx[src], kind="stable")]
        counts = np.bincount(idx[src], minlength=n)
        width = max(4, 1 << (int(counts.max(initial=0)) - 1).bit_length())
        rank = np.arange(len(order)) - (np.cumsum(counts) - counts)[idx[order]]
        slots = np.full((n, width), m, np.int64)  # m -> the zero row
        slots[idx[order], rank] = order
        self.slots = torch.from_numpy(slots).to(index.device)

    def __call__(self, *parts: torch.Tensor) -> torch.Tensor:
        """Scatter-sum of the concatenation of `parts` (M rows in all)."""
        if not self.padded:
            values = parts[0] if len(parts) == 1 else torch.cat(parts)
            return scatter_sum(self.n, self.index, values)
        key = (parts[0].shape[1:], parts[0].dtype)
        if key not in self._pad:
            self._pad[key] = parts[0].new_zeros((1, *parts[0].shape[1:]))
        values = torch.cat([*parts, self._pad[key]])
        return values[self.slots].sum(dim=1)
