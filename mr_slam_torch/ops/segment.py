"""Scatter-adds that sum in a fixed order on every device.

`Tensor.index_add_` on a CUDA tensor adds with float atomics, so the
order of the additions into one slot, and with it the rounding, changes
from run to run; the reference's XLA scatter-add does not. Every
scatter-add of the port goes through this module instead:

  * `index_add` / `scatter_sum` — one index and one or more value parts,
    whose columns are summed side by side (one sort a call). On a CPU
    tensor `index_add_`, which adds each slot's values in index order
    onto the base. On a CUDA tensor the kernel
    `mr_slam_torch/csrc/segment_sum.cu` (built by `cuda_build`, bound
    with ctypes): a stable sort of the index (none where the caller says
    it is sorted already), then one launch that adds each slot's values
    in their original order onto a zero, and that sum onto the base.
    Onto a zero base (`scatter_sum`) the two devices add alike; onto a
    base that is not zero the card rounds once more at the end, as
    PyTorch's sorted `index_put_(..., accumulate=True)` does at 2 to 32
    columns, the path the port took on the card before the kernel, which
    the benchmark's plain reference still takes. That `index_put_` adds a
    single column in no fixed order (a warp's strided partial sums, a
    shuffle tree, then the tail): the same sum only where every order
    gives it, as for the 0/1 weights the port counts with.
  * `ScatterPlan` — one index vector scattered into many times (the
    chordal solve's edge endpoints, fixed through a solve). On the card
    the plan lists each slot's sources once, padded to the largest
    count, and a scatter becomes a gather and a sum over that axis: no
    sort per call. On the CPU it is `index_add_`.

The kernel replaces no TPU kernel (the reference's `.at[slot].add` is
left to XLA); its wrapper counts its launches (`launch_count`, with the
replays of CUDA graphs added by `runtime/frame_graph.Segments`).

Scatter-min/max (`scatter_reduce_` with "amin"/"amax") are exact and
need no such care, and neither are integer counts (`count`): integer
additions give the same sum in any order, so a plain `index_add_`
serves on every device.
"""
from __future__ import annotations

import ctypes
import functools
import math

import numpy as np
import torch

_COLS = 32  # columns the kernel sums: a lane a column

_launches = 0
_recorded = 0


def launch_count() -> int:
    """Kernel launches (one per `index_add` / `scatter_sum` call on a
    CUDA tensor outside a CUDA-graph capture, plus those `add_launches`
    adds) since the last `reset_launch_count`."""
    return _launches


def recorded_count() -> int:
    """Launches made while their stream was capturing a CUDA graph, since
    the process started: a capture records the launch and runs nothing,
    so `launch_count` leaves them out."""
    return _recorded


def add_launches(n: int) -> None:
    """Count launches the wrapper did not make: a CUDA graph's replay
    runs the launches its capture recorded (`runtime/frame_graph.Segments`)."""
    global _launches
    _launches += n


def reset_launch_count() -> None:
    global _launches
    _launches = 0


@functools.cache
def _lib() -> ctypes.CDLL:
    from . import cuda_build

    lib = cuda_build.load("segment_sum")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.segment_sum_launch.argtypes = [p, p, p, i, i, i, p]
    lib.segment_sum_launch.restype = i
    return lib


def _launch(out: torch.Tensor, index: torch.Tensor, values: torch.Tensor,
            sorted_index: bool) -> None:
    """out (n, C) += values (M, C) by index (M,) on the card, in place:
    the index sorted stably (unless `sorted_index`), the values gathered
    into its order, one launch."""
    global _launches, _recorded
    n, cols = out.shape
    m = values.shape[0]
    if index.shape != (m,) or index.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"index must be ({m},) int32 or int64, got {tuple(index.shape)} "
                         f"{index.dtype}")
    if index.device != out.device or values.device != out.device:
        raise ValueError("base, index and values must be on one device")
    if out.dtype != torch.float32 or values.dtype != torch.float32:
        raise ValueError(f"the card's scatter-add takes float32, not {values.dtype}")
    if cols > _COLS:
        raise ValueError(f"the card's scatter-add sums at most {_COLS} columns, not {cols}")
    if max(n, m) >= 1 << 30:
        raise ValueError("more rows than the kernel indexes")
    if m == 0 or cols == 0:
        return
    keys = index.to(torch.int32)
    if not sorted_index:
        keys, perm = torch.sort(keys, stable=True)
        values = values[perm]
    keys, values = keys.contiguous(), values.contiguous()
    dev = out.device
    with torch.cuda.device(dev):
        err = _lib().segment_sum_launch(keys.data_ptr(), values.data_ptr(), out.data_ptr(), m, n,
                                        cols, torch._C._cuda_getCurrentRawStream(dev.index))
        capturing = torch.cuda.is_current_stream_capturing()
    if err != 0:
        raise RuntimeError(f"segment_sum launch failed: CUDA error {err}")
    if capturing:  # recorded into a graph: each replay launches it
        _recorded += 1
    else:
        _launches += 1


def _add_into(out: torch.Tensor, index: torch.Tensor, parts: tuple[torch.Tensor, ...],
              sorted_index: bool) -> torch.Tensor:
    """out plus the parts' columns side by side, by index, in place."""
    values = parts[0] if len(parts) == 1 else torch.cat(
        [p.reshape(p.shape[0], -1) for p in parts], dim=1)
    if out.device.type != "cuda":
        return out.index_add_(0, index, values)
    _launch(out.view(out.shape[0], -1), index.reshape(-1),
            values.reshape(values.shape[0], -1), sorted_index)
    return out


def index_add(base: torch.Tensor, index: torch.Tensor, *parts: torch.Tensor,
              sorted_index: bool = False) -> torch.Tensor:
    """`base.index_add(0, index, values)` (a new tensor) with each slot's
    values added in index order (on the card onto a zero, then onto the
    base), bit-stable across runs on the card. `values` is the one part,
    or the columns of several parts ((M,) or (M, ...) each) side by
    side, with `base` (n, C) of as many columns.
    `sorted_index`: the caller's promise that `index` is nondecreasing,
    which spares the card its sort."""
    return _add_into(base.clone(memory_format=torch.contiguous_format), index, parts,
                     sorted_index)


def scatter_sum(n: int, index: torch.Tensor, *parts: torch.Tensor,
                sorted_index: bool = False) -> torch.Tensor:
    """zeros((n, *values.shape[1:])) with values[k] added at index[k];
    with several parts, zeros((n, C)) and their C columns side by side
    (`index_add`)."""
    first = parts[0]
    if len(parts) == 1:
        out = first.new_zeros((n, *first.shape[1:]))
    else:
        out = first.new_zeros((n, sum(math.prod(p.shape[1:]) for p in parts)))
    return _add_into(out, index, parts, sorted_index)


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
