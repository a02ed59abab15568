"""Small constant tensors kept on each device.

`torch.tensor(host_values, device="cuda")` copies from pageable host
memory, and that copy waits for the stream to drain: inside a loop of
small kernels it turns every call into a host-device sync. Constants the
hot paths need (offset tables, bounds, unit vectors) are made once per
device and shared; callers must not write into them.
"""
from __future__ import annotations

import functools

import torch


@functools.lru_cache(maxsize=None)
def const(values: tuple, device: torch.device, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Read-only tensor of `values` (a nested tuple) on `device`."""
    return torch.tensor(values, dtype=dtype, device=device)
