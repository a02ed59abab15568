"""Peaks of the card and the operations and bytes of the program's
kernels, counted from the shapes the session launches them at.

Peaks: one NVIDIA H100 SXM (NVIDIA's data sheet, dense, 700 W): 3.35 TB/s
of HBM bandwidth and 67 TFLOP/s of float32 outside the tensor cores (the
VGICP accumulation runs on the CUDA cores in float32)."""
from __future__ import annotations

PEAK_BYTES_S = 3.35e12
PEAK_F32_FLOP_S = 67e12

# the plain twin's arithmetic for one point of `gn_accumulate` in slot
# mode with a pose and a centre (`vgicp_plain._terms_from_rows` after
# `transform_plain`): transform 18, centre 3, residual 3, distance 5,
# regularised covariance 3, adjugate 18, determinant 5, its floor 3,
# weight 2, weighted inverse 6, u 15, D 27, E 15 + 3, cross terms 9,
# cost 5, and the 29 sums
VGICP_FLOPS_PER_POINT = 169
# bytes each point needs whatever the data: xyz 12, mask 1, slot 4, found 1
# (the voxel row a found point gathers, 64 bytes, depends on the data and
# is not counted, so the bound is a lower one)
VGICP_BYTES_PER_POINT = 18
VGICP_OUT_FLOATS = 44


def vgicp_launch(batch: int, points: int) -> tuple[float, float]:
    """(operations, bytes) of one accumulation launch over `batch` clouds
    of `points` slots: the per-point streams, the pose and centre in, the
    44 sums out."""
    flops = float(batch * points * VGICP_FLOPS_PER_POINT)
    nbytes = float(batch * points * VGICP_BYTES_PER_POINT + batch * (12 + 3) * 4
                   + batch * VGICP_OUT_FLOATS * 4)
    return flops, nbytes


def share(flops: float, nbytes: float, seconds: float) -> tuple[float, str]:
    """(percent of the roofline, the bound that holds) for work done in
    `seconds` of device time."""
    t_compute = flops / PEAK_F32_FLOP_S
    t_memory = nbytes / PEAK_BYTES_S
    bound = "memory" if t_memory >= t_compute else "compute"
    return 100.0 * max(t_compute, t_memory) / seconds, bound
