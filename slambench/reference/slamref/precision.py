"""Float32 policy for the whole port.

SLAM is precision-sensitive end to end: pose chains, Gauss-Newton normal
equations and CG solves compound reduced-precision rounding into
metre-level trajectory error (`mr_slam_tpu/precision.py` records the
measurement that set the reference's policy). The reference therefore
makes f32 its global matmul default and opts descriptor batches back
into bf16 (`precision.fast`).

The port runs everything in f32, descriptor batches included: a float32
matmul on the card stays in full float32 only while TF32 is off, and a
float32 convolution goes through cuDNN in TF32 unless its own flag is
off, so `pin_f32` turns both off and sets the matmul precision to
"highest". The package calls it once at import, as the reference sets
its default at import.
"""
from __future__ import annotations

import torch


def pin_f32() -> None:
    """Full-f32 matmuls and convolutions (no TF32) on every device."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
