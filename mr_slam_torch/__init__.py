"""mr_slam_torch — the multi-robot LiDAR SLAM engine on PyTorch and CUDA.

A port of `mr_slam_tpu` (JAX on a TPU) to PyTorch on an NVIDIA Hopper
card. The JAX package is the reference: every module here has a
counterpart of the same name there, keeps its public layouts (packed
(H, 16) voxel rows, (..., 3, 3) rotations, (B, N, 3) / (B, N) masked
clouds) and is held to it by the `tests/test_torch_*.py` parity tests.

The port imports torch, numpy and the standard library, never jax.

Layout (the reference's, slice by slice):
  geometry/  SO(3)/SE(3) batched Lie-group math
  ops/       point clouds, voxel-hash grids, registration, and the
             hand-written Hopper kernel (`ops/hopper_vgicp.py`,
             `csrc/vgicp_accum.cu`)
  frontend/  scan-to-map odometry, the FAST-LIO-style IEKF, A-LOAM
             feature odometry, sensor preprocessing, keyframe gating
  loop/      place descriptors (ScanContext, RING / RING++, DiSCO and
             DiscoNet with its training, M2DP, FastHistogram)
  backend/   factor graph, PCM gating, chordal PGO
  runtime/   config, loop stage, end-to-end pipeline, tracing
  eval/      ATE, RPE, recall@N and the recall harness, the pose-graph
             generator, the independent reference solver, plots
  datasets/  synthetic multi-robot worlds (a numpy raycaster per frame,
             a batched one on the device)
  examples/  the end-to-end demo (`python -m mr_slam_torch.examples.demo_synthetic`)
"""
from . import precision as _precision

__version__ = "0.1.0"

# The reference sets f32 as its global matmul default at import
# (`mr_slam_tpu/__init__.py`); the port pins f32 the same way.
_precision.pin_f32()
