"""A frozen copy of the port's eager bodies, the benchmark's plain
reference: SO(3) / SE(3), point clouds, voxel-hash grids, registration
(the VGICP accumulation in plain PyTorch only), scan-to-map odometry,
the LIO filter, keyframes, ScanContext, loop retrieval and
verification, PCM (a plain maximum clique) and the chordal solve.

It imports torch, numpy and the standard library only: no CUDA kernel,
no CUDA graph, nothing of the program. Matmuls run in full float32
(TF32 off), as the program states."""
from . import precision as _precision

_precision.pin_f32()
