"""Multi-robot state (port of `mr_slam_tpu/parallel/`: `store`). The
mesh and multi-process modules (`mesh`, `multihost`) are not ported."""
