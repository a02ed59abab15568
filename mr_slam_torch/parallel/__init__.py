"""Multi-robot state and the multi-process runtime (port of
`mr_slam_tpu/parallel/`: `store`, `mesh`, `multihost`)."""
