"""Map/graph saving with the reference system's artifact layout (port of
`mr_slam_tpu/runtime/persistence.py`: `save_artifacts`,
`map_to_odom_transforms`, `save_session`, `load_session`).

Mirrors `mapSaving` (`global_manager.cpp:123-272`): the pose graph as
g2o before and after optimization, one directory per keyframe with a
gtsam-style `data` file (stamp + 4x4 estimate) and `cloud.pcd`, and the
merged map PCD — the same file tree as the reference package writes.
"""
from __future__ import annotations

import os

import numpy as np

from ..eval import g2o as g2o_io
from ..eval import pcd as pcd_io
from ..geometry import se3
from . import checkpoint, pipeline as pipeline_mod


def save_artifacts(out_dir: str, result: "pipeline_mod.SlamResult") -> None:
    """Write the reference-layout artifact tree:

    out_dir/
      fullGraph.g2o            (pre-optimization, odometry poses)
      fullGraph_optimized.g2o  (post-optimization)
      map.pcd                  (merged optimized cloud)
      keyframes/<robot>_<k>/data, cloud.pcd
    """
    os.makedirs(out_dir, exist_ok=True)
    g2o_io.export_g2o(os.path.join(out_dir, "fullGraph.g2o"), result.graph)
    g2o_io.export_g2o(os.path.join(out_dir, "fullGraph_optimized.g2o"),
                      result.graph._replace(poses=result.opt_poses))
    pcd_io.cloud_to_pcd(os.path.join(out_dir, "map.pcd"), pipeline_mod.compose_map(result))

    opt_R = result.opt_poses.R.cpu().numpy()
    opt_t = result.opt_poses.t.cpu().numpy()
    kf_root = os.path.join(out_dir, "keyframes")
    os.makedirs(kf_root, exist_ok=True)
    for r, rr in enumerate(result.robots):
        K = int(rr.store.count)
        stamps = rr.store.stamps[:K].cpu().numpy()
        xyz = rr.store.xyz[:K].cpu().numpy()
        mask = rr.store.mask[:K].cpu().numpy()
        for k in range(K):
            node = int(result.node_of[r, k])
            d = os.path.join(kf_root, f"{r}_{k}")
            os.makedirs(d, exist_ok=True)
            est = np.eye(4, dtype=np.float32)
            est[:3, :3] = opt_R[node]
            est[:3, 3] = opt_t[node]
            with open(os.path.join(d, "data"), "w") as f:
                f.write(f"stamp {float(stamps[k]):.9f}\n")
                f.write("estimate\n")
                for row in est:
                    f.write(" ".join(f"{v:.9f}" for v in row) + "\n")
            pcd_io.write_pcd(os.path.join(d, "cloud.pcd"), xyz[k][mask[k]])


def map_to_odom_transforms(result: "pipeline_mod.SlamResult") -> list:
    """Per-robot map->odom correction — the `/map -> robot_N/odom` TF
    (`publishTF`): T_map_odom = T_opt(latest kf) * T_odom(latest kf)^-1."""
    out = []
    for r, rr in enumerate(result.robots):
        K = int(rr.store.count)
        if K == 0:
            out.append(se3.identity(device=result.opt_poses.t.device))
            continue
        opt = se3.index(result.opt_poses, int(result.node_of[r, K - 1]))
        out.append(se3.compose(opt, se3.inverse(se3.index(rr.store.poses, K - 1))))
    return out


def save_session(path: str, state) -> None:
    """Checkpoint arbitrary pipeline state (a tree of tensors)."""
    checkpoint.save(path, state)


def load_session(path: str, template):
    return checkpoint.restore(path, template)
