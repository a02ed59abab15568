"""The session's helpers that the reference needs, copied from the
port's `runtime/pipeline.py`: the front-end configs, the keyframe
descriptor and its distances (ScanContext), and the
per-robot-pair PCM gate of inter-robot loops."""
from __future__ import annotations

import numpy as np
import torch

from ..backend import pcm
from ..frontend import lio, odometry
from ..geometry import se3
from ..geometry.se3 import Pose
from ..loop import scancontext
from ..ops import pointcloud as pcl
from .config import SlamConfig


def _odometry_config(cfg: SlamConfig) -> odometry.OdometryConfig:
    o = cfg.odometry
    return odometry.OdometryConfig(
        scan_leaf=o.scan_leaf, map_leaf=o.map_leaf, insert_leaf=o.insert_leaf,
        scan_capacity=o.scan_capacity, insert_capacity=o.insert_capacity,
        table_size=o.table_size, map_radius=o.map_radius, iters=o.iters,
        max_corr_dist=o.max_corr_dist, decay_every=o.decay_every,
        coarse_every=o.coarse_every, anneal=o.anneal,
    )


def _lio_config(cfg: SlamConfig) -> lio.LioConfig:
    o = cfg.odometry
    return lio.LioConfig(
        map_leaf=o.map_leaf, insert_leaf=o.insert_leaf, scan_leaf=o.scan_leaf,
        scan_capacity=o.scan_capacity, insert_capacity=o.insert_capacity,
        table_size=o.table_size, map_radius=o.map_radius,
        estimate_extrinsics=o.estimate_extrinsics,
    )


def _lio_extrinsic(cfg: SlamConfig, device=None) -> Pose | None:
    """OdometryCfg.extrinsic (a 4x4 tuple) as a Pose on `device`, or None."""
    if cfg.odometry.extrinsic is None:
        return None
    T = torch.tensor(cfg.odometry.extrinsic, dtype=torch.float32).reshape(4, 4)
    return Pose(T[:3, :3].contiguous().to(device), T[:3, 3].contiguous().to(device))


def describe_one(cloud: pcl.PointCloud, cfg: SlamConfig) -> dict:
    """Describe keyframe clouds (any leading batch) for cfg.loops.method."""
    method = cfg.loops.method
    if method == "scancontext":
        d = scancontext.describe(cloud)
        return {"sc": d, "key": scancontext.ring_key(d)}
    raise ValueError(f"the reference does not describe loop method {method}")


def _descriptor_distances(desc_q: dict, qi, desc_db: dict, cfg: SlamConfig):
    """Distances of query keyframes `qi` against a database, plus a yaw
    guess per database entry: ((..., D), (..., D))."""
    m = cfg.loops.method
    if m == "scancontext":
        d, shift = scancontext.distance(desc_q["sc"][qi], desc_db["sc"])
        n_sectors = desc_db["sc"].shape[-1]
        return d, shift.to(torch.float32) * (2 * np.pi / n_sectors)
    raise ValueError(f"the reference does not compare loop method {m}")


def pcm_groups(inter: list[dict], pose_of, cfg: SlamConfig):
    """The inter-robot loops grouped per robot pair, as PCM gates them:
    yields (loops, consistency adjacency (L, L) bool or None for a
    singleton). `pose_of(robot, kf)` returns that keyframe's odometry
    pose."""
    groups: dict[tuple[int, int], list[dict]] = {}
    for l in inter:
        key = (min(l["robot_a"], l["robot_b"]), max(l["robot_a"], l["robot_b"]))
        groups.setdefault(key, []).append(l)
    for key, ls in groups.items():
        if len(ls) == 1:
            yield ls, None
            continue

        def ends(l, key=key):
            if l["robot_a"] == key[0]:
                return (l["robot_a"], l["kf_a"]), (l["robot_b"], l["kf_b"]), l["rel"]
            return (l["robot_b"], l["kf_b"]), (l["robot_a"], l["kf_a"]), se3.inverse(l["rel"])

        oriented = [ends(l) for l in ls]
        pa = se3.stack([pose_of(*ea) for ea, _, _ in oriented])
        pb = se3.stack([pose_of(*eb) for _, eb, _ in oriented])
        meas = se3.stack([rel for _, _, rel in oriented])
        dev = pa.t.device
        M = pcm.consistency_matrix(
            pa, pb, meas, torch.ones(len(ls), dtype=torch.bool, device=dev),
            idx_a=torch.as_tensor(np.asarray([ea[1] for ea, _, _ in oriented]), device=dev),
            idx_b=torch.as_tensor(np.asarray([eb[1] for _, eb, _ in oriented]), device=dev),
            odo_drift_t=cfg.loops.pcm_odo_drift_t, odo_drift_r=cfg.loops.pcm_odo_drift_r,
            step_len=cfg.keyframes.dist_thresh,
        ).cpu().numpy()
        th = cfg.loops.pcm_threshold
        yield ls, (M < th) & (M.T < th)
