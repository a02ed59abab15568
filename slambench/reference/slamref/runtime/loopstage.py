"""Batched loop retrieval + geometric verification (port of
`mr_slam_tpu/runtime/loopstage.py`: `retrieve`, `_prep_side`,
`verify_chunk`, `search_pair_loops`).

Retrieval is one batched call per robot pair (every query's descriptor
distance against the whole database, top-k on the device, one small host
transfer). Verification is one batched call per CHUNK of candidates:
merged-submap prep, three voxel-grid builds and coarse-to-fine VGICP
over the whole chunk (the reference vmaps; here B is a tensor dimension,
so one Hopper kernel launch covers the chunk at every GN step). In this
frozen copy every
chunk runs `_verify_chunk_eager` op by op, its VGICP accumulation the
plain twin (`ops/vgicp_plain.py`).
"""
from __future__ import annotations

import numpy as np
import torch

from ..frontend import keyframes as kf
from ..geometry import se3, so3
from ..geometry.se3 import Pose
from ..ops import pointcloud as pcl
from ..ops import registration, voxel_grid
from .config import SlamConfig

# verification candidates are padded to a multiple of CHUNK
CHUNK = 8


def retrieve(
    descs_q: dict,
    qi: torch.Tensor,          # (Q,) query keyframe indices into store a
    q_pose_t: torch.Tensor,    # (Ka_cap, 3) query-store keyframe positions
    descs_db: dict,
    db_pose_t: torch.Tensor,   # (Kb_cap, 3) database keyframe positions
    db_count: torch.Tensor,    # () valid database size
    cfg: SlamConfig,
    same_robot: bool,
):
    """Batched candidate retrieval for Q queries against one database.

    Returns (d_top, i_top, yaw_top, od_top, oi_top, oyaw_top), each
    (Q, C): descriptor top-k and (same-robot only; +inf otherwise)
    odometry-radius top-k, masked-out entries +inf. `torch.topk` does
    not promise the reference's lower-index tie order; ties occur only
    among +inf entries, which the caller drops."""
    from . import helpers as pl

    L = cfg.loops
    C = L.candidates
    d, yaw = pl._descriptor_distances(descs_q, qi, descs_db, cfg)   # (Q, Kb_cap)
    dev = d.device
    Kb = d.shape[1]
    col = torch.arange(Kb, device=dev)
    invalid = col[None, :] >= db_count
    if same_robot:
        # temporal band + strict lower triangle: each unordered
        # same-robot pair is considered once, from its LATER keyframe
        sep = torch.abs(col[None, :] - qi[:, None]) <= L.min_separation
        invalid = invalid | sep | (col[None, :] >= qi[:, None])
    d = torch.where(invalid, torch.inf, d)
    neg_top, i_top = torch.topk(-d, C, dim=1)
    d_top = -neg_top
    yaw_top = torch.gather(yaw, 1, i_top)
    if same_robot and L.odom_radius > 0.0:
        pd = torch.linalg.norm(q_pose_t[qi][:, None, :] - db_pose_t[None, :, :], dim=-1)
        pd = torch.where(invalid | (pd >= L.odom_radius), torch.inf, pd)
        neg_od, oi_top = torch.topk(-pd, C, dim=1)
        od_top = -neg_od
        oyaw_top = torch.gather(yaw, 1, oi_top)
    else:
        Q = qi.shape[0]
        od_top = torch.full((Q, C), torch.inf, device=dev)
        oi_top = torch.zeros((Q, C), dtype=torch.int64, device=dev)
        oyaw_top = torch.zeros((Q, C), device=dev)
    return d_top, i_top, yaw_top, od_top, oi_top, oyaw_top


def _prep_side(store: kf.KeyframeStore, idx: torch.Tensor, cfg: SlamConfig):
    """Merged +-window neighborhoods around keyframes `idx` (B,), each in
    its keyframe's body frame, +-crop_xy-cropped and voxelized —
    `ICPCheck`'s submap prep."""
    L = cfg.loops
    merged = kf.merged_neighborhood(store, idx, L.verify_window)
    pose = se3.index(store.poses, idx)
    local = pcl.transform(merged, se3.inverse(pose))
    c = L.crop_xy
    local = pcl.crop_box(local, (-c, -c, -np.inf), (c, c, np.inf))
    return pcl.voxel_downsample(local, L.verify_leaf, L.verify_capacity), pose


# the two VGICP stages of a verify chunk (`registration._vgicp_direct1_raw`)
COARSE = dict(iters=15, max_corr_dist=4.0)
FINE = dict(iters=15, max_corr_dist=1.0)


def _chunk_inputs(store_a: kf.KeyframeStore, store_b: kf.KeyframeStore, ia: torch.Tensor,
                  ib: torch.Tensor, yaw: torch.Tensor, cfg: SlamConfig, same_robot: bool):
    """Both sides' submaps, side a's coarse / fine / fitness grids and
    the seeds. Returns (side b's cloud, coarse grid, fine grid, fitness
    grid, seed poses mapping b-frame points -> a-frame), one row a
    candidate."""
    L = cfg.loops
    a_ds, pose_a = _prep_side(store_a, ia, cfg)
    b_ds, pose_b = _prep_side(store_b, ib, cfg)

    grid_leaf = max(0.5, L.verify_leaf)
    table = max(1 << 14, 2 * L.verify_capacity)
    coarse_g = voxel_grid.build(a_ds, 2.0, 1 << 13, min_points=3, regularize="plane")
    fine_g = voxel_grid.build(a_ds, grid_leaf, table, min_points=3, regularize="plane")
    fit_g = voxel_grid.build(a_ds, grid_leaf, table, min_points=1)

    if same_robot:
        seed = se3.between(pose_a, pose_b)
    else:
        seed = se3.inverse(Pose(so3.yaw_rot(yaw), torch.zeros_like(pose_a.t)))
    return b_ds, coarse_g, fine_g, fit_g, seed


def _score(b_ds: pcl.PointCloud, fit_g: voxel_grid.VoxelGrid, pose: Pose, cfg: SlamConfig):
    """Fitness of the fine poses (B,). Returns (rel Pose (B,) b_kf_frame
    <- a_kf_frame, fitness (B,))."""
    # fitness is a mean: a 4x subsample scores it at a quarter of the
    # direct27 gather cost; structure points only (z above
    # fitness_z_min), since ground matches ground under any in-plane
    # transform
    sub_xyz = b_ds.xyz[:, ::4]
    sub = pcl.PointCloud(sub_xyz, b_ds.mask[:, ::4] & (sub_xyz[..., 2] > cfg.loops.fitness_z_min))
    fit = registration.fitness(sub, fit_g, pose)
    # pose maps b-frame points into a-frame; the loop record wants b <- a
    return se3.inverse(pose), fit


def _verify_chunk_eager(
    store_a: kf.KeyframeStore,
    store_b: kf.KeyframeStore,
    ia: torch.Tensor,
    ib: torch.Tensor,
    yaw: torch.Tensor,
    cfg: SlamConfig,
    same_robot: bool,
):
    """`verify_chunk` op by op: the CUDA graphs' oracle. The GN stages
    skip the full-cloud fitness that the reference's compiler drops
    (`_vgicp_direct1_raw`, then `se3.normalize`)."""
    b_ds, coarse_g, fine_g, fit_g, seed = _chunk_inputs(store_a, store_b, ia, ib, yaw, cfg,
                                                         same_robot)
    coarse = registration._vgicp_direct1_raw(b_ds, coarse_g, seed, **COARSE)
    fine = registration._vgicp_direct1_raw(b_ds, fine_g, se3.normalize(coarse.pose), **FINE)
    return _score(b_ds, fit_g, se3.normalize(fine.pose), cfg)


def search_pair_loops(
    store_a: kf.KeyframeStore,
    descs_a: dict,
    store_b: kf.KeyframeStore,
    descs_b: dict,
    cfg: SlamConfig,
    same_robot: bool,
    query_idx: np.ndarray | None = None,
    exclude: set | None = None,
    scores: dict | None = None,
) -> list[dict]:
    """All accepted loops between store a's queries and store b: one
    retrieval call, ceil(candidates / CHUNK) verify calls. Returns loop
    dicts {kf_a, kf_b, rel, fitness, desc_dist}. `exclude`: (kf_a, kf_b)
    pairs to skip. `scores`, where given, gets the fitness of every
    candidate verified, accepted or not, under (kf_a, kf_b). Each chunk
    is verified by `_verify_chunk_eager`."""
    L = cfg.loops
    Ka = int(store_a.count)
    Kb = int(store_b.count)
    if Ka == 0 or Kb == 0:
        return []
    dev = store_a.xyz.device
    if query_idx is None:
        query_idx = np.arange(store_a.capacity)
    qi = torch.as_tensor(np.asarray(query_idx, np.int64), device=dev)

    out = retrieve(
        descs_a, qi, store_a.poses.t, descs_b, store_b.poses.t,
        store_b.count, cfg, same_robot,
    )
    d_top, i_top, yaw_top, od_top, oi_top, oyaw_top = (x.cpu().numpy() for x in out)

    cand: list[tuple[int, int, float, float]] = []  # (ia, ib, yaw, desc_d)
    seen: set[tuple[int, int]] = set(exclude) if exclude else set()
    for q in range(len(query_idx)):
        ia = int(query_idx[q])
        if ia < 0 or ia >= Ka:
            continue
        for c in range(d_top.shape[1]):
            dd = float(d_top[q, c])
            if np.isfinite(dd) and dd <= L.dist_thresh:
                key = (ia, int(i_top[q, c]))
                if key not in seen:
                    seen.add(key)
                    cand.append((ia, int(i_top[q, c]), float(yaw_top[q, c]), dd))
        for c in range(od_top.shape[1]):
            if np.isfinite(od_top[q, c]):
                key = (ia, int(oi_top[q, c]))
                if key not in seen:
                    seen.add(key)
                    cand.append((ia, int(oi_top[q, c]), float(oyaw_top[q, c]), np.inf))
    if not cand:
        return []

    loops: list[dict] = []
    for s in range(0, len(cand), CHUNK):
        chunk = cand[s : s + CHUNK]
        B = len(chunk)
        pad = CHUNK - B
        ia_arr = torch.as_tensor([c[0] for c in chunk] + [0] * pad, device=dev)
        ib_arr = torch.as_tensor([c[1] for c in chunk] + [0] * pad, device=dev)
        yw_arr = torch.as_tensor([c[2] for c in chunk] + [0.0] * pad,
                                 dtype=torch.float32, device=dev)
        rel, fit = _verify_chunk_eager(store_a, store_b, ia_arr, ib_arr, yw_arr, cfg, same_robot)
        fit = fit.cpu().numpy()
        for k in range(B):
            if scores is not None:
                scores[(chunk[k][0], chunk[k][1])] = float(fit[k])
            if float(fit[k]) < L.fitness_thresh:
                loops.append(dict(
                    kf_a=chunk[k][0], kf_b=chunk[k][1], rel=se3.index(rel, k),
                    fitness=float(fit[k]), desc_dist=float(chunk[k][3]),
                ))
    return loops
