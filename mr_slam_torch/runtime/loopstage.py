"""Batched loop retrieval + geometric verification (port of
`mr_slam_tpu/runtime/loopstage.py`: `retrieve`, `_prep_side`,
`verify_chunk`, `search_pair_loops`).

Retrieval is one batched call per robot pair (every query's descriptor
distance against the whole database, top-k on the device, one small host
transfer). Verification is one batched call per CHUNK of candidates:
merged-submap prep, three voxel-grid builds and coarse-to-fine VGICP
over the whole chunk (the reference vmaps; here B is a tensor dimension,
so one Hopper kernel launch covers the chunk at every GN step, and the
two RING seeds per candidate make it 2 x CHUNK). The reference compiles
the chunk into one program; here it replays as CUDA graphs
(`runtime/verify_graph.py`), with `_verify_chunk_eager` as its oracle.
"""
from __future__ import annotations

import numpy as np
import torch

from ..frontend import keyframes as kf
from ..geometry import se3, so3
from ..geometry.se3 import Pose
from ..loop import ring
from ..ops import pointcloud as pcl
from ..ops import registration, voxel_grid
from . import observability as obs
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
    from . import pipeline as pl

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


def _seed_sinograms(cfg: SlamConfig, same_robot: bool, descs_a: dict | None,
                    descs_b: dict | None):
    """(sinograms of store a, of store b) when the candidates register
    from both SE(2) hypotheses (cross-robot RING / RING++ with
    descriptors), else None."""
    m = cfg.loops.method
    if same_robot or m not in ("ring", "ringpp") or descs_a is None:
        return None
    key = "sino" if m == "ring" else "sino_pp"
    return descs_a[key], descs_b[key]


def _chunk_inputs(store_a: kf.KeyframeStore, store_b: kf.KeyframeStore, ia: torch.Tensor,
                  ib: torch.Tensor, yaw: torch.Tensor, cfg: SlamConfig, same_robot: bool,
                  sinos: tuple | None):
    """Both sides' submaps, side a's coarse / fine / fitness grids and
    the seeds, S-folded into the batch. Returns (side b's cloud, coarse
    grid, fine grid, fitness grid, seed poses mapping b-frame points ->
    a-frame), each with B * S rows, row b * S + s candidate b's seed s."""
    L = cfg.loops
    a_ds, pose_a = _prep_side(store_a, ia, cfg)
    b_ds, pose_b = _prep_side(store_b, ib, cfg)

    grid_leaf = max(0.5, L.verify_leaf)
    table = max(1 << 14, 2 * L.verify_capacity)
    coarse_g = voxel_grid.build(a_ds, 2.0, 1 << 13, min_points=3, regularize="plane")
    fine_g = voxel_grid.build(a_ds, grid_leaf, table, min_points=3, regularize="plane")
    fit_g = voxel_grid.build(a_ds, grid_leaf, table, min_points=1)

    B = ia.shape[0]
    if same_robot:
        seed = se3.between(pose_a, pose_b)
    elif sinos is not None:
        if L.method == "ring":
            sino_a, sino_b = sinos[0][ia], sinos[1][ib]
        else:
            sino_a = torch.mean(sinos[0][ia], dim=1)
            sino_b = torch.mean(sinos[1][ib], dim=1)
        A = sino_a.shape[-2]
        shift = torch.round(yaw * A / np.pi).to(torch.int64)
        yaws, xys, _ = ring.se2_hypotheses(sino_a, sino_b, shift)     # (B, 2), (B, 2, 2)
        fwd = Pose(so3.yaw_rot(yaws), torch.cat([xys, torch.zeros_like(xys[..., :1])], dim=-1))
        seed = se3.inverse(Pose(fwd.R.reshape(-1, 3, 3), fwd.t.reshape(-1, 3)))  # (B * 2,)
    else:
        seed = se3.inverse(Pose(so3.yaw_rot(yaw), torch.zeros_like(pose_a.t)))
    S = seed.t.shape[0] // B
    if S > 1:  # candidate-major: row b * S + s is candidate b's seed s
        b_ds = pcl.PointCloud(b_ds.xyz.repeat_interleave(S, 0), b_ds.mask.repeat_interleave(S, 0))
        coarse_g, fine_g, fit_g = (
            voxel_grid.VoxelGrid(g.packed.repeat_interleave(S, 0), g.leaf)
            for g in (coarse_g, fine_g, fit_g)
        )
    return b_ds, coarse_g, fine_g, fit_g, seed


def _score(b_ds: pcl.PointCloud, fit_g: voxel_grid.VoxelGrid, pose: Pose, B: int,
           cfg: SlamConfig):
    """Fitness of the fine poses (B * S,) and each candidate's best seed.
    Returns (rel Pose (B,) b_kf_frame <- a_kf_frame, fitness (B,))."""
    # fitness is a mean: a 4x subsample scores it at a quarter of the
    # direct27 gather cost; structure points only (z above
    # fitness_z_min), since ground matches ground under any in-plane
    # transform
    sub_xyz = b_ds.xyz[:, ::4]
    sub = pcl.PointCloud(sub_xyz, b_ds.mask[:, ::4] & (sub_xyz[..., 2] > cfg.loops.fitness_z_min))
    fit = registration.fitness(sub, fit_g, pose)
    S = fit.shape[0] // B
    if S > 1:
        fits = fit.reshape(B, S)
        best = torch.argmin(fits, dim=1)       # the first of equal fitnesses
        rows = torch.arange(B, device=best.device) * S + best
        pose = se3.index(pose, rows)
        fit = fits.gather(1, best[:, None])[:, 0]
    # pose maps b-frame points into a-frame; the loop record wants b <- a
    return se3.inverse(pose), fit


def verify_chunk(
    store_a: kf.KeyframeStore,
    store_b: kf.KeyframeStore,
    ia: torch.Tensor,            # (B,)
    ib: torch.Tensor,            # (B,)
    yaw: torch.Tensor,           # (B,) descriptor yaw guess (a -> b points)
    cfg: SlamConfig,
    same_robot: bool,
    descs_a: dict | None = None,
    descs_b: dict | None = None,
):
    """Geometry-check a batch of candidate loops.

    Per candidate: prep both merged submaps, build the coarse / fine /
    permissive-fitness voxel grids of side a, register side b into them
    from the seed (same-robot: the odometry relative pose; otherwise the
    descriptor yaw guess) — coarse (2 m grid, 4 m radius) then fine
    VGICP — and score PCL-style fitness against the permissive grid.
    Cross-robot RING / RING++ candidates with descriptors register from
    both SE(2) hypotheses of `ring.se2_hypotheses` (yaw and yaw - pi, each
    with its translation): the seed axis S = 2 folds into the batch, so
    one VGICP kernel launch covers 2B registrations, and each
    candidate keeps the seed of lower fitness (the first on a tie).

    Runs on `runtime/verify_graph`'s runner for the pair's shapes: CUDA
    graph replays on the card, the same segments eagerly on the CPU;
    equal bit for bit to `_verify_chunk_eager`.

    Returns (rel Pose (B,) mapping b_kf_frame <- a_kf_frame points,
    fitness (B,))."""
    from . import verify_graph

    verify = verify_graph.verifier(store_a, store_b, cfg, same_robot, descs_a, descs_b,
                                   batch=ia.shape[0])
    return verify(ia, ib, yaw)


def _verify_chunk_eager(
    store_a: kf.KeyframeStore,
    store_b: kf.KeyframeStore,
    ia: torch.Tensor,
    ib: torch.Tensor,
    yaw: torch.Tensor,
    cfg: SlamConfig,
    same_robot: bool,
    descs_a: dict | None = None,
    descs_b: dict | None = None,
):
    """`verify_chunk` op by op: the CUDA graphs' oracle. The GN stages
    skip the full-cloud fitness that the reference's compiler drops
    (`_vgicp_direct1_raw`, then `se3.normalize`)."""
    b_ds, coarse_g, fine_g, fit_g, seed = _chunk_inputs(
        store_a, store_b, ia, ib, yaw, cfg, same_robot,
        _seed_sinograms(cfg, same_robot, descs_a, descs_b))
    coarse = registration._vgicp_direct1_raw(b_ds, coarse_g, seed, **COARSE)
    fine = registration._vgicp_direct1_raw(b_ds, fine_g, se3.normalize(coarse.pose), **FINE)
    return _score(b_ds, fit_g, se3.normalize(fine.pose), ia.shape[0], cfg)


def search_pair_loops(
    store_a: kf.KeyframeStore,
    descs_a: dict,
    store_b: kf.KeyframeStore,
    descs_b: dict,
    cfg: SlamConfig,
    same_robot: bool,
    query_idx: np.ndarray | None = None,
    exclude: set | None = None,
) -> list[dict]:
    """All accepted loops between store a's queries and store b: one
    retrieval call, ceil(candidates / CHUNK) verify calls. Returns loop
    dicts {kf_a, kf_b, rel, fitness, desc_dist}. `exclude`: (kf_a, kf_b)
    pairs to skip. Each host wait on the card counts at its site
    (`sync.loop.*`, `runtime/observability.py`)."""
    L = cfg.loops
    metrics = obs.metrics
    metrics.inc("sync.loop.count", 2)
    Ka = int(store_a.count)
    Kb = int(store_b.count)
    if Ka == 0 or Kb == 0:
        return []
    dev = store_a.xyz.device
    if query_idx is None:
        query_idx = np.arange(store_a.capacity)
    metrics.inc("sync.loop.query")
    qi = torch.as_tensor(np.asarray(query_idx, np.int64), device=dev)

    with obs.tracer.span("loop.retrieve"):
        out = retrieve(
            descs_a, qi, store_a.poses.t, descs_b, store_b.poses.t,
            store_b.count, cfg, same_robot,
        )
        metrics.inc("sync.loop.retrieve", len(out))
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
    metrics.inc("loops.candidates", len(cand))
    if not cand:
        return []

    from . import verify_graph

    loops: list[dict] = []
    verify = None
    for s in range(0, len(cand), CHUNK):
        chunk = cand[s : s + CHUNK]
        B = len(chunk)
        pad = CHUNK - B
        metrics.inc("sync.loop.chunk", 3)
        ia_arr = torch.as_tensor([c[0] for c in chunk] + [0] * pad, device=dev)
        ib_arr = torch.as_tensor([c[1] for c in chunk] + [0] * pad, device=dev)
        yw_arr = torch.as_tensor([c[2] for c in chunk] + [0.0] * pad,
                                 dtype=torch.float32, device=dev)
        with obs.tracer.span("loop.verify"):
            if verify is None:  # the pair's stores copied into the runner's buffers once
                verify = verify_graph.verifier(store_a, store_b, cfg, same_robot, descs_a,
                                               descs_b, batch=CHUNK)
            rel, fit = verify(ia_arr, ib_arr, yw_arr)
            metrics.inc("sync.loop.fitness")
            fit = fit.cpu().numpy()
        for k in range(B):
            metrics.inc("loops.verified")
            if float(fit[k]) < L.fitness_thresh:
                loops.append(dict(
                    kf_a=chunk[k][0], kf_b=chunk[k][1], rel=se3.index(rel, k),
                    fitness=float(fit[k]), desc_dist=float(chunk[k][3]),
                ))
            else:
                metrics.inc("loops.fitness_rejected")
    metrics.inc("loops.accepted", len(loops))
    return loops
