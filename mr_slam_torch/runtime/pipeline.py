"""End-to-end multi-robot SLAM pipeline (port of the main path of
`mr_slam_tpu/runtime/pipeline.py`):

  scan2map odometry -> keyframe gating -> ScanContext descriptors ->
  batched loop retrieval + chunked VGICP verification -> per-robot-pair
  PCM -> chordal PGO

and the products of a finished run: the merged elevation map and its
costmap (`build_elevation`), and the merged cloud (`compose_map`).

Host Python orchestrates stage order and the small dynamic loop list;
every heavy stage runs on the device of the input scans. Single process
only (the reference's multi-process loop exchange and sharded PGO are
not ported). Each stage is a tracer span (`runtime/observability.py`);
spans synchronize the device before they close so their wall times are
the stage's own.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..backend import chordal, factor_graph as fg, pcm
from ..frontend import keyframes as kf
from ..frontend import odometry
from ..geometry import se3
from ..geometry.se3 import Pose
from ..loop import scancontext
from ..ops import pointcloud as pcl
from . import observability as obs
from .config import SlamConfig


@dataclass
class RobotResult:
    odom_poses: Pose            # (T,) raw odometry
    store: kf.KeyframeStore     # keyframes
    kf_frame_idx: np.ndarray    # (K,) frame index of each keyframe


@dataclass
class SlamResult:
    robots: list[RobotResult]
    graph: fg.FactorGraph
    opt_poses: Pose             # (N,) optimized node poses
    node_of: np.ndarray         # (R, Kmax) node index per robot keyframe
    loops: list[dict]           # accepted loop records

    def optimized_trajectory(self, robot: int) -> Pose:
        ids = self.node_of[robot]
        ids = torch.as_tensor(ids[ids >= 0], device=self.opt_poses.t.device)
        return Pose(self.opt_poses.R[ids], self.opt_poses.t[ids])


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _odometry_config(cfg: SlamConfig) -> odometry.OdometryConfig:
    o = cfg.odometry
    return odometry.OdometryConfig(
        scan_leaf=o.scan_leaf, map_leaf=o.map_leaf, insert_leaf=o.insert_leaf,
        scan_capacity=o.scan_capacity, insert_capacity=o.insert_capacity,
        table_size=o.table_size, map_radius=o.map_radius, iters=o.iters,
        max_corr_dist=o.max_corr_dist, decay_every=o.decay_every,
        coarse_every=o.coarse_every, anneal=o.anneal,
    )


def run_frontend(
    scans: pcl.PointCloud,
    cfg: SlamConfig,
    origin: Pose | None = None,
) -> RobotResult:
    """Scan-to-map odometry + keyframe extraction for one robot's scan
    sequence (stacked (T, P, 3)/(T, P), body frame). A Python loop over
    frames that reads none of its results on the host: the keyframe
    flags come back once, at the end. (On the card each odometry step
    still syncs inside `so3.project`, whose `torch.linalg.svd` checks
    cuSOLVER's status.) Only the scan2map front-end is ported."""
    if cfg.odometry.frontend != "scan2map":
        raise NotImplementedError(f"front-end {cfg.odometry.frontend!r} is not ported")
    dev = scans.xyz.device
    if origin is None:
        origin = se3.identity(device=dev)
    ocfg = _odometry_config(cfg)
    with obs.tracer.span("frontend"):
        state = odometry.init(ocfg, origin)
        store = kf.init(cfg.keyframes.capacity, cfg.keyframes.points_per_kf, dev)
        T = scans.xyz.shape[0]
        poses, added = [], []
        for i in range(T):
            scan = pcl.PointCloud(scans.xyz[i], scans.mask[i])
            state, _ = odometry.step(state, scan, ocfg)
            store, add = kf.maybe_add(
                store, scan, state.pose, torch.full((), float(i), device=dev),
                dist_thresh=cfg.keyframes.dist_thresh, leaf=cfg.keyframes.leaf,
            )
            poses.append(state.pose)
            added.append(add)
        kf_frames = np.flatnonzero(torch.stack(added).cpu().numpy())
        _sync(dev)
    if int(store.count) >= cfg.keyframes.capacity:
        import warnings

        obs.metrics.inc("keyframes.capacity_saturated")
        warnings.warn(
            f"keyframe store full ({cfg.keyframes.capacity}); further "
            "keyframes are silently dropped — raise KeyframeCfg.capacity"
        )
    return RobotResult(
        odom_poses=se3.stack(poses), store=store,
        kf_frame_idx=np.asarray(kf_frames, np.int64),
    )


# --------------------------------------------------------------------------
# descriptors
# --------------------------------------------------------------------------


def describe_one(cloud: pcl.PointCloud, cfg: SlamConfig) -> dict:
    """Describe keyframe clouds (any leading batch). Only ScanContext,
    the default `LoopCfg.method`, is ported."""
    if cfg.loops.method != "scancontext":
        raise NotImplementedError(f"loop method {cfg.loops.method!r} is not ported")
    d = scancontext.describe(cloud)
    return {"sc": d, "key": scancontext.ring_key(d)}


def compute_descriptors(store: kf.KeyframeStore, cfg: SlamConfig) -> dict:
    """Batch-describe every keyframe slot: a dict of stacked tensors. Runs
    in f32 (the reference's bf16 opt-in for descriptors is not taken)."""
    return describe_one(pcl.PointCloud(store.xyz, store.mask), cfg)


def _descriptor_distances(desc_q: dict, qi, desc_db: dict, cfg: SlamConfig):
    """Distances of query keyframes `qi` (an index or a (Q,) tensor)
    against a database, plus a yaw guess per database entry: ((..., D),
    (..., D))."""
    if cfg.loops.method != "scancontext":
        raise NotImplementedError(f"loop method {cfg.loops.method!r} is not ported")
    d, shift = scancontext.distance(desc_q["sc"][qi], desc_db["sc"])
    n_sectors = desc_db["sc"].shape[-1]
    return d, shift.to(torch.float32) * (2 * np.pi / n_sectors)


# --------------------------------------------------------------------------
# PCM gating
# --------------------------------------------------------------------------


def pcm_gate_inter_loops(inter: list[dict], pose_of, cfg: SlamConfig) -> list[dict]:
    """Gate inter-robot loops with PCM independently per robot pair, as
    the reference does (`distributed_pcm.cpp:53-58`). `pose_of(robot,
    kf)` returns that keyframe's odometry pose."""
    if not cfg.loops.use_pcm or len(inter) <= 1:
        return list(inter)
    groups: dict[tuple[int, int], list[dict]] = {}
    for l in inter:
        key = (min(l["robot_a"], l["robot_b"]), max(l["robot_a"], l["robot_b"]))
        groups.setdefault(key, []).append(l)
    kept: list[dict] = []
    for key, ls in groups.items():
        if len(ls) == 1:
            kept.extend(ls)  # singleton: no pair support, keep (reference)
            continue

        def ends(l, key=key):
            if l["robot_a"] == key[0]:
                return (l["robot_a"], l["kf_a"]), (l["robot_b"], l["kf_b"]), l["rel"]
            return (l["robot_b"], l["kf_b"]), (l["robot_a"], l["kf_a"]), se3.inverse(l["rel"])

        oriented = [ends(l) for l in ls]
        pa = se3.stack([pose_of(*ea) for ea, _, _ in oriented])
        pb = se3.stack([pose_of(*eb) for _, eb, _ in oriented])
        meas = se3.stack([rel for _, _, rel in oriented])
        keep = pcm.filter_loops(
            pa, pb, meas, np.ones(len(ls), bool),
            threshold=cfg.loops.pcm_threshold,
            idx_a=np.asarray([ea[1] for ea, _, _ in oriented]),
            idx_b=np.asarray([eb[1] for _, eb, _ in oriented]),
            odo_drift_t=cfg.loops.pcm_odo_drift_t,
            odo_drift_r=cfg.loops.pcm_odo_drift_r,
            step_len=cfg.keyframes.dist_thresh,
        )
        kept.extend(l for l, k in zip(ls, keep) if k)
    return kept


# --------------------------------------------------------------------------
# full pipeline
# --------------------------------------------------------------------------


def run(
    scans_per_robot: list[pcl.PointCloud],
    cfg: SlamConfig,
    origins: list[Pose] | None = None,
) -> SlamResult:
    """Full multi-robot SLAM: per-robot front-ends, cross/self loop
    search, verification, PCM, chordal PGO, on the device of the scans.
    When `origins` is None, overlay `init_pose`s are used."""
    robots = []
    for r, scans in enumerate(scans_per_robot):
        origin = origins[r] if origins else cfg.init_pose(r)
        if origin is not None:
            origin = origin.to(scans.xyz.device)
        with obs.tracer.span(f"robot{r}"):  # -> span "robot<r>.frontend"
            robots.append(run_frontend(scans, cfg.for_robot(r), origin))
    return run_backend(robots, cfg)


def build_graph(robots: list[RobotResult], cfg: SlamConfig):
    """Pose-graph construction: one node write and one odometry-edge
    write per robot. Returns (graph, node_of (R, Kmax) int64, -1
    padded)."""
    R = len(robots)
    dev = robots[0].store.xyz.device
    graph = fg.init(cfg.pgo.node_capacity, cfg.pgo.edge_capacity, dev)
    counts = [int(rr.store.count) for rr in robots]
    node_of = -np.ones((R, max(max(counts, default=0), 1)), np.int64)
    for r, rr in enumerate(robots):
        K = counts[r]
        if K == 0:
            continue
        poses = Pose(rr.store.poses.R[:K], rr.store.poses.t[:K])
        graph, idx = fg.add_nodes_batch(
            graph, poses, torch.full((K,), r, dtype=torch.int64, device=dev)
        )
        idx_np = idx.cpu().numpy()
        node_of[r, :K] = np.where(idx_np < cfg.pgo.node_capacity, idx_np, -1)
        if (node_of[r, :K] < 0).any():
            import warnings

            warnings.warn(
                f"pose-graph node capacity {cfg.pgo.node_capacity} "
                f"saturated adding robot {r} ({K} keyframes) — "
                "overflow keyframes dropped from the graph"
            )
        if K > 1:
            meas = se3.between(
                Pose(poses.R[:-1], poses.t[:-1]), Pose(poses.R[1:], poses.t[1:])
            )
            graph, _ = fg.add_edges_batch(
                graph, idx[:-1], idx[1:], meas, fg.ODOM, 1.0, 1.0
            )
    return graph, node_of


def run_backend(robots: list[RobotResult], cfg: SlamConfig) -> SlamResult:
    """Back-end stages on finished front-end products: descriptors, graph
    build, loop retrieval + verification, per-pair PCM, chordal PGO.
    Single process (the reference's `pgo_mesh` path is not ported)."""
    from . import loopstage

    R = len(robots)
    dev = robots[0].store.xyz.device
    with obs.tracer.span("backend.prepare"):
        descs = [compute_descriptors(rr.store, cfg) for rr in robots]
        _sync(dev)

    with obs.tracer.span("backend.graph"):
        graph, node_of = build_graph(robots, cfg)

    # Each unordered pair once (ra == rb: self). Inter-robot pairs sweep
    # first so dense same-robot revisits cannot starve them of the
    # max_loops budget.
    pairs = sorted(
        ((ra, rb) for ra in range(R) for rb in range(ra + 1)),
        key=lambda p: p[0] == p[1],
    )
    loops: list[dict] = []
    with obs.tracer.span("backend.associate"):
        for ra, rb in pairs:
            found = loopstage.search_pair_loops(
                robots[ra].store, descs[ra], robots[rb].store, descs[rb],
                cfg, same_robot=(ra == rb),
            )
            for l in found:
                loops.append(dict(
                    robot_a=ra, kf_a=l["kf_a"], robot_b=rb, kf_b=l["kf_b"],
                    rel=l["rel"], fitness=l["fitness"], desc_dist=l["desc_dist"],
                ))
        _sync(dev)
    loops = loops[: cfg.loops.max_loops]
    obs.metrics.inc("backend.loops_found", len(loops))

    inter = [l for l in loops if l["robot_a"] != l["robot_b"]]
    intra = [l for l in loops if l["robot_a"] == l["robot_b"]]
    with obs.tracer.span("backend.pcm"):
        kept_inter = pcm_gate_inter_loops(
            inter, lambda r, k: se3.index(robots[r].store.poses, k), cfg
        )
    obs.metrics.inc("backend.pcm_rejected", len(inter) - len(kept_inter))

    accepted = intra + kept_inter
    if accepted:
        # rel maps a->b POINTS (T_b^-1 T_a); the edge measurement is
        # between(pose_i, pose_j) = T_a^-1 T_b = rel^-1
        ei = torch.as_tensor(
            [int(node_of[l["robot_a"], l["kf_a"]]) for l in accepted], device=dev
        )
        ej = torch.as_tensor(
            [int(node_of[l["robot_b"], l["kf_b"]]) for l in accepted], device=dev
        )
        kinds = torch.as_tensor(
            [fg.INTRA_LOOP if l["robot_a"] == l["robot_b"] else fg.INTER_LOOP
             for l in accepted], device=dev,
        )
        meas = se3.inverse(se3.stack([l["rel"] for l in accepted]))
        graph, _ = fg.add_edges_batch(
            graph, ei, ej, meas, kinds, cfg.loops.w_rot, cfg.loops.w_trans,
        )

    anchors = np.zeros(graph.node_capacity, bool)
    for r in range(R):
        if node_of[r, 0] >= 0:
            anchors[int(node_of[r, 0])] = True
    pgo_cfg = chordal.PGOConfig(
        rot_cg_iters=cfg.pgo.rot_cg_iters, gn_iters=cfg.pgo.gn_iters,
        pose_cg_iters=cfg.pgo.pose_cg_iters, robust_delta=cfg.pgo.robust_delta,
    )
    with obs.tracer.span("backend.solve"):
        opt = chordal.optimize(graph, torch.as_tensor(anchors, device=dev), pgo_cfg)
        _sync(dev)
    return SlamResult(
        robots=robots, graph=graph, opt_poses=opt, node_of=node_of, loops=accepted,
    )


# --------------------------------------------------------------------------
# products of a finished run
# --------------------------------------------------------------------------


def _optimized_keyframes(result: SlamResult):
    """Per robot with keyframes: (every keyframe point moved by its
    optimized pose (K * P, 3), mask (K * P,))."""
    out = []
    for r, rr in enumerate(result.robots):
        K = int(rr.store.count)
        if K == 0:
            continue
        ids = torch.as_tensor(result.node_of[r, :K], device=result.opt_poses.t.device)
        R, t = result.opt_poses.R[ids], result.opt_poses.t[ids]
        pts = torch.einsum("kab,kpb->kpa", R, rr.store.xyz[:K]) + t[:, None, :]
        out.append((pts.reshape(-1, 3), rr.store.mask[:K].reshape(-1)))
    return out


def build_elevation(result: SlamResult, cfg: SlamConfig, center=(0.0, 0.0), size: int = 600):
    """Fuse every optimized keyframe cloud into one global 2.5D elevation
    map, then terrain features and the costmap — the reference's "merged
    elevation map -> costmap" product (`composeGlobalMap` +
    `pointMap_layer`). `size` cells at cfg.elevation.resolution, on the
    device of the result. On a CUDA device the features run the stencil
    kernel. Returns (ElevationMap, TerrainFeatures, Costmap)."""
    from ..mapping import costmap as costmap_mod
    from ..mapping import elevation

    dev = result.opt_poses.t.device
    with obs.tracer.span("backend.compose"):
        emap = elevation.init(size=size, resolution=cfg.elevation.resolution, center=center,
                              device=dev)
        for xyz, mask in _optimized_keyframes(result):
            cloud = pcl.park(pcl.PointCloud(xyz, mask))
            emap = elevation.fuse(emap, cloud, elevation.sensor_variance(cloud.xyz))
        feats = elevation.features(emap)
        cm = costmap_mod.from_elevation(emap, feats, travers_thresh=cfg.elevation.travers_thresh)
        _sync(dev)
    return emap, feats, cm


def compose_map(result: SlamResult, leaf: float = 0.5, capacity: int = 1 << 17) -> pcl.PointCloud:
    """Merged global cloud: every keyframe re-transformed by its optimized
    pose, voxel-merged (`composeGlobalMap`,
    `global_manager.cpp:2090-2236`)."""
    parts = _optimized_keyframes(result)
    merged = pcl.park(pcl.PointCloud(torch.cat([x for x, _ in parts]),
                                     torch.cat([m for _, m in parts])))
    return pcl.voxel_downsample(merged, leaf, capacity)
