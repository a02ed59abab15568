"""End-to-end multi-robot SLAM pipeline (port of the main path of
`mr_slam_tpu/runtime/pipeline.py`):

  odometry (scan2map, or the FAST-LIO-style IEKF with IMU packets;
  either with per-point motion compensation) -> keyframe gating ->
  place descriptors (every `LoopCfg.method`: ScanContext, RING, RING++,
  DiSCO, M2DP, FastHistogram) ->
  batched loop retrieval + chunked VGICP verification -> per-robot-pair
  PCM -> chordal PGO

and the products of a finished run: the merged elevation map and its
costmap (`build_elevation`), and the merged cloud (`compose_map`).

Host Python orchestrates stage order and the small dynamic loop list;
every heavy stage runs on the device `run` is given (the card unless the
caller passes `device="cpu"`; a missing card raises). `run_backend`
also runs as one rank of several (`parallel/multihost.run_multihost`):
robot pairs shared out, accepted loops all-gathered, the pose graph
solved edge-sharded. Each stage is a tracer span (`runtime/observability.py`);
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
from ..loop import bev, disco, fast_histogram, m2dp, ring, scancontext
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


def _lio_config(cfg: SlamConfig):
    from ..frontend import lio

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
    return Pose(T[:3, :3].contiguous(), T[:3, 3].contiguous()).to(device)


def _frontend_lio(scans: pcl.PointCloud, imu: tuple, cfg: SlamConfig, origin: Pose,
                  times: torch.Tensor | None):
    """LIO odometry and keyframe gating as a frame loop: (poses (T,),
    store, added (T,) bool tensor). Frame 0 runs no filter step and gates
    the origin keyframe; frame i >= 1 propagates IMU packet i - 1. Without
    `times` every point is stamped at the sweep end (instantaneous
    synthetic scans)."""
    from ..frontend import lio

    gyro, acc, dts = imu
    dev = scans.xyz.device
    lcfg = _lio_config(cfg)
    state = lio.init(lcfg, origin, extrinsic=_lio_extrinsic(cfg, dev))
    store = kf.init(cfg.keyframes.capacity, cfg.keyframes.points_per_kf, dev)
    gate = dict(dist_thresh=cfg.keyframes.dist_thresh, leaf=cfg.keyframes.leaf)
    store, add0 = kf.maybe_add(store, pcl.PointCloud(scans.xyz[0], scans.mask[0]), origin,
                               torch.zeros((), device=dev), **gate)
    end = torch.sum(dts[0]) * 0.999
    T = scans.xyz.shape[0]
    poses, added = [origin], [add0]
    for i in range(1, T):
        scan = pcl.PointCloud(scans.xyz[i], scans.mask[i])
        pt_time = end.expand(scan.xyz.shape[0]) if times is None \
            else torch.minimum(times[i], end)
        state, _ = lio.step(state, scan, pt_time,
                            lio.ImuSample(gyro=gyro[i - 1], acc=acc[i - 1], dt=dts[i - 1]), lcfg)
        store, add = kf.maybe_add(store, scan, state.pose(),
                                  torch.full((), float(i), device=dev), **gate)
        poses.append(state.pose())
        added.append(add)
    return se3.stack(poses), store, torch.stack(added)


def _frontend_scan2map(scans: pcl.PointCloud, cfg: SlamConfig, origin: Pose,
                       times: torch.Tensor | None):
    """Scan-to-map odometry and keyframe gating as a frame loop, with
    constant-velocity motion compensation when `times` is given."""
    dev = scans.xyz.device
    ocfg = _odometry_config(cfg)
    state = odometry.init(ocfg, origin)
    store = kf.init(cfg.keyframes.capacity, cfg.keyframes.points_per_kf, dev)
    poses, added = [], []
    for i in range(scans.xyz.shape[0]):
        scan = pcl.PointCloud(scans.xyz[i], scans.mask[i])
        state, _ = odometry.step(state, scan, ocfg, t_rel=None if times is None else times[i])
        store, add = kf.maybe_add(
            store, scan, state.pose, torch.full((), float(i), device=dev),
            dist_thresh=cfg.keyframes.dist_thresh, leaf=cfg.keyframes.leaf,
        )
        poses.append(state.pose)
        added.append(add)
    return se3.stack(poses), store, torch.stack(added)


def run_frontend(
    scans: pcl.PointCloud,
    cfg: SlamConfig,
    origin: Pose | None = None,
    imu: tuple | None = None,
    times: torch.Tensor | None = None,
) -> RobotResult:
    """Odometry + keyframe extraction for one robot's scan sequence
    (stacked (T, P, 3)/(T, P), body frame), on the scans' device.

    `imu`: (gyro (T-1, S, 3), acc (T-1, S, 3), dt (T-1, S)) packets; with
    `cfg.odometry.frontend == "lio"` they drive the FAST-LIO-style
    front-end, otherwise (or without them) scan2map runs. `times`:
    optional (T, P) sweep-relative point times, motion compensation in
    both front-ends (IMU-interpolated in LIO, constant-velocity in
    scan2map).

    A Python loop over frames that reads none of its results on the
    host: the keyframe flags come back once, at the end. (A scan2map
    step still syncs inside `so3.project`, whose `torch.linalg.svd`
    checks cuSOLVER's status; a LIO step does not sync.)"""
    dev = scans.xyz.device
    if origin is None:
        origin = se3.identity(device=dev)
    with obs.tracer.span("frontend"):
        if cfg.odometry.frontend == "lio" and imu is not None:
            poses, store, added = _frontend_lio(scans, imu, cfg, origin, times)
        else:
            poses, store, added = _frontend_scan2map(scans, cfg, origin, times)
        kf_frames = np.flatnonzero(added.cpu().numpy())
        _sync(dev)
    if int(store.count) >= cfg.keyframes.capacity:
        import warnings

        obs.metrics.inc("keyframes.capacity_saturated")
        warnings.warn(
            f"keyframe store full ({cfg.keyframes.capacity}); further "
            "keyframes are silently dropped — raise KeyframeCfg.capacity"
        )
    return RobotResult(odom_poses=poses, store=store, kf_frame_idx=np.asarray(kf_frames, np.int64))


# --------------------------------------------------------------------------
# descriptors
# --------------------------------------------------------------------------


def describe_one(cloud: pcl.PointCloud, cfg: SlamConfig) -> dict:
    """Describe keyframe clouds (any leading batch) for cfg.loops.method:
    a dict of tensors (the same keys as the reference's)."""
    method = cfg.loops.method
    if method == "scancontext":
        d = scancontext.describe(cloud)
        return {"sc": d, "key": scancontext.ring_key(d)}
    if method == "ring":
        norm = bev.normalize_cloud(cloud, z_min=cfg.loops.bev_z_min)
        d = ring.describe(bev.cartesian_occupancy(norm)[..., 0, :, :])
        return {"sino": d.sinogram, "tiring": d.tiring}
    if method == "disco":
        g = bev.polar_occupancy(cloud, 40, 120, z_bins=20, z_min=cfg.loops.bev_z_min)
        d = disco.describe(g)
        return {"sig": d.signature, "spec": d.spectrum}
    if method == "ringpp":
        d = ring.describe_ringpp(bev.eigen_feature_bev(cloud, 120, 120, k=8))
        return {"sino_pp": d.sinograms, "tiring_pp": d.tirings}
    if method == "m2dp":
        return {"m2dp": m2dp.describe(cloud)}
    if method == "fasthist":
        return {"hist": fast_histogram.describe(cloud)}
    raise ValueError(f"unknown loop method {method}")


def compute_descriptors(store: kf.KeyframeStore, cfg: SlamConfig) -> dict:
    """Batch-describe every keyframe slot: a dict of stacked tensors. Runs
    in f32 (the reference's bf16 opt-in for descriptors is not taken);
    the bulky steps (Radon, k-NN) chunk over keyframes inside."""
    return describe_one(pcl.PointCloud(store.xyz, store.mask), cfg)


# DiSCO's relative yaw inverse-transforms one (40, 120) complex surface
# per (query, entry) pair; queries are taken this many at a time (16 x
# 256 entries x 4800 bins x 8 B = 157 MiB)
YAW_QUERY_CHUNK = 16


def _descriptor_distances(desc_q: dict, qi, desc_db: dict, cfg: SlamConfig):
    """Distances of query keyframes `qi` (an index or a (Q,) tensor)
    against a database, plus a yaw guess per database entry: ((..., D),
    (..., D))."""
    m = cfg.loops.method
    if m == "scancontext":
        d, shift = scancontext.distance(desc_q["sc"][qi], desc_db["sc"])
        n_sectors = desc_db["sc"].shape[-1]
        return d, shift.to(torch.float32) * (2 * np.pi / n_sectors)
    if m == "ring":
        d, shift = ring.correlate(desc_q["tiring"][qi], desc_db["tiring"])
        return d, ring.shift_to_yaw(shift, desc_db["tiring"].shape[-2])
    if m == "ringpp":
        d, shift = ring.correlate_multichannel(desc_q["tiring_pp"][qi], desc_db["tiring_pp"])
        return d, ring.shift_to_yaw(shift, desc_db["tiring_pp"].shape[-2])
    if m == "disco":
        sig = desc_db["sig"]
        d = disco.distance(desc_q["sig"][qi], sig,
                           torch.ones(sig.shape[0], dtype=torch.bool, device=sig.device))
        q_spec = desc_q["spec"][qi]
        flat = q_spec.reshape(-1, *q_spec.shape[-2:])
        yaws = torch.cat([
            disco.relative_yaw(flat[s:s + YAW_QUERY_CHUNK, None], desc_db["spec"])[0]
            for s in range(0, flat.shape[0], YAW_QUERY_CHUNK)
        ])
        return d, yaws.reshape(d.shape)
    if m == "m2dp":
        diff = desc_db["m2dp"] - desc_q["m2dp"][qi][..., None, :]
        d = torch.sqrt(torch.sum(diff * diff, dim=-1))
        return d, torch.zeros_like(d)
    if m == "fasthist":
        d = fast_histogram.distance(desc_q["hist"][qi], desc_db["hist"])
        return d, torch.zeros_like(d)
    raise ValueError(m)


# --------------------------------------------------------------------------
# single-candidate verification and odometry-space candidates
# --------------------------------------------------------------------------


def _verify_loop(
    store_a: kf.KeyframeStore,
    ia: int,
    store_b: kf.KeyframeStore,
    ib: int,
    yaw_guess: float,
    cfg: SlamConfig,
    same_robot: bool = False,
    descs_a: dict | None = None,
    descs_b: dict | None = None,
):
    """Geometry check (`ICPCheck`) of one candidate loop: a batch of one
    through `loopstage.verify_chunk`, so the chunked production path is
    the one source of truth. Returns (accept, rel_pose (b_kf_frame <-
    a_kf_frame), fitness)."""
    from . import loopstage

    dev = store_a.xyz.device
    rel, fit = loopstage.verify_chunk(
        store_a, store_b,
        torch.tensor([ia], device=dev), torch.tensor([ib], device=dev),
        torch.tensor([yaw_guess], dtype=torch.float32, device=dev), cfg, same_robot,
        descs_a=descs_a, descs_b=descs_b,
    )
    f = float(fit[0])
    return f < cfg.loops.fitness_thresh, se3.index(rel, 0), f


def odom_space_candidates(store: kf.KeyframeStore, qi: int, cfg: SlamConfig) -> list[int]:
    """Same-robot loop candidates by RADIUS SEARCH over the key-pose
    cloud (`detectLoopClosure`'s radius search): past keyframe indices
    within `cfg.loops.odom_radius` metres of keyframe `qi`, outside the
    temporal window, nearest first, at most `cfg.loops.candidates`."""
    L = cfg.loops
    if L.odom_radius <= 0.0:
        return []
    K = int(store.count)
    if K == 0:
        return []
    t = store.poses.t[:K].cpu().numpy()
    d = np.linalg.norm(t - t[qi], axis=-1)
    ok = (d < L.odom_radius) & (np.abs(np.arange(K) - qi) > L.min_separation)
    idx = np.flatnonzero(ok)
    return [int(i) for i in idx[np.argsort(d[idx])][: L.candidates]]


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
    imus: list[tuple] | None = None,
    times_per_robot: list | None = None,
    *,
    device="cuda",
) -> SlamResult:
    """Full multi-robot SLAM: per-robot front-ends, cross/self loop
    search, verification, PCM, chordal PGO, on `device` (the card by
    default; without CUDA that raises, pass device="cpu"). Scans, IMU
    packets, point times and origins are moved there. When `origins` is
    None, overlay `init_pose`s are used. `imus`: per-robot IMU packets
    for robots whose front-end is LIO; `times_per_robot`: per-robot
    (T, P) point times for motion compensation (`run_frontend`)."""
    from .online import resolve_device

    dev = resolve_device(device)
    robots = []
    for r, scans in enumerate(scans_per_robot):
        scans = pcl.PointCloud(scans.xyz.to(dev), scans.mask.to(dev))
        origin = origins[r] if origins else cfg.init_pose(r)
        if origin is not None:
            origin = origin.to(dev)
        imu = tuple(x.to(dev) for x in imus[r]) if imus else None
        times = times_per_robot[r].to(dev) if times_per_robot else None
        with obs.tracer.span(f"robot{r}"):  # -> span "robot<r>.frontend"
            robots.append(run_frontend(scans, cfg.for_robot(r), origin, imu, times))
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


# the columns of a loop record in `_allgather_loops`
_LOOP_FIELDS = 19


def _allgather_loops(my_loops: list[tuple[int, dict]], max_loops: int, group,
                     device="cpu") -> list[tuple[int, dict]]:
    """Exchange each rank's accepted loops: pack them into a fixed
    (max_loops, 19) float32 block [pair_idx, ra, kf_a, rb, kf_b, fitness,
    desc_dist, R(9), t(3)] plus a count, all-gather both, and unpack
    every rank's in rank order (the cross-host `Loops` message
    exchange), `rel` on the CPU. The block travels from `device` (the
    rank's, which NCCL needs). The indices travel as float32, exact
    below 2^24; `rel`, `fitness` and `desc_dist` are float32 values and
    arrive unchanged."""
    from ..parallel import mesh

    block = np.zeros((max_loops, _LOOP_FIELDS), np.float32)
    for i, (pi, l) in enumerate(my_loops[:max_loops]):
        ints = (pi, l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"])
        if max(ints) >= 1 << 24:
            raise ValueError(f"loop record index beyond float32's exact range: {ints}")
        block[i, 0:7] = [*ints, l["fitness"], l["desc_dist"]]
        block[i, 7:16] = l["rel"].R.reshape(-1).cpu().numpy()
        block[i, 16:19] = l["rel"].t.cpu().numpy()
    count = torch.tensor([min(len(my_loops), max_loops)], dtype=torch.int64, device=device)
    blocks = mesh.all_gather(torch.from_numpy(block).to(device), group).cpu().numpy()  # (P, L, 19)
    counts = mesh.all_gather(count, group).reshape(-1).tolist()
    merged: list[tuple[int, dict]] = []
    for p, c in enumerate(counts):
        for row in blocks[p, :c]:
            merged.append((int(row[0]), dict(
                robot_a=int(row[1]), kf_a=int(row[2]), robot_b=int(row[3]), kf_b=int(row[4]),
                rel=Pose(torch.from_numpy(row[7:16].reshape(3, 3).copy()),
                         torch.from_numpy(row[16:19].copy())),
                fitness=float(row[5]), desc_dist=float(row[6]),
            )))
    return merged


def run_backend(robots: list[RobotResult], cfg: SlamConfig, group=None) -> SlamResult:
    """Back-end stages on finished front-end products: descriptors, graph
    build, loop retrieval + verification, per-pair PCM, chordal PGO.
    Deterministic given identical inputs, so several processes run it
    redundantly (`parallel/multihost.py`). With `group` (a process
    group), robot pairs are shared out over its ranks (pair index modulo
    the ranks), the accepted loops all-gathered (`_allgather_loops`), and
    the pose graph solved with its edges sharded over the ranks
    (`backend/distributed.py`); every rank returns the same result.
    Without one, the single-process run."""
    from . import loopstage
    from ..parallel import mesh

    R = len(robots)
    dev = robots[0].store.xyz.device
    n_ranks, rank = mesh.size(group), mesh.rank(group)
    with obs.tracer.span("backend.prepare"):
        descs = [compute_descriptors(rr.store, cfg) for rr in robots]
        _sync(dev)

    with obs.tracer.span("backend.graph"):
        graph, node_of = build_graph(robots, cfg)

    # Each unordered pair once (ra == rb: self). Inter-robot pairs sweep
    # first so dense same-robot revisits cannot starve them of the
    # max_loops budget. Sorting the merged loops by pair index keeps
    # every rank's list in the single process's order.
    pairs = sorted(
        ((ra, rb) for ra in range(R) for rb in range(ra + 1)),
        key=lambda p: p[0] == p[1],
    )
    my_loops: list[tuple[int, dict]] = []
    with obs.tracer.span("backend.associate"):
        for pi, (ra, rb) in enumerate(pairs):
            if pi % n_ranks != rank:
                continue
            found = loopstage.search_pair_loops(
                robots[ra].store, descs[ra], robots[rb].store, descs[rb],
                cfg, same_robot=(ra == rb),
            )
            for l in found:
                my_loops.append((pi, dict(
                    robot_a=ra, kf_a=l["kf_a"], robot_b=rb, kf_b=l["kf_b"],
                    rel=l["rel"], fitness=l["fitness"], desc_dist=l["desc_dist"],
                )))
        _sync(dev)
        if group is not None:
            my_loops = [(pi, dict(l, rel=l["rel"].to(dev)))
                        for pi, l in _allgather_loops(my_loops, cfg.loops.max_loops, group, dev)]
    loops = [l for _, l in sorted(my_loops, key=lambda x: x[0])]
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
        anchors = torch.as_tensor(anchors, device=dev)
        if group is None:
            opt = chordal.optimize(graph, anchors, pgo_cfg)
        else:
            from ..backend import distributed

            opt = distributed.optimize(graph, anchors, group, pgo_cfg)
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
