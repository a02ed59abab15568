"""The reference's stages, each worked out from the benchmark's inputs
(scans, point times, IMU packets) and from the program's outputs that
the stage before it produced (the poses `add_frame` returned, the
keyframe decisions, the loops it found and accepted).

A SLAM session is chaotic in float32: a change of one ulp in a scan can
move a robot's track by metres a few dozen frames later, in the program
and in this reference alike. So the reference follows the program stage
by stage rather than running a session of its own: each stage starts
from what the program fed the next stage and is compared with what the
program made of it.

`q` is the precision of a stage's inputs: `exact` keeps them, `bf16`
rounds every floating input through bfloat16 (the control, which has to
come out as not correct)."""
from __future__ import annotations

import numpy as np
import torch

from .slamref.backend import chordal, pcm
from .slamref.backend import factor_graph as fg
from .slamref.frontend import keyframes as kf
from .slamref.frontend import lio, odometry
from .slamref.geometry import se3
from .slamref.geometry.se3 import Pose
from .slamref.ops import pointcloud as pcl
from .slamref.ops import voxel_grid
from .slamref.runtime import helpers, loopstage
from .slamref.runtime.config import SlamConfig


def exact(x):
    return x


def bf16(x):
    """A floating tensor rounded through bfloat16 (others unchanged)."""
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return x.to(torch.bfloat16).to(x.dtype)
    return x


# -- front-end ---------------------------------------------------------------
def state_from(snap: dict, q=exact):
    """A slamref odometry state from `drive.snapshot`'s copy."""
    def build(x):
        if isinstance(x, dict) and "_type" in x:
            kind = x["_type"]
            f = {k: build(v) for k, v in x.items() if k != "_type"}
            cls = dict(OdometryState=odometry.OdometryState, LioState=lio.LioState,
                       VoxelGrid=voxel_grid.VoxelGrid, Pose=Pose)[kind]
            return cls(**f)
        return q(x)
    return build(snap)


def frontend_step(cfg: SlamConfig, snap: dict, xyz, mask, times, imu, q=exact):
    """One front-end step of the reference from the state before the
    frame. Returns the state after it."""
    state = state_from(snap, q)
    scan = pcl.park(pcl.PointCloud(q(xyz), mask))
    if isinstance(state, lio.LioState):
        g, a, d = (q(x) for x in imu)
        out, _ = lio.step(state, scan, q(times), lio.ImuSample(gyro=g, acc=a, dt=d),
                          helpers._lio_config(cfg))
        return out
    out, _ = odometry.step(state, scan, helpers._odometry_config(cfg),
                           t_rel=None if times is None else q(times), shed=False)
    return out


def frontend_gaps(ref, prog: dict) -> tuple[float, float, float]:
    """(translation gap m, rotation gap (Frobenius), map gap: the largest
    difference of any packed cell value) between the reference's state
    after a frame and the program's copy of its own."""
    if isinstance(ref, lio.LioState):
        R, t, grids = ref.R, ref.p, [(ref.grid.packed, prog["grid"]["packed"])]
        pR, pt = prog["R"], prog["p"]
    else:
        R, t = ref.pose.R, ref.pose.t
        pR, pt = prog["pose"]["R"], prog["pose"]["t"]
        grids = [(ref.grid.packed, prog["grid"]["packed"]),
                 (ref.coarse_grid.packed, prog["coarse_grid"]["packed"])]
    dt = float(torch.linalg.norm(t.double() - pt.double()))
    dR = float(torch.linalg.norm(R.double() - pR.double()))
    # coords, counts, means, covariances and valid flags alike: a cell
    # present on one side only differs by its whole row
    dm = max(float(torch.max(torch.abs(a[..., :16].double() - b[..., :16].double())))
             for a, b in grids)
    return dt, dR, dm


# -- keyframe gate -------------------------------------------------------------
GATE_ROUNDING_M = 1e-5  # float32 rounding of a distance of the ring road's size


def gate_decisions(ts: np.ndarray, dist_thresh: float, capacity: int, q=exact):
    """The keyframe gate over one robot's returned positions (T, 3),
    in float64: (added (T,) bool, |distance - threshold| (T,) at each
    frame). The first frame always gates in."""
    if q is bf16:
        ts = bf16(torch.from_numpy(ts.astype(np.float32))).double().numpy()
    added = np.zeros(len(ts), bool)
    margin = np.full(len(ts), np.inf)
    last = np.full(3, np.inf)
    count = 0
    for i, t in enumerate(ts):
        d = float(np.linalg.norm(t - last)) if np.isfinite(last).all() else np.inf
        margin[i] = abs(d - dist_thresh)
        if d > dist_thresh and count < capacity:
            added[i] = True
            last = t
            count += 1
    return added, margin


def keyframe_cloud(cfg: SlamConfig, xyz, mask, points_per_kf: int, q=exact):
    """The cloud the store keeps of a keyframe's scan."""
    ds = pcl.voxel_downsample(pcl.park(pcl.PointCloud(q(xyz), mask)), cfg.keyframes.leaf,
                              points_per_kf, bounds=kf._BOUNDS)
    return ds.xyz, ds.mask


# -- loop stage ----------------------------------------------------------------
def reference_store(clouds, poses, count: int, capacity: int, points_per_kf: int, device,
                    q=exact) -> kf.KeyframeStore:
    """A robot's keyframe store holding its first `count` keyframes:
    `clouds` [(xyz, mask)] and `poses` [(R, t)] per keyframe."""
    s = kf.init(capacity, points_per_kf, device)
    for k in range(count):
        s.xyz[k] = q(clouds[k][0])
        s.mask[k] = clouds[k][1]
        s.poses.R[k] = q(poses[k][0])
        s.poses.t[k] = q(poses[k][1])
    return s._replace(count=torch.tensor(count, dtype=torch.int64, device=device))


def replay_round(cfg: SlamConfig, stores: dict, descs: dict, robots: list, pending: list,
                 searched: dict, loop_every: int, scores: dict | None = None) -> list[dict]:
    """One loop-stage round of the session (`OnlineSlam.run_loop_stage`
    up to PCM): per pending robot, retrieval and verification against
    every robot with keyframes, skipping the pairs `searched` already
    holds, which it extends as the session does. Returns the loops found,
    {robot_a, kf_a, robot_b, kf_b, rel (R, t), fitness}. `scores`, where
    given, gets the fitness of every candidate verified, accepted or
    not, under (robot_a, kf_a, robot_b, kf_b)."""
    by_robot: dict[int, list[int]] = {}
    for ra, ia in pending:
        by_robot.setdefault(ra, []).append(ia)
    found = []
    for ra, ias in by_robot.items():
        Q = max(loop_every, len(ias), 1)
        qi = np.full((Q,), -1, np.int64)
        qi[: len(ias)] = ias
        for rb in robots:
            if int(stores[rb].count) == 0:
                continue
            exclude = searched.setdefault((ra, rb), set())
            pair_scores: dict = {}
            pair = loopstage.search_pair_loops(stores[ra], descs[ra], stores[rb], descs[rb], cfg,
                                               same_robot=(ra == rb), query_idx=qi,
                                               exclude=exclude, scores=pair_scores)
            if scores is not None:
                scores.update({(ra, a, rb, b): f for (a, b), f in pair_scores.items()})
            for l in pair:
                if (l["kf_a"], l["kf_b"]) in exclude:
                    continue
                exclude.add((l["kf_a"], l["kf_b"]))
                searched.setdefault((rb, ra), set()).add((l["kf_b"], l["kf_a"]))
                found.append(dict(robot_a=ra, kf_a=l["kf_a"], robot_b=rb, kf_b=l["kf_b"],
                                  rel=(l["rel"].R, l["rel"].t), fitness=l["fitness"]))
    return found


def pcm_faults(cfg: SlamConfig, inter: list[dict], kept: set, pose_of, q=exact) -> int:
    """PCM over the inter-robot loops the program verified, with the
    program's measurements: per robot pair, the loops the program kept
    must be a clique of the reference's consistency graph and as large as
    its largest (a singleton is kept). Returns the number of pairs where
    they are not."""
    loops = [dict(l, rel=Pose(q(l["rel"][0]), q(l["rel"][1]))) for l in inter]
    faults = 0
    for group, adj in helpers.pcm_groups(loops, lambda r, k: Pose(*(q(x) for x in pose_of(r, k))),
                                         cfg):
        keys = [(l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"]) for l in group]
        inside = np.asarray([k in kept for k in keys])
        if adj is None:
            faults += int(not inside.all())
            continue
        idx = np.flatnonzero(inside)
        sub = adj[np.ix_(idx, idx)] | np.eye(len(idx), dtype=bool)
        best = len(pcm.max_clique_plain(adj))
        faults += int(not sub.all() or len(idx) != best)
    return faults


# -- back end ------------------------------------------------------------------
def solve(cfg: SlamConfig, events: list, kf_pose: dict, loops: list[dict], n_nodes: int,
          device, q=exact) -> Pose:
    """The chordal solve of the session's graph as the program built it
    for its last solve: one node a keyframe in the order they were
    gated (the first `n_nodes`), an odometry edge between each robot's
    consecutive keyframes, then the accepted loops."""
    p = cfg.pgo
    g = fg.init(p.node_capacity, p.edge_capacity, device)
    node_of: dict = {}
    for r, k in events[:n_nodes]:
        pose = Pose(*(q(x) for x in kf_pose[(r, k)]))
        g, idx = fg.add_node(g, pose, r)
        node_of[(r, k)] = idx
        if k > 0:
            prev = Pose(*(q(x) for x in kf_pose[(r, k - 1)]))
            g, _ = fg.add_edge(g, node_of[(r, k - 1)], idx, se3.between(prev, pose), fg.ODOM,
                               1.0, 1.0)
    if loops:
        ei = torch.as_tensor([node_of[(l["robot_a"], l["kf_a"])] for l in loops], device=device)
        ej = torch.as_tensor([node_of[(l["robot_b"], l["kf_b"])] for l in loops], device=device)
        kinds = torch.as_tensor([fg.INTRA_LOOP if l["robot_a"] == l["robot_b"] else fg.INTER_LOOP
                                 for l in loops], device=device)
        meas = se3.inverse(se3.stack([Pose(q(l["rel"][0]), q(l["rel"][1])) for l in loops]))
        g, _ = fg.add_edges_batch(g, ei, ej, meas, kinds, cfg.loops.w_rot, cfg.loops.w_trans)
    anchors = np.zeros(g.node_capacity, bool)
    for (r, k), idx in node_of.items():
        if k == 0:
            anchors[idx] = True
    return chordal._optimize_eager(
        g, torch.as_tensor(anchors, device=device),
        chordal.PGOConfig(rot_cg_iters=p.rot_cg_iters, gn_iters=p.gn_iters,
                          pose_cg_iters=p.pose_cg_iters, robust_delta=p.robust_delta))


def describe(cfg: SlamConfig, store: kf.KeyframeStore) -> dict:
    """Descriptors of every slot of a store."""
    return helpers.describe_one(pcl.PointCloud(store.xyz, store.mask), cfg)

