"""Online (streaming) multi-robot SLAM session (port of
`mr_slam_tpu/runtime/online.py`: `OnlineSlam`).

One deterministic scheduler replaces the reference system's callback
threads (discovery, loop closing, composing at 3 Hz, TF at 10 Hz):
`add_frame` ticks odometry and gates keyframes; every `loop_every` new
keyframes (or on a stamp cadence) the session runs the loop stage
(batched retrieval -> batched verification -> PCM -> chordal PGO over
the whole graph); TF snapshots and the merged map follow stamp
cadences. Robots register lazily (`register_robot`) and may join
mid-session.

Backing state is the batched `parallel.store.MultiRobotStore`, written
in place. A session lives on one device, named when it is built
(`device="cuda"` by default; building one on a machine without CUDA
raises, it never falls back to the CPU). Frames may arrive on any
device: `add_frame` moves them to the session's, asynchronously from a
CPU cloud.

Host syncs per frame: one scalar, the keyframe gate (needed to schedule
the descriptor write and the loop stage), plus one transfer of the two
GEM motion scalars when GEM is on. Keyframe counts are kept on the host
as well as on the device, so the capacity check costs none. The
cadence products (TF, merged map) and the loop stage sync when they
fire. (The odometry step's own syncs, inside `so3.project`'s SVD, are
the batch front-end's as well.)

Only the scan2map front-end is ported: a robot whose resolved config
selects the LIO front-end, or a frame with per-point times or an IMU
packet, raises (ROADMAP Queue 1 step 14).
"""
from __future__ import annotations

import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..backend import chordal, factor_graph as fg
from ..frontend import keyframes as kf
from ..frontend import odometry
from ..geometry import se3
from ..geometry.se3 import Pose
from ..geometry.tf_tree import TransformBuffer
from ..mapping import elevation
from ..ops import pointcloud as pcl
from ..parallel import store as mstore_lib
from . import observability as obs
from . import pipeline as pl
from .config import SlamConfig

_STEP14 = "the LIO front-end and per-point motion compensation are ROADMAP Queue 1 step 14"


def resolve_device(device) -> torch.device:
    """`device` as a torch.device; a CUDA device on a machine without
    CUDA raises (an entry point never falls back to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {dev} requested but CUDA is not available; pass device='cpu' to run on the CPU"
        )
    return dev


class OnlineSlam:
    def __init__(self, cfg: SlamConfig, enable_gem: bool = False, device="cuda"):
        self.device = resolve_device(device)
        self.cfg = cfg
        self.robots: dict[int, dict] = {}    # per-robot odometry/GEM state
        self.rows: dict[int, int] = {}       # robot id -> mstore row
        self.kf_counts: dict[int, int] = {}  # robot id -> keyframes stored (host)
        self.mstore: Optional[mstore_lib.MultiRobotStore] = None
        # `self.graph` holds ONLY the odometry chains; accepted loop edges
        # live in `self.loops` and are composed in at optimize time
        # (`_graph_with_loops`)
        self.graph = fg.init(cfg.pgo.node_capacity, cfg.pgo.edge_capacity, self.device)
        self.node_of: dict[tuple[int, int], int] = {}
        self.loops: list[dict] = []
        self._pending_kf: list[tuple[int, int]] = []  # (robot, kf index)
        # (robot_a, robot_b) -> {(kf_a, kf_b)} already verified — the
        # incremental exclude sets (symmetric entries kept both ways)
        self._searched: dict[tuple[int, int], set] = {}
        self._inter_candidates: list[dict] = []  # every verified inter loop
        self.opt_poses: Optional[Pose] = None
        self._opt_n_nodes = -1  # graph size at the last solve
        self.loop_every = cfg.scheduler.loop_every_kf
        self.enable_gem = enable_gem  # per-robot rolling elevation maps
        self.tf = TransformBuffer()
        self.merged_map: Optional[pcl.PointCloud] = None
        self._last_loop_stamp: Optional[float] = None
        self._last_compose_stamp: Optional[float] = None
        self._last_tf_stamp: Optional[float] = None
        self._over_budget_prev = False  # last frame blew the deadline

    # -- batched-store plumbing ----------------------------------------
    def _kf_capacity(self) -> int:
        """Uniform store capacity: the largest resolved per-robot keyframe
        capacity (rows of smaller robots carry padding)."""
        return max([self.cfg.keyframes.capacity] + [
            ov.keyframes.capacity for ov in self.cfg.overlays if ov.keyframes is not None
        ])

    def _points_per_kf(self) -> int:
        return max([self.cfg.keyframes.points_per_kf] + [
            ov.keyframes.points_per_kf for ov in self.cfg.overlays if ov.keyframes is not None
        ])

    def _ensure_row(self, robot: int) -> int:
        """Allocate (or grow) the batched store row for `robot`."""
        if robot in self.rows:
            return self.rows[robot]
        dev = self.device
        if self.mstore is None:
            # descriptor layout from one describe_one of an empty cloud
            P = self._points_per_kf()
            dummy = pcl.park(pcl.PointCloud(torch.zeros((P, 3), device=dev),
                                            torch.zeros((P,), dtype=torch.bool, device=dev)))
            template = pl.describe_one(dummy, self.cfg)
            self.mstore = mstore_lib.init(1, self._kf_capacity(), P, desc_template=template,
                                          device=dev)
            self.rows[robot] = 0
            return 0
        # geometric growth: when every row is used, DOUBLE the row count in
        # one realloc; spare rows hold a fresh store's values until claimed
        row = len(self.rows)
        allocated = self.mstore.desc_valid.shape[0]
        if row >= allocated:
            spare = mstore_lib.init(allocated, self._kf_capacity(), self._points_per_kf(),
                                    desc_dim=0, device=dev).stores

            def grow(a, fill=None):
                tail = torch.zeros((allocated, *a.shape[1:]), dtype=a.dtype, device=dev) \
                    if fill is None else fill
                return torch.cat([a, tail])

            s = self.mstore.stores
            stores = kf.KeyframeStore(
                xyz=grow(s.xyz, spare.xyz), mask=grow(s.mask, spare.mask),
                poses=Pose(grow(s.poses.R, spare.poses.R), grow(s.poses.t, spare.poses.t)),
                stamps=grow(s.stamps, spare.stamps), count=grow(s.count, spare.count),
                last_pose=Pose(grow(s.last_pose.R, spare.last_pose.R),
                               grow(s.last_pose.t, spare.last_pose.t)),
            )
            self.mstore = mstore_lib.MultiRobotStore(
                stores=stores,
                descriptors=mstore_lib.map_descriptors(grow, self.mstore.descriptors),
                desc_valid=grow(self.mstore.desc_valid),
            )
        self.rows[robot] = row
        return row

    def store_view(self, robot: int):
        """This robot's (KeyframeStore, descriptors) views."""
        return self.mstore.robot_view(self.rows[robot])

    def _to_device(self, x: torch.Tensor) -> torch.Tensor:
        """`x` on the session's device. A CPU tensor goes to the card
        through pinned memory without blocking, so feeding a frame adds
        no host sync."""
        if x.device == self.device:
            return x
        if self.device.type == "cuda" and x.device.type == "cpu":
            return x.pin_memory().to(self.device, non_blocking=True)
        return x.to(self.device)

    # -- discovery ------------------------------------------------------
    def register_robot(self, robot: int, origin: Pose | None = None) -> None:
        if robot in self.robots:
            return
        if origin is None:
            origin = self.cfg.init_pose(robot)  # overlay T.initPose
        if origin is not None:
            origin = Pose(self._to_device(origin.R), self._to_device(origin.t))
        rcfg = self.cfg.for_robot(robot)
        if rcfg.odometry.frontend == "lio":
            raise NotImplementedError(f"robot {robot} selects the LIO front-end: {_STEP14}")
        ocfg = pl._odometry_config(rcfg)
        rs = dict(
            frontend="scan2map",
            odo=odometry.init(ocfg, origin, device=self.device),
            odo_cfg=ocfg,
            kf_cfg=rcfg.keyframes,
            frame=0,
        )
        if self.enable_gem:
            e = rcfg.elevation
            center = (0.0, 0.0) if origin is None else tuple(origin.t[:2].tolist())
            rs["gem_cfg"] = e
            rs["gem_local"] = elevation.init(size=e.size, resolution=e.resolution,
                                             center=center, device=self.device)
            # flushed grid submaps: (kf index, cloud in that keyframe's
            # body frame) — the SubMap{grid, pose} publish at each keyframe
            rs["gem_flushed"] = []
        self.robots[robot] = rs
        self._ensure_row(robot)
        self.kf_counts.setdefault(robot, 0)

    # -- per-frame tick -------------------------------------------------
    def add_frame(self, robot: int, scan: pcl.PointCloud, stamp: float = 0.0, times=None,
                  imu=None) -> Pose:
        """Odometry tick + keyframe gate. Returns the current odometry
        pose estimate for `robot`. `times` (per-point capture times) and
        `imu` (an IMU packet) belong to the LIO front-end and raise.

        Sync budget: one scalar device-to-host transfer per frame (the
        keyframe-gate bit), plus the GEM tick's motion scalars when GEM
        is on."""
        if times is not None or imu is not None:
            raise NotImplementedError(f"add_frame(times=..., imu=...): {_STEP14}")
        if robot not in self.robots:
            self.register_robot(robot)
        rs = self.robots[robot]
        row = self.rows[robot]
        sched = self.cfg.scheduler
        scan = pcl.PointCloud(self._to_device(scan.xyz), self._to_device(scan.mask))
        # two-rate + load-shed decision: never frame 0 or the frame right
        # after a registered keyframe (the map must grow around new
        # keyframes); a shed frame's map contribution is DROPPED
        after_kf = rs["frame"] == rs.get("last_kf_frame", -2) + 1
        shed = (rs["frame"] > 0 and not after_kf and (
            (sched.map_every > 1 and rs["frame"] % sched.map_every != 0)
            or (sched.shed and self._over_budget_prev)
        ))
        t_frame0 = time.perf_counter()
        with obs.tracer.span("online.frontend"):
            rs["odo"], _ = odometry.step(rs["odo"], scan, rs["odo_cfg"], shed=shed)
            pose = rs["odo"].pose
            k = self.kf_counts[robot]  # the slot a keyframe lands in
            self.mstore, added, _ = mstore_lib.gate_and_add(
                self.mstore, row, scan, pose,
                torch.full((), float(stamp), dtype=torch.float32, device=self.device),
                dist_thresh=rs["kf_cfg"].dist_thresh, leaf=rs["kf_cfg"].leaf,
            )
            added = bool(added.item())  # the one per-frame sync
        rs["frame"] += 1
        if added:
            self.kf_counts[robot] += 1
        elif self.kf_counts[robot] >= self._kf_capacity():
            obs.metrics.inc("keyframes.capacity_saturated")
            if obs.metrics.counters["keyframes.capacity_saturated"] == 1:
                warnings.warn(
                    "keyframe store full; further keyframes are dropped — "
                    "raise KeyframeCfg.capacity"
                )
        if self.enable_gem:
            with obs.tracer.span("online.gem"):
                self._gem_tick(rs, scan, pose)
        if shed:
            obs.metrics.inc("frontend.frames_shed")
        if added:
            rs["last_kf_frame"] = rs["frame"] - 1  # frame already advanced
            self._on_keyframe(robot, k, stamp)
        # ---- deadline monitor (A-LOAM soft-deadline/drop analogue) ----
        if sched.frame_budget_s > 0.0:
            self._over_budget_prev = time.perf_counter() - t_frame0 > sched.frame_budget_s
            if self._over_budget_prev:
                obs.metrics.inc("frontend.frames_over_budget")
        # ---- stamp-driven cadences (composing 3 Hz / TF 10 Hz / loop
        # 0.1 Hz in the reference launch) -------------------------------
        if sched.loop_period_s > 0.0 and self._pending_kf:
            if (self._last_loop_stamp is None
                    or stamp - self._last_loop_stamp >= sched.loop_period_s):
                self._last_loop_stamp = stamp
                self.run_loop_stage()
        if sched.tf_period_s > 0.0:
            if self._last_tf_stamp is None or stamp - self._last_tf_stamp >= sched.tf_period_s:
                self._last_tf_stamp = stamp
                self.publish_tf(stamp)
        if sched.compose_period_s > 0.0:
            if (self._last_compose_stamp is None
                    or stamp - self._last_compose_stamp >= sched.compose_period_s):
                self._last_compose_stamp = stamp
                with obs.tracer.span("online.compose"):
                    self.merged_map = self.compose_map()
                    pl._sync(self.device)
                obs.metrics.inc("compose.runs")
        return pose

    # -- cadence products ------------------------------------------------
    def _solved_node(self, robot: int, K: int):
        """(node, kf index) of `robot`'s latest keyframe COVERED BY the
        last solve (a newer node would read zeros from the stale array),
        or (None, K - 1)."""
        node = self.node_of.get((robot, K - 1))
        k_used = K - 1
        if node is not None and node >= self._opt_n_nodes:
            for k_used in range(K - 2, -1, -1):
                node = self.node_of.get((robot, k_used))
                if node is None or node < self._opt_n_nodes:
                    break
            else:
                node = None
        return node, k_used

    def publish_tf(self, stamp: float) -> None:
        """Write the current map->odom correction per robot into the
        session's tf2-analogue buffer (`publishTF`: /map -> robot_N/odom).
        Correction = optimized(latest solved kf) o odom(that kf)^-1;
        identity until the first optimization. One host transfer for all
        robots."""
        names, Rs, ts = [], [], []
        for r in self.robots:
            K = self.kf_counts[r]
            if K == 0:
                continue
            store, _ = self.store_view(r)
            node, k_used = self._solved_node(r, K)
            if self.opt_poses is not None and node is not None:
                corr = se3.compose(se3.index(self.opt_poses, node),
                                   se3.inverse(se3.index(store.poses, k_used)))
            else:
                corr = se3.identity(device=self.device)
            names.append(f"robot_{r}/odom")
            Rs.append(corr.R)
            ts.append(corr.t)
        if names:
            R = torch.stack(Rs).cpu().numpy()
            t = torch.stack(ts).cpu().numpy()
            for i, child in enumerate(names):
                self.tf.set_transform("map", child, stamp, R[i], t[i])
        obs.metrics.inc("tf.publishes")

    def compose_map(self, leaf: float = 0.5, capacity: int = 1 << 17) -> pcl.PointCloud:
        """Merged global cloud from the CURRENT session state (keyframes
        re-transformed by optimized poses where available) — the
        composing-thread product (`composeGlobalMap`)."""
        parts_xyz, parts_mask = [], []
        for r in self.robots:
            K = self.kf_counts[r]
            if K == 0:
                continue
            store, _ = self.store_view(r)
            ids = np.asarray([self.node_of.get((r, k), -1) for k in range(K)])
            # only read nodes covered by the LAST solve
            if (self.opt_poses is not None and (ids >= 0).all()
                    and (ids < self._opt_n_nodes).all()):
                idx = torch.as_tensor(ids, device=self.device)
                poses = Pose(self.opt_poses.R[idx], self.opt_poses.t[idx])
            else:
                poses = Pose(store.poses.R[:K], store.poses.t[:K])
            pts = torch.einsum("kab,kpb->kpa", poses.R, store.xyz[:K]) + poses.t[:, None, :]
            parts_xyz.append(pts.reshape(-1, 3))
            parts_mask.append(store.mask[:K].reshape(-1))
        if not parts_xyz:
            return pcl.park(pcl.PointCloud(torch.zeros((1, 3), device=self.device),
                                           torch.zeros((1,), dtype=torch.bool, device=self.device)))
        merged = pcl.park(pcl.PointCloud(torch.cat(parts_xyz), torch.cat(parts_mask)))
        return pcl.voxel_downsample(merged, leaf, capacity)

    # -- per-robot rolling GEM -------------------------------------------
    def _gem_tick(self, rs: dict, scan: pcl.PointCloud, pose: Pose) -> None:
        """Shift the rolling local grid to the robot and Kalman-fuse the
        frame — the per-frame half of GEM's `Callback` (`G_Clear_map` /
        `G_fuse`)."""
        m = elevation.shift(rs["gem_local"], pose.t[:2])
        m = elevation.predict(m)
        # motion-induced variance (RobotMotionMapUpdater): odometry drift
        # proportional to motion since the last frame, split into a
        # vertical and a tilt (lever-arm) component
        last = rs.get("gem_last_pose")
        e = rs.get("gem_cfg", self.cfg.elevation)
        if last is not None and (e.drift_z > 0.0 or e.drift_tilt > 0.0):
            c = torch.clamp((torch.trace(last.R.T @ pose.R) - 1.0) / 2.0, -1.0, 1.0)
            dt, drot = torch.stack([torch.linalg.norm(pose.t - last.t), torch.arccos(c)]).tolist()
            m = elevation.motion_update(m, pose.t[:2], sigma_z=e.drift_z * dt,
                                        sigma_tilt=e.drift_tilt * drot)
        rs["gem_last_pose"] = pose
        world = pcl.transform(scan, pose)
        var = elevation.sensor_variance(scan.xyz)  # beam model, body frame
        rs["gem_local"] = elevation.fuse(m, world, var)

    def _gem_flush(self, rs: dict, k: int, pose: Pose) -> None:
        """Keyframe boundary: flush the local grid as a cloud anchored to
        keyframe k's BODY frame (`updateLocalMap` publishing SubMap{grid,
        pose}); `global_elevation` re-anchors it to the optimized pose."""
        cloud = elevation.to_cloud(rs["gem_local"])       # world frame
        rs["gem_flushed"].append((k, pcl.transform(cloud, se3.inverse(pose))))

    def global_elevation(self, size: int = 512, center=(0.0, 0.0)):
        """Compose the global 2.5D map from flushed grid submaps, each
        re-anchored to its keyframe's OPTIMIZED pose (`GetInitMap` +
        `composeGlobalMap`'s elevation product)."""
        e = self.cfg.elevation
        emap = elevation.init(size=size, resolution=e.resolution, center=center,
                              device=self.device)
        for robot, rs in self.robots.items():
            store, _ = self.store_view(robot)
            for k, body in rs.get("gem_flushed", []):
                node = self.node_of.get((robot, k))
                if node is None:
                    continue
                if self.opt_poses is not None and node < self._opt_n_nodes:
                    pose = se3.index(self.opt_poses, node)
                else:
                    pose = se3.index(store.poses, k)
                world = pcl.transform(body, pose)
                emap = elevation.fuse(emap, world, elevation.sensor_variance(body.xyz))
        return emap

    def _on_keyframe(self, robot: int, k: int, stamp: float = 0.0) -> None:
        rs = self.robots[robot]
        row = self.rows[robot]
        store, _ = self.store_view(robot)
        pose = se3.index(store.poses, k)
        if self.enable_gem:
            self._gem_flush(rs, k, pose)
        self.graph, idx = fg.add_node(self.graph, pose, robot)
        if self.graph.n_nodes >= self.graph.node_capacity:
            obs.metrics.inc("graph.node_capacity_saturated")
            warnings.warn(
                "pose-graph node capacity reached; further keyframes "
                "cannot enter the graph — raise PGOCfg.node_capacity"
            )
        self.node_of[(robot, k)] = idx
        if k > 0:
            meas = se3.between(se3.index(store.poses, k - 1), pose)
            self.graph, _ = fg.add_edge(self.graph, self.node_of[(robot, k - 1)], idx, meas,
                                        fg.ODOM, 1.0, 1.0)
        # incremental descriptor append — O(1) new work per keyframe
        one = pl.describe_one(store.cloud(k), self.cfg)
        self.mstore = mstore_lib.write_descriptor(self.mstore, row, k, one)
        self._pending_kf.append((robot, k))
        if self.loop_every > 0 and len(self._pending_kf) >= self.loop_every:
            self._last_loop_stamp = stamp
            self.run_loop_stage()

    # -- loop stage -----------------------------------------------------
    def run_loop_stage(self) -> int:
        """Detect + verify loops for pending keyframes; optimize when any
        loop lands. Returns the number of loops found this round.

        Per (pending-robot, database-robot) pair: one retrieval call and
        one verification call per chunk of candidates
        (`runtime/loopstage.py`)."""
        from . import loopstage

        cfg = self.cfg
        new_loops = []
        pending, self._pending_kf = self._pending_kf, []
        # each unordered keyframe pair is verified at most once per
        # session, even when both ends are pending this round;
        # `self._searched` keeps the per-robot-pair exclude sets
        by_robot: dict[int, list[int]] = {}
        for ra, ia in pending:
            by_robot.setdefault(ra, []).append(ia)
        for ra, ias in by_robot.items():
            store_a, descs_a = self.store_view(ra)
            # fixed-length query batch: one retrieval shape per batch size
            Q = max(self.loop_every, len(ias), 1)
            qi = np.full((Q,), -1, np.int64)
            qi[: len(ias)] = ias
            for rb in self.robots:
                if self.kf_counts[rb] == 0:
                    continue
                store_b, descs_b = self.store_view(rb)
                exclude = self._searched.setdefault((ra, rb), set())
                found = loopstage.search_pair_loops(
                    store_a, descs_a, store_b, descs_b, cfg,
                    same_robot=(ra == rb), query_idx=qi, exclude=exclude,
                )
                for l in found:
                    if (l["kf_a"], l["kf_b"]) in exclude:
                        continue
                    exclude.add((l["kf_a"], l["kf_b"]))
                    self._searched.setdefault((rb, ra), set()).add((l["kf_b"], l["kf_a"]))
                    new_loops.append(dict(
                        robot_a=ra, kf_a=l["kf_a"], robot_b=rb, kf_b=l["kf_b"], rel=l["rel"],
                        fitness=l["fitness"], desc_dist=l["desc_dist"],
                    ))
        if not new_loops:
            return 0
        # PCM over ALL inter-robot candidates ever verified (old + new,
        # previously rejected ones included: consistency can emerge as
        # evidence accumulates), re-gated per robot pair every round
        self._inter_candidates.extend(l for l in new_loops if l["robot_a"] != l["robot_b"])
        inter = list(self._inter_candidates)
        intra = [l for l in self.loops + new_loops if l["robot_a"] == l["robot_b"]]

        def pose_of(r, k):
            store, _ = self.store_view(r)
            return se3.index(store.poses, k)

        with obs.tracer.span("online.pcm"):
            kept = pl.pcm_gate_inter_loops(inter, pose_of, cfg)
        obs.metrics.inc("online.pcm_rejected", len(inter) - len(kept))
        self.loops = intra + kept
        with obs.tracer.span("online.solve"):
            self.optimize()
            pl._sync(self.device)
        return len(new_loops)

    def _graph_with_loops(self) -> fg.FactorGraph:
        """The persistent odometry graph with the currently accepted loop
        edges appended in one batched write (the persistent graph never
        holds loop edges, so rejected ones are simply not written)."""
        if not self.loops:
            return self.graph
        dev = self.device
        ei = torch.as_tensor([self.node_of[(l["robot_a"], l["kf_a"])] for l in self.loops],
                             device=dev)
        ej = torch.as_tensor([self.node_of[(l["robot_b"], l["kf_b"])] for l in self.loops],
                             device=dev)
        kinds = torch.as_tensor(
            [fg.INTRA_LOOP if l["robot_a"] == l["robot_b"] else fg.INTER_LOOP for l in self.loops],
            device=dev,
        )
        meas = se3.inverse(se3.stack([l["rel"] for l in self.loops]))
        g, _ = fg.add_edges_batch(self.graph, ei, ej, meas, kinds, self.cfg.loops.w_rot,
                                  self.cfg.loops.w_trans)
        return g

    def optimize(self) -> None:
        self._opt_n_nodes = self.graph.n_nodes
        g = self._graph_with_loops()
        anchors = np.zeros(g.node_capacity, bool)
        for r in self.robots:
            if (r, 0) in self.node_of:
                anchors[self.node_of[(r, 0)]] = True
        p = self.cfg.pgo
        self.opt_poses = chordal.optimize(
            g, torch.as_tensor(anchors, device=self.device),
            chordal.PGOConfig(rot_cg_iters=p.rot_cg_iters, gn_iters=p.gn_iters,
                              pose_cg_iters=p.pose_cg_iters, robust_delta=p.robust_delta),
        )

    # -- results --------------------------------------------------------
    def result(self) -> pl.SlamResult:
        """The session's current result. The keyframe stores are cloned:
        later frames write the session's store in place, and the result
        must not change with them."""
        if self._pending_kf:
            self.run_loop_stage()  # flush tail keyframes (the revisits!)
        ids = sorted(self.robots)
        counts = {r: self.kf_counts[r] for r in ids}
        node_of = -np.ones((len(ids), max(max(counts.values(), default=0), 1)), np.int64)
        robots = []
        for ri, r in enumerate(ids):
            store, _ = self.store_view(r)
            store = kf.KeyframeStore(
                xyz=store.xyz.clone(), mask=store.mask.clone(),
                poses=Pose(store.poses.R.clone(), store.poses.t.clone()),
                stamps=store.stamps.clone(), count=store.count.clone(),
                last_pose=Pose(store.last_pose.R.clone(), store.last_pose.t.clone()),
            )
            robots.append(pl.RobotResult(odom_poses=self.robots[r]["odo"].pose, store=store,
                                         kf_frame_idx=np.arange(counts[r])))
            for k in range(counts[r]):
                node_of[ri, k] = self.node_of.get((r, k), -1)
        # re-solve if the graph grew since the last optimize: a stale
        # opt_poses would read ZEROS for nodes added after that solve
        if self.opt_poses is None or self._opt_n_nodes != self.graph.n_nodes:
            self.optimize()
        return pl.SlamResult(robots=robots, graph=self._graph_with_loops(),
                             opt_poses=self.opt_poses, node_of=node_of, loops=list(self.loops))
