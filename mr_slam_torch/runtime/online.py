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
device: `add_frame` copies them into the robot's runner, asynchronously
from a CPU cloud (through pinned memory).

The tick is the counterpart of the reference's jitted `odometry.step` /
`lio.step`, `store.gate_and_add` and GEM steps: each robot keeps one
runner (`_RobotGraphs`, on `runtime/frame_graph`'s `Scan2Map` / `Lio`),
keyed on its front-end, the point count and whether point times come,
whose first frame runs eagerly and whose later frames replay CUDA
graphs on the card (the front-end step, the gate with the stamp from a
static buffer, the GEM tick on static map buffers); scan2map's SO(3)
projections and the GEM motion scalars stay eager between them. A runner
notices a reallocated store (a robot joining past the allocated rows)
and captures its gate anew. The eager tick is kept as
`_add_frame_eager`, the oracle that the runner is held to bit for bit.

Host syncs: each point where the host waits on the card counts at its
site in `observability.metrics` (`sync.<site>`). A frame waits at the
keyframe gate's bit (`sync.frontend.gate`, needed to schedule the
descriptor write and the loop stage) and, on scan2map, at the two SO(3)
projections between the runner's replays (`sync.frontend.project`);
with GEM on, at the motion scalars (`sync.gem.motion`). Keyframe counts
are kept on the host as well as on the device, so the capacity check
costs none. The cadence products (`sync.tf`, `sync.compose.*`), the
loop stage (`sync.loop.*`, `sync.verify.*`, `sync.pcm`) and the solve
(`sync.solve.*`) wait when they fire.

Spans (`observability.tracer`): `online.frontend` (with
`online.frontend.project` and `online.frontend.gate_read` inside),
`online.keyframe` (with `online.describe`), `online.tf`,
`online.compose`, `online.gem`, and `online.loop_stage` around
`loop.retrieve`, `loop.verify`, `online.pcm` and `online.solve` (with
`online.solve.prepare` and `online.solve.project`). Each loop a solve
keeps counts once in `loops.corrected`, and its seconds from the later
of its keyframes to the end of that solve in `loops.correction_s`.

A robot runs the front-end its resolved config selects: scan2map, or
the FAST-LIO-style IEKF (`OdometryCfg.frontend == "lio"`), whose frames
after the first must carry an IMU packet. Per-point capture times
motion-compensate either. A LIO frame makes no host sync of its own:
its budget is the keyframe gate's one (plus GEM's).
"""
from __future__ import annotations

import functools
import time
import warnings
from typing import Optional

import numpy as np
import torch

from ..backend import chordal, factor_graph as fg
from ..frontend import keyframes as kf
from ..frontend import lio, odometry
from ..geometry import se3
from ..geometry.se3 import Pose
from ..geometry.tf_tree import TransformBuffer
from ..mapping import elevation
from ..ops import pointcloud as pcl
from ..parallel import store as mstore_lib
from . import frame_graph
from . import observability as obs
from . import pipeline as pl
from . import solve_graph
from .config import SlamConfig


class _RobotGraphs:
    """A robot's runner in a session: its front-end's runner
    (`frame_graph.Scan2Map` / `Lio`) gating into the robot's row of the
    session's store (`frame_graph.RowGate`) and, with GEM on, the GEM
    tick as segments of the same runner on static `ElevationMap`
    buffers (`_gem_motion`, `_gem_fuse`). Built from the session's state
    (`robots[r]["odo"]`, `["gem_local"]`, `["gem_last_pose"]`), which it
    replaces by views of its buffers."""

    def __init__(self, sess: "OnlineSlam", robot: int, key: tuple):
        rs = sess.robots[robot]
        frontend, n_points, with_times = key
        kcfg = rs["kf_cfg"]
        gate = frame_graph.RowGate(sess.mstore, sess.rows[robot], kcfg.dist_thresh, kcfg.leaf)
        cls = frame_graph.Lio if frontend == "lio" else frame_graph.Scan2Map
        self.key = key
        self.front = cls(rs["odo"], rs["odo_cfg"], n_points, with_times, gate)
        rs["odo"] = self.odo = self.front.state()
        self.gem = None
        if sess.enable_gem:
            m, last = rs["gem_local"], rs.get("gem_last_pose")
            R, t = self.front.pose()
            if last is None:
                last = Pose(torch.eye(3, device=R.device), torch.zeros(3, device=R.device))
            self.gem_cfg = rs.get("gem_cfg", sess.cfg.elevation)
            self.gem = dict(
                height=m.height.clone(), variance=m.variance.clone(), valid=m.valid.clone(),
                origin=m.origin.clone(), resolution=m.resolution.clone(), last_R=last.R.clone(),
                last_t=last.t.clone(), sigma_z=torch.zeros((), device=R.device),
                sigma_tilt=torch.zeros((), device=R.device), xyz=self.front.b["xyz"],
                mask=self.front.b["mask"], R=R, t=t)
            g = self.gem
            rs["gem_local"] = self.gem_map = elevation.ElevationMap(
                g["height"], g["variance"], g["valid"], g["origin"], g["resolution"])
            self.gem_last = Pose(g["last_R"], g["last_t"])
            if rs.get("gem_last_pose") is not None:
                rs["gem_last_pose"] = self.gem_last

    def fits(self, rs: dict, key: tuple, imu_len) -> bool:
        """Whether the runner takes this frame: the same key, LIO packets
        of its length, and the session's state still its buffers."""
        if key != self.key or rs["odo"] is not self.odo:
            return False
        if imu_len is not None and self.front.imu_len not in (None, imu_len):
            return False
        last = rs.get("gem_last_pose")
        return self.gem is None or (rs["gem_local"] is self.gem_map
                                    and (last is None or last is self.gem_last))

    def gem_tick(self, rs: dict, first: bool) -> None:
        """`OnlineSlam._gem_tick` on the buffers: the motion scalars come
        to the host as in the reference (`float(...)`), their drift
        products go back as f32 device scalars."""
        b, e, segs = self.gem, self.gem_cfg, self.front.segs
        run = segs.eager if first else segs.run
        with segs.on_stream():
            if rs.get("gem_last_pose") is not None and (e.drift_z > 0.0 or e.drift_tilt > 0.0):
                obs.metrics.inc("sync.gem.motion")
                dt, drot = run("gem_motion", _gem_motion, b)["motion"].tolist()
                b["sigma_z"].fill_(e.drift_z * dt)
                b["sigma_tilt"].fill_(e.drift_tilt * drot)
                run("gem_moved", functools.partial(_gem_fuse, moved=True), b)
            else:
                run("gem", _gem_fuse, b)
        rs["gem_last_pose"] = self.gem_last

    def close(self) -> None:
        self.front.close()


def _gem_motion(b: dict) -> dict:
    """The motion since the last GEM tick (distance, rotation angle), as
    `OnlineSlam._gem_tick` computes it."""
    last, pose = Pose(b["last_R"], b["last_t"]), Pose(b["R"], b["t"])
    c = torch.clamp((torch.trace(last.R.T @ pose.R) - 1.0) / 2.0, -1.0, 1.0)
    return dict(motion=torch.stack([torch.linalg.norm(pose.t - last.t), torch.arccos(c)]))


def _gem_fuse(b: dict, moved: bool = False) -> dict:
    """The rest of the GEM tick on the buffers: shift, predict, the
    motion update from the f32 drift scalars `sigma_z` / `sigma_tilt`
    (when `moved`), fuse; the pose becomes the last pose."""
    pose = Pose(b["R"], b["t"])
    m = elevation.ElevationMap(b["height"], b["variance"], b["valid"], b["origin"], b["resolution"])
    m = elevation.predict(elevation.shift(m, pose.t[:2]))
    if moved:
        m = elevation.motion_update(m, pose.t[:2], sigma_z=b["sigma_z"], sigma_tilt=b["sigma_tilt"])
    b["last_R"].copy_(pose.R)
    b["last_t"].copy_(pose.t)
    scan = pcl.PointCloud(b["xyz"], b["mask"])
    m = elevation.fuse(m, pcl.transform(scan, pose), elevation.sensor_variance(scan.xyz))
    for f in ("height", "variance", "valid", "origin"):
        b[f].copy_(getattr(m, f))
    return {}


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
        self._runners: dict[int, _RobotGraphs] = {}  # robot id -> its runner
        # host time of each keyframe (bounded by the keyframe capacity) and
        # the loops counted in `loops.corrected` (bounded by the loops)
        self._kf_time: dict[tuple[int, int], float] = {}
        self._corrected: set[tuple[int, int, int, int]] = set()

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
            # the streaming lidar-inertial front-end: frames carry IMU packets
            lcfg = pl._lio_config(rcfg)
            odo = lio.init(lcfg, origin, extrinsic=pl._lio_extrinsic(rcfg, self.device),
                           device=self.device)
            rs = dict(frontend="lio", odo=odo, odo_cfg=lcfg)
        else:
            ocfg = pl._odometry_config(rcfg)
            rs = dict(frontend="scan2map", odo=odometry.init(ocfg, origin, device=self.device),
                      odo_cfg=ocfg)
        rs.update(kf_cfg=rcfg.keyframes, frame=0)
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
        pose estimate for `robot` (tensors of its own). `times`: optional
        (P,) sweep-relative point times, motion compensation in either
        front-end. `imu`: (gyro (S, 3), acc (S, 3), dt (S)), the packet
        covering the sweep, required on every frame after the first of a
        LIO robot (frame 0 runs no filter step and gates the origin
        keyframe).

        The tick goes through the robot's runner (`_RobotGraphs`): the
        front-end step, the gate and the GEM tick as segments of static
        buffers, replayed from CUDA graphs on the card from the runner's
        second frame on. `robots[robot]["odo"]` and `["gem_local"]` are
        then views of its buffers, which the next frame rewrites.

        Host waits (`sync.<site>` counters): the keyframe-gate bit, on
        scan2map the two SO(3) projections between the replays, the GEM
        tick's motion scalars when GEM is on, and those of the keyframe,
        loop stage, TF and compose work that the frame sets off."""
        return self._tick(robot, scan, stamp, times, imu, self._frontend_graphs)

    def _add_frame_eager(self, robot: int, scan: pcl.PointCloud, stamp: float = 0.0, times=None,
                         imu=None) -> Pose:
        """`add_frame` with every step eager, on fresh tensors: the oracle
        the runner is held to (bit for bit on one device)."""
        return self._tick(robot, scan, stamp, times, imu, self._frontend_eager)

    def _tick(self, robot, scan, stamp, times, imu, frontend) -> Pose:
        if robot not in self.robots:
            self.register_robot(robot)
        rs = self.robots[robot]
        sched = self.cfg.scheduler
        # two-rate + load-shed decision: never frame 0 or the frame right
        # after a registered keyframe (the map must grow around new
        # keyframes); a shed frame's map contribution is DROPPED
        after_kf = rs["frame"] == rs.get("last_kf_frame", -2) + 1
        shed = (rs["frontend"] == "scan2map" and rs["frame"] > 0 and not after_kf and (
            (sched.map_every > 1 and rs["frame"] % sched.map_every != 0)
            or (sched.shed and self._over_budget_prev)
        ))
        t_frame0 = time.perf_counter()
        with obs.tracer.span("online.frontend"):
            if rs["frontend"] == "lio" and imu is None and rs["frame"] > 0:
                raise ValueError(f"robot {robot} runs the LIO front-end; add_frame needs an "
                                 "imu=(gyro, acc, dt) packet per frame")
            k = self.kf_counts[robot]  # the slot a keyframe lands in
            pose, added, gem_tick = frontend(robot, rs, scan, stamp, times, imu, shed)
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
                gem_tick()
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
                    obs.metrics.inc("sync.compose.end")
                    pl._sync(self.device)
                obs.metrics.inc("compose.runs")
        return pose

    def _frontend_eager(self, robot, rs, scan, stamp, times, imu, shed):
        """The front-end step and the gate on fresh tensors. Returns
        (pose, added, the GEM tick to run)."""
        scan = pcl.PointCloud(self._to_device(scan.xyz), self._to_device(scan.mask))
        if times is not None:
            times = self._to_device(times)
        if rs["frontend"] == "lio":
            if imu is not None:
                gyro, acc, dts = (self._to_device(x) for x in imu)
                end = torch.sum(dts) * 0.999
                pt_time = end.expand(scan.xyz.shape[0]) if times is None else times
                rs["odo"], _ = lio.step(rs["odo"], scan, pt_time,
                                        lio.ImuSample(gyro=gyro, acc=acc, dt=dts), rs["odo_cfg"])
            pose = rs["odo"].pose()
        else:
            rs["odo"], _ = odometry.step(rs["odo"], scan, rs["odo_cfg"], t_rel=times, shed=shed)
            pose = rs["odo"].pose
        self.mstore, added, _ = mstore_lib.gate_and_add(
            self.mstore, self.rows[robot], scan, pose,
            torch.full((), float(stamp), dtype=torch.float32, device=self.device),
            dist_thresh=rs["kf_cfg"].dist_thresh, leaf=rs["kf_cfg"].leaf,
        )
        added = self._gate_read(added)
        return pose, added, lambda: self._gem_tick(rs, scan, pose)

    def _frontend_graphs(self, robot, rs, scan, stamp, times, imu, shed):
        """The front-end step and the gate through the robot's runner.
        Returns (pose, added, the GEM tick to run)."""
        lio_frame = rs["frontend"] == "lio" and imu is not None
        runner = self._runner(robot, rs, scan.xyz.shape[0], times is not None,
                              imu[2].shape[0] if lio_frame else None)
        front = runner.front
        first = front.steps == 0
        front.gate.store = self.mstore
        args = (self._host(scan.xyz), self._host(scan.mask),
                None if times is None else self._host(times), stamp)
        if rs["frontend"] == "lio":
            out = front.step(*args, imu=tuple(self._host(x) for x in imu) if lio_frame else None)
        else:
            out = front.step(*args, shed=shed)
        rs["odo"] = runner.odo = front.state()
        added = self._gate_read(out["added"])
        R, t = front.pose()
        return Pose(R.clone(), t.clone()), added, lambda: runner.gem_tick(rs, first)

    @staticmethod
    def _gate_read(added: torch.Tensor) -> bool:
        """The keyframe gate's bit on the host: the frame's own sync."""
        with obs.tracer.span("online.frontend.gate_read"):
            obs.metrics.inc("sync.frontend.gate")
            return bool(added.item())

    def _host(self, x: torch.Tensor) -> torch.Tensor:
        """A frame input ready for a `copy_` into the runner's buffers
        that does not block: pinned when a CPU tensor goes to the card."""
        if self.device.type == "cuda" and x.device.type == "cpu":
            return x.pin_memory()
        return x

    def _runner(self, robot: int, rs: dict, n_points: int, with_times: bool, imu_len):
        """The robot's runner for a frame of `n_points` points, with or
        without point times (and LIO packets of `imu_len` samples): the
        current one when it fits and the session's state is still its
        buffers, else a new one built from the session's state."""
        key = (rs["frontend"], n_points, with_times)
        runner = self._runners.get(robot)
        if runner is not None and not runner.fits(rs, key, imu_len):
            runner.close()
            runner = None
        if runner is None:
            runner = self._runners[robot] = _RobotGraphs(self, robot, key)
        return runner

    def graph_stats(self) -> dict:
        """Each robot's runner's frames, captures, replays, capture
        seconds, graph-pool bytes and gate recaptures."""
        return {r: run.front.stats() for r, run in self._runners.items()}

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
        identity until the first optimization. Two host transfers for all
        robots (`sync.tf`)."""
        with obs.tracer.span("online.tf"):
            self._publish_tf(stamp)
        obs.metrics.inc("tf.publishes")

    def _publish_tf(self, stamp: float) -> None:
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
            obs.metrics.inc("sync.tf", 2)
            R = torch.stack(Rs).cpu().numpy()
            t = torch.stack(ts).cpu().numpy()
            for i, child in enumerate(names):
                self.tf.set_transform("map", child, stamp, R[i], t[i])

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
                obs.metrics.inc("sync.compose.ids")
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
            obs.metrics.inc("sync.gem.motion")
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
        body = pcl.transform(cloud, se3.inverse(pose))
        # the mask is a view of the grid's, which the next tick rewrites
        rs["gem_flushed"].append((k, pcl.PointCloud(body.xyz, body.mask.clone())))

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
        """A new keyframe: its graph node and odometry edge, its
        descriptor, and the loop stage when enough keyframes wait."""
        self._kf_time[(robot, k)] = time.perf_counter()
        with obs.tracer.span("online.keyframe"):
            self._add_keyframe(robot, k, stamp)

    def _add_keyframe(self, robot: int, k: int, stamp: float) -> None:
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
        with obs.tracer.span("online.describe"):
            one = pl.describe_one(store.cloud(k), self.cfg)
        obs.metrics.inc("sync.keyframe.valid")  # the slot's valid flag set from the host
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
        with obs.tracer.span("online.loop_stage"):
            return self._loop_stage()

    def _loop_stage(self) -> int:
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
            obs.metrics.inc("sync.solve.end")
            pl._sync(self.device)
        self._count_corrected(time.perf_counter())
        return len(new_loops)

    def _count_corrected(self, now: float) -> None:
        """Count each loop of the last solve not counted before, with its
        seconds from the later of its two keyframes to `now`. Keyframes
        restored from a checkpoint have no time and predate the others;
        a loop between two of them is not counted."""
        for l in self.loops:
            key = (l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"])
            if key in self._corrected:
                continue
            self._corrected.add(key)
            seen = [self._kf_time[k] for k in (key[:2], key[2:]) if k in self._kf_time]
            if seen:
                obs.metrics.inc("loops.corrected")
                obs.metrics.inc("loops.correction_s", now - max(seen))

    def _graph_with_loops(self) -> fg.FactorGraph:
        """The persistent odometry graph with the currently accepted loop
        edges appended in one batched write (the persistent graph never
        holds loop edges, so rejected ones are simply not written)."""
        if not self.loops:
            return self.graph
        dev = self.device
        obs.metrics.inc("sync.solve.loops", 3)
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
        """`chordal.optimize` of the graph with the accepted loops, through
        its runner (`runtime/solve_graph`); what comes before the first
        replay is the span `online.solve.prepare`."""
        with obs.tracer.span("online.solve.prepare"):
            self._opt_n_nodes = self.graph.n_nodes
            g = self._graph_with_loops()
            anchors = np.zeros(g.node_capacity, bool)
            for r in self.robots:
                if (r, 0) in self.node_of:
                    anchors[self.node_of[(r, 0)]] = True
            p = self.cfg.pgo
            obs.metrics.inc("sync.solve.anchors")
            solve = solve_graph.prepare(
                g, torch.as_tensor(anchors, device=self.device),
                chordal.PGOConfig(rot_cg_iters=p.rot_cg_iters, gn_iters=p.gn_iters,
                                  pose_cg_iters=p.pose_cg_iters, robust_delta=p.robust_delta),
            )
        self.opt_poses = solve()

    # -- results --------------------------------------------------------
    def result(self) -> pl.SlamResult:
        """The session's current result. The keyframe stores and the
        odometry poses are cloned: later frames write the session's store
        and the runners' buffers in place, and the result must not change
        with them."""
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
            rs = self.robots[r]
            pose = rs["odo"].pose() if rs["frontend"] == "lio" else rs["odo"].pose
            robots.append(pl.RobotResult(odom_poses=Pose(pose.R.clone(), pose.t.clone()),
                                         store=store, kf_frame_idx=np.arange(counts[r])))
            for k in range(counts[r]):
                node_of[ri, k] = self.node_of.get((r, k), -1)
        # re-solve if the graph grew since the last optimize: a stale
        # opt_poses would read ZEROS for nodes added after that solve
        if self.opt_poses is None or self._opt_n_nodes != self.graph.n_nodes:
            self.optimize()
        return pl.SlamResult(robots=robots, graph=self._graph_with_loops(),
                             opt_poses=self.opt_poses, node_of=node_of, loops=list(self.loops))
