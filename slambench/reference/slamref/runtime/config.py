"""One typed hierarchical configuration for the whole engine.

The reference spreads ~40 launch params, rosparam YAMLs, OpenCV
FileStorage initial poses, and argparse-mutated module globals across
four mechanisms (SURVEY.md §5.6). Here a single frozen dataclass tree
covers every stage; defaults mirror `global_manager.launch:1-66`,
`RING_ros/config.py` and FAST-LIO YAMLs where a counterpart exists.
Frozen dataclasses hash, so a config can key a cache. Field for field the
same tree as `mr_slam_tpu.runtime.config` (a test holds the two equal).
"""
from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


@dataclass(frozen=True)
class OdometryCfg:
    frontend: str = "scan2map"      # scan2map (A-LOAM-style) | lio (FAST-LIO-style)
    scan_leaf: float = 0.4
    map_leaf: float = 1.0
    insert_leaf: float = 0.15
    scan_capacity: int = 4096
    insert_capacity: int = 16384
    table_size: int = 1 << 17
    map_radius: float = 120.0
    iters: int = 8
    max_corr_dist: float = 1.0
    # lidar-IMU extrinsic (LIO front-end): 16 floats, row-major 4x4
    # IMU <- lidar transform (the per-robot `extrinsic_R`/`extrinsic_T`
    # YAML entries, `FAST_LIO/config/*.yaml`); None = identity
    extrinsic: tuple[float, ...] | None = None
    estimate_extrinsics: bool = False  # refine R_li/t_li online (the
                                       # reference's 23-state IKFoM path)
    decay_every: int = 8    # map FOV-trim cadence (frames)
    coarse_every: int = 4   # coarse rescue-grid refresh cadence (frames)
    anneal: bool = True     # annealed fine-register association (67 vs
                            # 52 fps at 32x1024; ATE 0.073 vs 0.063 on
                            # the bench circle — see
                            # registration.point_to_plane_icp)


@dataclass(frozen=True)
class KeyframeCfg:
    dist_thresh: float = 2.0        # LIO_Publisher dis_th
    leaf: float = 0.2               # submap voxel (launch:55)
    capacity: int = 256             # keyframes per robot
    points_per_kf: int = 4096


@dataclass(frozen=True)
class LoopCfg:
    """Gate values whose reference counterparts differ numerically are
    calibrated in docs/calibration.md (the reference-threshold ->
    ours mapping table); change them together with that table."""

    method: str = "scancontext"     # scancontext | ring | ringpp | disco | m2dp | fasthist
    dist_thresh: float = 0.25       # descriptor gate (RING 0.48 ->
                                    # cosine ~0.2; docs/calibration.md)
    min_separation: int = 10        # skip recent frames (same robot)
    candidates: int = 1             # top-k to verify per query
    verify_window: int = 2          # merged +-window keyframes (submap_size)
    verify_leaf: float = 0.4        # vs ref icp filter 0.2 m — see
                                    # docs/calibration.md voxel-leaves row
    verify_capacity: int = 16384
    fitness_thresh: float = 0.15    # accept gate (ref 0.10 PCL scoring;
                                    # docs/calibration.md fitness row)
    fitness_z_min: float = 0.25     # fitness scores STRUCTURE points
                                    # only (body-frame z above this):
                                    # ground matches ground under any
                                    # in-plane transform, so a ground-
                                    # dominated mean accepts false loops
                                    # in symmetric worlds. Registration
                                    # still uses all points (ground
                                    # observes z/pitch/roll).
    max_loops: int = 64
    w_rot: float = 10.0             # loop noise 1e-1 -> info 10 (launch)
    w_trans: float = 10.0
    pcm_threshold: float = 2.204    # chi2 @ 6dof, pcm_thresh 0.10 (vs
                                    # ref 0.872 @ identity covariance —
                                    # docs/calibration.md PCM row)
    use_pcm: bool = True
    # per-KEYFRAME-step odometry drift PSD entering the PCM cycle
    # covariance (pcm.consistency_matrix): long cycles tolerate
    # proportionally more inconsistency. 0 = the reference's fixed
    # identity covariance.
    pcm_odo_drift_t: float = 0.02   # m / keyframe step
    pcm_odo_drift_r: float = 0.002  # rad / keyframe step
    crop_xy: float = 60.0           # +-x/y crop of merged verify submaps
                                    # (`global_manager.cpp:1916-1926`)
    bev_z_min: float = 0.0          # BEV z floor (body frame); raise to
                                    # strip ground returns from descriptors
    odom_radius: float = 0.0        # same-robot odometry-space loop search
                                    # radius in m (0 = off) — the 6-D
                                    # key-pose radius path
                                    # (`global_manager.cpp:1029-1094`)


@dataclass(frozen=True)
class PGOCfg:
    # Defaults are sized for small/online graphs (tens to ~200 nodes).
    # For production-scale graphs (>= ~300 nodes) raise to
    # (rot_cg_iters=120, gn_iters=30, pose_cg_iters=120) — the
    # reference-parity budget (~gtsam's 200 GN iterations,
    # `evaluation_utils.cpp:321`), validated <= 1.1x the independent
    # reference solver's ATE on 510-node graphs
    # (tests/test_reference_solver.py, bench `ate_vs_reference`).
    rot_cg_iters: int = 60
    gn_iters: int = 12
    pose_cg_iters: int = 40
    robust_delta: float = 1.0
    node_capacity: int = 1024
    edge_capacity: int = 2048


@dataclass(frozen=True)
class ElevationCfg:
    size: int = 60                  # 12 m x 12 m @ 0.2 m
    resolution: float = 0.2
    travers_thresh: float = 0.4
    # motion-induced variance drift (RobotMotionMapUpdater analogue):
    # per metre travelled / radian rotated since the last fuse, the grid
    # gains sigma_z = drift_z * d and sigma_tilt = drift_tilt * drot of
    # height variance. 0 disables the update.
    drift_z: float = 0.01
    drift_tilt: float = 0.01


@dataclass(frozen=True)
class SchedulerCfg:
    """Online-session cadences — the reference's launch-configured
    thread rates (`global_manager.launch:39-48`: composing 3 Hz, TF
    10 Hz, loop detection 0.1 Hz, graph pub 1 Hz) plus A-LOAM's
    load-shedding soft deadline (`A-LOAM/src/laserMapping.cpp:303`
    drops mapping frames under load; `scanRegistration.cpp:477-478`
    warns past 100 ms).

    Keyframe-count and stamp-based loop cadences are both supported;
    either firing runs the loop stage. Stamp cadences use the frame
    stamps fed to `add_frame` (bag time), not wall clock, so replays
    are deterministic."""
    loop_every_kf: int = 3       # loop stage every N new keyframes
    loop_period_s: float = 0.0   # ... or by stamp cadence (0 = off)
    compose_period_s: float = 0.0  # merged-map composing cadence (0 = off)
    tf_period_s: float = 0.0     # map->odom TF snapshot cadence (0 = off)
    map_every: int = 1           # two-rate odometry: full map insert every
                                 # Nth frame (A-LOAM's 10 Hz odometry vs
                                 # lower-rate mapping split); between, the
                                 # registration map is left untouched
    frame_budget_s: float = 0.0  # odometry soft deadline (0 = off)
    shed: bool = False           # past-deadline frames shed their map
                                 # insert (counted in metrics) instead of
                                 # silently lagging


@dataclass(frozen=True)
class RobotOverlay:
    """Per-robot override — the reference's per-robot mechanisms rolled
    into one typed overlay: FAST-LIO per-robot sensor YAMLs
    (`FAST_LIO/config/velodyne32_robot1..3.yaml`), per-robot GEM
    configs, and the OpenCV-FileStorage initial poses `T.initPose`
    read via `manual_config_dir` (`global_manager.cpp:2469-2506`,
    `cfg/real/robot_N.yaml`). Unset sections inherit the base config.

    `init_pose`: 16 floats, row-major 4x4 homogeneous transform."""
    robot: int = 0
    odometry: OdometryCfg | None = None
    keyframes: KeyframeCfg | None = None
    elevation: ElevationCfg | None = None
    init_pose: tuple[float, ...] | None = None


@dataclass(frozen=True)
class SlamConfig:
    n_robots: int = 1
    odometry: OdometryCfg = field(default_factory=OdometryCfg)
    keyframes: KeyframeCfg = field(default_factory=KeyframeCfg)
    loops: LoopCfg = field(default_factory=LoopCfg)
    pgo: PGOCfg = field(default_factory=PGOCfg)
    elevation: ElevationCfg = field(default_factory=ElevationCfg)
    scheduler: SchedulerCfg = field(default_factory=SchedulerCfg)
    overlays: tuple[RobotOverlay, ...] = ()

    def replace(self, **kw) -> "SlamConfig":
        return dataclasses.replace(self, **kw)

    def for_robot(self, robot: int) -> "SlamConfig":
        """Resolve per-robot overlays into a plain SlamConfig (still
        hashable/static). No overlay for `robot` -> self."""
        for ov in self.overlays:
            if ov.robot == robot:
                return dataclasses.replace(
                    self,
                    odometry=ov.odometry or self.odometry,
                    keyframes=ov.keyframes or self.keyframes,
                    elevation=ov.elevation or self.elevation,
                    overlays=(),
                )
        return self if not self.overlays else dataclasses.replace(
            self, overlays=()
        )

    def init_pose(self, robot: int):
        """Initial pose from the overlay as a geometry Pose, or None
        (the `readConfigs` T.initPose path)."""
        for ov in self.overlays:
            if ov.robot == robot and ov.init_pose is not None:
                import torch

                from ..geometry.se3 import Pose

                T = torch.tensor(ov.init_pose, dtype=torch.float32).reshape(4, 4)
                return Pose(T[:3, :3].contiguous(), T[:3, 3].contiguous())
        return None

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self), indent=2)

    @classmethod
    def from_json(cls, text: str) -> "SlamConfig":
        raw = json.loads(text)

        def sub(kind, key):
            return kind(**raw.get(key) or {}) if raw.get(key) else kind()

        overlays = tuple(
            RobotOverlay(
                robot=o.get("robot", 0),
                odometry=OdometryCfg(**o["odometry"]) if o.get("odometry") else None,
                keyframes=KeyframeCfg(**o["keyframes"]) if o.get("keyframes") else None,
                elevation=ElevationCfg(**o["elevation"]) if o.get("elevation") else None,
                init_pose=tuple(o["init_pose"]) if o.get("init_pose") else None,
            )
            for o in raw.get("overlays", [])
        )
        return cls(
            n_robots=raw.get("n_robots", 1),
            odometry=sub(OdometryCfg, "odometry"),
            keyframes=sub(KeyframeCfg, "keyframes"),
            loops=sub(LoopCfg, "loops"),
            pgo=sub(PGOCfg, "pgo"),
            elevation=sub(ElevationCfg, "elevation"),
            scheduler=sub(SchedulerCfg, "scheduler"),
            overlays=overlays,
        )
