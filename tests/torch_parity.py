"""Shared helpers of the `test_torch_*.py` parity tests: move the same
arrays between the JAX reference (`mr_slam_tpu`) and the PyTorch port
(`mr_slam_torch`) through numpy, and build the shared synthetic inputs
once with the port's numpy raycaster.

Importing this module pins PyTorch to one CPU thread. Trajectory-level
parity (odometry, loop verification, the whole pipeline) is chaotic in
float32: a sum taken in another order flips a near-degenerate plane
normal and the runs part by centimetres. With several threads the
order of PyTorch's CPU reductions follows the machine's core count, so
one thread keeps each parity test's outcome fixed.

The reference package is imported inside the converters, so a test
module that needs only the port's side (the `gpu` tests, run on a
machine without JAX) can use the input builders."""
from __future__ import annotations

import numpy as np
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl

torch.set_num_threads(1)


def to_jax(x):
    import jax.numpy as jnp

    if isinstance(x, torch.Tensor):
        return jnp.asarray(x.detach().cpu().numpy())
    return jnp.asarray(x)


def to_torch(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x))


def pose_to_jax(p: tse3.Pose):
    from mr_slam_tpu.geometry import se3 as jse3

    return jse3.Pose(to_jax(p.R), to_jax(p.t))


def pose_to_torch(p) -> tse3.Pose:
    return tse3.Pose(to_torch(p.R), to_torch(p.t))


def cloud_to_jax(pc: tpcl.PointCloud):
    from mr_slam_tpu.ops import pointcloud as jpcl

    return jpcl.PointCloud(to_jax(pc.xyz), to_jax(pc.mask))


def make_scans(world, traj, n_frames, seed=0, n_rings=16, n_azimuth=512):
    """Stacked (T, R*A, 3)/(T, R*A) port clouds raycast along `traj`."""
    rng = np.random.default_rng(seed)
    clouds = []
    for i in range(n_frames):
        xyz, _, hit = synthetic.scan(
            world, tse3.index(traj, i), n_rings=n_rings, n_azimuth=n_azimuth, rng=rng
        )
        clouds.append(synthetic.scan_to_cloud(xyz, hit))
    return tpcl.PointCloud(
        torch.stack([c.xyz for c in clouds]), torch.stack([c.mask for c in clouds])
    )


def jitter(pc: tpcl.PointCloud, sigma: float, seed: int) -> tpcl.PointCloud:
    """Add isotropic N(0, sigma^2) noise to every valid point. The
    raycaster's beams at azimuth 0 and +-pi/2 put whole columns of
    points within an ulp of the x = 0 and y = 0 voxel faces, where the
    two packages' rounding decides the cell; a millimetre of noise
    moves them off the faces."""
    rng = np.random.default_rng(seed)
    noise = torch.from_numpy(rng.normal(0.0, sigma, pc.xyz.shape).astype(np.float32))
    return tpcl.park(tpcl.PointCloud(pc.xyz + noise, pc.mask))


def structured_cloud(seed: int, n: int = 2048) -> tpcl.PointCloud:
    """Ground plane + two walls + noise near the origin: enough
    structure to constrain all 6 dof (the reference tests' cloud, drawn
    with numpy)."""
    rng = np.random.default_rng(seed)
    n4 = n // 4
    ground = np.concatenate(
        [rng.uniform(-10, 10, (n4 * 2, 2)), np.zeros((n4 * 2, 1))], axis=-1)
    wall1 = np.concatenate(
        [rng.uniform(-10, 10, (n4, 1)), np.full((n4, 1), 8.0),
         rng.uniform(0, 4, (n4, 1))], axis=-1)
    wall2 = np.concatenate(
        [np.full((n4, 1), -9.0), rng.uniform(-10, 10, (n4, 1)),
         rng.uniform(0, 4, (n4, 1))], axis=-1)
    xyz = np.concatenate([ground, wall1, wall2], axis=0)
    xyz = (xyz + 0.01 * rng.standard_normal(xyz.shape)).astype(np.float32)
    return tpcl.PointCloud(torch.from_numpy(xyz), torch.ones(xyz.shape[0], dtype=torch.bool))


def rot_err_deg(Ra, Rb) -> float:
    """Geodesic angle between two rotations (numpy or tensors), degrees."""
    M = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    c = np.clip((np.trace(M) - 1.0) / 2.0, -1.0, 1.0)
    return float(np.degrees(np.arccos(c)))


# --------------------------------------------------------------------------
# elevation / costmap state, both directions through numpy
# --------------------------------------------------------------------------


def emap_to_jax(m):
    from mr_slam_tpu.mapping import elevation as jel

    return jel.ElevationMap(*(to_jax(a) for a in m))


def emap_to_torch(m):
    from mr_slam_torch.mapping import elevation as tel

    return tel.ElevationMap(*(to_torch(a) for a in m))


def feats_to_jax(f):
    from mr_slam_tpu.mapping import elevation as jel

    return jel.TerrainFeatures(*(to_jax(a) for a in f))


def feats_to_torch(f):
    from mr_slam_torch.mapping import elevation as tel

    return tel.TerrainFeatures(*(to_torch(a) for a in f))


def color_to_jax(cg):
    from mr_slam_tpu.mapping import elevation as jel

    return jel.ColorGrid(*(to_jax(a) for a in cg))


def color_to_torch(cg):
    from mr_slam_torch.mapping import elevation as tel

    return tel.ColorGrid(*(to_torch(a) for a in cg))


def costmap_to_jax(cm):
    from mr_slam_tpu.mapping import costmap as jcm

    return jcm.Costmap(*(to_jax(a) for a in cm))


def costmap_to_torch(cm):
    from mr_slam_torch.mapping import costmap as tcm

    return tcm.Costmap(*(to_torch(a) for a in cm))


def slam_result_to_jax(res):
    """A minimal reference `SlamResult` holding the port result's
    keyframe stores, optimized poses and `node_of` — what the products
    of a finished run (`build_elevation`, `compose_map`) read."""
    from mr_slam_tpu.frontend import keyframes as jkf
    from mr_slam_tpu.runtime import pipeline as jpipe

    robots = []
    for rr in res.robots:
        s = rr.store
        store = jkf.KeyframeStore(
            xyz=to_jax(s.xyz), mask=to_jax(s.mask), poses=pose_to_jax(s.poses),
            stamps=to_jax(s.stamps), count=to_jax(s.count), last_pose=pose_to_jax(s.last_pose),
        )
        robots.append(jpipe.RobotResult(
            odom_poses=pose_to_jax(rr.odom_poses), store=store,
            kf_frame_idx=np.asarray(rr.kf_frame_idx),
        ))
    return jpipe.SlamResult(
        robots=robots, graph=None, opt_poses=pose_to_jax(res.opt_poses),
        node_of=np.asarray(res.node_of), loops=[],
    )


# --------------------------------------------------------------------------
# the reference session behind `chip_smoke.JAX_REF_ONLINE_ATE`
# --------------------------------------------------------------------------


def online_reference():
    """Run the reference's `OnlineSlam` (JAX on the CPU) over the stream
    and config of `chip_smoke.py` phase 7: phase 5's scans as one
    interleaved stream, GEM on, the reference launch's cadences. Returns
    (per-robot keyframe ATE in m, accepted inter-robot loops, accepted
    loops). Run from the repository root:

        JAX_PLATFORMS=cpu python -c "from tests.torch_parity import online_reference; \\
            print(online_reference())"
    """
    import chip_smoke
    from mr_slam_tpu.runtime import config as jcfg
    from mr_slam_tpu.runtime import online as jonline

    trajs, scans, cfg = chip_smoke.scenario()
    ocfg = chip_smoke.online_config(cfg)
    sess = jonline.OnlineSlam(jcfg.SlamConfig.from_json(ocfg.to_json()), enable_gem=True)
    for f in chip_smoke.online_frames(trajs, scans):
        if f.robot not in sess.robots:
            sess.register_robot(f.robot, pose_to_jax(f.origin))
        sess.add_frame(f.robot, cloud_to_jax(f.scan), stamp=f.stamp)
    res = sess.result()
    opt_t = np.asarray(res.opt_poses.t)
    ates = tuple(
        chip_smoke.online_ate((np.asarray(res.robots[r].store.stamps),
                               int(res.robots[r].store.count)), opt_t, res.node_of[r], trajs[r], r)
        for r in range(len(trajs))
    )
    inter = sum(l["robot_a"] != l["robot_b"] for l in res.loops)
    return ates, inter, len(res.loops)


# --------------------------------------------------------------------------
# the references behind `chip_smoke.JAX_REF_RING_*` and `JAX_REF_RECALL`
# --------------------------------------------------------------------------


def ring_reference():
    """Run the reference's `pipeline.run` (JAX on the CPU) on the scans of
    `chip_smoke.py` phase 5 under `chip_smoke.ring_config`. Returns
    (per-robot keyframe ATE in m, accepted inter-robot loops). Run from
    the repository root:

        JAX_PLATFORMS=cpu python -c "from tests.torch_parity import ring_reference; \\
            print(ring_reference())"
    """
    import chip_smoke
    from mr_slam_tpu.eval import metrics as jmet
    from mr_slam_tpu.runtime import config as jcfg
    from mr_slam_tpu.runtime import pipeline as jpipe

    trajs, scans, cfg = chip_smoke.scenario()
    rcfg = jcfg.SlamConfig.from_json(chip_smoke.ring_config(cfg).to_json())
    res = jpipe.run([cloud_to_jax(s) for s in scans], rcfg,
                    origins=[pose_to_jax(tse3.index(t, 0)) for t in trajs])
    ates = tuple(
        float(jmet.ate(res.optimized_trajectory(r), pose_to_jax(
            tse3.index(trajs[r], torch.as_tensor(res.robots[r].kf_frame_idx)))).rmse)
        for r in range(len(trajs)))
    return ates, sum(l["robot_a"] != l["robot_b"] for l in res.loops)


def recall_reference():
    """recall@1 of the reference's `recall_harness.evaluate_method` (JAX on
    the CPU) for every method on `chip_smoke.recall_set()`, with the
    protocol of `chip_smoke.py` phase 8. Run from the repository root:

        JAX_PLATFORMS=cpu python -c "from tests.torch_parity import recall_reference; \\
            print(recall_reference())"
    """
    import chip_smoke
    from mr_slam_tpu.eval import recall_harness as jrh

    clouds, positions = chip_smoke.recall_set()
    jc, jp = cloud_to_jax(clouds), to_jax(positions)
    return {m: float(jrh.evaluate_method(m, jc, jp, radius=chip_smoke.RECALL_RADIUS,
                                         min_separation=chip_smoke.RECALL_MIN_SEP,
                                         max_n=chip_smoke.RECALL_MAX_N).recall_at_n[0])
            for m in chip_smoke.DESC_METHODS}
