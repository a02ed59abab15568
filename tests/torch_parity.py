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


def rest_then_circle(n_rest: int, n: int, **circle) -> tse3.Pose:
    """`n_rest` frames standing at the circle's first pose, then the
    circle's `n` frames: a LIO filter starts at rest (v = 0), so its
    truth must too (the reference's undistortion tests do the same)."""
    c = synthetic.circle_trajectory(n, **circle)
    return tse3.Pose(torch.cat([c.R[:1].expand(n_rest, 3, 3), c.R]),
                     torch.cat([c.t[:1].expand(n_rest, 3), c.t]))


def imu_to_jax(imu):
    return tuple(to_jax(x) for x in imu)


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


def room(seed: int, n_plane: int, n_line: int):
    """(planar points, line points) as CPU tensors: a floor, two walls
    and four poles within 10 m of the origin, 5 mm of noise. Near the
    origin a point-to-plane / point-to-line GN system is well
    conditioned; on a scan's points 25 m out one ulp of summation order
    moves its fixed point by millimetres."""
    rng = np.random.default_rng(seed)
    h = n_plane // 2
    floor = np.c_[rng.uniform(-10, 10, (n_plane, 2)), np.zeros(n_plane)]
    wall1 = np.c_[rng.uniform(-10, 10, h), np.full(h, 8.0), rng.uniform(0, 4, h)]
    wall2 = np.c_[np.full(h, -9.0), rng.uniform(-10, 10, h), rng.uniform(0, 4, h)]
    poles = [np.c_[np.full((n_line, 2), p), rng.uniform(1.5, 6.0, n_line)]
             for p in ((3.0, 3.0), (-4.0, 5.0), (5.0, -6.0), (-6.0, -3.0))]
    planes = np.concatenate([floor, wall1, wall2])
    lines = np.concatenate(poles)
    return [torch.from_numpy((x + 0.005 * rng.standard_normal(x.shape)).astype(np.float32))
            for x in (planes, lines)]


def rot_diff_deg(Ra, Rb) -> float:
    """Angle of Ra Rb^T in degrees from its skew part, in float64: exact
    for small angles, where the trace's arccos (`rot_err_deg`) loses
    ~0.03 degrees to float32 orthonormality."""
    M = np.asarray(Ra, np.float64) @ np.asarray(Rb, np.float64).T
    w = np.array([M[2, 1] - M[1, 2], M[0, 2] - M[2, 0], M[1, 0] - M[0, 1]]) / 2.0
    return float(np.degrees(np.arcsin(min(np.linalg.norm(w), 1.0))))


def flax_to_state_dict(tree) -> dict:
    """A flax DiscoNet parameter or gradient tree as the port's
    `state_dict` names and layouts (`disco_net.state_dict_from_flax`),
    so each leaf compares with the port parameter's `.grad`."""
    import jax

    from mr_slam_torch.loop import disco_net

    return disco_net.state_dict_from_flax(jax.tree.map(np.asarray, tree))


def graph_to_numpy(g) -> dict:
    """The valid content of a factor graph of either package as numpy
    arrays (node and edge counts as ints)."""
    n, e = int(g.n_nodes), int(g.n_edges)
    host = (lambda x: x.detach().cpu().numpy()) if isinstance(g.poses.t, torch.Tensor) \
        else np.asarray
    return dict(
        capacity=(g.node_capacity, g.edge_capacity), n_nodes=n, n_edges=e,
        R=host(g.poses.R)[:n], t=host(g.poses.t)[:n], robot=host(g.node_robot)[:n],
        edge_i=host(g.edge_i)[:e], edge_j=host(g.edge_j)[:e], meas_R=host(g.edge_meas.R)[:e],
        meas_t=host(g.edge_meas.t)[:e], kind=host(g.edge_kind)[:e],
        w_rot=host(g.edge_w_rot)[:e], w_trans=host(g.edge_w_trans)[:e],
    )


def graph_to_torch(g, device="cpu"):
    """A reference `FactorGraph` as the port's, through numpy."""
    from mr_slam_torch.backend import factor_graph as tfg

    a = graph_to_numpy(g)
    tg = tfg.init(*a["capacity"], device)
    tg, _ = tfg.add_nodes_batch(tg, tse3.Pose(to_torch(a["R"]).to(device), to_torch(a["t"]).to(device)),
                                to_torch(a["robot"]).to(device))
    tg, _ = tfg.add_edges_batch(
        tg, to_torch(a["edge_i"]).to(device), to_torch(a["edge_j"]).to(device),
        tse3.Pose(to_torch(a["meas_R"]).to(device), to_torch(a["meas_t"]).to(device)),
        to_torch(a["kind"]).to(device), to_torch(a["w_rot"]).to(device),
        to_torch(a["w_trans"]).to(device))
    return tg


def graph_astype(g, dtype):
    """A port `FactorGraph` with its poses, measurements and weights in
    `dtype` (a float32 graph cast to float64 keeps its values)."""
    P = type(g.poses)
    return g._replace(poses=P(g.poses.R.to(dtype), g.poses.t.to(dtype)),
                      edge_meas=P(g.edge_meas.R.to(dtype), g.edge_meas.t.to(dtype)),
                      edge_w_rot=g.edge_w_rot.to(dtype), edge_w_trans=g.edge_w_trans.to(dtype))


def graph_to_jax(g, dtype=None):
    """A port `FactorGraph` (or `graph_to_numpy`'s arrays) as the
    reference's, through numpy; its float arrays in `dtype` when given
    (float64 needs JAX's x64 mode)."""
    import jax
    import jax.numpy as jnp

    from mr_slam_tpu.backend import factor_graph as jfg
    from mr_slam_tpu.geometry import se3 as jse3

    a = g if isinstance(g, dict) else graph_to_numpy(g)
    jg = jfg.init(*(int(c) for c in a["capacity"]))
    if dtype is not None:
        jg = jax.tree.map(lambda x: x.astype(dtype) if jnp.issubdtype(x.dtype, jnp.floating)
                          else x, jg)
        a = {k: (v.astype(dtype) if isinstance(v, np.ndarray) and v.dtype.kind == "f" else v)
             for k, v in a.items()}
    jg, _ = jfg.add_nodes_batch(jg, jse3.Pose(jnp.asarray(a["R"]), jnp.asarray(a["t"])),
                                jnp.asarray(a["robot"], jnp.int32))
    jg, _ = jfg.add_edges_batch(
        jg, jnp.asarray(a["edge_i"], jnp.int32), jnp.asarray(a["edge_j"], jnp.int32),
        jse3.Pose(jnp.asarray(a["meas_R"]), jnp.asarray(a["meas_t"])),
        jnp.asarray(a["kind"], jnp.int32), jnp.asarray(a["w_rot"]), jnp.asarray(a["w_trans"]))
    return jg


def grid_to_jax(g):
    from mr_slam_tpu.ops import voxel_grid as jvg

    return jvg.VoxelGrid(to_jax(g.packed), to_jax(np.float32(g.leaf)))


def lio_state_to_jax(s):
    """A port `LioState` as the reference's (the host frame count as its
    int32 scalar)."""
    import jax.numpy as jnp
    from mr_slam_tpu.frontend import lio as jlio

    arrays = {f: to_jax(getattr(s, f)) for f in s._fields if f not in ("grid", "frame")}
    return jlio.LioState(**arrays, grid=grid_to_jax(s.grid), frame=jnp.int32(s.frame))


def lio_state_to_torch(s):
    from mr_slam_torch.frontend import lio as tlio
    from mr_slam_torch.ops import voxel_grid as tvg

    tensors = {f: to_torch(getattr(s, f)) for f in s._fields if f not in ("grid", "frame")}
    return tlio.LioState(**tensors, grid=tvg.VoxelGrid(to_torch(s.grid.packed), float(s.grid.leaf)),
                         frame=int(s.frame))


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


# --------------------------------------------------------------------------
# the references behind `chip_smoke.JAX_REF_LIO_*`, `JAX_REF_S2M_*`, `JAX_REF_FEAT`
# --------------------------------------------------------------------------


def lio_reference(part: str = "all"):
    """The reference's runs (JAX on the CPU) over the inputs of
    `chip_smoke.py` phase 9 (`chip_smoke.lio_scenario`). `part`: "lio"
    (the LIO `pipeline.run` with IMU packets and point times: per-robot
    keyframe ATE in m and inter-robot loops), "s2m" (the odometry ATE
    of scan2map on the start-sheared scans with point times, per copy of
    the scans moved by +-1 ulp, `chip_smoke.ulp_moved`, and robot, then
    the median per robot; with it "s2m_raw", without the times),
    "online" (the LIO session fed by `synthetic_bag(with_imu=True)`:
    per-robot keyframe ATE), "feat"
    (feature odometry over robot 0's range images: ATE and final error),
    or "all". Run from the repository root, one part per process if the
    CPU is shared (each takes minutes):

        JAX_PLATFORMS=cpu python -c "from tests.torch_parity import lio_reference; \\
            print(lio_reference('lio'))"
    """
    import chip_smoke
    from mr_slam_tpu.runtime import config as jcfg
    from mr_slam_tpu.runtime import pipeline as jpipe

    out = {}
    base = chip_smoke.smoke_config()
    if part in ("lio", "s2m", "online", "all"):
        sc = chip_smoke.lio_scenario()
        origins = [pose_to_jax(tse3.index(t, 0)) for t in sc["trajs"]]

    def kf_ates(res):
        from mr_slam_tpu.eval import metrics as jmet

        return tuple(
            float(jmet.ate(res.optimized_trajectory(r), pose_to_jax(
                tse3.index(sc["trajs"][r], torch.as_tensor(res.robots[r].kf_frame_idx)))).rmse)
            for r in range(len(sc["trajs"])))

    if part in ("lio", "all"):
        lcfg = jcfg.SlamConfig.from_json(chip_smoke.lio_config(base).to_json())
        res = jpipe.run([cloud_to_jax(s) for s in sc["lio"]], lcfg, origins=origins,
                        imus=[imu_to_jax(i) for i in sc["imus"]],
                        times_per_robot=[to_jax(t) for t in sc["lio_times"]])
        out["lio"] = (kf_ates(res), sum(l["robot_a"] != l["robot_b"] for l in res.loops))
    if part in ("s2m", "all"):
        scfg = jcfg.SlamConfig.from_json(base.to_json())

        def odo_ate(r, seed, times):
            rr = jpipe.run_frontend(cloud_to_jax(chip_smoke.ulp_moved(sc["s2m"][r], seed, "cpu")),
                                    scfg.for_robot(r), origins[r],
                                    times=None if times is None else to_jax(times[r]))
            return chip_smoke.positions_ate(np.asarray(rr.odom_poses.t), sc["trajs"][r])

        R = len(sc["trajs"])
        copies = tuple(tuple(odo_ate(r, seed, sc["s2m_times"]) for r in range(R))
                       for seed in range(chip_smoke.S2M_ULP_COPIES + 1))
        out["s2m"] = (copies, tuple(float(np.median([c[r] for c in copies])) for r in range(R)))
        out["s2m_raw"] = tuple(odo_ate(r, 0, None) for r in range(R))
    if part in ("online", "all"):
        from mr_slam_torch.datasets import replay as trep
        from mr_slam_tpu.datasets import replay as jrep
        from mr_slam_tpu.runtime import online as jonline

        frames = trep.synthetic_bag(synthetic.default_world(chip_smoke.LIO_WORLD), sc["trajs"],
                                    chip_smoke.LIO_FRAMES, n_rings=chip_smoke.RINGS,
                                    n_azimuth=chip_smoke.AZIMUTH, with_imu=True,
                                    imu_sub=chip_smoke.LIO_IMU_SUB)
        ocfg = chip_smoke.online_config(chip_smoke.lio_config(base))
        sess = jonline.OnlineSlam(jcfg.SlamConfig.from_json(ocfg.to_json()))
        jrep.replay([jrep.Frame(stamp=f.stamp, robot=f.robot, scan=cloud_to_jax(f.scan),
                                origin=None if f.origin is None else pose_to_jax(f.origin),
                                imu=None if f.imu is None else imu_to_jax(f.imu)) for f in frames],
                    sess)
        res = sess.result()
        opt_t = np.asarray(res.opt_poses.t)
        out["online"] = tuple(
            chip_smoke.online_ate((np.asarray(res.robots[r].store.stamps),
                                   int(res.robots[r].store.count)), opt_t, res.node_of[r],
                                  sc["trajs"][r], r)
            for r in range(len(sc["trajs"])))
    if part in ("feat", "all"):
        from mr_slam_tpu.frontend import feature_odometry as jfo
        from mr_slam_tpu.frontend import odometry as jodo

        traj, clean = chip_smoke.feature_scenario()
        xyz, hit = chip_smoke.range_images(clean, "cpu")
        _, poses, _ = jfo.run(to_jax(xyz), to_jax(hit), jodo.OdometryConfig(),
                              pose_to_jax(tse3.index(traj, 0)))
        out["feat"] = (chip_smoke.positions_ate(np.asarray(poses.t), traj),
                       float(np.linalg.norm(np.asarray(poses.t[-1]) - traj.t[-1].numpy())))
    return out


def s2m_ulp_reference(robots=(0, 1, 2), seeds=range(9), frames=None, laps=None):
    """The reference's side of `s2m_chaos.py ensemble` (JAX on the CPU):
    scan2map `run_frontend` with point times on `chip_smoke.lio_scenario`'s
    start-sheared scans as given (seed 0) and moved by +-1 ulp
    (`chip_smoke.ulp_moved`), on the road reshaped to `frames` / `laps`
    when they are given. Returns {(robot, seed): (odometry ATE, largest
    error, its frame)}:

        JAX_PLATFORMS=cpu python -c "from tests.torch_parity import s2m_ulp_reference; \\
            print(s2m_ulp_reference((2,), range(12), 28, 0.48))"
    """
    import chip_smoke
    from mr_slam_tpu.runtime import config as jcfg
    from mr_slam_tpu.runtime import pipeline as jpipe

    if frames is not None:
        chip_smoke.LIO_FRAMES, chip_smoke.LIO_LAPS = frames, laps
    sc = chip_smoke.lio_scenario()
    cfg = jcfg.SlamConfig.from_json(chip_smoke.smoke_config().to_json())
    out = {}
    for r in robots:
        traj = sc["trajs"][r]
        for seed in seeds:
            rr = jpipe.run_frontend(cloud_to_jax(chip_smoke.ulp_moved(sc["s2m"][r], seed, "cpu")),
                                    cfg.for_robot(r), pose_to_jax(tse3.index(traj, 0)),
                                    times=to_jax(sc["s2m_times"][r]))
            est = np.asarray(rr.odom_poses.t)
            e = np.linalg.norm(est - traj.t.numpy(), axis=-1)
            out[(r, seed)] = (chip_smoke.positions_ate(est, traj), float(e.max()), int(e.argmax()))
    return out


def lio_phase5_reference():
    """The reference's LIO `pipeline.run` (JAX on the CPU) on phase 5's
    road instead of phase 9's: `chip_smoke.lio_scenario` over the
    trajectories of `chip_smoke.scenario()` in its world, phase 9's LIO
    config. Returns (keyframe ATE, odometry ATE) per robot in m and the
    inter-robot loops; the reason phase 9 has a road of its own."""
    import chip_smoke
    from mr_slam_tpu.eval import metrics as jmet
    from mr_slam_tpu.runtime import config as jcfg
    from mr_slam_tpu.runtime import pipeline as jpipe

    trajs, _, base = chip_smoke.scenario()
    sc = chip_smoke.lio_scenario(chip_smoke.WORLD_SEED, trajs)
    cfg = jcfg.SlamConfig.from_json(chip_smoke.lio_config(base).to_json())
    res = jpipe.run([cloud_to_jax(s) for s in sc["lio"]], cfg,
                    origins=[pose_to_jax(tse3.index(t, 0)) for t in trajs],
                    imus=[imu_to_jax(i) for i in sc["imus"]],
                    times_per_robot=[to_jax(t) for t in sc["lio_times"]])
    kf = tuple(float(jmet.ate(res.optimized_trajectory(r), pose_to_jax(
        tse3.index(t, torch.as_tensor(res.robots[r].kf_frame_idx)))).rmse)
        for r, t in enumerate(trajs))
    odo = tuple(chip_smoke.positions_ate(np.asarray(rr.odom_poses.t), t)
                for rr, t in zip(res.robots, trajs))
    return kf, odo, sum(l["robot_a"] != l["robot_b"] for l in res.loops)


# --------------------------------------------------------------------------
# the reference behind `chip_smoke.JAX_REF_LONGRUN` and `test_torch_longrun`
# --------------------------------------------------------------------------


def longrun_config_jax(R: int):
    """The reference long run's `SlamConfig`, built as
    `examples/bench_longrun.py:44-55` builds it."""
    from mr_slam_tpu.runtime.config import KeyframeCfg, LoopCfg, OdometryCfg, PGOCfg, SlamConfig

    return SlamConfig(
        n_robots=R,
        odometry=OdometryCfg(scan_capacity=8192, insert_capacity=16384),
        keyframes=KeyframeCfg(dist_thresh=2.0, capacity=256, points_per_kf=4096),
        loops=LoopCfg(dist_thresh=0.75, min_separation=8, candidates=2,
                      fitness_thresh=0.15, max_loops=256),
        pgo=PGOCfg(rot_cg_iters=120, gn_iters=30, pose_cg_iters=120,
                   node_capacity=1024, edge_capacity=4096),
    )


def longrun_reference(T: int = 120, rings: int = 64, azimuth: int = 1024, R: int = 3):
    """The reference's `pipeline.run` (JAX on the CPU) on the port's numpy
    scans of `bench_longrun.scenario(T, R, rings, azimuth)` with the long
    run's config. Returns (per-robot
    keyframe ATE in m, keyframe counts, inter-robot loops, loops). Run
    from the repository root (`chip_smoke.JAX_REF_LONGRUN`):

        JAX_PLATFORMS=cpu python -c "from tests.torch_parity import longrun_reference; \\
            print(longrun_reference(120))"
    """
    from mr_slam_torch.examples import bench_longrun
    from mr_slam_tpu.eval import metrics as jmet
    from mr_slam_tpu.runtime import pipeline as jpipe

    trajs, scans = bench_longrun.scenario(T, R, rings, azimuth)
    res = jpipe.run([cloud_to_jax(s) for s in scans], longrun_config_jax(len(trajs)),
                    origins=[pose_to_jax(tse3.index(t, 0)) for t in trajs])
    ates = tuple(float(jmet.ate(res.optimized_trajectory(r), pose_to_jax(
        tse3.index(t, torch.as_tensor(res.robots[r].kf_frame_idx)))).rmse)
        for r, t in enumerate(trajs))
    kfs = tuple(int(rr.store.count) for rr in res.robots)
    return ates, kfs, sum(l["robot_a"] != l["robot_b"] for l in res.loops), len(res.loops)


# --------------------------------------------------------------------------
# the reference behind `chip_smoke.JAX_REF_GS_PGO`
# --------------------------------------------------------------------------


def gs_pgo_reference() -> dict:
    """Gauss-Seidel at `GSConfig()` on phase 10's 510-node graph, the
    port's `graphgen.multi_robot_graph(**chip_smoke.PGO_GRAPH)` drawn on
    the CPU: the ATE (m) of the reference's `gauss_seidel.optimize` (JAX
    on the CPU, the graph carried across through numpy), of the port's
    eager solve, of the port's chordal solve at `chip_smoke.PGO_FULL`,
    and of the odometry. Run from the repository root:

        JAX_PLATFORMS=cpu python -c "from tests.torch_parity import gs_pgo_reference; \\
            print(gs_pgo_reference())"
    """
    import jax.numpy as jnp

    import chip_smoke
    from mr_slam_torch.backend import chordal, gauss_seidel
    from mr_slam_torch.eval import graphgen
    from mr_slam_tpu.backend import gauss_seidel as jgs

    g, true, anchors, _ = graphgen.multi_robot_graph(**chip_smoke.PGO_GRAPH, device="cpu")
    n = int(g.n_nodes)

    def ate(t) -> float:
        d = np.asarray(t)[:n] - true.t.numpy()
        return float(np.sqrt(np.mean(np.sum(d * d, axis=-1))))

    R = chip_smoke.PGO_GRAPH["n_robots"]
    ref = jgs.optimize(graph_to_jax(g), jnp.asarray(anchors.numpy()), R, jgs.GSConfig())
    port = gauss_seidel._optimize_eager(g, anchors, R, gauss_seidel.GSConfig())
    cen = chordal._optimize_eager(g, anchors, chordal.PGOConfig(**chip_smoke.PGO_FULL))
    return dict(reference=ate(ref.t), port=ate(port.t), chordal=ate(cen.t),
                odometry=ate(g.poses.t))
