"""The general registration paths of the port against the reference on
the same inputs: VGICP with direct7 / direct27 neighbours, with and
without source covariances (the matrix path beside the fused direct1
kernel path), point-to-point ICP, GICP, the refusal of a `schedule` off
direct1, and `pipeline._verify_loop`.

Single registrations are held to 1e-4 m / 1e-4 rad on scenes near the
origin (`torch_parity.room`, `structured_cloud`), where the 6x6 GN
system is well conditioned and an ulp of summation order does not move
the fixed point; both packages start from the same init."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.frontend import keyframes as tkf
from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_torch.ops import pointcloud as tpcl, registration as treg, voxel_grid as tvg
from mr_slam_torch.runtime import loopstage as tls, pipeline as tpipe
from mr_slam_torch.runtime.config import KeyframeCfg, LoopCfg, SlamConfig
from mr_slam_tpu.frontend import keyframes as jkf
from mr_slam_tpu.geometry import se3 as jse3
from mr_slam_tpu.ops import registration as jreg
from mr_slam_tpu.runtime import pipeline as jpipe
from mr_slam_tpu.runtime.config import KeyframeCfg as JKeyframeCfg
from mr_slam_tpu.runtime.config import LoopCfg as JLoopCfg
from mr_slam_tpu.runtime.config import SlamConfig as JSlamConfig
from tests.torch_parity import (
    cloud_to_jax, grid_to_jax, make_scans, pose_to_jax, room, rot_diff_deg, rot_err_deg,
    structured_cloud, to_jax,
)

T_TOL = 1e-4      # m
R_TOL = 1e-4      # rad
TRUE = tse3.Pose(tso3.exp(torch.tensor([0.01, -0.02, 0.04])), torch.tensor([0.2, -0.1, 0.05]))
SECOND = tse3.Pose(tso3.exp(torch.tensor([-0.02, 0.01, -0.06])), torch.tensor([-0.3, 0.15, 0.0]))


def assert_pose_close(pt, pj, t_tol=T_TOL, r_tol=R_TOL):
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=t_tol, rtol=0)
    assert np.radians(rot_diff_deg(pt.R.numpy(), np.asarray(pj.R))) < r_tol


@pytest.fixture(scope="module")
def room_pair():
    """Two (source, target-grid) pairs on the room scene, moved by TRUE
    and SECOND, batched as B = 2, with the sources' regularized
    covariances."""
    planes, lines = room(0, 2000, 100)
    target = tpcl.make(torch.cat([planes, lines]))
    grid = tvg.build(target, 0.5, 1 << 13, min_points=3, regularize="plane")
    srcs = [tpcl.transform(target, tse3.inverse(p)) for p in (TRUE, SECOND)]
    covs = [treg._regularized_covs(s, 10)[0] for s in srcs]
    src = tpcl.PointCloud(torch.stack([s.xyz for s in srcs]), torch.stack([s.mask for s in srcs]))
    return src, tvg.VoxelGrid(torch.stack([grid.packed] * 2), grid.leaf), torch.stack(covs), grid


@pytest.mark.parametrize("covs", [False, True], ids=["no_covs", "source_covs"])
@pytest.mark.parametrize("neighbors", ["direct7", "direct27"])
def test_general_vgicp_matches_reference(room_pair, neighbors, covs):
    src, grids, source_covs, grid = room_pair
    res = treg.vgicp(src, grids, tse3.identity((2,)),
                     source_covs=source_covs if covs else None, neighbors=neighbors, iters=20)
    assert res.pose.t.shape == (2, 3)
    for k, true in enumerate((TRUE, SECOND)):
        sk = tpcl.PointCloud(src.xyz[k], src.mask[k])
        ref = jreg.vgicp(cloud_to_jax(sk), grid_to_jax(grid), jse3.identity(),
                         source_covs=to_jax(source_covs[k]) if covs else None,
                         neighbors=neighbors, iters=20)
        assert_pose_close(tse3.index(res.pose, k), ref.pose)
        # with source covariances one point sits on the 1 m gate and
        # counts in one package only (2585 against 2584 inliers); as it
        # is weighted ~1e3 along its snapped plane's normal, the mean
        # cost then parts by 1.4e-4 relative: held to 3e-4, not 1e-4
        assert abs(float(res.num_inliers[k]) - float(ref.num_inliers)) <= (1 if covs else 0)
        np.testing.assert_allclose(float(res.error[k]), float(ref.error),
                                   rtol=3e-4 if covs else 1e-4)
        np.testing.assert_allclose(res.pose.t[k].numpy(), true.t.numpy(), atol=0.02)


def test_schedule_off_direct1_still_raises(room_pair):
    src, grids, source_covs, _ = room_pair
    with pytest.raises(NotImplementedError):
        treg.vgicp(src, grids, tse3.identity((2,)), neighbors="direct7", schedule=((5, 1),))
    with pytest.raises(NotImplementedError):
        treg.vgicp(src, grids, tse3.identity((2,)), source_covs=source_covs,
                   schedule=((5, 1),))


@pytest.mark.parametrize("method", ["point_to_point_icp", "gicp"])
def test_icp_and_gicp_match_reference(method):
    target = structured_cloud(3, 1536)
    source = tpcl.transform(target, tse3.inverse(TRUE))
    res = getattr(treg, method)(source, target, tse3.identity(), iters=20)
    ref = getattr(jreg, method)(cloud_to_jax(source), cloud_to_jax(target), jse3.identity(),
                                iters=20)
    assert_pose_close(res.pose, ref.pose)
    assert float(res.num_inliers) == float(ref.num_inliers)
    # converged costs are ~1e-10: compare them absolutely
    np.testing.assert_allclose(float(res.error), float(ref.error), atol=1e-8)
    np.testing.assert_allclose(res.pose.t.numpy(), TRUE.t.numpy(), atol=1e-3)


def test_regularized_covs_match_reference():
    pc = structured_cloud(4, 1024)
    C, v = treg._regularized_covs(pc, 10)
    jC, jv = jreg._regularized_covs(cloud_to_jax(pc), 10)
    np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
    np.testing.assert_allclose(C.numpy(), np.asarray(jC), atol=1e-4)


# `_verify_loop` on the revisit store of `tests/test_torch_loopstage.py`
CFG_KW = dict(
    keyframes=dict(dist_thresh=1.0, capacity=32, points_per_kf=4096),
    loops=dict(method="scancontext", dist_thresh=0.4, min_separation=4,
               candidates=2, verify_capacity=8192, fitness_thresh=0.3),
)
CFG = SlamConfig(keyframes=KeyframeCfg(**CFG_KW["keyframes"]), loops=LoopCfg(**CFG_KW["loops"]))
JCFG = JSlamConfig(keyframes=JKeyframeCfg(**CFG_KW["keyframes"]),
                   loops=JLoopCfg(**CFG_KW["loops"]))


@pytest.fixture(scope="module")
def circle_store():
    world = synthetic.default_world(3)
    n = 20
    traj = synthetic.circle_trajectory(n, radius=10.0, laps=1.0)
    scans = make_scans(world, traj, n, seed=0, n_rings=16, n_azimuth=512)
    store = tkf.init(32, 4096)
    for i in range(n):
        store, _ = tkf.maybe_add(
            store, tpcl.PointCloud(scans.xyz[i], scans.mask[i]), tse3.index(traj, i),
            torch.tensor(0.1 * i), dist_thresh=1.0, leaf=0.2,
        )
    jstore = jkf.KeyframeStore(
        xyz=to_jax(store.xyz), mask=to_jax(store.mask), poses=pose_to_jax(store.poses),
        stamps=to_jax(store.stamps), count=jnp.int32(int(store.count)),
        last_pose=pose_to_jax(store.last_pose))
    return store, jstore


@pytest.mark.parametrize("case", ["same_robot", "cross_yaw", "reject"])
def test_verify_loop_is_a_batch_of_one(circle_store, case):
    """Equal to `verify_chunk` at B = 1, and to the reference's
    `_verify_loop` within the loopstage bounds (1 cm, 0.1 deg, fitness
    0.05 on the same side of the gate)."""
    store, jstore = circle_store
    K = int(store.count)
    ia, ib, same = {"same_robot": (K - 1, 1, True), "cross_yaw": (K - 1, 0, False),
                    "reject": (K // 2, 1, False)}[case]
    ok, rel, fit = tpipe._verify_loop(store, ia, store, ib, 0.0, CFG, same_robot=same)
    crel, cfit = tls.verify_chunk(store, store, torch.tensor([ia]), torch.tensor([ib]),
                                  torch.zeros(1), CFG, same)
    assert torch.equal(rel.t, crel.t[0]) and torch.equal(rel.R, crel.R[0])
    assert fit == float(cfit[0]) and ok == (fit < CFG.loops.fitness_thresh)
    jok, jrel, jfit = jpipe._verify_loop(jstore, ia, jstore, ib, 0.0, JCFG, same_robot=same)
    assert bool(ok) == bool(jok)
    np.testing.assert_allclose(fit, jfit, atol=0.05)
    np.testing.assert_allclose(rel.t.numpy(), np.asarray(jrel.t), atol=0.01)
    assert rot_err_deg(rel.R.numpy(), np.asarray(jrel.R)) < 0.1
    if case != "reject":
        assert ok
