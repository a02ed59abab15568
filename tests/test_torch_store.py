"""The batched multi-robot keyframe store (`parallel/store.py`) of the
port against the reference's: `init`, `ingest`, `gate_and_add` and
`write_descriptor` give leaf-for-leaf the same arrays (exactly: the
voxel downsample agrees bit for bit), the online session's row growth
by doubling lays the store out as the reference's does, and
`robot_view` reads one row (a view the next write changes)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.parallel import store as tstore
from mr_slam_torch.runtime import checkpoint as tckpt
from mr_slam_torch.runtime import config as tcfg
from mr_slam_torch.runtime import online as tonline
from mr_slam_torch.runtime import pipeline as tpipe
from mr_slam_tpu.parallel import store as jstore
from mr_slam_tpu.runtime import config as jcfg
from mr_slam_tpu.runtime import online as jonline
from mr_slam_tpu.runtime import pipeline as jpipe
from tests.torch_parity import cloud_to_jax, jitter, make_scans, pose_to_jax, to_jax

R, K, P = 3, 6, 1024


def assert_same_leaves(port, ref):
    """Leaf-for-leaf equality in the reference's leaf order."""
    pl = [v for _, v in tckpt.flatten(port)]
    jl = jax.tree_util.tree_leaves(ref)
    assert len(pl) == len(jl)
    for i, (a, b) in enumerate(zip(pl, jl)):
        a = tckpt.to_numpy(a)
        b = np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, (i, a.shape, b.shape, a.dtype, b.dtype)
        np.testing.assert_array_equal(a, b, err_msg=f"leaf {i}")


@pytest.fixture(scope="module")
def frames():
    world = synthetic.default_world(0)
    traj = synthetic.circle_trajectory(8, radius=10.0, laps=0.2)
    scans = jitter(make_scans(world, traj, 8, seed=3, n_rings=16, n_azimuth=256), 0.002, 4)
    return traj, scans


def template():
    dummy = tpcl.park(tpcl.PointCloud(torch.zeros((P, 3)), torch.zeros(P, dtype=torch.bool)))
    return tpipe.describe_one(dummy, tcfg.SlamConfig())


def test_init_matches_reference():
    t = tstore.init(R, K, P, desc_template=template())
    jt = jpipe.describe_one(cloud_to_jax(tpcl.park(tpcl.PointCloud(
        torch.zeros((P, 3)), torch.zeros(P, dtype=torch.bool)))), jcfg.SlamConfig())
    assert_same_leaves(t, jstore.init(R, K, P, desc_template=jt))
    flat = tstore.init(R, K, P, desc_dim=7)
    assert_same_leaves(flat, jstore.init(R, K, P, desc_dim=7))
    assert flat.n_robots == R and flat.kf_capacity == K


def test_gate_and_add_and_write_descriptor_match_reference(frames):
    """Frames gated into rows 1 and 2 alternately, each kept keyframe
    described by the port and written, against the reference's jitted
    pair."""
    traj, scans = frames
    cfg = tcfg.SlamConfig()
    t = tstore.init(R, K, P, desc_template=template())
    j = jstore.init(R, K, P, desc_template={k: to_jax(v) for k, v in template().items()})
    for i in range(8):
        row = 1 + i % 2
        cloud = tpcl.PointCloud(scans.xyz[i], scans.mask[i])
        pose = tse3.index(traj, i)
        stamp = torch.tensor(0.1 * i)
        t, added, slot = tstore.gate_and_add(t, row, cloud, pose, stamp, dist_thresh=1.0, leaf=0.2)
        j, jadded, jslot = jstore.gate_and_add(j, jnp.int32(row), cloud_to_jax(cloud),
                                               pose_to_jax(pose), to_jax(stamp),
                                               dist_thresh=1.0, leaf=0.2)
        assert bool(added) == bool(jadded) and int(slot) == int(jslot)
        if bool(added):
            store, _ = t.robot_view(row)
            one = tpipe.describe_one(store.cloud(int(slot)), cfg)
            t = tstore.write_descriptor(t, row, int(slot), one)
            # the same descriptor into both stores (describing is held by
            # `test_torch_loopstage`; its sums part by an ulp here and there)
            jone = {k: to_jax(v) for k, v in one.items()}
            j = jstore.write_descriptor(j, jnp.int32(row), jslot, jone)
    assert int(t.stores.count.sum()) >= 4
    assert_same_leaves(t, j)


def test_ingest_matches_reference(frames):
    traj, scans = frames
    t = tstore.init(2, 2, P, desc_dim=5)
    j = jstore.init(2, 2, P, desc_dim=5)
    rng = np.random.default_rng(0)
    for i in range(3):  # the third write overflows row 0 (capacity 2)
        xyz = scans.xyz[i][:P].contiguous()
        mask = scans.mask[i][:P].contiguous()
        pose = tse3.index(traj, i)
        desc = torch.from_numpy(rng.normal(size=5).astype(np.float32))
        t = tstore.ingest(t, 0, xyz, mask, pose, torch.tensor(0.5 * i), desc)
        j = jstore.ingest(j, jnp.int32(0), to_jax(xyz), to_jax(mask), pose_to_jax(pose),
                          jnp.float32(0.5 * i), to_jax(desc))
    assert int(t.stores.count[0]) == 2
    assert_same_leaves(t, j)


def test_cross_robot_distances_match_reference():
    rng = np.random.default_rng(1)
    t = tstore.init(2, 4, 8, desc_dim=6)
    db = rng.normal(size=(2, 4, 6)).astype(np.float32)
    valid = rng.random((2, 4)) > 0.3
    t = t._replace(descriptors=torch.from_numpy(db), desc_valid=torch.from_numpy(valid))
    j = jstore.init(2, 4, 8, desc_dim=6)._replace(descriptors=jnp.asarray(db),
                                                 desc_valid=jnp.asarray(valid))
    q = rng.normal(size=(2, 3, 6)).astype(np.float32)
    out = tstore.cross_robot_distances(t, torch.from_numpy(q))
    ref = np.asarray(jstore.cross_robot_distances(j, jnp.asarray(q)))
    assert out.shape == (2, 3, 2, 4)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5, atol=1e-5)
    with pytest.raises(NotImplementedError, match="step 15"):
        tstore.cross_robot_distances(t, torch.from_numpy(q), axis_name="robot")


def test_row_growth_matches_reference():
    """Registering robots 5, 2, 9 allocates rows 0, 1, 2 in 1, 2, 4
    allocated rows; spare rows hold a fresh store."""
    cfg_t = tcfg.SlamConfig(keyframes=tcfg.KeyframeCfg(capacity=4, points_per_kf=256))
    cfg_j = jcfg.SlamConfig(keyframes=jcfg.KeyframeCfg(capacity=4, points_per_kf=256))
    port = tonline.OnlineSlam(cfg_t, device="cpu")
    ref = jonline.OnlineSlam(cfg_j)
    for robot, allocated in ((5, 1), (2, 2), (9, 4)):
        port.register_robot(robot)
        ref.register_robot(robot)
        assert port.mstore.n_robots == ref.mstore.n_robots == allocated
    assert port.rows == ref.rows == {5: 0, 2: 1, 9: 2}
    assert_same_leaves(port.mstore, ref.mstore)


def test_robot_view_is_a_view_of_its_row(frames):
    traj, scans = frames
    t = tstore.init(2, K, P, desc_template=template())
    store, descs = t.robot_view(1)
    assert store.xyz.shape == (K, P, 3) and set(descs) == {"sc", "key"}
    t, added, slot = tstore.gate_and_add(t, 1, tpcl.PointCloud(scans.xyz[0], scans.mask[0]),
                                         tse3.index(traj, 0), torch.tensor(0.0), 1.0, 0.2)
    assert bool(added) and int(slot) == 0
    assert int(store.count) == 1  # the earlier view sees the write
    assert bool(store.mask[0].any())
    assert int(t.stores.count[0]) == 0 and not bool(t.stores.mask[0].any())
