"""Artifacts of a finished run: the `so3` quaternion / RPY conversions,
g2o export and import (`eval/g2o.py`), PCD writing (`eval/pcd.py`) and
the reference-layout artifact tree (`runtime/persistence.py`), each
against the reference package on the same inputs.

Bounds: conversions within 1e-6; the g2o text, the keyframe `data`
files and the PCD bytes identical; the merged `map.pcd` (a voxel
downsample of the same clouds) the same points within 1e-5."""
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.backend import factor_graph as tfg
from mr_slam_torch.eval import g2o as tg2o
from mr_slam_torch.eval import pcd as tpcd
from mr_slam_torch.frontend import keyframes as tkf
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.geometry import so3 as tso3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import persistence as tpers
from mr_slam_torch.runtime import pipeline as tpipe
from mr_slam_tpu.backend import factor_graph as jfg
from mr_slam_tpu.eval import g2o as jg2o
from mr_slam_tpu.eval import pcd as jpcd
from mr_slam_tpu.geometry import so3 as jso3
from mr_slam_tpu.runtime import persistence as jpers
from tests.torch_parity import pose_to_jax, slam_result_to_jax, to_jax


def rotations(seed=0, n=64):
    """Random rotations plus the identity, half-turns about each axis
    and near half-turns (every branch of Shepperd's construction)."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(n, 3))
    special = np.array([[0, 0, 0], [np.pi, 0, 0], [0, np.pi, 0], [0, 0, np.pi],
                        [3.1, 0.1, 0], [0, 0.05, 3.13], [1e-4, 0, 0]])
    return tso3.exp(torch.as_tensor(np.concatenate([w, special]), dtype=torch.float32))


def test_quaternion_conversions_match_reference():
    R = rotations()
    q = tso3.rot_to_quat(R)
    np.testing.assert_allclose(q.numpy(), np.asarray(jso3.rot_to_quat(to_jax(R))), atol=1e-6)
    assert bool((q[:, 0] >= 0).all())
    back = tso3.quat_to_rot(q)
    np.testing.assert_allclose(back.numpy(), R.numpy(), atol=2e-6)
    qn = torch.as_tensor(np.random.default_rng(1).normal(size=(16, 4)), dtype=torch.float32)
    np.testing.assert_allclose(tso3.quat_to_rot(qn).numpy(),
                               np.asarray(jso3.quat_to_rot(to_jax(qn))), atol=1e-6)


def test_rpy_conversions_match_reference():
    rng = np.random.default_rng(2)
    rpy = torch.as_tensor(rng.uniform([-3, -1.5, -3], [3, 1.5, 3], (64, 3)), dtype=torch.float32)
    R = tso3.rpy_to_rot(rpy)
    np.testing.assert_allclose(R.numpy(), np.asarray(jso3.rpy_to_rot(to_jax(rpy))), atol=1e-6)
    out = tso3.rot_to_rpy(R)
    np.testing.assert_allclose(out.numpy(), np.asarray(jso3.rot_to_rpy(to_jax(R))), atol=1e-6)
    np.testing.assert_allclose(out.numpy(), rpy.numpy(), atol=1e-4)


def graph_to_jax(g):
    return jfg.FactorGraph(
        poses=pose_to_jax(g.poses), node_robot=to_jax(g.node_robot.to(torch.int32)),
        node_valid=to_jax(g.node_valid), n_nodes=jnp.int32(g.n_nodes),
        edge_i=to_jax(g.edge_i.to(torch.int32)), edge_j=to_jax(g.edge_j.to(torch.int32)),
        edge_meas=pose_to_jax(g.edge_meas), edge_kind=to_jax(g.edge_kind.to(torch.int32)),
        edge_w_rot=to_jax(g.edge_w_rot), edge_w_trans=to_jax(g.edge_w_trans),
        edge_valid=to_jax(g.edge_valid), n_edges=jnp.int32(g.n_edges),
    )


def small_result(K=3, P=96):
    """A port SlamResult of 2 robots x K keyframes of random clouds, a
    graph built node by node (odometry chains, one inter-robot and one
    intra-robot loop) and random optimized poses."""
    rng = np.random.default_rng(5)
    R = rotations(seed=6, n=2 * K)

    def pose(i):
        return tse3.Pose(R[i], torch.as_tensor(rng.normal(0, 5, 3), dtype=torch.float32))

    g = tfg.init(16, 32)
    robots, node_of = [], -np.ones((2, K), np.int64)
    for r in range(2):
        store = tkf.init(K + 1, P)
        store.xyz[:K] = torch.as_tensor(rng.normal(0, 8, (K, P, 3)), dtype=torch.float32)
        store.mask[:K] = torch.as_tensor(rng.random((K, P)) > 0.2)
        for k in range(K):
            p = pose(r * K + k)
            store.poses.R[k], store.poses.t[k] = p.R, p.t
            store.stamps[k] = 0.1 * k + 0.03 * r
            g, idx = tfg.add_node(g, p, r)
            node_of[r, k] = idx
            if k:
                meas = tse3.between(tse3.index(store.poses, k - 1), p)
                g, _ = tfg.add_edge(g, node_of[r, k - 1], idx, meas, tfg.ODOM, 1.0, 1.0)
        robots.append(tpipe.RobotResult(odom_poses=tse3.index(store.poses, K - 1),
                                        store=store._replace(count=torch.tensor(K)),
                                        kf_frame_idx=np.arange(K)))
    for (i, j, kind) in ((node_of[0, 2], node_of[1, 0], tfg.INTER_LOOP),
                         (node_of[0, 0], node_of[0, 2], tfg.INTRA_LOOP)):
        g, _ = tfg.add_edge(g, i, j, pose(0), kind, 10.0, 10.0)
    opt = tse3.Pose(rotations(seed=7, n=16)[:16],
                    torch.as_tensor(rng.normal(0, 5, (16, 3)), dtype=torch.float32))
    return tpipe.SlamResult(robots=robots, graph=g, opt_poses=opt, node_of=node_of, loops=[])


def test_add_node_and_add_edge_match_reference():
    res = small_result()
    g = res.graph
    jg = jfg.init(16, 32)
    for i in range(g.n_nodes):
        jg, _ = jfg.add_node(jg, pose_to_jax(tse3.index(g.poses, i)), jnp.int32(g.node_robot[i]))
    for e in range(g.n_edges):
        jg, _ = jfg.add_edge(jg, jnp.int32(g.edge_i[e]), jnp.int32(g.edge_j[e]),
                             pose_to_jax(tse3.index(g.edge_meas, e)), jnp.int32(g.edge_kind[e]),
                             jnp.float32(g.edge_w_rot[e]), jnp.float32(g.edge_w_trans[e]))
    for a, b in zip(graph_to_jax(g), jg):
        for x, y in zip(a if isinstance(a, tuple) else (a,), b if isinstance(b, tuple) else (b,)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    full = tfg.init(2, 1)
    for _ in range(3):
        full, idx = tfg.add_node(full, tse3.identity(), 0)
    assert full.n_nodes == 2 and idx == 1  # full: a no-op at the last index


def test_export_g2o_text_matches_reference(tmp_path):
    g = small_result().graph
    tg2o.export_g2o(str(tmp_path / "port.g2o"), g)
    jg2o.export_g2o(str(tmp_path / "ref.g2o"), graph_to_jax(g))
    text = (tmp_path / "port.g2o").read_text()
    assert text == (tmp_path / "ref.g2o").read_text()
    assert text.count("VERTEX_SE3:QUAT") == 6 and text.count("EDGE_SE3:QUAT") == 6


def test_import_g2o_roundtrip_matches_reference(tmp_path):
    g = small_result().graph
    path = str(tmp_path / "g.g2o")
    tg2o.export_g2o(path, g)
    back = tg2o.import_g2o(path, node_capacity=16, edge_capacity=32)
    ref = jg2o.import_g2o(path, node_capacity=16, edge_capacity=32)
    assert back.n_nodes == g.n_nodes == int(ref.n_nodes)
    assert back.n_edges == g.n_edges == int(ref.n_edges)
    n, e = g.n_nodes, g.n_edges
    np.testing.assert_allclose(back.poses.R[:n].numpy(), g.poses.R[:n].numpy(), atol=1e-6)
    np.testing.assert_allclose(back.poses.t[:n].numpy(), g.poses.t[:n].numpy(), atol=1e-6)
    np.testing.assert_allclose(back.edge_meas.R[:e].numpy(), g.edge_meas.R[:e].numpy(), atol=1e-6)
    for name in ("node_robot", "node_valid", "edge_i", "edge_j", "edge_kind", "edge_w_rot",
                 "edge_w_trans", "edge_valid"):
        np.testing.assert_array_equal(getattr(back, name).numpy(), getattr(g, name).numpy())
        np.testing.assert_array_equal(getattr(back, name).numpy(), np.asarray(getattr(ref, name)))
    np.testing.assert_allclose(back.poses.R.numpy(), np.asarray(ref.poses.R), atol=1e-6)
    np.testing.assert_allclose(back.edge_meas.t.numpy(), np.asarray(ref.edge_meas.t), atol=1e-6)


@pytest.mark.parametrize("binary", [True, False])
def test_write_pcd_bytes_match_reference(tmp_path, binary):
    rng = np.random.default_rng(3)
    xyz = rng.normal(0, 10, (200, 3)).astype(np.float32)
    inten = rng.uniform(0, 1, 200).astype(np.float32)
    for kw in (dict(), dict(intensity=inten)):
        tpcd.write_pcd(str(tmp_path / "port.pcd"), xyz, binary=binary, **kw)
        jpcd.write_pcd(str(tmp_path / "ref.pcd"), xyz, binary=binary, **kw)
        data = (tmp_path / "port.pcd").read_bytes()
        assert data == (tmp_path / "ref.pcd").read_bytes()
        back = tpcd.read_pcd(str(tmp_path / "port.pcd"))
        np.testing.assert_allclose(back[:, :3], xyz, atol=0 if binary else 1e-6)
    cloud = tpcl.PointCloud(torch.from_numpy(xyz), torch.from_numpy(inten > 0.5))
    tpcd.cloud_to_pcd(str(tmp_path / "c.pcd"), cloud, binary=binary)
    assert tpcd.read_pcd(str(tmp_path / "c.pcd")).shape == (int((inten > 0.5).sum()), 3)


def test_save_artifacts_tree_matches_reference(tmp_path):
    res = small_result()
    jres = slam_result_to_jax(res)
    jres.graph = graph_to_jax(res.graph)
    tpers.save_artifacts(str(tmp_path / "port"), res)
    jpers.save_artifacts(str(tmp_path / "ref"), jres)

    def tree(root):
        return sorted(os.path.relpath(os.path.join(d, f), root)
                      for d, _, fs in os.walk(root) for f in fs)

    files = tree(tmp_path / "port")
    assert files == tree(tmp_path / "ref")
    assert len(files) == 3 + 2 * 6  # two graphs, the map, (data, cloud) per keyframe
    for f in files:
        a, b = (tmp_path / "port" / f).read_bytes(), (tmp_path / "ref" / f).read_bytes()
        if f == "map.pcd":
            pa, pb = tpcd.read_pcd(str(tmp_path / "port" / f)), jpcd.read_pcd(
                str(tmp_path / "ref" / f))
            assert pa.shape == pb.shape and pa.shape[0] > 100
            np.testing.assert_allclose(pa, pb, rtol=0, atol=1e-5)
        else:
            assert a == b, f
    tfs = tpers.map_to_odom_transforms(res)
    jtfs = jpers.map_to_odom_transforms(jres)
    for a, b in zip(tfs, jtfs):
        np.testing.assert_allclose(a.R.numpy(), np.asarray(b.R), atol=1e-6)
        np.testing.assert_allclose(a.t.numpy(), np.asarray(b.t), atol=1e-5)
