"""The port's process meshes and the sharded store
(`parallel/mesh.py`, `parallel/store.cross_robot_distances` with a
group) on 2 and 4 gloo ranks on the CPU.

`cross_robot_distances` over a group: each rank holds its block of the
robots; the all-gathered result equals the reference's `shard_map`
result on as many virtual devices and the port's single-process result
(the same float32 arithmetic on the same rows: within 1e-5, as
`test_torch_store.py` holds the single-process path to the reference;
measured equal)."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from mr_slam_torch.parallel import mesh as tmesh, store as tstore
from mr_slam_tpu.parallel import store as jstore
from tests import torch_dist


def test_make_mesh_single_process():
    m = tmesh.make_mesh(1, 1)
    assert m.shape == {tmesh.ROBOT_AXIS: 1, tmesh.SHARD_AXIS: 1}
    assert m.robot_group is None and m.shard_group is None
    assert tmesh.single_device_mesh().shape == m.shape


def test_too_many_raises():
    with pytest.raises(ValueError):
        tmesh.make_mesh(16, 16)


@pytest.mark.parametrize("n,parts", [(8, 2), (8, 4), (10, 4), (3, 3)])
def test_block_is_contiguous_and_covers(n, parts):
    blocks = [list(range(n))[tmesh.block(n, parts, i)] for i in range(parts)]
    assert sum(blocks, []) == list(range(n))
    assert max(map(len, blocks)) - min(map(len, blocks)) <= -(-n // parts)


def test_make_mesh_shapes(tmp_path):
    outs = torch_dist.run_ranks(torch_dist.mesh_axes, 4, tmp_path, 2, 2)
    for rank, out in enumerate(outs):
        i, j = divmod(rank, 2)
        assert out["index"] == (i, j)
        assert out["shape"] == {tmesh.ROBOT_AXIS: 2, tmesh.SHARD_AXIS: 2}
        # robot axis: ranks j and 2 + j; shard axis: ranks 2i and 2i + 1
        assert out[tmesh.ROBOT_AXIS] == (2, float((j + 1) + (2 + j + 1)))
        assert out[tmesh.SHARD_AXIS] == (2, float((2 * i + 1) + (2 * i + 2)))


def test_make_mesh_one_axis(tmp_path):
    outs = torch_dist.run_ranks(torch_dist.mesh_axes, 2, tmp_path, 2, 1)
    for out in outs:
        assert out[tmesh.ROBOT_AXIS] == (2, 3.0) and out[tmesh.SHARD_AXIS] is None


def _store_inputs(n_robots=8, K=8, D=16, seed=0):
    rng = np.random.default_rng(seed)
    db = rng.normal(size=(n_robots, K, D)).astype(np.float32)
    valid = rng.random((n_robots, K)) > 0.3
    valid[:, 0] = True
    # each robot's query is its own first descriptor, slightly moved
    q = (db[:, :1] + 0.01 * rng.normal(size=(n_robots, 1, D))).astype(np.float32)
    return db, valid, q


@pytest.mark.parametrize("world", (2, 4))
def test_cross_robot_distances_sharded(world, tmp_path):
    db, valid, q = _store_inputs()
    outs = torch_dist.run_ranks(torch_dist.store_distances, world, tmp_path, db, valid, q)
    got = np.concatenate(outs)                      # (8, 1, 8, K) in robot order
    assert got.shape == (8, 1, 8, 8)
    # the reference: the same rows sharded over `world` virtual devices
    s = jstore.init(8, 8, 4, desc_dim=16)._replace(descriptors=jnp.asarray(db),
                                                   desc_valid=jnp.asarray(valid))
    m = jax.make_mesh((world,), ("robot",))
    f = jax.jit(jax.shard_map(
        lambda st, qq: jstore.cross_robot_distances(st, qq, "robot"), mesh=m,
        in_specs=(jax.tree.map(lambda _: P("robot"), s), P("robot")), out_specs=P("robot"),
        check_vma=False))
    ref = np.asarray(f(s, jnp.asarray(q)))
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-5)
    # the port's single process on the whole store
    t = tstore.init(8, 8, 4, desc_dim=16)._replace(descriptors=torch.from_numpy(db),
                                                   desc_valid=torch.from_numpy(valid))
    single = tstore.cross_robot_distances(t, torch.from_numpy(q)).numpy()
    np.testing.assert_allclose(got, single, rtol=1e-5, atol=1e-5)
    for r in range(8):  # each robot's query finds its own entry first
        assert int(np.argmin(got[r, 0, :, 0])) == r
