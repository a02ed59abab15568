"""Run a function on several gloo ranks on the CPU, for the multi-process
tests of the port (`test_torch_distributed.py`, `test_torch_parallel.py`,
`test_torch_sharded_elevation.py`, `test_torch_multihost.py`).

`run_ranks(fn, world, tmp_path, *args)` spawns `world` processes; each
pins PyTorch to one thread (as `torch_parity` does), joins a gloo
process group that meets through a file under `tmp_path` (no port, so
parallel test workers cannot collide), runs `fn(rank, world, *args)`
and sends its result back. The group's timeout and a time limit on
collecting the results bound every case: a rank that fails or hangs
kills all the others and fails the test.

A spawned child imports the module that defines its target, so the
targets live here, and this module imports neither JAX nor the
reference package.
"""
from __future__ import annotations

import datetime
import multiprocessing as mp
import queue
import time
import traceback

import numpy as np

GROUP_TIMEOUT_S = 60


def _entry(fn, rank, world, rdzv, args, results):
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    try:
        dist.init_process_group("gloo", init_method=rdzv, rank=rank, world_size=world,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        out = fn(rank, world, *args)
        dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - reported to the parent, which fails the test
        results.put((rank, False, traceback.format_exc()))


def run_ranks(fn, world: int, tmp_path, *args, timeout_s: float = 240.0) -> list:
    """[fn(rank, world, *args) for every rank], each run in its own
    process on one gloo group."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    rdzv = f"file://{tmp_path}/rdzv-{time.monotonic_ns()}"
    procs = [ctx.Process(target=_entry, args=(fn, r, world, rdzv, args, results), daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    outs: dict[int, object] = {}
    deadline = time.monotonic() + timeout_s
    try:
        while len(outs) < world:
            try:
                rank, ok, out = results.get(timeout=max(deadline - time.monotonic(), 0.1))
            except queue.Empty:
                raise TimeoutError(f"ranks {sorted(set(range(world)) - set(outs))} gave no "
                                   f"result within {timeout_s} s") from None
            if not ok:
                raise RuntimeError(f"rank {rank} failed:\n{out}")
            outs[rank] = out
    finally:
        for p in procs:
            p.join(timeout=10)
            if p.is_alive():
                p.kill()
                p.join()
    return [outs[r] for r in range(world)]


# --------------------------------------------------------------------------
# rank targets
# --------------------------------------------------------------------------


def _graph(a: dict):
    import torch

    from mr_slam_torch.backend import factor_graph as tfg
    from mr_slam_torch.geometry import se3

    def t(x):
        return torch.from_numpy(np.asarray(x))

    g = tfg.init(*a["capacity"])
    g, _ = tfg.add_nodes_batch(g, se3.Pose(t(a["R"]), t(a["t"])), t(a["robot"]).long())
    g, _ = tfg.add_edges_batch(g, t(a["edge_i"]).long(), t(a["edge_j"]).long(),
                               se3.Pose(t(a["meas_R"]), t(a["meas_t"])), t(a["kind"]).long(),
                               t(a["w_rot"]), t(a["w_trans"]))
    return g


def distributed_pgo(rank, world, graph: dict, anchors: np.ndarray, config):
    """`distributed.optimize` over the world on a graph given as
    `torch_parity.graph_to_numpy` arrays: (R, t) numpy."""
    import torch
    import torch.distributed as dist

    from mr_slam_torch.backend import distributed

    opt = distributed.optimize(_graph(graph), torch.from_numpy(anchors), dist.group.WORLD,
                               config)
    return opt.R.numpy(), opt.t.numpy()


def mesh_axes(rank, world, n_robots: int, n_shards: int):
    """`make_mesh(n_robots, n_shards)`: this rank's (robot, shard)
    position, each axis' group size, and the sum of (rank + 1) over each
    axis' group (None where the axis has no group)."""
    import torch

    from mr_slam_torch.parallel import mesh

    m = mesh.make_mesh(n_robots, n_shards)
    out = {"index": (m.index(mesh.ROBOT_AXIS), m.index(mesh.SHARD_AXIS)), "shape": m.shape}
    for axis in (mesh.ROBOT_AXIS, mesh.SHARD_AXIS):
        g = m.group(axis)
        x = torch.tensor([float(rank + 1)])
        out[axis] = None if g is None else (mesh.size(g), float(mesh.all_reduce(x, g)))
    return out


def store_distances(rank, world, db: np.ndarray, valid: np.ndarray, queries: np.ndarray):
    """`cross_robot_distances` with each rank holding its block of the
    robots' databases and queries."""
    import torch
    import torch.distributed as dist

    from mr_slam_torch.parallel import mesh, store

    rows = mesh.block(db.shape[0], world, rank)
    s = store.init(rows.stop - rows.start, db.shape[1], 4, desc_dim=db.shape[2])
    s = s._replace(descriptors=torch.from_numpy(db[rows]), desc_valid=torch.from_numpy(valid[rows]))
    return store.cross_robot_distances(s, torch.from_numpy(queries[rows]),
                                       dist.group.WORLD).numpy()


def emap(height: np.ndarray, valid: np.ndarray, res: float):
    """A port `ElevationMap` of the given height and valid layers."""
    import torch

    from mr_slam_torch.mapping import elevation

    h = torch.from_numpy(height)
    return elevation.ElevationMap(height=h, variance=torch.ones_like(h),
                                  valid=torch.from_numpy(valid), origin=torch.zeros(2),
                                  resolution=torch.tensor(res, dtype=torch.float32))


def sharded_features(rank, world, height: np.ndarray, valid: np.ndarray, res: float):
    """`features_sharded` of the whole grid over the world: the four
    layers as numpy."""
    import torch.distributed as dist

    from mr_slam_torch.mapping import sharded_elevation

    f = sharded_elevation.features_sharded(emap(height, valid, res), dist.group.WORLD)
    return [a.numpy() for a in f]


def sharded_bad_rows(rank, world, rows: int):
    """The ValueError message of `features_sharded` on a (rows, 8) grid,
    or None."""
    import torch.distributed as dist

    from mr_slam_torch.mapping import sharded_elevation

    m = emap(np.zeros((rows, 8), np.float32), np.ones((rows, 8), bool), 0.2)
    try:
        sharded_elevation.features_sharded(m, dist.group.WORLD)
    except ValueError as e:
        return str(e)
    return None


def allgather_loops(rank, world, loops: list, max_loops: int):
    """`pipeline._allgather_loops` of this rank's share of `loops`
    (pair index modulo the world): the merged records as plain values."""
    import torch
    import torch.distributed as dist

    from mr_slam_torch.geometry import se3
    from mr_slam_torch.runtime import pipeline

    mine = [(pi, dict(l, rel=se3.Pose(torch.from_numpy(l["rel"][0]), torch.from_numpy(l["rel"][1]))))
            for pi, l in loops if pi % world == rank]
    merged = pipeline._allgather_loops(mine, max_loops, dist.group.WORLD)
    return [(pi, dict(l, rel=(l["rel"].R.numpy(), l["rel"].t.numpy()))) for pi, l in merged]
