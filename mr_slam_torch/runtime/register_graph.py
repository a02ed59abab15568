"""The registration entry points replayed as CUDA graphs: the port's
counterpart of the reference's jitted `vgicp`, `point_to_plane_icp`,
`loam_icp`, `point_to_point_icp` and `gicp`
(`mr_slam_tpu/ops/registration.py:215-735`, each one compiled program
whose GN loops are `lax.scan`s), and of `register_pair` (`:791`), which
is built from them.

A runner holds static buffers for one key: every input tensor of the
call (the clouds, their masks, the target table, the init pose, the
source covariances when given). A call copies its inputs in with
`copy_` and runs the segments of `frame_graph.Segments` on the buffers:

  vgicp (direct1 or general), point_to_plane_icp, loam_icp
    gn      the raw body, and its fitness at the unprojected pose where
            the reference scores one
            [se3.normalize, eager: so3.project's SVD syncs the host]
  point_to_point_icp, gicp
    gn      the raw `_icp_loop_raw` (its cost is also its fitness); for
            GICP, both clouds' `_regularized_covs` too
            [se3.normalize, eager]
  register_pair
    reg     the method's grid build (vgicp, point_to_plane), the fitness
            grid build and the method's raw body, without the method's
            own fitness, which `register_pair` overwrites
            [se3.normalize, eager]
    score   `fitness` of every 4th source point at the projected pose

A runner's first call runs the segments eagerly on its buffers: that
run makes cuBLAS's and cuSOLVER's handles (GICP's batched 3x3
`inv_ex`), the device constants and the workspaces, which a capture
cannot make. From its second call on, each segment is captured once and
replayed. Replays launch the eager kernels on the same inputs, so a call
equals `registration._<name>_eager` bit for bit, and the VGICP kernel's
launches recorded inside a graph are counted at each replay. A failed
capture raises: there is no eager fallback on the card. On the CPU the
segments run eagerly, in the same order, on the same buffers. Outputs
are returned as clones.

The key is the device, the entry point, every static argument and the
shape and dtype of every input. Inputs are not padded to share a key:
padding would move the parked points that `voxel_grid.build` sorts, and
the results would no longer be the eager call's. So a caller whose
cloud lengths change pays one eager call for each new length (a loop
pair's merged target has a data-dependent length, but keeps it across
repeated calls of the pair), and a runner pays back only from the third
call of its key on: the first runs eagerly, the second captures (slower
than an eager call). No caller in the port repeats a key yet; only its
tests and `chip_smoke.py` do.

At most MAX_RUNNERS runners are kept, the least recently used dropped
first, and fewer while the graph pools of the runners kept on a card
sum to more than POOL_SHARE of its memory: a GICP runner's pool holds
its k-NN distance chunks (`pointcloud.KNN_CHUNK_ELEMS`), 15 GiB at a
20,480-point target, which the eager body holds only for the length of
a call. A dropped runner's pool goes back to PyTorch's allocator.

Callers that run inside a CUDA graph of their own (loop verification,
the odometry, the LIO update, the feature runner) call the raw or eager
bodies: a capture cannot hold another.
"""
from __future__ import annotations

import functools
from typing import Callable

import torch

from ..geometry import se3
from ..geometry.se3 import Pose
from ..ops import registration as reg
from ..ops import voxel_grid
from ..ops.pointcloud import PointCloud
from . import frame_graph

MAX_RUNNERS = 4
POOL_SHARE = 0.25  # of a card's memory, the most the kept runners' graph pools hold


@functools.lru_cache(maxsize=None)
def _pool_budget(device: torch.device) -> int:
    return int(POOL_SHARE * torch.cuda.mem_get_info(device)[1])


_runners = frame_graph.RunnerCache(MAX_RUNNERS, _pool_budget)


def _outputs(res: reg.RegistrationResult, fitness: torch.Tensor | None) -> dict:
    out = dict(raw_R=res.pose.R, raw_t=res.pose.t, inliers=res.num_inliers, error=res.error,
               converged=res.converged)
    if fitness is not None:
        out["fitness"] = fitness
    return out


class Runner:
    """The segments and static buffers of one key: `runner(inputs)` runs
    `gn` (named `first`) on the buffers of `inputs`, projects its pose,
    and with `score` runs it at the projected pose. `unbatch`: the
    results are item 0 of a batch of one (`register_pair`'s VGICP)."""

    def __init__(self, inputs: dict, gn: Callable, score: Callable | None = None,
                 unbatch: bool = False):
        dev = self.device = inputs["R0"].device
        self.segs = frame_graph.Segments(dev, "register")
        self.gn, self.score, self.unbatch = gn, score, unbatch
        self.first = "gn" if score is None else "reg"
        self.calls = 0
        self.b = {k: torch.empty(v.shape, dtype=v.dtype, device=dev) for k, v in inputs.items()}
        if score is not None:  # the projected pose the score reads
            self.b.update(R=torch.empty_like(self.b["R0"]), t=torch.empty_like(self.b["t0"]))

    def __call__(self, inputs: dict) -> reg.RegistrationResult:
        b, segs = self.b, self.segs
        run = segs.eager if self.calls == 0 else segs.run
        with segs.on_stream():
            for k, v in inputs.items():
                b[k].copy_(v)
            b.update(run(self.first, self.gn, b))
            pose = se3.normalize(Pose(b["raw_R"], b["raw_t"]))
            rest = [b["inliers"], b["error"], b.get("fitness"), b["converged"]]
            if self.unbatch:
                pose = se3.index(pose, 0)
                rest = [None if x is None else x[0] for x in rest]
            if self.score is not None:
                b["R"].copy_(pose.R)
                b["t"].copy_(pose.t)
                rest[2] = run("score", self.score, b)["fitness"]
            # the graphs rewrite their outputs at the next replay
            out = reg.RegistrationResult(Pose(pose.R.clone(), pose.t.clone()),
                                         *(x.clone() for x in rest))
        self.calls += 1
        return out

    def stats(self) -> dict:
        s = self.segs
        return dict(calls=self.calls, captures=s.captures, replays=s.replays,
                    capture_s=s.capture_s, pool_bytes=s.pool_bytes())

    def held_bytes(self) -> int:
        return self.segs.held_bytes

    def close(self) -> None:
        """Release the graphs once their last replay has run."""
        self.segs.close(self.calls)


def _call(entry: str, inputs: dict, static: dict, gn: Callable, score: Callable | None = None,
          unbatch: bool = False) -> reg.RegistrationResult:
    """Run `inputs` through the runner of the key (entry, static, the
    inputs' shapes and dtypes), made with `gn(bufs, **static)`."""
    key = (inputs["R0"].device, entry, tuple(static.items()),
           tuple((k, tuple(v.shape), v.dtype) for k, v in inputs.items()))
    runner = _runners.get(key, lambda: Runner(
        inputs, functools.partial(gn, **static),
        None if score is None else functools.partial(score, **static), unbatch))
    out = runner(inputs)
    _runners.trim()  # its capture may have grown its pool
    return out


def _source(b: dict) -> PointCloud:
    return PointCloud(b["xyz"], b["mask"])


def _init(b: dict) -> Pose:
    return Pose(b["R0"], b["t0"])


# --------------------------------------------------------------------------
# the entry points' segments
# --------------------------------------------------------------------------


def _vgicp_gn(b: dict, leaf, direct1: bool, iters: int, max_corr_dist: float, damping: float,
              tol: float, neighbors: str, schedule) -> dict:
    source, target = _source(b), voxel_grid.VoxelGrid(b["table"], leaf)
    if direct1:
        res = reg._vgicp_direct1_raw(source, target, _init(b), iters, max_corr_dist, damping,
                                     tol, schedule=schedule)
    else:
        res = reg._vgicp_general_raw(source, target, _init(b), b.get("covs"), iters,
                                     max_corr_dist, damping, tol, neighbors)
    return _outputs(res, reg.fitness(source, target, res.pose, max_range=1.0))


def _point_to_plane_gn(b: dict, leaf, iters: int, max_corr_dist: float, damping: float,
                       tol: float, neighbors: str, inner: int, schedule) -> dict:
    source, target = _source(b), voxel_grid.VoxelGrid(b["table"], leaf)
    res = reg.point_to_plane_icp_raw(source, target, _init(b), iters, max_corr_dist, damping, tol,
                                     neighbors, inner, schedule)
    return _outputs(res, reg.fitness(source, target, res.pose, max_range=1.0))


def _loam_gn(b: dict, leaf, iters: int, max_corr_dist: float, damping: float,
             tol: float) -> dict:
    surfs = PointCloud(b["surfs"], b["surfs_mask"])
    target = voxel_grid.VoxelGrid(b["table"], leaf)
    res = reg.loam_icp_raw(PointCloud(b["corners"], b["corners_mask"]), surfs, target, _init(b),
                           iters, max_corr_dist, damping, tol)
    return _outputs(res, reg.fitness(surfs, target, res.pose, max_range=1.0))


def _icp_gn(b: dict, iters: int, max_corr_dist: float, damping: float, tol: float) -> dict:
    res = reg._point_to_point_icp_raw(_source(b), PointCloud(b["tgt"], b["tgt_mask"]), _init(b),
                                      iters, max_corr_dist, damping, tol)
    return _outputs(res, res.fitness)


def _gicp_gn(b: dict, iters: int, max_corr_dist: float, damping: float, tol: float,
             corr_k: int) -> dict:
    res = reg._gicp_raw(_source(b), PointCloud(b["tgt"], b["tgt_mask"]), _init(b), iters,
                        max_corr_dist, damping, tol, corr_k)
    return _outputs(res, res.fitness)


def _pair_reg(b: dict, leaf: float, table_size: int, method: str, iters: int,
              max_corr_dist: float) -> dict:
    source, target, init = _source(b), PointCloud(b["tgt"], b["tgt_mask"]), _init(b)
    kw = dict(iters=iters, max_corr_dist=max_corr_dist)
    if method == "icp":
        res = reg._point_to_point_icp_raw(source, target, init, **kw)
    elif method == "gicp":
        res = reg._gicp_raw(source, target, init, **kw)
    else:
        grid = voxel_grid.build(target, leaf, table_size, min_points=3, regularize="plane")
        if method == "vgicp":
            res = reg._vgicp_direct1_raw(PointCloud(source.xyz[None], source.mask[None]),
                                         voxel_grid.VoxelGrid(grid.packed[None], grid.leaf),
                                         Pose(init.R[None], init.t[None]), **kw)
        else:
            res = reg.point_to_plane_icp_raw(source, grid, init, **kw)
    fit_grid = voxel_grid.build(target, leaf, table_size, min_points=1)
    return dict(_outputs(res, None), fit_packed=fit_grid.packed)


def _pair_score(b: dict, leaf: float, **_) -> dict:
    sub = PointCloud(b["xyz"][::4], b["mask"][::4])
    return dict(fitness=reg.fitness(sub, voxel_grid.VoxelGrid(b["fit_packed"], leaf),
                                    Pose(b["R"], b["t"])))


# --------------------------------------------------------------------------
# the entry points (`registration.*` calls them)
# --------------------------------------------------------------------------


def vgicp(source: PointCloud, target: voxel_grid.VoxelGrid, init: Pose,
          source_covs: torch.Tensor | None, iters: int, max_corr_dist: float, damping: float,
          tol: float, neighbors: str, schedule) -> reg.RegistrationResult:
    """`registration.vgicp` through its runner."""
    inputs = dict(xyz=source.xyz, mask=source.mask, table=target.packed, R0=init.R, t0=init.t)
    if source_covs is not None:
        inputs["covs"] = source_covs
    direct1 = reg._direct1(source_covs, neighbors, schedule)
    static = dict(leaf=target.leaf, direct1=direct1, iters=iters, max_corr_dist=max_corr_dist,
                  damping=damping, tol=tol, neighbors=neighbors, schedule=schedule)
    return _call("vgicp", inputs, static, _vgicp_gn)


def point_to_plane_icp(source: PointCloud, target: voxel_grid.VoxelGrid, init: Pose, iters: int,
                       max_corr_dist: float, damping: float, tol: float, neighbors: str,
                       inner: int, schedule) -> reg.RegistrationResult:
    """`registration.point_to_plane_icp` through its runner."""
    inputs = dict(xyz=source.xyz, mask=source.mask, table=target.packed, R0=init.R, t0=init.t)
    static = dict(leaf=target.leaf, iters=iters, max_corr_dist=max_corr_dist, damping=damping,
                  tol=tol, neighbors=neighbors, inner=inner, schedule=schedule)
    return _call("point_to_plane_icp", inputs, static, _point_to_plane_gn)


def loam_icp(corners: PointCloud, surfs: PointCloud, target: voxel_grid.VoxelGrid, init: Pose,
             iters: int, max_corr_dist: float, damping: float,
             tol: float) -> reg.RegistrationResult:
    """`registration.loam_icp` through its runner."""
    inputs = dict(corners=corners.xyz, corners_mask=corners.mask, surfs=surfs.xyz,
                  surfs_mask=surfs.mask, table=target.packed, R0=init.R, t0=init.t)
    static = dict(leaf=target.leaf, iters=iters, max_corr_dist=max_corr_dist, damping=damping,
                  tol=tol)
    return _call("loam_icp", inputs, static, _loam_gn)


def point_to_point_icp(source: PointCloud, target: PointCloud, init: Pose, iters: int,
                       max_corr_dist: float, damping: float,
                       tol: float) -> reg.RegistrationResult:
    """`registration.point_to_point_icp` through its runner."""
    inputs = dict(xyz=source.xyz, mask=source.mask, tgt=target.xyz, tgt_mask=target.mask,
                  R0=init.R, t0=init.t)
    static = dict(iters=iters, max_corr_dist=max_corr_dist, damping=damping, tol=tol)
    return _call("point_to_point_icp", inputs, static, _icp_gn)


def gicp(source: PointCloud, target: PointCloud, init: Pose, iters: int, max_corr_dist: float,
         damping: float, tol: float, corr_k: int) -> reg.RegistrationResult:
    """`registration.gicp` through its runner."""
    inputs = dict(xyz=source.xyz, mask=source.mask, tgt=target.xyz, tgt_mask=target.mask,
                  R0=init.R, t0=init.t)
    static = dict(iters=iters, max_corr_dist=max_corr_dist, damping=damping, tol=tol,
                  corr_k=corr_k)
    return _call("gicp", inputs, static, _gicp_gn)


def register_pair(source: PointCloud, target: PointCloud, init: Pose, leaf: float,
                  table_size: int, method: str, iters: int,
                  max_corr_dist: float) -> reg.RegistrationResult:
    """`registration.register_pair` through its runner."""
    inputs = dict(xyz=source.xyz, mask=source.mask, tgt=target.xyz, tgt_mask=target.mask,
                  R0=init.R, t0=init.t)
    static = dict(leaf=leaf, table_size=table_size, method=method, iters=iters,
                  max_corr_dist=max_corr_dist)
    return _call("register_pair", inputs, static, _pair_reg, _pair_score,
                 unbatch=method == "vgicp")


def stats() -> list[dict]:
    """Each kept runner's calls, captures, replays, capture seconds and
    graph-pool bytes, with its key's entry point and static arguments,
    the least recently used first."""
    return _runners.stats(lambda k: dict(entry=k[1], static=dict(k[2])))


def clear() -> None:
    """Drop every runner (their graphs and buffers)."""
    _runners.clear()
