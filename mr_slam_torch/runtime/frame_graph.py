"""The front-ends' frame loops replayed as CUDA graphs: the port's
counterpart of the reference's `pipeline._frontend_fused` and
`_frontend_fused_lio` (`mr_slam_tpu/runtime/pipeline.py:80-186`), which
run a robot's whole front-end as one compiled `lax.scan`, and of the
jitted `odometry.step` / `lio.step` / `store.gate_and_add` that
`OnlineSlam.add_frame` ticks (`mr_slam_tpu/runtime/online.py:191-314`).

A runner (`Scan2Map`, `Lio`) holds a robot's frame state in static
buffers (the scan, its mask and point times, the IMU packet, the stamp,
the poses, both maps' packed tables, the keyframe store) and cuts the
work of a frame into segments, each a function of those buffers that
writes its new state back into them with `copy_`:

  scan2map (`Scan2Map.step`), the stages of `odometry.step`:
    coarse         prediction, motion compensation, downsample, coarse ICP
                   [so3.project, eager: its torch.linalg.svd syncs the host]
    fine           fine ICP
                   [so3.project, eager]
    insert         fine insert                  (not when shed)
    decay          fine-map trim                (its cadence, not when shed)
    coarse_insert  coarse insert + trim         (its cadence, not when shed)
    commit         pose <- new pose, the keyframe gate
  LIO (`Lio.step`): a frame with an IMU packet is one segment, `lio.step`
    and the keyframe gate (no projection, no host sync); the filter's
    first step (no update) and the later ones are two segments. A frame
    without a packet (a session's first) only gates the current pose.

The keyframe gate is a parameter of the runner: `StoreGate`
(`kf.maybe_add` on a `KeyframeStore`, the batch path) or `RowGate`
(`store.gate_and_add` on one row of a `MultiRobotStore`, the session).
The frame index of the cadences is the state's own `frame`, so a runner
built from a restored state starts mid-stream.

A runner's first step runs eagerly. On a CUDA device each segment is
captured into a CUDA graph the first time it runs after that, and
replayed from then on: every later step is graph replays, the
projections between them and the copies of the frame's inputs. Before
its capture a segment that has not run eagerly runs once eagerly on
copies of the buffers (results dropped): that run makes the device
constants (`devconst`) and the cuBLAS / CUB workspaces of the runner's
stream, which a capture cannot. All of a runner's graphs share one
memory pool and one stream. A replay launches the same kernels on the
same inputs as the eager step, so the results are the eager card path's
bit for bit. A failed capture raises: there is no eager fallback on the
card. On the CPU the same segments run eagerly, in the same order, on
the same buffers. A capture launches nothing, so no kernel's wrapper
(VGICP, the terrain stencil, the segment sum) counts the launches it
records; each replay adds them (`hopper_vgicp.add_launches`,
`hopper_stencil.add_launches`, `segment.add_launches`), and the counts
stay the launches the card ran. Loop verification's chunks
(`runtime/verify_graph.py`), the chordal solve's stages
(`runtime/solve_graph.py`) and the registration entry points
(`runtime/register_graph.py`) run on the same `Segments`, and keep
their runners in a `RunnerCache`.

`Loam` is the A-LOAM feature front-end's runner
(`feature_odometry.run`, the reference's jitted `step` scanned over the
frames, `mr_slam_tpu/frontend/feature_odometry.py:28-95`):

    first     frame 0: the prediction is the pose (no registration)
    coarse    features.extract, the prediction, the coarse point-to-plane
              ICP of the surfs (3 iterations, direct27)
              [so3.project, eager]
    loam      loam_icp_raw (its fitness, which `step` never reads, left
              out as XLA leaves it out)
              [se3.normalize, eager]
    maintain  both downsamples, inserts and decays, and the commit

`scan2map` and `lio` run a stacked sequence through one runner (the
batch path, `pipeline.run_frontend`); `OnlineSlam.add_frame` keeps one
runner a robot and steps it a frame at a time.

Every runner projects through `project`, which counts the SVD's host
waits at `sync.<site>` and opens the span `online.frontend.project` in
the front-ends (`online.solve.project` in the solves); `Segments`
counts its kind's captures, their seconds and its eager first calls'
seconds (`graph.<kind>.*`, `runtime/observability.py`).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Callable, NamedTuple

import torch

from ..frontend import feature_odometry, odometry
from ..frontend import keyframes as kf
from ..geometry import so3
from ..geometry.se3 import Pose
from ..ops import features as feat
from ..ops import hopper_stencil, hopper_vgicp, segment
from ..ops import pointcloud as pcl
from ..ops import registration, voxel_grid
from ..parallel import store as mstore_lib
from . import observability as obs


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    return x


# host waits of one `so3.project` on the card: its batched
# `torch.linalg.svd` syncs twice (PyTorch 2.11, cuSOLVER)
SVD_SYNCS = 2


def project(R: torch.Tensor, site: str, span: str | None = None) -> torch.Tensor:
    """`so3.project(R)` between a runner's replays, counted as SVD_SYNCS
    host waits at `sync.<site>`, inside the tracer span `span` when one
    is named."""
    obs.metrics.inc(f"sync.{site}", SVD_SYNCS)
    if span is None:
        return so3.project(R)
    with obs.tracer.span(span):
        return so3.project(R)


@functools.lru_cache(maxsize=None)
def _side_stream(device: torch.device) -> torch.cuda.Stream:
    """The runners' stream on `device`, one for the process: a capture
    needs a stream other than the default one, and cuBLAS keeps a
    workspace (32 MiB on an H100) for every stream it has run on, for
    the life of the process; a stream of PyTorch's pool for each call
    held 32 MiB more a call, up to 1 GiB."""
    return torch.cuda.Stream(device)


class Segments:
    """Named segments of a frame, each `fn(bufs) -> dict of outputs`:
    eager on the CPU; on a CUDA device captured at the first `run` and
    replayed from then on (the outputs are then the graph's own tensors,
    rewritten by every replay). `kind` names the runners' family in the
    counters `graph.<kind>.captures`, `.capture_s` and `.eager_s`
    (`frontend`, `verify`, `solve`, `register`)."""

    def __init__(self, device, kind: str):
        self.device = torch.device(device)
        self.kind = kind
        self.capture = self.device.type == "cuda"
        self._graphs: dict = {}
        self._eager: set = set()
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
        self.held_bytes = 0  # the pool's bytes after the last capture
        if self.capture:
            self.stream = _side_stream(self.device)
            self.pool = torch.cuda.graph_pool_handle()

    @contextlib.contextmanager
    def on_stream(self):
        """Run the block on the runner's stream, ordered after the
        caller's stream and before what the caller enqueues next."""
        if not self.capture:
            yield
            return
        caller = torch.cuda.current_stream(self.device)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            yield
        caller.wait_stream(self.stream)

    def eager(self, name: str, fn: Callable, bufs: dict) -> dict:
        """Run the segment eagerly on every device (a runner's first step)."""
        self._eager.add(name)
        t = time.perf_counter()
        out = fn(bufs)
        obs.metrics.inc(f"graph.{self.kind}.eager_s", time.perf_counter() - t)
        return out

    def run(self, name: str, fn: Callable, bufs: dict) -> dict:
        """Run the segment: a graph replay on a CUDA device (captured at
        the first call, on the buffers of that call), eagerly on the CPU."""
        if not self.capture:
            return fn(bufs)
        if name not in self._graphs:
            self._graphs[name] = self._capture(name, fn, bufs)
        graph, out, (vgicp, stencil, sums) = self._graphs[name]
        graph.replay()
        self.replays += 1
        if vgicp:
            hopper_vgicp.add_launches(vgicp)
        if stencil:
            hopper_stencil.add_launches(stencil)
        if sums:
            segment.add_launches(sums)
        return out

    def drop(self, name: str) -> bool:
        """Forget the segment's graph (its buffers were rebound): the next
        `run` captures it anew. Returns whether there was one."""
        if name not in self._graphs:
            return False
        obs.metrics.inc(f"sync.{self.kind}.drop")
        self.stream.synchronize()  # its last replay has run
        del self._graphs[name]
        return True

    def _capture(self, name: str, fn: Callable, bufs: dict):
        t = time.perf_counter()
        if name not in self._eager:
            fn(_clone(bufs))
        vgicp = collections.Counter(hopper_vgicp.recorded_by_batch())
        stencil = hopper_stencil.recorded_count()
        sums = segment.recorded_count()
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            out = fn(bufs)
        except BaseException:
            with contextlib.suppress(RuntimeError):  # the capture is already invalid
                graph.capture_end()
            raise
        graph.capture_end()
        dt = time.perf_counter() - t
        self.captures += 1
        self.capture_s += dt
        obs.metrics.inc(f"graph.{self.kind}.captures")
        obs.metrics.inc(f"graph.{self.kind}.capture_s", dt)
        self.held_bytes = self.pool_bytes()  # replays allocate nothing more
        launches = (dict(collections.Counter(hopper_vgicp.recorded_by_batch()) - vgicp),
                    hopper_stencil.recorded_count() - stencil, segment.recorded_count() - sums)
        return graph, out, launches

    def pool_bytes(self) -> int:
        """Device memory the graphs' pool holds (its peak: a pool keeps
        its segments while its graphs live)."""
        if not self.capture:
            return 0
        pool = tuple(self.pool)
        return sum(s["total_size"] for s in torch.cuda.memory_snapshot()
                   if tuple(s.get("segment_pool_id", ())) == pool)

    def close(self, frames: int) -> dict:
        """Release the graphs once their last replay has run; returns the
        call's counts: frames, captures, replays, capture seconds and the
        pool's bytes."""
        stats = dict(frames=frames, captures=self.captures, replays=self.replays,
                     capture_s=self.capture_s, pool_bytes=self.pool_bytes())
        if self.capture:
            obs.metrics.inc(f"sync.{self.kind}.close")
            self.stream.synchronize()
            self._graphs.clear()
        return stats


class RunnerCache:
    """Runners by key, at most `max_runners`, the least recently used
    dropped first (its graphs released once their last replay has run).
    With `pool_budget(device) -> bytes`, also dropped while the graph
    pools that the kept runners on a device hold sum to more than its
    budget; the most recently used runner is always kept. A runner has
    `stats()` and `close()`, and with a budget `device` and `held_bytes()`
    (its pool's bytes, known once it has captured)."""

    def __init__(self, max_runners: int,
                 pool_budget: Callable[[torch.device], int] | None = None):
        self.max_runners = max_runners
        self.pool_budget = pool_budget
        self._runners: collections.OrderedDict = collections.OrderedDict()

    def get(self, key, make: Callable[[], object]):
        """The runner of `key`, made by `make()` if there is none; it
        becomes the most recently used."""
        runner = self._runners.pop(key, None)
        if runner is None:
            runner = make()
        self._runners[key] = runner
        self.trim()
        return runner

    def trim(self) -> None:
        """Drop the least recently used runners over the limits (call it
        again after a runner's call: a capture grows its pool)."""
        while len(self._runners) > self.max_runners:
            self._runners.popitem(last=False)[1].close()
        if self.pool_budget is None:
            return
        held = collections.Counter()
        for r in self._runners.values():
            held[r.device] += r.held_bytes()
        drop = []
        for key in list(self._runners)[:-1]:
            dev, n = self._runners[key].device, self._runners[key].held_bytes()
            if held[dev] and held[dev] > self.pool_budget(dev):
                held[dev] -= n
                drop.append(key)
        for key in drop:
            self._runners.pop(key).close()
        if drop:  # a dropped runner's pool stays reserved until then
            torch.cuda.empty_cache()

    def values(self) -> list:
        return list(self._runners.values())

    def stats(self, describe: Callable[[object], dict] = lambda key: {}) -> list[dict]:
        """Each runner's `stats()` with `describe(key)`, the least
        recently used first."""
        return [dict(r.stats(), **describe(k)) for k, r in self._runners.items()]

    def clear(self) -> None:
        """Drop every runner (their graphs and buffers)."""
        while self._runners:
            self._runners.popitem(last=False)[1].close()


class Run(NamedTuple):
    poses: Pose                      # (T,) odometry poses
    store: kf.KeyframeStore | None   # keyframes (None without a gate)
    added: torch.Tensor | None       # (T,) bool, a keyframe added at frame i
    state: object                    # the final OdometryState / LIO state
    error: torch.Tensor | None       # (T,) scan2map's / LOAM's registration cost (0 at frame 0)
    inliers: torch.Tensor | None     # (T,) their registration inliers
    stats: dict                      # captures, replays, capture_s, pool_bytes


# --------------------------------------------------------------------------
# keyframe gates
# --------------------------------------------------------------------------


def _store_bufs(store: kf.KeyframeStore) -> dict:
    return dict(kf_xyz=store.xyz, kf_mask=store.mask, kf_R=store.poses.R, kf_t=store.poses.t,
                kf_stamps=store.stamps, kf_count=store.count.clone(),
                kf_last_R=store.last_pose.R.clone(), kf_last_t=store.last_pose.t.clone())


def _store(b: dict) -> kf.KeyframeStore:
    return kf.KeyframeStore(xyz=b["kf_xyz"], mask=b["kf_mask"], poses=Pose(b["kf_R"], b["kf_t"]),
                            stamps=b["kf_stamps"], count=b["kf_count"],
                            last_pose=Pose(b["kf_last_R"], b["kf_last_t"]))


class StoreGate:
    """`kf.maybe_add(store, scan, pose, stamp, **gate)` on a
    `KeyframeStore` whose tensors become the runner's buffers (it writes
    the slot in place; the count and gate anchor are copied)."""

    def __init__(self, store: kf.KeyframeStore, **gate):
        self.gate = gate
        self._init = store

    def bufs(self) -> dict:
        return _store_bufs(self._init)

    def rebind(self, b: dict) -> bool:
        return False

    def __call__(self, b: dict, pose: Pose) -> dict:
        store, add = kf.maybe_add(_store(b), pcl.PointCloud(b["xyz"], b["mask"]), pose, b["stamp"],
                                  **self.gate)
        b["kf_count"].copy_(store.count)
        b["kf_last_R"].copy_(store.last_pose.R)
        b["kf_last_t"].copy_(store.last_pose.t)
        return dict(added=add)

    def store(self, b: dict) -> kf.KeyframeStore:
        return _store(b)


class RowGate:
    """`store.gate_and_add` on row `row` of a session's
    `MultiRobotStore`, in place. The store's tensors are buffers of the
    runner: the session sets `store` to its current store before every
    frame, and when it has reallocated the store (a robot joined past the
    allocated rows) `rebind` points the buffers at the new tensors, after
    which the runner captures its gated segments anew. Outputs: `added`
    (device bool) and `slot` (device int64)."""

    def __init__(self, store: mstore_lib.MultiRobotStore, row: int, dist_thresh: float,
                 leaf: float):
        self.store, self.row = store, row
        self.dist_thresh, self.leaf = dist_thresh, leaf

    def bufs(self) -> dict:
        s = self.store.stores
        return dict(ms_xyz=s.xyz, ms_mask=s.mask, ms_R=s.poses.R, ms_t=s.poses.t,
                    ms_stamps=s.stamps, ms_count=s.count, ms_last_R=s.last_pose.R,
                    ms_last_t=s.last_pose.t, ms_valid=self.store.desc_valid)

    def rebind(self, b: dict) -> bool:
        new = self.bufs()
        if all(b[k].data_ptr() == v.data_ptr() for k, v in new.items()):
            return False
        b.update(new)
        return True

    def __call__(self, b: dict, pose: Pose) -> dict:
        stores = kf.KeyframeStore(xyz=b["ms_xyz"], mask=b["ms_mask"],
                                  poses=Pose(b["ms_R"], b["ms_t"]), stamps=b["ms_stamps"],
                                  count=b["ms_count"], last_pose=Pose(b["ms_last_R"], b["ms_last_t"]))
        store = mstore_lib.MultiRobotStore(stores=stores, descriptors=None, desc_valid=b["ms_valid"])
        _, added, slot = mstore_lib.gate_and_add(store, self.row, pcl.PointCloud(b["xyz"], b["mask"]),
                                                 pose, b["stamp"], dist_thresh=self.dist_thresh,
                                                 leaf=self.leaf)
        return dict(added=added, slot=slot)


# --------------------------------------------------------------------------
# runners
# --------------------------------------------------------------------------

# the front-end runners' projections between replays: their sync site and span
PROJECT = ("frontend.project", "online.frontend.project")


def _load_frame(b: dict, xyz: torch.Tensor, mask: torch.Tensor, times: torch.Tensor | None,
                stamp: float) -> None:
    """Copy a frame's inputs into the buffers (called once a frame). A
    CPU input in pinned memory reaches the card without a host sync."""
    b["xyz"].copy_(xyz, non_blocking=True)
    b["mask"].copy_(mask, non_blocking=True)
    if times is not None:
        b["times"].copy_(times, non_blocking=True)
    b["stamp"].fill_(float(stamp))


class _Runner:
    """What both front-ends' runners share: the segments, the frame
    buffers, the gate and its recaptures."""

    GATED: tuple = ()

    def __init__(self, dev, n_points: int, with_times: bool, gate):
        self.segs = Segments(dev, "frontend")
        self.gate = gate
        self.steps = 0
        self.gate_recaptures = 0
        self.b = dict(xyz=torch.empty((n_points, 3), device=dev),
                      mask=torch.empty((n_points,), dtype=torch.bool, device=dev),
                      stamp=torch.zeros((), device=dev))
        if with_times:
            self.b["times"] = torch.empty((n_points,), device=dev)
        if gate is not None:
            self.b.update(gate.bufs())

    def _rebind_gate(self) -> None:
        if self.gate is not None and self.gate.rebind(self.b):
            self.gate_recaptures += sum(self.segs.drop(n) for n in self.GATED)

    def stats(self) -> dict:
        s = self.segs
        return dict(frames=self.steps, captures=s.captures, replays=s.replays,
                    capture_s=s.capture_s, pool_bytes=s.pool_bytes(),
                    gate_recaptures=self.gate_recaptures)

    def close(self) -> dict:
        """Release the graphs once their last replay has run; returns the
        runner's counts (`stats`)."""
        return dict(self.segs.close(self.steps), gate_recaptures=self.gate_recaptures)


class Scan2Map(_Runner):
    """scan2map's runner: `odometry.step` with `config` from `state`,
    then the gate, a frame a `step`, on (N, 3) / (N,) scans (with (N,)
    point times when `with_times`)."""

    GATED = ("commit",)

    def __init__(self, state: odometry.OdometryState, config: odometry.OdometryConfig,
                 n_points: int, with_times: bool = False, gate=None):
        super().__init__(state.pose.t.device, n_points, with_times, gate)
        self.config, self.frame = config, state.frame
        self.leaf, self.coarse_leaf = state.grid.leaf, state.coarse_grid.leaf
        R, t = state.pose
        self.b.update(R=R.clone(), t=t.clone(), prev_R=state.prev_pose.R.clone(),
                      prev_t=state.prev_pose.t.clone(), new_R=R.clone(), new_t=t.clone(),
                      coarse_R=R.clone(), grid=state.grid.packed.clone(),
                      coarse=state.coarse_grid.packed.clone())

    def pose(self) -> Pose:
        return Pose(self.b["R"], self.b["t"])

    def state(self) -> odometry.OdometryState:
        """The state on the buffers (views: the next step rewrites them)."""
        b = self.b
        return odometry.OdometryState(
            grid=voxel_grid.VoxelGrid(b["grid"], self.leaf),
            coarse_grid=voxel_grid.VoxelGrid(b["coarse"], self.coarse_leaf),
            pose=self.pose(), prev_pose=Pose(b["prev_R"], b["prev_t"]), frame=self.frame)

    def _predict(self, b):
        return odometry.predict(Pose(b["R"], b["t"]), Pose(b["prev_R"], b["prev_t"]),
                                pcl.PointCloud(b["xyz"], b["mask"]), self.config, b.get("times"))

    def _first(self, b):  # frame 0: no registration, the pose is the prediction
        pred, scan, ds = self._predict(b)
        b["new_R"].copy_(pred.R)
        b["new_t"].copy_(pred.t)
        return dict(scan=scan, ds=ds)

    def _coarse(self, b):
        pred, scan, ds = self._predict(b)
        res = odometry.register_coarse(ds, voxel_grid.VoxelGrid(b["coarse"], self.coarse_leaf),
                                       pred, self.config)
        return dict(scan=scan, ds=ds, coarse_raw=res.pose.R, coarse_t=res.pose.t)

    def _fine(self, b):
        res = odometry.register_fine(b["ds"], voxel_grid.VoxelGrid(b["grid"], self.leaf),
                                     Pose(b["coarse_R"], b["coarse_t"]), self.config)
        b["new_t"].copy_(res.pose.t)
        return dict(fine_raw=res.pose.R, error=res.error, inliers=res.num_inliers)

    def _insert(self, b):
        grid = odometry.insert_fine(voxel_grid.VoxelGrid(b["grid"], self.leaf), b["scan"],
                                    Pose(b["new_R"], b["new_t"]), self.config)
        b["grid"].copy_(grid.packed)
        return {}

    def _decay(self, b):
        grid = odometry.decay_fine(voxel_grid.VoxelGrid(b["grid"], self.leaf),
                                   Pose(b["new_R"], b["new_t"]), self.config)
        b["grid"].copy_(grid.packed)
        return {}

    def _coarse_insert(self, b):
        grid = odometry.insert_coarse(voxel_grid.VoxelGrid(b["coarse"], self.coarse_leaf), b["ds"],
                                      Pose(b["new_R"], b["new_t"]), self.config)
        b["coarse"].copy_(grid.packed)
        return {}

    def _commit(self, b):
        b["prev_R"].copy_(b["R"])
        b["prev_t"].copy_(b["t"])
        b["R"].copy_(b["new_R"])
        b["t"].copy_(b["new_t"])
        return {} if self.gate is None else self.gate(b, Pose(b["R"], b["t"]))

    def step(self, xyz, mask, times=None, stamp: float = 0.0, shed: bool = False) -> dict:
        """One frame: `odometry.step(shed=shed)` on the scan, then the gate
        at `stamp`. Returns the frame's outputs: the gate's, and `error`
        and `inliers` from the state's frame 1 on; on the card they are
        the graphs' tensors, which the next step rewrites."""
        b, segs, i = self.b, self.segs, self.frame
        run = segs.eager if self.steps == 0 else segs.run
        out = {}
        with segs.on_stream():
            _load_frame(b, xyz, mask, times, stamp)
            if i == 0:
                b.update(run("first", self._first, b))
            else:
                b.update(run("coarse", self._coarse, b))
                b["coarse_R"].copy_(project(b["coarse_raw"], *PROJECT))
                b.update(run("fine", self._fine, b))
                b["new_R"].copy_(project(b["fine_raw"], *PROJECT))
                out.update(error=b["error"], inliers=b["inliers"])
            if not shed:
                run("insert", self._insert, b)
                if odometry.decays(i, self.config):
                    run("decay", self._decay, b)
                if odometry.inserts_coarse(i, self.config):
                    run("coarse_insert", self._coarse_insert, b)
            self._rebind_gate()
            gated = run("commit", self._commit, b)
            b.update(gated)
        self.frame += 1
        self.steps += 1
        return dict(out, **gated)


class Lio(_Runner):
    """The LIO front-end's runner: `lio.step` with `config` from `state`,
    then the gate, a frame a `step`. `end`: every point's time is
    clipped to it and it stands for missing point times (the batch path:
    packet 0's sweep end); None: each frame's own packet's sweep end
    stands for missing times and given times are used unclipped (the
    session, as the reference's `OnlineSlam.add_frame`)."""

    GATED = ("origin", "step_first", "step")
    FIELDS = ("R", "p", "v", "bg", "ba", "R_li", "t_li", "grav", "P")

    def __init__(self, state, config, n_points: int, with_times: bool = False, gate=None,
                 end: torch.Tensor | None = None):
        super().__init__(state.p.device, n_points, with_times, gate)
        self.config, self.frame, self.leaf = config, state.frame, state.grid.leaf
        self.n_points = n_points
        self.b.update({f: getattr(state, f).clone() for f in self.FIELDS})
        self.b["grid"] = state.grid.packed.clone()
        if end is not None:
            self.b["end"] = end

    @property
    def imu_len(self) -> int | None:
        """Samples of the IMU packets the buffers hold (None before the first)."""
        return None if "dt" not in self.b else self.b["dt"].shape[0]

    def pose(self) -> Pose:
        return Pose(self.b["R"], self.b["p"])

    def state(self):
        """The state on the buffers (views: the next step rewrites them)."""
        from ..frontend import lio as lio_mod

        return lio_mod.LioState(**{f: self.b[f] for f in self.FIELDS},
                                grid=voxel_grid.VoxelGrid(self.b["grid"], self.leaf),
                                frame=self.frame)

    def _origin(self, b):
        return {} if self.gate is None else self.gate(b, Pose(b["R"], b["p"]))

    def _frame_fn(self, frame: int):
        from ..frontend import lio as lio_mod

        def fn(b):
            if "end" in b:
                pt_time = b["end"].expand(self.n_points) if "times" not in b \
                    else torch.minimum(b["times"], b["end"])
            else:
                end = torch.sum(b["dt"]) * 0.999
                pt_time = end.expand(self.n_points) if "times" not in b else b["times"]
            state = lio_mod.LioState(**{f: b[f] for f in self.FIELDS},
                                     grid=voxel_grid.VoxelGrid(b["grid"], self.leaf), frame=frame)
            new, _ = lio_mod.step(state, pcl.PointCloud(b["xyz"], b["mask"]), pt_time,
                                  lio_mod.ImuSample(gyro=b["gyro"], acc=b["acc"], dt=b["dt"]),
                                  self.config)
            for f in self.FIELDS:
                b[f].copy_(getattr(new, f))
            b["grid"].copy_(new.grid.packed)
            return {} if self.gate is None else self.gate(b, new.pose())
        return fn

    def step(self, xyz, mask, times=None, stamp: float = 0.0, imu: tuple | None = None) -> dict:
        """One frame: with `imu` = (gyro (S, 3), acc (S, 3), dt (S)),
        `lio.step` on the packet, then the gate at `stamp`; without, the
        gate on the current pose alone (no filter step). Returns the
        gate's outputs (on the card the graphs' tensors, which the next
        step rewrites). Every packet of a runner has the same S."""
        b, segs = self.b, self.segs
        run = segs.eager if self.steps == 0 else segs.run
        with segs.on_stream():
            _load_frame(b, xyz, mask, times, stamp)
            self._rebind_gate()
            if imu is None:
                out = run("origin", self._origin, b)
            else:
                for name, x in zip(("gyro", "acc", "dt"), imu):
                    if name not in b:
                        b[name] = torch.empty(x.shape, dtype=x.dtype, device=b["p"].device)
                    b[name].copy_(x, non_blocking=True)
                out = run("step_first" if self.frame == 0 else "step", self._frame_fn(self.frame), b)
                self.frame += 1
            b.update(out)
        self.steps += 1
        return out


def scan2map(scans: pcl.PointCloud, config: odometry.OdometryConfig, origin: Pose,
             times: torch.Tensor | None = None, store: kf.KeyframeStore | None = None,
             gate: dict | None = None, shed=None) -> Run:
    """`odometry.step` over a stacked (T, N, 3)/(T, N) sequence on the
    scans' device, with `kf.maybe_add(store, scan, pose, i, **gate)`
    after each step when a `store` is given. `times`: (T, N) point
    times (motion compensation); `shed`: T bools, the steps run with
    `shed=True`. Returns each step's cost and inliers beside the poses.
    Equal bit for bit to the loop of `odometry.step` and `kf.maybe_add`
    on the same device (`pipeline._frontend_scan2map`)."""
    dev = scans.xyz.device
    T, N = scans.xyz.shape[:2]
    runner = Scan2Map(odometry.init(config, origin), config, N, times is not None,
                      None if store is None else StoreGate(store, **(gate or {})))
    out_R = torch.empty((T, 3, 3), device=dev)
    out_t = torch.empty((T, 3), device=dev)
    added = torch.empty((T,), dtype=torch.bool, device=dev) if store is not None else None
    err = torch.zeros((T,), device=dev)
    inl = torch.zeros((T,), device=dev)
    with runner.segs.on_stream():
        for i in range(T):
            out = runner.step(scans.xyz[i], scans.mask[i], None if times is None else times[i],
                              float(i), shed=shed is not None and bool(shed[i]))
            if "error" in out:
                err[i].copy_(out["error"])
                inl[i].copy_(out["inliers"])
            out_R[i].copy_(runner.b["R"])
            out_t[i].copy_(runner.b["t"])
            if store is not None:
                added[i].copy_(out["added"])
    return Run(poses=Pose(out_R, out_t), store=None if store is None else runner.gate.store(runner.b),
               added=added, state=runner.state(), error=err, inliers=inl, stats=runner.close())


def lio(scans: pcl.PointCloud, imu: tuple, config, origin: Pose, extrinsic: Pose | None = None,
        times: torch.Tensor | None = None, store: kf.KeyframeStore | None = None,
        gate: dict | None = None) -> Run:
    """The LIO front-end over a stacked sequence with IMU packets (gyro
    (T-1, S, 3), acc (T-1, S, 3), dt (T-1, S)): frame 0 gates the origin
    keyframe; frame i >= 1 runs `lio.step` on packet i - 1 and gates a
    keyframe, as one CUDA graph on the card. Without `times` every point
    is stamped at the sweep end. Equal bit for bit to
    `pipeline._frontend_lio` on the same device."""
    from ..frontend import lio as lio_mod

    gyro, acc, dts = imu
    dev = scans.xyz.device
    T, N = scans.xyz.shape[:2]
    runner = Lio(lio_mod.init(config, origin, extrinsic=extrinsic), config, N, times is not None,
                 None if store is None else StoreGate(store, **(gate or {})),
                 end=torch.sum(dts[0]) * 0.999)
    out_R = torch.empty((T, 3, 3), device=dev)
    out_t = torch.empty((T, 3), device=dev)
    added = torch.empty((T,), dtype=torch.bool, device=dev) if store is not None else None
    with runner.segs.on_stream():
        for i in range(T):
            packet = None if i == 0 else (gyro[i - 1], acc[i - 1], dts[i - 1])
            out = runner.step(scans.xyz[i], scans.mask[i], None if times is None else times[i],
                              float(i), packet)
            out_R[i].copy_(origin.R if i == 0 else runner.b["R"])
            out_t[i].copy_(origin.t if i == 0 else runner.b["p"])
            if store is not None:
                added[i].copy_(out["added"])
    return Run(poses=Pose(out_R, out_t), store=None if store is None else runner.gate.store(runner.b),
               added=added, state=runner.state(), error=None, inliers=None, stats=runner.close())


class Loam:
    """The A-LOAM feature front-end's runner: `feature_odometry.step` with
    `config` from `state`, a frame a `step`, on (R, A, 3) / (R, A) range
    images."""

    def __init__(self, state: odometry.OdometryState, config: odometry.OdometryConfig,
                 image_shape: tuple):
        dev = state.pose.t.device
        self.segs = Segments(dev, "frontend")
        self.config, self.frame, self.steps = config, state.frame, 0
        self.leaf, self.coarse_leaf = state.grid.leaf, state.coarse_grid.leaf
        R, t = state.pose
        self.b = dict(xyz=torch.empty((*image_shape, 3), device=dev),
                      hit=torch.empty(image_shape, dtype=torch.bool, device=dev),
                      R=R.clone(), t=t.clone(), prev_R=state.prev_pose.R.clone(),
                      prev_t=state.prev_pose.t.clone(), new_R=R.clone(), new_t=t.clone(),
                      coarse_R=R.clone(), grid=state.grid.packed.clone(),
                      coarse=state.coarse_grid.packed.clone())

    def state(self) -> odometry.OdometryState:
        """The state on the buffers (views: the next step rewrites them)."""
        b = self.b
        return odometry.OdometryState(
            grid=voxel_grid.VoxelGrid(b["grid"], self.leaf),
            coarse_grid=voxel_grid.VoxelGrid(b["coarse"], self.coarse_leaf),
            pose=Pose(b["R"], b["t"]), prev_pose=Pose(b["prev_R"], b["prev_t"]),
            frame=self.frame)

    def _predict(self, b) -> Pose:
        return feature_odometry.predict(Pose(b["R"], b["t"]), Pose(b["prev_R"], b["prev_t"]))

    def _first(self, b):  # frame 0: no registration, the pose is the prediction
        pred = self._predict(b)
        b["new_R"].copy_(pred.R)
        b["new_t"].copy_(pred.t)
        return {}

    def _coarse(self, b):
        f = feat.extract(b["xyz"], b["hit"])
        res = registration.point_to_plane_icp_raw(
            f.surfs, voxel_grid.VoxelGrid(b["coarse"], self.coarse_leaf), self._predict(b),
            **feature_odometry.coarse_kw(self.config))
        return dict(corners=f.corners.xyz, corners_mask=f.corners.mask, surfs=f.surfs.xyz,
                    surfs_mask=f.surfs.mask, coarse_raw=res.pose.R, coarse_t=res.pose.t)

    def _loam(self, b):
        res = registration.loam_icp_raw(
            pcl.PointCloud(b["corners"], b["corners_mask"]),
            pcl.PointCloud(b["surfs"], b["surfs_mask"]), voxel_grid.VoxelGrid(b["grid"], self.leaf),
            Pose(b["coarse_R"], b["coarse_t"]), **feature_odometry.loam_kw(self.config))
        b["new_t"].copy_(res.pose.t)
        return dict(loam_raw=res.pose.R, error=res.error, inliers=res.num_inliers)

    def _maintain(self, b):
        grid, coarse = feature_odometry.maintain(
            voxel_grid.VoxelGrid(b["grid"], self.leaf),
            voxel_grid.VoxelGrid(b["coarse"], self.coarse_leaf), b["xyz"], b["hit"],
            Pose(b["new_R"], b["new_t"]), self.config)
        b["grid"].copy_(grid.packed)
        b["coarse"].copy_(coarse.packed)
        b["prev_R"].copy_(b["R"])
        b["prev_t"].copy_(b["t"])
        b["R"].copy_(b["new_R"])
        b["t"].copy_(b["new_t"])
        return {}

    def step(self, xyz: torch.Tensor, hit: torch.Tensor) -> dict:
        """One frame of `feature_odometry.step`. Returns `error` and
        `inliers` from the state's frame 1 on (on the card the graphs'
        tensors, which the next step rewrites)."""
        b, segs = self.b, self.segs
        run = segs.eager if self.steps == 0 else segs.run
        out = {}
        with segs.on_stream():
            b["xyz"].copy_(xyz, non_blocking=True)
            b["hit"].copy_(hit, non_blocking=True)
            if self.frame == 0:
                run("first", self._first, b)
            else:
                b.update(run("coarse", self._coarse, b))
                b["coarse_R"].copy_(project(b["coarse_raw"], *PROJECT))
                b.update(run("loam", self._loam, b))
                b["new_R"].copy_(project(b["loam_raw"], *PROJECT))
                out.update(error=b["error"], inliers=b["inliers"])
            run("maintain", self._maintain, b)
        self.frame += 1
        self.steps += 1
        return out

    def close(self) -> dict:
        """Release the graphs once their last replay has run; returns the
        runner's counts: frames, captures, replays, capture seconds and
        the pool's bytes."""
        return self.segs.close(self.steps)


def loam(xyz_images: torch.Tensor, hits: torch.Tensor, config: odometry.OdometryConfig,
         origin: Pose | None = None) -> Run:
    """`feature_odometry.step` over (T, R, A, 3) / (T, R, A) range images
    on their device, from `odometry.init(config, origin)`, through one
    `Loam` runner. Equal bit for bit to the loop of `step` on the same
    device (`feature_odometry._run_eager`)."""
    dev = xyz_images.device
    T = xyz_images.shape[0]
    runner = Loam(odometry.init(config, origin, device=dev), config, hits.shape[1:])
    out_R = torch.empty((T, 3, 3), device=dev)
    out_t = torch.empty((T, 3), device=dev)
    err = torch.zeros((T,), device=dev)
    inl = torch.zeros((T,), device=dev)
    with runner.segs.on_stream():
        for i in range(T):
            out = runner.step(xyz_images[i], hits[i])
            if out:
                err[i].copy_(out["error"])
                inl[i].copy_(out["inliers"])
            out_R[i].copy_(runner.b["R"])
            out_t[i].copy_(runner.b["t"])
    return Run(poses=Pose(out_R, out_t), store=None, added=None, state=runner.state(), error=err,
               inliers=inl, stats=runner.close())
