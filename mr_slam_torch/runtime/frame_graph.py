"""The front-ends' frame loops replayed as CUDA graphs: the port's
counterpart of the reference's `pipeline._frontend_fused` and
`_frontend_fused_lio` (`mr_slam_tpu/runtime/pipeline.py:80-186`), which
run a robot's whole front-end as one compiled `lax.scan`.

A frame's state lives in static buffers (the scan, its mask and point
times, the IMU packet, the stamp, the poses, both maps' packed tables,
the keyframe store). The work of a frame is cut into segments, each a
function of those buffers that writes its new state back into them
with `copy_`:

  scan2map (`scan2map`), the stages of `odometry.step`:
    coarse         prediction, motion compensation, downsample, coarse ICP
                   [so3.project, eager: its torch.linalg.svd syncs the host]
    fine           fine ICP
                   [so3.project, eager]
    insert         fine insert                  (not when shed)
    decay          fine-map trim                (its cadence, not when shed)
    coarse_insert  coarse insert + trim         (its cadence, not when shed)
    commit         pose <- new pose, the keyframe gate
  LIO (`lio`): frame i >= 1 is one segment, `lio.step` and the keyframe
    gate (no projection, no host sync); the filter's first step (no
    update) and the later ones are two segments.

Frame 0 runs eagerly. On a CUDA device each segment is captured into a
CUDA graph the first time it runs from frame 1 on, and replayed from
then on: every frame i >= 1 is graph replays, the projections between
them and the copies of the frame's inputs and outputs. Before its
capture a segment that has not run eagerly in this call runs once
eagerly on copies of the buffers (results dropped): that run makes the
device constants (`devconst`) and the cuBLAS / CUB workspaces of the
runner's stream, which a capture cannot. All of a call's graphs share
one memory pool and one stream. A replay launches the same kernels on
the same inputs as the eager step, so the results are the eager card
path's bit for bit. A failed capture raises: there is no eager fallback
on the card. On the CPU the same segments run eagerly, in the same
order, on the same buffers. A capture launches nothing, so the VGICP
kernel's wrapper does not count the launches it records; each replay
adds them (`hopper_vgicp.add_launches`), and the counts stay the
launches the card ran. Loop verification's chunks run on the same
`Segments` (`runtime/verify_graph.py`).
"""
from __future__ import annotations

import collections
import contextlib
import functools
import time
from typing import Callable, NamedTuple

import torch

from ..frontend import keyframes as kf
from ..frontend import odometry
from ..geometry import so3
from ..geometry.se3 import Pose
from ..ops import hopper_vgicp
from ..ops import pointcloud as pcl
from ..ops import voxel_grid


def _clone(x):
    if isinstance(x, torch.Tensor):
        return x.clone()
    if isinstance(x, dict):
        return {k: _clone(v) for k, v in x.items()}
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return type(x)(*(_clone(v) for v in x))
    return x


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
    rewritten by every replay)."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.capture = self.device.type == "cuda"
        self._graphs: dict = {}
        self._eager: set = set()
        self.captures = 0
        self.replays = 0
        self.capture_s = 0.0
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
        """Run the segment eagerly on every device (frame 0)."""
        self._eager.add(name)
        return fn(bufs)

    def run(self, name: str, fn: Callable, bufs: dict) -> dict:
        """Run the segment: a graph replay on a CUDA device (captured at
        the first call, on the buffers of that call), eagerly on the CPU."""
        if not self.capture:
            return fn(bufs)
        if name not in self._graphs:
            self._graphs[name] = self._capture(name, fn, bufs)
        graph, out, launches = self._graphs[name]
        graph.replay()
        self.replays += 1
        if launches:
            hopper_vgicp.add_launches(launches)
        return out

    def _capture(self, name: str, fn: Callable, bufs: dict):
        t = time.perf_counter()
        if name not in self._eager:
            fn(_clone(bufs))
        recorded = collections.Counter(hopper_vgicp.recorded_by_batch())
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
        try:
            out = fn(bufs)
        except BaseException:
            with contextlib.suppress(RuntimeError):  # the capture is already invalid
                graph.capture_end()
            raise
        graph.capture_end()
        self.captures += 1
        self.capture_s += time.perf_counter() - t
        return graph, out, dict(collections.Counter(hopper_vgicp.recorded_by_batch()) - recorded)

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
            self.stream.synchronize()
            self._graphs.clear()
        return stats


class Run(NamedTuple):
    poses: Pose                      # (T,) odometry poses
    store: kf.KeyframeStore | None   # keyframes (None without a gate)
    added: torch.Tensor | None       # (T,) bool, a keyframe added at frame i
    state: object                    # the final OdometryState / LIO state
    error: torch.Tensor | None       # (T,) scan2map's registration cost (0 at frame 0)
    inliers: torch.Tensor | None     # (T,) scan2map's registration inliers
    stats: dict                      # captures, replays, capture_s, pool_bytes


def _store_bufs(store: kf.KeyframeStore) -> dict:
    return dict(kf_xyz=store.xyz, kf_mask=store.mask, kf_R=store.poses.R, kf_t=store.poses.t,
                kf_stamps=store.stamps, kf_count=store.count.clone(),
                kf_last_R=store.last_pose.R.clone(), kf_last_t=store.last_pose.t.clone())


def _store(b: dict) -> kf.KeyframeStore:
    return kf.KeyframeStore(xyz=b["kf_xyz"], mask=b["kf_mask"], poses=Pose(b["kf_R"], b["kf_t"]),
                            stamps=b["kf_stamps"], count=b["kf_count"],
                            last_pose=Pose(b["kf_last_R"], b["kf_last_t"]))


def _gate(b: dict, pose: Pose, gate: dict) -> torch.Tensor:
    """`kf.maybe_add` of the frame's scan on the store's buffers (it
    writes the slot in place; the count and gate anchor are copied)."""
    store, add = kf.maybe_add(_store(b), pcl.PointCloud(b["xyz"], b["mask"]), pose, b["stamp"],
                              **gate)
    b["kf_count"].copy_(store.count)
    b["kf_last_R"].copy_(store.last_pose.R)
    b["kf_last_t"].copy_(store.last_pose.t)
    return add


def _load_frame(b: dict, scans: pcl.PointCloud, i: int, times: torch.Tensor | None) -> None:
    b["xyz"].copy_(scans.xyz[i])
    b["mask"].copy_(scans.mask[i])
    if times is not None:
        b["times"].copy_(times[i])
    b["stamp"].fill_(float(i))


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
    segs = Segments(dev)
    state = odometry.init(config, origin)
    b = dict(xyz=torch.empty((N, 3), device=dev), mask=torch.empty((N,), dtype=torch.bool, device=dev),
             stamp=torch.zeros((), device=dev),
             R=origin.R.clone(), t=origin.t.clone(), prev_R=origin.R.clone(),
             prev_t=origin.t.clone(), new_R=origin.R.clone(), new_t=origin.t.clone(),
             coarse_R=origin.R.clone(), grid=state.grid.packed, coarse=state.coarse_grid.packed)
    if times is not None:
        b["times"] = torch.empty((N,), device=dev)
    if store is not None:
        b.update(_store_bufs(store))
    leaf, coarse_leaf = state.grid.leaf, state.coarse_grid.leaf
    out_R = torch.empty((T, 3, 3), device=dev)
    out_t = torch.empty((T, 3), device=dev)
    added = torch.empty((T,), dtype=torch.bool, device=dev) if store is not None else None
    err = torch.zeros((T,), device=dev)
    inl = torch.zeros((T,), device=dev)
    gate = gate or {}

    def pose(b, prefix=""):
        return Pose(b[prefix + "R"], b[prefix + "t"])

    def predict(b):
        return odometry.predict(pose(b), pose(b, "prev_"), pcl.PointCloud(b["xyz"], b["mask"]),
                                config, b.get("times"))

    def first(b):  # frame 0: no registration, the pose is the prediction
        pred, scan, ds = predict(b)
        b["new_R"].copy_(pred.R)
        b["new_t"].copy_(pred.t)
        return dict(scan=scan, ds=ds)

    def coarse(b):
        pred, scan, ds = predict(b)
        res = odometry.register_coarse(ds, voxel_grid.VoxelGrid(b["coarse"], coarse_leaf), pred,
                                       config)
        return dict(scan=scan, ds=ds, coarse_raw=res.pose.R, coarse_t=res.pose.t)

    def fine(b):
        res = odometry.register_fine(b["ds"], voxel_grid.VoxelGrid(b["grid"], leaf),
                                     Pose(b["coarse_R"], b["coarse_t"]), config)
        b["new_t"].copy_(res.pose.t)
        return dict(fine_raw=res.pose.R, error=res.error, inliers=res.num_inliers)

    def insert(b):
        grid = odometry.insert_fine(voxel_grid.VoxelGrid(b["grid"], leaf), b["scan"], pose(b, "new_"),
                                    config)
        b["grid"].copy_(grid.packed)
        return {}

    def decay(b):
        grid = odometry.decay_fine(voxel_grid.VoxelGrid(b["grid"], leaf), pose(b, "new_"), config)
        b["grid"].copy_(grid.packed)
        return {}

    def coarse_insert(b):
        grid = odometry.insert_coarse(voxel_grid.VoxelGrid(b["coarse"], coarse_leaf), b["ds"],
                                      pose(b, "new_"), config)
        b["coarse"].copy_(grid.packed)
        return {}

    def commit(b):
        b["prev_R"].copy_(b["R"])
        b["prev_t"].copy_(b["t"])
        b["R"].copy_(b["new_R"])
        b["t"].copy_(b["new_t"])
        return {} if store is None else dict(added=_gate(b, pose(b), gate))

    with segs.on_stream():
        for i in range(T):
            _load_frame(b, scans, i, times)
            run = segs.eager if i == 0 else segs.run
            if i == 0:
                b.update(run("first", first, b))
            else:
                b.update(run("coarse", coarse, b))
                b["coarse_R"].copy_(so3.project(b["coarse_raw"]))
                b.update(run("fine", fine, b))
                b["new_R"].copy_(so3.project(b["fine_raw"]))
                err[i].copy_(b["error"])
                inl[i].copy_(b["inliers"])
            if not (shed is not None and shed[i]):
                run("insert", insert, b)
                if odometry.decays(i, config):
                    run("decay", decay, b)
                if odometry.inserts_coarse(i, config):
                    run("coarse_insert", coarse_insert, b)
            b.update(run("commit", commit, b))
            out_R[i].copy_(b["R"])
            out_t[i].copy_(b["t"])
            if store is not None:
                added[i].copy_(b["added"])
    final = odometry.OdometryState(
        grid=voxel_grid.VoxelGrid(b["grid"], leaf),
        coarse_grid=voxel_grid.VoxelGrid(b["coarse"], coarse_leaf),
        pose=pose(b), prev_pose=pose(b, "prev_"), frame=T)
    return Run(poses=Pose(out_R, out_t), store=None if store is None else _store(b), added=added,
               state=final, error=err, inliers=inl, stats=segs.close(T))


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
    segs = Segments(dev)
    s0 = lio_mod.init(config, origin, extrinsic=extrinsic)
    fields = ("R", "p", "v", "bg", "ba", "R_li", "t_li", "grav", "P")
    b = {f: getattr(s0, f).clone() for f in fields}
    b.update(grid=s0.grid.packed, xyz=torch.empty((N, 3), device=dev),
             mask=torch.empty((N,), dtype=torch.bool, device=dev),
             stamp=torch.zeros((), device=dev), gyro=torch.empty_like(gyro[0]),
             acc=torch.empty_like(acc[0]), dt=torch.empty_like(dts[0]),
             end=torch.sum(dts[0]) * 0.999)
    if times is not None:
        b["times"] = torch.empty((N,), device=dev)
    if store is not None:
        b.update(_store_bufs(store))
    leaf = s0.grid.leaf
    out_R = torch.empty((T, 3, 3), device=dev)
    out_t = torch.empty((T, 3), device=dev)
    added = torch.empty((T,), dtype=torch.bool, device=dev) if store is not None else None
    gate = gate or {}

    def state(b, frame):
        return lio_mod.LioState(**{f: b[f] for f in fields},
                                grid=voxel_grid.VoxelGrid(b["grid"], leaf), frame=frame)

    def frame_fn(frame):
        def fn(b):
            pt_time = b["end"].expand(N) if times is None else torch.minimum(b["times"], b["end"])
            new, _ = lio_mod.step(state(b, frame), pcl.PointCloud(b["xyz"], b["mask"]), pt_time,
                                  lio_mod.ImuSample(gyro=b["gyro"], acc=b["acc"], dt=b["dt"]), config)
            for f in fields:
                b[f].copy_(getattr(new, f))
            b["grid"].copy_(new.grid.packed)
            return {} if store is None else dict(added=_gate(b, new.pose(), gate))
        return fn

    def origin_gate(b):
        return {} if store is None else dict(added=_gate(b, origin, gate))

    with segs.on_stream():
        for i in range(T):
            _load_frame(b, scans, i, times)
            if i == 0:
                b.update(segs.eager("origin", origin_gate, b))
                out_R[0].copy_(origin.R)
                out_t[0].copy_(origin.t)
            else:
                b["gyro"].copy_(gyro[i - 1])
                b["acc"].copy_(acc[i - 1])
                b["dt"].copy_(dts[i - 1])
                name = "step_first" if i == 1 else "step"
                b.update(segs.run(name, frame_fn(i - 1), b))
                out_R[i].copy_(b["R"])
                out_t[i].copy_(b["p"])
            if store is not None:
                added[i].copy_(b["added"])
    final = state(b, T - 1)
    return Run(poses=Pose(out_R, out_t), store=None if store is None else _store(b), added=added,
               state=final, error=None, inliers=None, stats=segs.close(T))
