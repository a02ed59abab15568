"""Drive the program: the fleet's stream through one
`mr_slam_torch.runtime.online.OnlineSlam` session, closed loop (the next
frame goes in when `add_frame` returns), a warm prefix first and then the
measured window.

What the window records is the program's output and nothing more: each
call's host time, the pose `add_frame` returned, the robot's keyframe
count after the call (a host integer of the session), and, around the
front-end frames sampled from the seed, copies of the robot's odometry
state before and after the frame (outside the timed call). After the
window the session's loops, candidates, last solve and keyframe clouds
are copied out and the session is dropped."""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .traffic import Stream


@dataclass
class Record:
    """What the run saw of the program."""
    poses: dict = field(default_factory=dict)      # (robot, frame) -> (R, t) device clones
    kf_after: dict = field(default_factory=dict)   # (robot, frame) -> keyframes after the call
    call_s: list = field(default_factory=list)     # host seconds of each window call
    window: list = field(default_factory=list)     # (robot, frame) of each window call
    kinds: list = field(default_factory=list)      # what each window call ran (`KINDS`)
    window_s: float = 0.0
    samples: list = field(default_factory=list)    # (robot, frame, state before, state after)
    fed: int = 0                                   # fleet frames fed, prefix included
    out: dict = field(default_factory=dict)        # the session's products after the window


def snapshot(state):
    """A copy of a robot's odometry state (`OdometryState` / `LioState`):
    tensors cloned, grids and poses field by field, host ints kept."""
    def copy(x):
        if isinstance(x, torch.Tensor):
            return x.clone()
        if isinstance(x, tuple) and hasattr(x, "_fields"):
            return {"_type": type(x).__name__, **{f: copy(getattr(x, f)) for f in x._fields}}
        return x
    return copy(state)


def sample_frames(stream: Stream, seed: int) -> set:
    """Front-end frames to check: per robot, every `sample_every`-th frame
    after the prefix from an offset drawn from the seed."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 7])
    R, k = stream.robots, stream.sample_every
    first = stream.prefix // R
    out = set()
    T = stream.xyz[0].shape[0]
    for r in range(R):
        i = first + int(rng.integers(2, k + 2))
        while i < T:
            out.add((r, i))
            i += k
    return out


# what a call ran besides the front-end, from the program's spans and
# counters: the most expensive first
KINDS = (("solve", "span", "online.solve"), ("loop", "span", "loop.retrieve"),
         ("compose", "span", "online.compose"), ("tf", "counter", "tf.publishes"))


def _activity(obs) -> tuple:
    st, ct = obs.tracer.stats, obs.metrics.counters
    return tuple(st[name].count if src == "span" and name in st else
                 ct.get(name, 0) if src == "counter" else 0 for _, src, name in KINDS)


class Driver:
    def __init__(self, session, stream: Stream, seed: int, sync):
        self.sess = session
        self.stream = stream
        self.sync = sync
        self.rec = Record()
        self.samples = sample_frames(stream, seed)

    def feed(self, j: int, timed: bool) -> None:
        """Fleet frame j of the stream into the session."""
        st, sess, rec = self.stream, self.sess, self.rec
        r, i = st.order[j]
        xyz, mask, times, imu = st.frame(r, i)
        if r not in sess.robots:
            origin = st.trajs[r]
            from mr_slam_torch.geometry.se3 import Pose as PPose
            sess.register_robot(r, PPose(origin.R[0].clone(), origin.t[0].clone()))
        sampled = timed and (r, i) in self.samples
        if sampled:
            before = snapshot(sess.robots[r]["odo"])
        from mr_slam_torch.ops.pointcloud import PointCloud as PCloud
        from mr_slam_torch.runtime import observability as obs
        act0 = _activity(obs) if timed else None
        t0 = time.perf_counter()
        pose = sess.add_frame(r, PCloud(xyz, mask), stamp=st.stamps[(r, i)], times=times, imu=imu)
        dt = time.perf_counter() - t0
        if timed:
            act = _activity(obs)
            rec.kinds.append(next((k for (k, _, _), a, b in zip(KINDS, act0, act) if b > a), "plain"))
        rec.poses[(r, i)] = (pose.R, pose.t)
        rec.kf_after[(r, i)] = sess.kf_counts[r]
        rec.fed += 1
        if timed:
            rec.call_s.append(dt)
            rec.window.append((r, i))
        if sampled:
            rec.samples.append((r, i, before, snapshot(sess.robots[r]["odo"])))

    def prefix(self) -> None:
        for j in range(self.stream.prefix):
            self.feed(j, timed=False)
        self.sync()

    def window(self, seconds: float, on_frame=None) -> None:
        """Feed frames until `seconds` have passed; every frame started in
        time is finished and counted, and the window ends when the last
        one returns. Raises when the stream runs out first."""
        st = self.stream
        j = st.prefix
        t0 = time.perf_counter()
        aside = 0.0  # seconds the callback took (the traced run's profiler)
        while time.perf_counter() - t0 - aside < seconds:
            if j >= len(st.order):
                raise RuntimeError(
                    f"the stream ran out after {j - st.prefix} window frames in "
                    f"{time.perf_counter() - t0:.1f} s: the mix holds too few frames for "
                    f"a {seconds} s window")
            self.feed(j, timed=True)
            if on_frame is not None:
                aside += on_frame(j - st.prefix, time.perf_counter() - t0 - aside)
            j += 1
        self.sync()
        self.rec.window_s = time.perf_counter() - t0 - aside

    def collect(self) -> None:
        """Copy the session's products out of it: every loop found (intra
        loops are kept, inter-robot ones are PCM's candidates), the loops
        accepted at the last solve, the solve's poses and node count, the
        node of each keyframe and the stored keyframe clouds."""
        sess = self.sess

        def loop(l):
            return dict(robot_a=l["robot_a"], kf_a=l["kf_a"], robot_b=l["robot_b"],
                        kf_b=l["kf_b"], fitness=l["fitness"],
                        rel=(l["rel"].R.clone(), l["rel"].t.clone()))

        intra = [l for l in sess.loops if l["robot_a"] == l["robot_b"]]
        found = [loop(l) for l in intra] + [loop(l) for l in sess._inter_candidates]
        kept = [(l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"]) for l in sess.loops]
        stores = {}
        for r in sess.robots:
            store, _ = sess.store_view(r)
            K = sess.kf_counts[r]
            stores[r] = dict(xyz=store.xyz[:K].clone(), mask=store.mask[:K].clone(),
                             R=store.poses.R[:K].clone(), t=store.poses.t[:K].clone())
        opt = None
        if sess.opt_poses is not None:
            n = sess._opt_n_nodes
            opt = (sess.opt_poses.R[:n].clone(), sess.opt_poses.t[:n].clone())
        self.rec.out = dict(found=found, kept=kept, stores=stores, opt=opt,
                            opt_n_nodes=sess._opt_n_nodes, node_of=dict(sess.node_of),
                            robots=list(sess.robots), loop_every=sess.loop_every)
