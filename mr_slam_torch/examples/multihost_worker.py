"""Multi-process SLAM worker: one OS process of several, each owning a
contiguous block of the robots (the port's counterpart of
`examples/multihost_worker.py`).

    MRSLAM_COORDINATOR=127.0.0.1:29500 MRSLAM_NUM_PROCESSES=2 MRSLAM_PROCESS_ID=0 \\
        python -m mr_slam_torch.examples.multihost_worker

or, for all ranks at once, `launch(n_procs, env)` from Python. Each
process joins the group (`multihost.initialize`), feeds its own robots'
scans, and runs `multihost.run_multihost`; every process gets the same
result. Environment (besides the three above):

  MRSLAM_DEVICE   `cuda` (the default: the card, raises without one) or `cpu`
  MRSLAM_INPUT    an .npz with `xyz` (R, T, P, 3), `mask` (R, T, P),
                  `origin_R` (R, 3, 3), `origin_t` (R, 3), `cfg` (a
                  `SlamConfig.to_json()`) and optional grids (`grids`: names;
                  `<name>_height`, `<name>_valid`, `<name>_res`) for
                  `sharded_elevation.features_sharded`. Without it the
                  scenario of `scenario()`: MRSLAM_ROBOTS robots (2) x
                  MRSLAM_FRAMES frames (8) at 16 x 256 rays, drawn with numpy
  MRSLAM_OUT      a directory: each rank writes `rank<p>.npz` (its optimized
                  poses of every run, the replicated front-end products'
                  digests, loops, stats); process 0 also the grids' features
  MRSLAM_REPEAT   runs of `run_multihost` (1)
  MRSLAM_BENCH    set: time the front-ends only, MRSLAM_BENCH_REPS (3) times,
                  and print one JSON line {"bench_fps": ...} from process 0
"""
from __future__ import annotations

import hashlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]


def config(n_robots: int):
    """The reference worker's `SlamConfig` for `n_robots` robots."""
    from mr_slam_torch.runtime.config import KeyframeCfg, LoopCfg, OdometryCfg, SlamConfig

    return SlamConfig(
        n_robots=n_robots,
        odometry=OdometryCfg(table_size=1 << 15, scan_capacity=2048, insert_capacity=8192),
        keyframes=KeyframeCfg(capacity=16, points_per_kf=4096),
        loops=LoopCfg(dist_thresh=0.3, min_separation=4, fitness_thresh=0.15, candidates=1),
    )


def scenario(n_robots: int = 2, n_frames: int = 8):
    """The reference worker's scenario with numpy draws: world 7, robot r
    on a radius-22 circle at phase 2 pi r / R, ~2.6 m a frame, 16 x 256
    rays with robot r's range noise from seed r. Returns (host inputs as
    written to MRSLAM_INPUT, trajectories)."""
    from mr_slam_torch.datasets import synthetic

    world = synthetic.default_world(7)
    trajs = [synthetic.circle_trajectory(n_frames, radius=22.0, laps=0.15 * n_frames / 8.0,
                                         phase=2 * np.pi * r / n_robots)
             for r in range(n_robots)]
    clouds = [synthetic.scan_batch(world, t, n_rings=16, n_azimuth=256,
                                   rng=np.random.default_rng(r)) for r, t in enumerate(trajs)]
    inputs = dict(
        xyz=np.stack([c.xyz.numpy() for c in clouds]),
        mask=np.stack([c.mask.numpy() for c in clouds]),
        origin_R=np.stack([t.R[0].numpy() for t in trajs]),
        origin_t=np.stack([t.t[0].numpy() for t in trajs]),
        cfg=np.array(config(n_robots).to_json()),
    )
    return inputs, trajs


def digest(t: torch.Tensor) -> str:
    """A SHA-256 of a tensor's bytes (bit-for-bit comparisons across
    processes)."""
    return hashlib.sha256(t.detach().cpu().contiguous().numpy().tobytes()).hexdigest()


def robot_digests(rr) -> list[str]:
    """Digests of what a robot's front-end hands the back-end: the
    keyframe store, the odometry poses, the keyframe frames."""
    s = rr.store
    return [digest(x) for x in (s.xyz, s.mask, s.poses.R, s.poses.t, s.stamps, s.count,
                                s.last_pose.R, s.last_pose.t, rr.odom_poses.R, rr.odom_poses.t,
                                torch.as_tensor(rr.kf_frame_idx))]


def loop_rows(loops: list[dict]) -> np.ndarray:
    """Accepted loops as (L, 18) float32 rows [ra, kf_a, rb, kf_b,
    fitness, desc_dist, R(9), t(3)]."""
    rows = np.zeros((len(loops), 18), np.float32)
    for i, l in enumerate(loops):
        rows[i, :6] = [l["robot_a"], l["kf_a"], l["robot_b"], l["kf_b"], l["fitness"],
                       l["desc_dist"]]
        rows[i, 6:15] = l["rel"].R.reshape(-1).cpu().numpy()
        rows[i, 15:] = l["rel"].t.cpu().numpy()
    return rows


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _bench(host_scans, cfg, host_origins, dev, rank):
    """Front-end frames/s of every rank's robots together: each rank
    times its own front-ends after a barrier; the slowest rank sets the
    wall. Then, as the reference worker does, the wall split into the
    front-ends, the host feed (`feed_global`) and the replication
    (`_replicate_to_hosts`), each the mean of the reps on process 0."""
    import torch.distributed as dist

    from mr_slam_torch.ops import pointcloud as pcl
    from mr_slam_torch.parallel import mesh, multihost as mh

    reps = int(os.environ.get("MRSLAM_BENCH_REPS", "3"))
    scans, origins = mh.feed_global(host_scans, dev), mh.feed_global(host_origins, dev)
    # warm-up on two frames: the port compiles nothing per shape, so this
    # only loads the kernels and libraries the timed runs use
    mh.frontend_spmd({r: pcl.PointCloud(c.xyz[:2], c.mask[:2]) for r, c in scans.items()},
                     cfg, origins)
    _sync(dev)
    group = dist.group.WORLD if dist.is_initialized() else None
    if group is not None:
        dist.barrier()
    t0 = time.perf_counter()
    for _ in range(reps):
        out = mh.frontend_spmd(scans, cfg, origins)
    _sync(dev)
    mine = torch.tensor([(time.perf_counter() - t0) / reps], dtype=torch.float64, device=dev)
    walls = mine if group is None else mesh.all_gather(mine, group).reshape(-1)
    t0 = time.perf_counter()
    for _ in range(reps):
        mh.feed_global(host_scans, dev)
    _sync(dev)
    feed_s = (time.perf_counter() - t0) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        mh._replicate_to_hosts(out, cfg.n_robots, group)
    _sync(dev)
    replicate_s = (time.perf_counter() - t0) / reps
    frames = cfg.n_robots * next(iter(scans.values())).xyz.shape[0]
    if rank == 0:
        print(json.dumps({"bench_fps": frames / float(walls.max()), "robots": cfg.n_robots,
                          "frames": frames // cfg.n_robots, "processes": walls.numel(),
                          "wall_s": walls.tolist(), "device": str(dev),
                          "split_ms": {"frontend": 1e3 * float(mine), "feed": 1e3 * feed_s,
                                       "replicate": 1e3 * replicate_s}}), flush=True)


def main() -> None:
    from mr_slam_torch.geometry.se3 import Pose
    from mr_slam_torch.mapping import elevation, sharded_elevation
    from mr_slam_torch.ops import hopper_stencil, hopper_vgicp
    from mr_slam_torch.ops import pointcloud as pcl
    from mr_slam_torch.parallel import mesh, multihost as mh
    from mr_slam_torch.runtime import observability as obs
    from mr_slam_torch.runtime.config import SlamConfig

    dev = mh.initialize(device=os.environ.get("MRSLAM_DEVICE", "cuda"))
    if dev.type == "cpu":
        torch.set_num_threads(1)  # one summation order, as the single-process tests
    rank = torch.distributed.get_rank() if torch.distributed.is_initialized() else 0
    if "MRSLAM_INPUT" in os.environ:
        inputs = dict(np.load(os.environ["MRSLAM_INPUT"]))
    else:
        inputs, _ = scenario(int(os.environ.get("MRSLAM_ROBOTS", "2")),
                             int(os.environ.get("MRSLAM_FRAMES", "8")))
    cfg = SlamConfig.from_json(str(inputs["cfg"]))
    m = mh.robot_mesh(cfg.n_robots)
    mine = mh.local_robot_ids(m, cfg.n_robots)
    host_scans = {r: pcl.PointCloud(inputs["xyz"][r], inputs["mask"][r]) for r in mine}
    host_origins = {r: Pose(inputs["origin_R"][r], inputs["origin_t"][r]) for r in mine}
    if os.environ.get("MRSLAM_BENCH"):
        _bench(host_scans, cfg, host_origins, dev, rank)
        return
    scans, origins = mh.feed_global(host_scans, dev), mh.feed_global(host_origins, dev)

    out: dict[str, np.ndarray] = {}
    stats = {"rank": rank, "device": str(dev), "robots": mine, "runs": []}
    for k in range(int(os.environ.get("MRSLAM_REPEAT", "1"))):
        obs.tracer.stats.clear()
        obs.metrics.counters.clear()
        hopper_vgicp.reset_launch_count()
        _sync(dev)
        t0 = time.perf_counter()
        res = mh.run_multihost(scans, cfg, origins, m)
        _sync(dev)
        wall = time.perf_counter() - t0
        out[f"opt_R_{k}"] = res.opt_poses.R.cpu().numpy()
        out[f"opt_t_{k}"] = res.opt_poses.t.cpu().numpy()
        out[f"loops_{k}"] = loop_rows(res.loops)
        stats["runs"].append({
            "wall_s": wall, "vgicp_launches": hopper_vgicp.launch_count(),
            "spans": {n: s["total_s"] for n, s in obs.tracer.report().items()},
            "counters": dict(obs.metrics.counters),
            "digests": [robot_digests(rr) for rr in res.robots],
        })
    out["node_of"] = res.node_of
    for r, rr in enumerate(res.robots):
        out[f"odom_t_{r}"] = rr.odom_poses.t.cpu().numpy()
        out[f"kf_{r}"] = rr.kf_frame_idx
    group = m.group(mesh.ROBOT_AXIS)
    for name in inputs.get("grids", np.array([], str)).tolist():
        height = torch.from_numpy(inputs[f"{name}_height"]).to(dev)
        emap = elevation.ElevationMap(
            height=height, variance=torch.ones_like(height),
            valid=torch.from_numpy(inputs[f"{name}_valid"]).to(dev),
            origin=torch.zeros(2, device=dev),
            resolution=torch.tensor(float(inputs[f"{name}_res"]), device=dev))
        obs.metrics.counters.clear()
        hopper_stencil.reset_launch_count()
        _sync(dev)
        t0 = time.perf_counter()
        feats = sharded_elevation.features_sharded(emap, group)
        _sync(dev)
        stats[f"grid_{name}"] = {"s": time.perf_counter() - t0,
                                 "stencil_launches": hopper_stencil.launch_count(),
                                 "counters": dict(obs.metrics.counters)}
        if rank == 0:
            for layer, a in zip(feats._fields, feats):
                out[f"{name}_{layer}"] = a.cpu().numpy()
    out["stats"] = np.array(json.dumps(stats))
    if "MRSLAM_OUT" in os.environ:
        path = Path(os.environ["MRSLAM_OUT"]) / f"rank{rank}.npz"
        np.savez(path.with_suffix(".tmp.npz"), **out)
        os.replace(path.with_suffix(".tmp.npz"), path)
    print(f"[rank {rank}] done: {len(res.loops)} loops, {stats['runs'][-1]['wall_s']:.2f} s",
          flush=True)


def launch(n_procs: int, env: dict | None = None, timeout_s: float = 600.0,
           log_dir: str | os.PathLike | None = None, independent: bool = False) -> list[str]:
    """Run `n_procs` workers of this module on this host, ranks 0..n-1
    (LOCAL_WORLD_SIZE n: every rank is on this host)
    meeting at a fresh file `<log_dir>/rdzv` (which no other process can
    take the way it can take a port found free; one process: no group).
    `independent`: the workers run side by side, each alone with no
    group. Waits for all, each under the same time limit; as soon as
    one fails or the limit passes, kills every worker and raises. Returns each worker's output (its
    stdout and stderr, kept in `log_dir`, by default MRSLAM_OUT or a
    temporary directory)."""
    import tempfile

    base = dict(os.environ)
    base.update(env or {})
    for k in ("PYTEST_CURRENT_TEST", "MRSLAM_COORDINATOR", "MRSLAM_NUM_PROCESSES",
              "MRSLAM_PROCESS_ID", "LOCAL_WORLD_SIZE"):
        base.pop(k, None)
    base["PYTHONPATH"] = os.pathsep.join(
        [str(REPO)] + [p for p in base.get("PYTHONPATH", "").split(os.pathsep) if p])
    logs = Path(log_dir or base.get("MRSLAM_OUT") or tempfile.mkdtemp(prefix="mrslam-")).resolve()
    logs.mkdir(parents=True, exist_ok=True)
    (logs / "rdzv").unlink(missing_ok=True)
    procs, files = [], []
    for pid in range(n_procs):
        e = dict(base)
        if n_procs > 1 and not independent:
            e.update(MRSLAM_COORDINATOR=f"file://{logs / 'rdzv'}",
                     MRSLAM_NUM_PROCESSES=str(n_procs), MRSLAM_PROCESS_ID=str(pid),
                     LOCAL_WORLD_SIZE=str(n_procs))
        f = open(logs / f"worker{pid}.log", "w")
        files.append(f)
        procs.append(subprocess.Popen([sys.executable, "-m", "mr_slam_torch.examples.multihost_worker"],
                                      env=e, stdout=f, stderr=subprocess.STDOUT, cwd=REPO))
    deadline = time.monotonic() + timeout_s
    failed = None
    try:
        while failed is None and any(p.poll() is None for p in procs):
            failed = next((i for i, p in enumerate(procs) if p.poll() not in (None, 0)), None)
            if time.monotonic() > deadline:
                failed = "timeout"
            time.sleep(0.1)
        if failed is None:
            failed = next((i for i, p in enumerate(procs) if p.returncode != 0), None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for f in files:
            f.close()
    texts = [(logs / f"worker{pid}.log").read_text() for pid in range(n_procs)]
    if failed is not None:
        which = "the time limit passed" if failed == "timeout" else f"worker {failed} failed"
        tail = texts[0 if failed == "timeout" else failed][-4000:]
        raise RuntimeError(f"{which} ({timeout_s} s limit); its output:\n{tail}")
    return texts


def _bench_env(n_robots: int, n_frames: int, device: str, reps: int,
               input_path: str | os.PathLike | None = None) -> dict:
    env = dict(MRSLAM_BENCH="1", MRSLAM_BENCH_REPS=str(reps), MRSLAM_DEVICE=device,
               MRSLAM_ROBOTS=str(n_robots), MRSLAM_FRAMES=str(n_frames))
    if input_path is not None:
        env["MRSLAM_INPUT"] = str(input_path)
    return env


def _bench_records(texts: list[str]) -> list[dict]:
    recs = [json.loads(line) for t in texts for line in t.splitlines()
            if line.startswith("{") and "bench_fps" in line]
    if not recs:
        raise RuntimeError(f"no bench_fps line from the workers:\n{texts[0][-2000:]}")
    return recs


def bench(n_procs: int, n_robots: int, n_frames: int, device: str = "cuda", reps: int = 3,
          timeout_s: float = 900.0, log_dir=None, input_path=None) -> dict:
    """Front-end frames/s of `n_robots` robots over `n_procs` worker
    processes of one group (MRSLAM_BENCH mode): process 0's JSON record,
    with its `split_ms` (front-ends, feed, replication). `input_path`:
    an MRSLAM_INPUT file whose scans and config replace `scenario()`'s
    (`n_robots` and `n_frames` are then its own)."""
    texts = launch(n_procs, _bench_env(n_robots, n_frames, device, reps, input_path),
                   timeout_s=timeout_s, log_dir=log_dir)
    return _bench_records(texts[:1])[0]


def bench_roof(n_procs: int, n_frames: int, device: str = "cuda", reps: int = 3,
               timeout_s: float = 900.0, log_dir=None) -> float:
    """The cores roof: the summed frames/s of `n_procs` independent
    1-robot workers running at the same time, with no group and no
    collective. No n-process scheme on the same hardware does better, so
    a distributed run's gap to it is the coordination cost, and the rest
    of its gap to n x one process is contention for the hardware."""
    texts = launch(n_procs, _bench_env(1, n_frames, device, reps), timeout_s=timeout_s,
                   log_dir=log_dir, independent=True)
    return sum(r["bench_fps"] for r in _bench_records(texts))


def card_note(n_procs: int, device: str) -> str:
    """How the processes of a bench share the hardware."""
    if device != "cuda":
        return f"{n_procs} CPU processes on {os.cpu_count()} cores"
    cards = torch.cuda.device_count()
    if n_procs > cards:
        return f"{n_procs} processes share {cards} card(s): they split its SMs"
    return f"{n_procs} processes, one card each"


if __name__ == "__main__":
    main()
