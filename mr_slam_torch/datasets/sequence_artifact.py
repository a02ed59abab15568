"""Deterministic real-format sequence artifact (port of
`mr_slam_tpu/datasets/sequence_artifact.py`: `generate`, `run_session`).

`generate` writes NCLT-byte-format multi-session lidar logs at
production scan sizes with exact ground truth: a courtyard world raycast
into `velodyne_sync` binary files (packed little-endian u16 x/y/z at
5 mm resolution + intensity u8 + ring u8 per point, the layout
`loaders.load_nclt_velodyne_bin` decodes) plus a ground-truth CSV
(utime, x, y, z, roll, pitch, heading) per session, in NCLT's z-down
sensor convention. It is the reference's generator copied: pure numpy
float64 with seeded generators, so the bytes, and the digest over them,
are the reference package's.

`run_session` drives the real-data chain

    bytes -> loaders.load_nclt_velodyne_bin -> loaders.to_scanlog
          -> native prefetching ScanLogReader -> replay.scanlog_bag
          -> OnlineSlam -> optimized trajectories -> ATE vs the CSV

on the session's device.
"""
from __future__ import annotations

import hashlib
import json
import os

import numpy as np

_SCALE, _OFFSET = 0.005, -100.0       # NCLT velodyne_sync quantization
_EPOCH_US = 1_357_847_200_000_000     # arbitrary NCLT-era utime origin


# --------------------------------------------------------------------------
# numpy raycaster (float64, bit-deterministic across platforms)
# --------------------------------------------------------------------------


def _world_np(seed: int, extent: float, n_boxes: int) -> np.ndarray:
    """Courtyard world boxes (M, 2, 3) float64: perimeter walls + random
    buildings with a clear ring road, from its own numpy generator."""
    rng = np.random.default_rng(seed)
    e = extent
    walls = np.array([
        [[-e, -e, 0.0], [e, -e + 0.5, 4.0]],
        [[-e, e - 0.5, 0.0], [e, e, 4.0]],
        [[-e, -e, 0.0], [-e + 0.5, e, 4.0]],
        [[e - 0.5, -e, 0.0], [e, e, 4.0]],
    ])
    centers = rng.uniform(-e * 0.8, e * 0.8, (n_boxes, 2))
    sizes = rng.uniform(1.0, 6.0, (n_boxes, 2))
    heights = rng.uniform(2.0, 8.0, (n_boxes, 1))
    r = np.linalg.norm(centers, axis=-1, keepdims=True)
    push = np.where((r > 0.38 * e) & (r < 0.68 * e),
                    0.72 * e / np.maximum(r, 1.0), 1.0)
    centers = centers * push
    lo = np.concatenate([centers - sizes / 2, np.zeros((n_boxes, 1))],
                        axis=-1)
    hi = np.concatenate([centers + sizes / 2, heights], axis=-1)
    return np.concatenate([walls, np.stack([lo, hi], axis=1)], axis=0)


def _ray_dirs_np(n_rings: int, n_azimuth: int,
                 fov_up: float = 15.0, fov_down: float = -25.0) -> np.ndarray:
    """(rings*azimuth, 3) float64 beam directions (+15/-25 deg FOV)."""
    elev = np.deg2rad(np.linspace(fov_down, fov_up, n_rings))
    azim = np.linspace(-np.pi, np.pi, n_azimuth, endpoint=False)
    ce, se = np.cos(elev)[:, None], np.sin(elev)[:, None]
    ca, sa = np.cos(azim)[None, :], np.sin(azim)[None, :]
    dirs = np.stack(
        [ce * ca, ce * sa, np.broadcast_to(se, (n_rings, n_azimuth))], axis=-1
    )
    return dirs.reshape(-1, 3)


def _raycast_np(boxes: np.ndarray, R: np.ndarray, t: np.ndarray,
                dirs: np.ndarray, rng: np.random.Generator,
                max_range: float = 80.0, sensor_height: float = 0.8,
                noise: float = 0.03):
    """One frame: ground-plane + AABB slab intersection in float64.
    Returns (pts_body (H, 3) float64, ray indices (H,)) for hit rays
    only."""
    dirs_w = dirs @ R.T                                   # (N, 3)
    o = t + R @ np.array([0.0, 0.0, sensor_height])
    dz = dirs_w[:, 2]
    with np.errstate(divide="ignore"):
        t_ground = np.where(dz < -1e-6, -o[2] / dz, np.inf)
    lo, hi = boxes[:, 0], boxes[:, 1]                     # (M, 3)
    inv_d = 1.0 / np.where(np.abs(dirs_w) < 1e-9, 1e-9, dirs_w)
    t0 = (lo[None] - o[None, None, :]) * inv_d[:, None, :]   # (N, M, 3)
    t1 = (hi[None] - o[None, None, :]) * inv_d[:, None, :]
    tmin = np.max(np.minimum(t0, t1), axis=-1)            # (N, M)
    tmax = np.min(np.maximum(t0, t1), axis=-1)
    hit_box = (tmax >= np.maximum(tmin, 1e-3)) & (tmin > 1e-3)
    t_box = np.min(np.where(hit_box, tmin, np.inf), axis=-1)
    rng_t = np.minimum(t_ground, t_box)
    hit = np.isfinite(rng_t) & (rng_t <= max_range) & (rng_t > 0.5)
    rng_t = rng_t + noise * rng.standard_normal(rng_t.shape)
    idx = np.flatnonzero(hit)
    pts_w = o[None, :] + rng_t[idx, None] * dirs_w[idx]
    pts_b = (pts_w - t[None, :]) @ R                      # R^T applied
    return pts_b, idx                                     # (ray indices)


def _write_nclt_bin(path: str, pts_ned: np.ndarray, ring: np.ndarray) -> None:
    """Encode points into the velodyne_sync byte layout (see module
    docstring). Intensity is a deterministic function of range."""
    q = np.round((pts_ned - _OFFSET) / _SCALE)
    q = np.clip(q, 0, 65535).astype("<u2")
    inten = np.clip(
        255.0 * np.exp(-np.linalg.norm(pts_ned, axis=-1) / 40.0), 0, 255
    ).astype(np.uint8)
    rec = np.zeros((q.shape[0], 8), np.uint8)
    rec[:, 0:6] = q.view(np.uint8).reshape(-1, 6)
    rec[:, 6] = inten
    rec[:, 7] = (ring % 32).astype(np.uint8)
    rec.tofile(path)


def _trajectory_np(T: int, radius: float, laps: float, phase: float,
                   ccw: bool):
    """Ring-road trajectory: positions (T, 3), yaws (T,) — numpy."""
    s = 1.0 if ccw else -1.0
    ang = phase + s * 2.0 * np.pi * laps * np.arange(T) / T
    pos = np.stack(
        [radius * np.cos(ang), radius * np.sin(ang), np.zeros(T)], axis=-1
    )
    yaw = ang + s * np.pi / 2.0
    return pos, yaw


def generate(out_dir: str, frames: int = 100, robots: int = 2,
             n_rings: int = 64, n_azimuth: int = 1024,
             noise: float = 0.03, seed: int = 0, world_seed: int = 7,
             extent: float = 60.0, n_boxes: int = 36,
             frame_dt: float = 0.1, laps: float = 1.25) -> dict:
    """Emit `robots` NCLT-format sessions of `frames` frames each into
    `out_dir/robot{r}/velodyne_sync/<utime>.bin` + groundtruth.csv.
    Returns the manifest (also written as manifest.json): parameters,
    per-file sha256, and one digest over the whole artifact.

    Size the trajectory to the front-end: per-frame arc is
    2*pi*radius*laps/frames (~1.7 m at the 100-frame default) — keep it
    under ~2.5 m or scan-to-map odometry leaves its convergence basin
    (the same per-frame-motion envelope real 10 Hz logs satisfy)."""
    boxes = _world_np(world_seed, extent, n_boxes)
    dirs = _ray_dirs_np(n_rings, n_azimuth)
    flip = np.diag([1.0, -1.0, -1.0])     # body z-up <-> NCLT z-down

    files: dict[str, str] = {}
    for r in range(robots):
        rdir = os.path.join(out_dir, f"robot{r}", "velodyne_sync")
        os.makedirs(rdir, exist_ok=True)
        pos, yaw = _trajectory_np(
            frames, radius=22.0 + 3.0 * r, laps=laps,
            phase=2.0 * np.pi * r / max(robots, 1), ccw=(r % 2 == 0),
        )
        rng = np.random.default_rng(seed * 1000 + r)
        gt_rows = []
        for i in range(frames):
            c, s = np.cos(yaw[i]), np.sin(yaw[i])
            R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
            pts, ray_idx = _raycast_np(boxes, R, pos[i], dirs, rng,
                                       noise=noise)
            ring = ray_idx // n_azimuth           # ring-major dir layout
            pts_ned = pts @ flip                  # z-down sensor frame
            utime = _EPOCH_US + int(round(
                (i * frame_dt + 0.05 * r) * 1e6))
            path = os.path.join(rdir, f"{utime}.bin")
            _write_nclt_bin(path, pts_ned, ring)
            files[os.path.relpath(path, out_dir)] = _sha256(path)
            p_ned = flip @ pos[i]
            gt_rows.append((utime, p_ned[0], p_ned[1], p_ned[2],
                            0.0, 0.0, -yaw[i]))
        gt_path = os.path.join(out_dir, f"robot{r}", "groundtruth.csv")
        with open(gt_path, "w") as f:
            for row in gt_rows:
                f.write("%d,%.9f,%.9f,%.9f,%.9f,%.9f,%.9f\n" % row)
        files[os.path.relpath(gt_path, out_dir)] = _sha256(gt_path)

    digest = hashlib.sha256(
        "".join(f"{k}:{v}\n" for k, v in sorted(files.items())).encode()
    ).hexdigest()
    manifest = {
        "format": "nclt_velodyne_sync",
        "frames": frames, "robots": robots,
        "n_rings": n_rings, "n_azimuth": n_azimuth, "noise": noise,
        "seed": seed, "world_seed": world_seed, "extent": extent,
        "n_boxes": n_boxes, "frame_dt": frame_dt,
        "files": files, "digest": digest,
    }
    with open(os.path.join(out_dir, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            h.update(chunk)
    return h.hexdigest()


# --------------------------------------------------------------------------
# the full real-data chain
# --------------------------------------------------------------------------


def run_session(root: str, cfg=None, scanlog_dir: str | None = None, device="cuda") -> dict:
    """bytes -> loaders -> scanlog -> replay -> OnlineSlam -> ATE.

    Reads every `robot*/` session under `root` through the NCLT byte
    decoder, converts it to the native prefetching scanlog format
    (written to `scanlog_dir`, by default `root`), replays the merged
    stamp-ordered stream into an `OnlineSlam` on `device` (origins from
    the ground-truth CSVs, as the reference system's per-robot
    `T.initPose` launch arguments), runs a final loop stage and a
    full-graph solve, and scores ATE RMSE per robot against the CSV at
    the keyframes that have graph nodes, each at its own stamp. (The
    reference takes the first stamps instead, which misaligns estimates
    and ground truth once a keyframe misses the graph; the port does
    not copy that.) Returns {ate_rmse_m, per_robot, frames, keyframes,
    loops}."""
    import torch

    from ..geometry.se3 import Pose
    from ..runtime.config import KeyframeCfg, LoopCfg, OdometryCfg, SlamConfig
    from ..runtime.online import OnlineSlam, resolve_device
    from . import loaders, replay

    device = resolve_device(device)
    if cfg is None:
        cfg = SlamConfig(
            odometry=OdometryCfg(scan_capacity=8192, insert_capacity=16384),
            keyframes=KeyframeCfg(dist_thresh=2.0, capacity=256),
            loops=LoopCfg(dist_thresh=0.75, min_separation=8, candidates=2,
                          fitness_thresh=0.15),
        )
    flip = np.diag([1.0, -1.0, -1.0])
    robots = sorted(
        d for d in os.listdir(root)
        if d.startswith("robot") and os.path.isdir(os.path.join(root, d))
    )
    scanlog_dir = scanlog_dir or root
    logs: dict[int, str] = {}
    gts: dict[int, np.ndarray] = {}
    n_frames = 0
    for d in robots:
        r = int(d[len("robot"):])
        gts[r] = loaders.load_nclt_groundtruth(os.path.join(root, d, "groundtruth.csv"))
        vdir = os.path.join(root, d, "velodyne_sync")
        bins = sorted(os.listdir(vdir))

        def frames_iter(vdir=vdir, bins=bins):
            for b in bins:
                utime = int(b[:-4])
                xyz, mask, _ = loaders.load_nclt_velodyne_bin(os.path.join(vdir, b))
                yield ((utime - _EPOCH_US) * 1e-6, xyz[mask] @ flip, np.ones(mask.sum(), bool))

        log = os.path.join(scanlog_dir, f"robot{r}.scanlog")
        n_frames += loaders.to_scanlog(log, frames_iter(), 1 << 16)
        logs[r] = log

    session = OnlineSlam(cfg, device=device)
    for r, gt in gts.items():
        p = flip @ gt[0, 1:4]
        yaw = -gt[0, 6]
        c, s = np.cos(yaw), np.sin(yaw)
        R = np.array([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]])
        session.register_robot(r, Pose(torch.as_tensor(R, dtype=torch.float32),
                                       torch.as_tensor(p, dtype=torch.float32)))
    replay.replay(replay.scanlog_bag(logs), session)
    session.run_loop_stage()
    # final full-graph solve: a mid-replay optimize leaves opt_poses
    # covering only the nodes that existed then
    session.optimize()

    opt_t = session.opt_poses.t.cpu().numpy()
    per_robot = {}
    sq, n = 0.0, 0
    for r, gt in gts.items():
        store, _ = session.store_view(r)
        ks = [k for k in range(session.kf_counts[r]) if (r, k) in session.node_of]
        est = opt_t[[session.node_of[(r, k)] for k in ks]]
        stamps = store.stamps.cpu().numpy()[ks].astype(np.float64)
        # nearest-utime match (store stamps are float32; the few-us
        # rounding must not shift the row)
        utimes = np.round(stamps * 1e6) + float(_EPOCH_US)
        gt_ut = gt[:, 0].astype(np.float64)
        lo = np.clip(np.searchsorted(gt_ut, utimes), 1, gt.shape[0] - 1)
        pick_lo = (utimes - gt_ut[lo - 1]) <= (gt_ut[lo] - utimes)
        gt_idx = np.where(pick_lo, lo - 1, lo)
        gt_pos = gt[gt_idx, 1:4] @ flip       # back to z-up body world
        err2 = np.sum((est - gt_pos) ** 2, axis=-1)
        per_robot[str(r)] = round(float(np.sqrt(err2.mean())), 4)
        sq += float(err2.sum())
        n += err2.shape[0]
    return {
        "ate_rmse_m": round(float(np.sqrt(sq / max(n, 1))), 4),
        "per_robot": per_robot,
        "frames": n_frames,
        "keyframes": n,
        "loops": len(session.loops),
    }
