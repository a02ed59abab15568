"""The one traffic generator: a mix's parameters (`traffic/<name>.json`)
and a configuration's sensor (`configs/<name>.json`) become the fleet's
stream, on the card, from the run's seed.

A mix names the world, the ring road and how the robots sit on it, the
pace, the stream's length and the warm prefix. The seed draws only the
range noise, so every seed gives the same roads, frame counts and
cadences."""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from . import scenes
from .reference.slamref.geometry import se3
from .reference.slamref.geometry.se3 import Pose
from .reference.slamref.ops.pointcloud import PointCloud

CHUNK = 50  # frames raycast per call


@dataclass
class Stream:
    """The fleet's inputs on the device. Robot r's frame i is stamped
    `period * i + offset * r`; `order` lists (robot, frame) by stamp."""
    trajs: list            # Pose (T,) per robot, the true poses
    xyz: list              # (T, P, 3) per robot
    mask: list             # (T, P) per robot
    times: list            # (T, P) per robot, or None (no point times)
    imu: list              # (gyro, acc, dt) (T-1, S, ...) per robot, or None
    order: list            # [(robot, frame)] in stamp order
    stamps: dict           # (robot, frame) -> stamp
    prefix: int            # fleet frames fed before the window
    sample_every: int      # robot frames between front-end samples

    @property
    def robots(self) -> int:
        return len(self.xyz)

    def frame(self, r: int, i: int):
        """(scan xyz, mask, times or None, imu packet or None) of robot r's frame i."""
        t = None if self.times[r] is None else self.times[r][i]
        imu = None
        if self.imu[r] is not None and i > 0:
            g, a, d = self.imu[r]
            imu = (g[i - 1], a[i - 1], d[i - 1])
        return self.xyz[r][i], self.mask[r][i], t, imu


def road(mix: dict, robot: int, frames: int) -> Pose:
    """Robot `robot`'s ring road of `frames` frames (CPU), after the
    mix's `rest_frames` frames at rest."""
    rd = mix["road"]
    radius, pace = rd["radius_m"], rd["pace_m"]
    if rd["layout"] == "convoy":      # one direction, robot r `gap_m` behind robot r - 1
        phase = rd.get("phase0", 0.0) - robot * rd["gap_m"] / radius
        ccw = True
    elif rd["layout"] == "spread":    # phases 2 pi r / R, alternating directions
        phase = 2 * math.pi * robot / mix["robots"]
        ccw = robot % 2 == 0
    else:
        raise ValueError(f"unknown road layout {rd['layout']}")
    rest = rd.get("rest_frames", 0)
    moving = frames - rest
    laps = pace * (moving - 1) / (2 * math.pi * radius)
    c = scenes.circle_trajectory(moving, radius=radius, laps=laps, phase=phase, ccw=ccw)
    if rest == 0:
        return c
    return Pose(torch.cat([c.R[:1].expand(rest, 3, 3), c.R]), torch.cat([c.t[:1].expand(rest, 3), c.t]))


def generate(mix: dict, sensor: dict, seed: int, device, frames: int | None = None) -> Stream:
    """The stream of `mix` under `sensor` on `device`, its noise drawn
    from `seed` (`frames` overrides the mix's frames per robot)."""
    dev = torch.device(device)
    R = mix["robots"]
    T = frames if frames is not None else mix["frames_per_robot"]
    w = mix["world"]
    world = scenes.default_world(w["seed"], extent=w["extent_m"], n_boxes=w["boxes"])
    gen = torch.Generator(device=dev)
    gen.manual_seed(int(seed) % (1 << 63))
    rings, az, noise = sensor["rings"], sensor["azimuth"], sensor["noise_m"]
    period = mix["stamp_period_s"]
    trajs, xyzs, masks, times, imus = [], [], [], [], []
    for r in range(R):
        traj = road(mix, r, T)
        traj_d = Pose(traj.R.to(dev), traj.t.to(dev))
        parts = []
        for s in range(0, T, CHUNK):
            e = min(s + CHUNK, T)
            draw = torch.randn((e - s, rings, az), generator=gen, device=dev)
            parts.append(scenes.scan_batch(world, se3.index(traj_d, slice(s, e)), rings, az,
                                           noise, draw))
        xyz = torch.cat([p.xyz for p in parts])
        mask = torch.cat([p.mask for p in parts])
        t_pts = None
        if sensor.get("point_times") == "sweep_end":
            up = torch.tensor([0.0, 0.0, scenes.SENSOR_HEIGHT], device=dev)
            t_pts = scenes.relative_times(xyz - up, period)
            rel = se3.between(se3.index(traj_d, slice(0, T - 1)), se3.index(traj_d, slice(1, T)))
            for s in range(1, T, CHUNK):
                e = min(s + CHUNK, T)
                xyz[s:e] = scenes.shear_to_end_batch(PointCloud(xyz[s:e], mask[s:e]),
                                                     se3.index(rel, slice(s - 1, e - 1)),
                                                     t_pts[s:e], period).xyz
            t_pts[0] = 0.999 * period
        imu = None
        if sensor.get("imu_samples"):
            imu = scenes.imu_for_trajectory(traj_d, period, n_sub=sensor["imu_samples"])
        trajs.append(traj_d)
        xyzs.append(xyz)
        masks.append(mask)
        times.append(t_pts)
        imus.append(imu)
    offset = mix["stamp_offset_s"]
    stamps = {(r, i): period * i + offset * r for r in range(R) for i in range(T)}
    order = sorted(stamps, key=lambda k: (stamps[k], k[0]))
    return Stream(trajs=trajs, xyz=xyzs, mask=masks, times=times, imu=imus, order=order,
                  stamps=stamps, prefix=mix["prefix_frames_per_robot"] * R,
                  sample_every=mix["sample_every_frames"])
