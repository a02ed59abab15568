"""scan2map with point times on `chip_smoke.py`'s phase-9 road: how far
rounding alone moves it.

    python3 s2m_chaos.py ensemble [--device cpu|cuda] [--robots 0,1,2]
        [--seeds 0-8] [--frames 40] [--laps 0.72]
    python3 s2m_chaos.py bisect [--robot 2] [--frames 28] [--laps 0.48]

`ensemble` runs `pipeline.run_frontend` with the point times on the
start-sheared scans as given (seed 0) and on copies whose coordinates are
moved by +-1 ulp (`chip_smoke.ulp_moved`, numpy seeds), and prints each
run's odometry ATE, its largest error and the frame of it.
`tests/torch_parity.s2m_ulp_reference` runs the reference on the same
inputs.

`bisect` (needs the card) runs the chain on the card, on the card with
every scan undistorted on the CPU, and on the CPU. Then, from each
frame's state of the CPU chain and of the card chain, it takes one step
on each device, stage by stage (undistorted cloud, downsampled cloud,
coarse and fine pose), and prints the largest difference of each stage
and each step's error to the truth.

`--frames` / `--laps` reshape the road (`chip_smoke.LIO_FRAMES` frames,
`LIO_REST` of them at rest, `LIO_LAPS` laps of the circle); 28 / 0.48 is
the 24-moving-frame road of the first phase-9 runs. CPU runs use one
PyTorch thread, as the parity tests do.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import chip_smoke as cs


def _seeds(text: str) -> list[int]:
    if "-" in text:
        a, b = text.split("-")
        return list(range(int(a), int(b) + 1))
    return [int(x) for x in text.split(",")]


def ensemble(sc, cfg, device, robots, seeds):
    from mr_slam_torch.geometry import se3
    from mr_slam_torch.runtime import pipeline

    for r in robots:
        traj = sc["trajs"][r]
        for seed in seeds:
            t = time.perf_counter()
            rr = pipeline.run_frontend(cs.ulp_moved(sc["s2m"][r], seed, device), cfg.for_robot(r),
                                       se3.index(traj, 0).to(device),
                                       times=sc["s2m_times"][r].to(device))
            est = rr.odom_poses.t.cpu().numpy()
            e = np.linalg.norm(est - traj.t.numpy(), axis=-1)
            print(f"port {device} robot {r} copy {seed}: odometry ATE {cs.positions_ate(est, traj):.4f} m, "
                  f"largest error {e.max():.3f} m at frame {int(e.argmax())} "
                  f"({time.perf_counter() - t:.1f} s)", flush=True)


def _to(pc, dev):
    from mr_slam_torch.ops import pointcloud as pcl

    return pcl.PointCloud(pc.xyz.to(dev), pc.mask.to(dev))


def _state_to(st, dev):
    from mr_slam_torch.frontend import odometry

    def grid(g):
        return type(g)(*[x.to(dev) if torch.is_tensor(x) else x for x in g])

    return odometry.OdometryState(grid=grid(st.grid), coarse_grid=grid(st.coarse_grid),
                                  pose=st.pose.to(dev), prev_pose=st.prev_pose.to(dev),
                                  frame=st.frame)


def _chain(sc, r, ocfg, dev, undistort_on_cpu=False):
    """The scan2map chain of robot r on dev: (per-frame errors, states
    before each frame)."""
    from mr_slam_torch.frontend import odometry, preprocess
    from mr_slam_torch.geometry import se3
    from mr_slam_torch.ops import pointcloud as pcl

    traj = sc["trajs"][r]
    state = odometry.init(ocfg, se3.index(traj, 0).to(dev))
    states, pos = [], []
    for i in range(traj.t.shape[0]):
        states.append(state)
        scan = pcl.PointCloud(sc["s2m"][r].xyz[i], sc["s2m"][r].mask[i])
        times = sc["s2m_times"][r][i]
        if undistort_on_cpu:
            motion = se3.between(state.prev_pose.to("cpu"), state.pose.to("cpu"))
            und = preprocess.undistort_constant_velocity(scan, times, motion, cs.LIO_PERIOD)
            state, _ = odometry.step(state, _to(und, dev), ocfg)
        else:
            state, _ = odometry.step(state, _to(scan, dev), ocfg, t_rel=times.to(dev))
        pos.append(state.pose.t.cpu())
    return np.linalg.norm(torch.stack(pos).numpy() - traj.t.numpy(), axis=-1), states


def _stages(st, scan, t_rel, ocfg):
    """`odometry.step`'s stages from state st for one frame."""
    from mr_slam_torch.frontend import odometry
    from mr_slam_torch.geometry import se3

    pred, und, ds = odometry.predict(st.pose, st.prev_pose, scan, ocfg, t_rel, cs.LIO_PERIOD)
    coarse = odometry.register_coarse(ds, st.coarse_grid, pred, ocfg)
    fine = odometry.register_fine(ds, st.grid, se3.normalize(coarse.pose), ocfg)
    return dict(undistorted=und.xyz, downsampled=ds.xyz, coarse=coarse.pose.t, fine=fine.pose.t)


def _diff(a, b) -> float:
    d = (a.cpu().double() - b.cpu().double()).abs()
    return float(torch.where(torch.isfinite(d), d, torch.zeros_like(d)).max())


def bisect(sc, cfg, r):
    from mr_slam_torch.ops import pointcloud as pcl
    from mr_slam_torch.runtime import pipeline

    dev = torch.device("cuda", 0)
    ocfg = pipeline._odometry_config(cfg.for_robot(r))
    traj = sc["trajs"][r]

    def show(tag, e):
        print(f"robot {r} {tag}: odometry ATE {np.sqrt(np.mean(e ** 2)):.4f} m, errors per frame (m) "
              f"{np.round(e, 3).tolist()}", flush=True)

    e_card, s_card = _chain(sc, r, ocfg, dev)
    show("on the card", e_card)
    show("on the card, undistorted on the CPU", _chain(sc, r, ocfg, dev, undistort_on_cpu=True)[0])
    e_cpu, s_cpu = _chain(sc, r, ocfg, "cpu")
    show("on the CPU", e_cpu)
    for name, states in (("CPU", s_cpu), ("card", s_card)):
        for i in range(1, traj.t.shape[0]):
            scan = pcl.PointCloud(sc["s2m"][r].xyz[i], sc["s2m"][r].mask[i])
            t_rel = sc["s2m_times"][r][i]
            a = _stages(_state_to(states[i], "cpu"), scan, t_rel, ocfg)
            b = _stages(_state_to(states[i], dev), _to(scan, dev), t_rel.to(dev), ocfg)
            err = [float(torch.linalg.norm(x["fine"].cpu() - traj.t[i])) for x in (a, b)]
            print(f"  from the {name} chain's state, frame {i}: card - CPU largest difference "
                  + ", ".join(f"{k} {_diff(a[k], b[k]):.2e}" for k in a)
                  + f"; error to the truth after the CPU's step {err[0]:.3f} m, the card's "
                  f"{err[1]:.3f} m", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("mode", choices=("ensemble", "bisect"))
    ap.add_argument("--device", default="cpu")
    ap.add_argument("--robots", default="0,1,2")
    ap.add_argument("--robot", type=int, default=2)
    ap.add_argument("--seeds", default="0-8")
    ap.add_argument("--frames", type=int, default=cs.LIO_FRAMES)
    ap.add_argument("--laps", type=float, default=cs.LIO_LAPS)
    args = ap.parse_args()
    torch.set_num_threads(1)
    cs.LIO_FRAMES, cs.LIO_LAPS = args.frames, args.laps
    sc = cs.lio_scenario()
    cfg = cs.smoke_config()
    print(f"road: {args.frames} frames ({cs.LIO_REST} at rest), radius {cs.LIO_RADIUS} m, "
          f"{args.laps} laps, world {cs.LIO_WORLD}", flush=True)
    if args.mode == "ensemble":
        ensemble(sc, cfg, torch.device(args.device), [int(x) for x in args.robots.split(",")],
                 _seeds(args.seeds))
    else:
        bisect(sc, cfg, args.robot)


if __name__ == "__main__":
    main()
