"""Synthetic multi-robot pose-graph generator for optimizer evaluation
(port of `mr_slam_tpu/eval/graphgen.py`).

Builds the graph the reference's back-end assembles from a multi-robot
run (`readFullGraph`, `global_manager.cpp:1484-1535`): per-robot
odometry chains integrated from NOISY relative motions (real drift,
exact ground truth), intra-robot loop closures where a robot revisits
its own track, and inter-robot loops where two robots' true positions
coincide. Loop measurements are the true relative pose plus bounded
noise, at loop weight. Used by the ATE-versus-reference gate (ours <=
1.1x the reference optimizer's ATE) and the reference-solver checks.

The odometry drift is drawn from `default_rng(seed)` (the reference
draws it with `jax.random`, so the noisy chains differ); the loop pairs
are chosen on the true geometry and their noise and outliers drawn from
`default_rng(seed + 1)`, both exactly as the reference does, so one seed
picks the same loop pairs in both packages.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..backend import factor_graph as fg
from ..datasets import synthetic
from ..geometry import se3, so3
from ..geometry.se3 import Pose


def _circle_f32(n: int, radius: float, laps: float, device) -> Pose:
    """`synthetic.circle_trajectory(n, radius, laps)` with its angles
    taken in float32, as the reference takes them (the port's trajectory
    rounds float64 angles, ~15 ulp off on a 30 m circle): the loop
    selection compares true distances with the loop radius."""
    ang = np.linspace(np.float32(0.0), np.float32(2 * np.pi * laps), n, dtype=np.float32)
    ang = torch.from_numpy(ang).to(device)
    t = torch.stack([radius * torch.cos(ang), radius * torch.sin(ang), torch.zeros_like(ang)],
                    dim=-1)
    return Pose(so3.yaw_rot(ang + np.float32(np.pi / 2)), t)


def multi_robot_graph(
    n_robots: int = 3,
    nodes_per_robot: int = 170,
    radius: float = 30.0,
    laps: float = 2.0,
    drift_t: float = 0.05,
    drift_r: float = 0.004,
    loop_noise_t: float = 0.02,
    loop_noise_r: float = 0.002,
    loop_stride: int = 25,
    loop_radius: float = 8.0,
    min_separation: int = 40,
    outlier_frac: float = 0.0,
    seed: int = 0,
    node_capacity: int | None = None,
    edge_capacity: int | None = None,
    *,
    device="cuda",
):
    """Returns (graph, true_poses (R*K,) Pose stacked robot-major,
    anchors (node_capacity,) bool, node_of (R, K) int) on `device` (the
    card unless the caller passes device="cpu").

    Robots ride the same circle with angular offsets, so inter-robot
    revisits are dense; `laps > 1` gives each robot intra-robot
    revisits too."""
    from ..runtime.online import resolve_device

    dev = resolve_device(device)
    R, K = n_robots, nodes_per_robot
    N = R * K
    node_capacity = node_capacity or int(1.1 * N) + 8
    edge_capacity = edge_capacity or 4 * N
    drift_rng = np.random.default_rng(seed)

    true_list, noisy_list = [], []
    for r in range(R):
        t = _circle_f32(K, radius, laps, dev)
        # rotate robot r's whole track by a phase offset around the site
        Rz = so3.yaw_rot(torch.tensor(2.0 * math.pi * r / R, dtype=torch.float32, device=dev))
        t = Pose(Rz[None] @ t.R, (Rz @ t.t.T).T)
        true_list.append(t)
        noisy_list.append(synthetic.perturb_trajectory(t, drift_t, drift_r, rng=drift_rng))

    graph = fg.init(node_capacity, edge_capacity, dev)
    node_of = np.arange(N).reshape(R, K)
    for r in range(R):
        graph, idx = fg.add_nodes_batch(
            graph, noisy_list[r], torch.full((K,), r, dtype=torch.int64, device=dev))
        node_of[r] = idx.cpu().numpy()
        # odometry edges from the NOISY chain: consistent with the
        # initial values, so the residual error lives in the drift
        meas = se3.between(se3.index(noisy_list[r], slice(0, K - 1)),
                           se3.index(noisy_list[r], slice(1, K)))
        graph, _ = fg.add_edges_batch(graph, idx[:-1], idx[1:], meas, fg.ODOM, 1.0, 1.0)

    # loop closures from the TRUE geometry + bounded noise: candidates
    # chosen on the host, every measurement in one batched op
    rng = np.random.default_rng(seed + 1)
    true_t = np.stack([t.t.cpu().numpy() for t in true_list])  # (R, K, 3)
    sel = []  # (ra, ia, rb, ib, kind)
    for ra in range(R):
        for ia in range(loop_stride, K, loop_stride):
            # intra: nearest previous node outside the separation window
            d = np.linalg.norm(true_t[ra, :ia] - true_t[ra, ia], axis=-1)
            d[max(0, ia - min_separation):] = np.inf
            ib = int(np.argmin(d))
            if np.isfinite(d[ib]) and d[ib] < loop_radius:
                sel.append((ra, ia, ra, ib, fg.INTRA_LOOP))
            # inter: nearest node of each other robot
            for rb in range(ra):
                d = np.linalg.norm(true_t[rb] - true_t[ra, ia], axis=-1)
                ib = int(np.argmin(d))
                if d[ib] < loop_radius:
                    sel.append((ra, ia, rb, ib, fg.INTER_LOOP))

    true = Pose(torch.cat([t.R for t in true_list]), torch.cat([t.t for t in true_list]))
    if sel:
        L = len(sel)
        ja = torch.tensor([node_of[ra, ia] for ra, ia, *_ in sel], device=dev)
        jb = torch.tensor([node_of[rb, ib] for _, _, rb, ib, _ in sel], device=dev)
        meas = se3.between(se3.index(true, ja), se3.index(true, jb))

        def f32(x):
            return torch.from_numpy(np.asarray(x, np.float32)).to(dev)

        dw = so3.exp(f32(loop_noise_r * rng.standard_normal((L, 3))))
        dt = f32(loop_noise_t * rng.standard_normal((L, 3)))
        noisy_R, noisy_t = dw @ meas.R, meas.t + dt
        # outlier injection: a fraction of loops replaced by wrong
        # measurements (random associations, what PCM must absorb)
        if outlier_frac > 0.0:
            n_out = int(round(outlier_frac * L))
            if n_out:
                out_idx = torch.from_numpy(rng.choice(L, size=n_out, replace=False)).to(dev)
                noisy_R[out_idx] = so3.exp(f32(rng.uniform(-np.pi, np.pi, (n_out, 3)) * 0.5))
                noisy_t[out_idx] = f32(rng.uniform(-20.0, 20.0, (n_out, 3)))
        graph, _ = fg.add_edges_batch(
            graph, ja, jb, Pose(noisy_R, noisy_t),
            torch.tensor([k for *_, k in sel], device=dev),
            torch.full((L,), 10.0, device=dev), torch.full((L,), 10.0, device=dev),
        )

    anchors = torch.zeros(node_capacity, dtype=torch.bool, device=dev)
    anchors[torch.from_numpy(node_of[:, 0]).to(dev)] = True
    return graph, true, anchors, node_of
