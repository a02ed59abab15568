"""Offline visualization, the reference's rviz views as PNG files (port
of `mr_slam_tpu/eval/visualize.py`): `plot_map` (top-down merged cloud,
trajectories, loop edges), `plot_elevation` (2.5D layers) and
`plot_costmap`.

matplotlib is imported inside each call (the Agg backend, no display),
so importing this module needs no matplotlib; tensors on any device are
copied to the host for drawing.
"""
from __future__ import annotations

import numpy as np

_COLORS = ["tab:red", "tab:blue", "tab:green", "tab:orange", "tab:purple"]


def _mpl():
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    return plt


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def plot_map(path: str, result, max_points: int = 100_000, title: str = "merged map"):
    """Top-down view: merged cloud (height-coloured), optimized
    trajectories per robot, loop edges (dashed: intra-robot)."""
    from ..runtime import pipeline as pl

    plt = _mpl()
    fig, ax = plt.subplots(figsize=(10, 10))
    merged = pl.compose_map(result)
    pts = _np(merged.xyz)[_np(merged.mask)]
    if len(pts) > max_points:
        pts = pts[np.random.default_rng(0).choice(len(pts), max_points, replace=False)]
    ax.scatter(pts[:, 0], pts[:, 1], c=pts[:, 2], s=0.3, cmap="viridis", alpha=0.5)
    for r in range(len(result.robots)):
        t = _np(result.optimized_trajectory(r).t)
        ax.plot(t[:, 0], t[:, 1], color=_COLORS[r % len(_COLORS)], lw=2, label=f"robot {r}")
    opt_t = _np(result.opt_poses.t)
    for l in result.loops:
        pa = opt_t[result.node_of[l["robot_a"], l["kf_a"]]]
        pb = opt_t[result.node_of[l["robot_b"], l["kf_b"]]]
        style = "--" if l["robot_a"] == l["robot_b"] else "-"
        ax.plot([pa[0], pb[0]], [pa[1], pb[1]], style, color="k", lw=0.8, alpha=0.7)
    ax.set_aspect("equal")
    ax.legend()
    ax.set_title(title)
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_elevation(path: str, emap, feats=None):
    """Height and log10 variance of an `ElevationMap`; slope and
    traversability too when `feats` is given."""
    plt = _mpl()
    n = 2 if feats is None else 4
    fig, axes = plt.subplots(1, n, figsize=(5 * n, 5))
    valid = _np(emap.valid)
    axes[0].imshow(np.where(valid, _np(emap.height), np.nan), cmap="terrain")
    axes[0].set_title("height")
    v = np.where(valid, _np(emap.variance), np.nan)
    axes[1].imshow(np.log10(v + 1e-9), cmap="magma")
    axes[1].set_title("log10 variance")
    if feats is not None:
        axes[2].imshow(_np(feats.slope), cmap="inferno")
        axes[2].set_title("slope")
        axes[3].imshow(_np(feats.traversability), cmap="RdYlGn", vmin=0, vmax=1)
        axes[3].set_title("traversability")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)


def plot_costmap(path: str, cm):
    """The costmap's cells, unknown ones transparent."""
    plt = _mpl()
    fig, ax = plt.subplots(figsize=(6, 6))
    c = _np(cm.cost).astype(float)
    c[c < 0] = np.nan
    ax.imshow(c, cmap="Reds", vmin=0, vmax=100)
    ax.set_title("costmap (red = lethal)")
    fig.savefig(path, dpi=120, bbox_inches="tight")
    plt.close(fig)
