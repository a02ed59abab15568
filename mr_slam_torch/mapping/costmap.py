"""Costmap conversion — navigation-ready occupancy from terrain layers
(port of `mr_slam_tpu/mapping/costmap.py`).

The reference's costmap_2d plugin (`pointMap_layer.cpp:119-126`,
`elevationMap_layer.cpp`) marks LETHAL_OBSTACLE where traversability is
below a threshold or the height above one. Here that is a threshold over
the elevation map's feature layers, in the standard cost convention
(0 = free, 100 = lethal, -1 = unknown) as an int8 grid, plus the
rasterization of a merged world-frame cloud into a fixed global costmap
(scatter-max of booleans: exact, order-free) and a max-filter inflation.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops.pointcloud import PointCloud
from . import elevation

FREE = 0
LETHAL = 100
UNKNOWN = -1
COST_DTYPE = torch.int8


class Costmap(NamedTuple):
    cost: torch.Tensor        # (H, W) int8
    origin: torch.Tensor      # (2,) float32
    resolution: torch.Tensor  # () float32


def _classify(seen: torch.Tensor, lethal: torch.Tensor) -> torch.Tensor:
    cost = torch.where(lethal, LETHAL, FREE)
    return torch.where(seen, cost, UNKNOWN).to(COST_DTYPE)


def from_elevation(
    m: elevation.ElevationMap,
    feats: elevation.TerrainFeatures,
    travers_thresh: float = 0.4,   # reference launch default
    z_thresh: float = 1.5,         # obstacle height gate
    ref_height: float = 0.0,
) -> Costmap:
    """Threshold terrain layers into costs (`pointMap_layer.cpp:119-126`:
    lethal where travers < travers_thresh or z > z_thresh)."""
    lethal = (feats.traversability < travers_thresh) | ((m.height - ref_height) > z_thresh)
    return Costmap(cost=_classify(m.valid, lethal), origin=m.origin, resolution=m.resolution)


def rasterize_cloud(
    cloud: PointCloud,
    traversability: torch.Tensor,
    origin: torch.Tensor,
    resolution: float,
    size: int,
    travers_thresh: float = 0.4,
    z_thresh: float = 1.5,
) -> Costmap:
    """Mark costs straight from a merged elevation cloud with per-point
    traversability (the global manager publishes exactly that cloud; the
    costmap node re-bins it — `pointMap_layer.cpp:84-127`)."""
    dev = cloud.xyz.device
    origin = torch.as_tensor(origin, dtype=torch.float32, device=dev)
    res = torch.full((), resolution, dtype=torch.float32, device=dev)
    ij = torch.floor((cloud.xyz[:, :2] - origin) / res).to(torch.int64)
    inb = (
        cloud.mask
        & (ij[:, 0] >= 0) & (ij[:, 0] < size)
        & (ij[:, 1] >= 0) & (ij[:, 1] < size)
    )
    flat = torch.where(inb, ij[:, 0] * size + ij[:, 1], size * size)
    lethal_pt = (traversability < travers_thresh) | (cloud.xyz[:, 2] > z_thresh)
    seen = torch.zeros((size * size + 1,), dtype=torch.int32, device=dev)
    seen.scatter_reduce_(0, flat, inb.to(torch.int32), "amax")
    lethal = torch.zeros((size * size + 1,), dtype=torch.int32, device=dev)
    lethal.scatter_reduce_(0, flat, (inb & lethal_pt).to(torch.int32), "amax")
    cost = _classify(seen[:-1] > 0, lethal[:-1] > 0)
    return Costmap(cost=cost.reshape(size, size), origin=origin, resolution=res)


def inflate(cm: Costmap, radius_cells: int = 2) -> Costmap:
    """Binary obstacle inflation (move_base's inflation layer, reduced to
    a max filter)."""
    lethal = cm.cost == LETHAL
    for _ in range(radius_cells):
        lethal = elevation._dilate3(lethal.to(torch.float32)) > 0
    cost = torch.where(lethal, LETHAL, cm.cost.to(torch.int32)).to(COST_DTYPE)
    return cm._replace(cost=cost)
