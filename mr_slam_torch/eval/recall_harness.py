"""Place-recognition recall harness over every descriptor family (port
of `mr_slam_tpu/eval/recall_harness.py`: `METHODS`, `evaluate_method`,
`evaluate_cross`).

Given keyframe clouds and ground-truth positions, each method's
descriptors and distance matrix are computed in batches on one device
and scored by recall@N (`disco_ros/evaluate.py` semantics). The entry
points run on the card unless the caller passes `device="cpu"`; a
missing card raises.
"""
from __future__ import annotations

from typing import Callable

import torch

from ..loop import bev, disco, fast_histogram, m2dp, ring, scancontext
from ..ops import pointcloud as pcl
from . import metrics

# descriptor batches: clouds are described this many at a time (RING++'s
# k-NN distance matrices are chunked further inside), and queries
# correlated against the database this many at a time
DESCRIBE_CHUNK = 64
QUERY_CHUNK = 64


def _chunked(fn, clouds: pcl.PointCloud) -> torch.Tensor:
    n = clouds.xyz.shape[0]
    return torch.cat([fn(pcl.PointCloud(clouds.xyz[s:s + DESCRIBE_CHUNK],
                                        clouds.mask[s:s + DESCRIBE_CHUNK]))
                      for s in range(0, n, DESCRIBE_CHUNK)])


def _by_query(fn, dq: torch.Tensor) -> torch.Tensor:
    return torch.cat([fn(dq[s:s + QUERY_CHUNK]) for s in range(0, dq.shape[0], QUERY_CHUNK)])


def _sc_describe(clouds):
    return scancontext.describe(clouds)


def _sc_cross(dq, ddb):
    return _by_query(lambda q: scancontext.distance(q, ddb)[0], dq)


def _ring_describe(clouds):
    return _chunked(lambda c: ring.describe(
        bev.cartesian_occupancy(bev.normalize_cloud(c))[:, 0]).tiring, clouds)


def _ring_cross(dq, ddb):
    return _by_query(lambda q: ring.correlate(q, ddb)[0], dq)


def _ringpp_describe(clouds):
    # k-NN is quadratic in points: 2048 voxel centroids per cloud keep the
    # harness bounded (the reference's choice)
    def desc(c):
        ds = pcl.voxel_downsample(c, 0.5, 2048)
        return ring.describe_ringpp(bev.eigen_feature_bev(ds, 120, 120, k=8)).tirings
    return _chunked(desc, clouds)


def _ringpp_cross(dq, ddb):
    return _by_query(lambda q: ring.correlate_multichannel(q, ddb)[0], dq)


def _disco_describe(clouds):
    return _chunked(lambda c: disco.describe(
        bev.polar_occupancy(c, 40, 120, z_bins=20)).signature, clouds)


def _l2_cross(dq, ddb):
    def one(q):
        diff = q[:, None, :] - ddb[None, :, :]
        return torch.sqrt(torch.sum(diff * diff, dim=-1))
    return _by_query(one, dq)


def _m2dp_describe(clouds):
    return _chunked(m2dp.describe, clouds)


def _hist_describe(clouds):
    return _chunked(fast_histogram.describe, clouds)


def _hist_cross(dq, ddb):
    return _by_query(lambda q: fast_histogram.distance(q, ddb), dq)


METHODS: dict[str, tuple[Callable, Callable]] = {
    "scancontext": (_sc_describe, _sc_cross),
    "ring": (_ring_describe, _ring_cross),
    "ringpp": (_ringpp_describe, _ringpp_cross),
    "disco": (_disco_describe, _l2_cross),
    "m2dp": (_m2dp_describe, _l2_cross),
    "fasthist": (_hist_describe, _hist_cross),
}


def _on(device, clouds: pcl.PointCloud, *tensors):
    from ..runtime.online import resolve_device

    dev = resolve_device(device)
    return (pcl.PointCloud(clouds.xyz.to(dev), clouds.mask.to(dev)),
            *(torch.as_tensor(t, dtype=torch.float32).to(dev) for t in tensors))


def evaluate_method(
    method: str,
    clouds: pcl.PointCloud,     # (K, P, ...) keyframe clouds (body frame)
    positions: torch.Tensor,    # (K, 3) ground-truth keyframe positions
    radius: float = 5.0,
    min_separation: int = 10,
    max_n: int = 10,
    device="cuda",
) -> metrics.RecallResult:
    """Query every keyframe against all others (a temporal window left
    out) and score recall@1..max_n — `evaluate.py:59-198` semantics."""
    clouds, positions = _on(device, clouds, positions)
    K = positions.shape[0]
    describe, cross = METHODS[method]
    descs = describe(clouds)
    dists = cross(descs, descs)
    idx = torch.arange(K, device=positions.device)
    near_in_time = torch.abs(idx[:, None] - idx[None, :]) < min_separation
    dists = torch.where(near_in_time, torch.inf, dists)
    pos = metrics.make_positives(positions, positions, radius=radius) & ~near_in_time
    return metrics.recall_at_n(dists, pos, pos.any(dim=1), max_n=max_n)


def evaluate_cross(
    method: str,
    clouds_q: pcl.PointCloud,    # (Q, P, ...) query keyframes
    positions_q: torch.Tensor,   # (Q, 3)
    clouds_db: pcl.PointCloud,   # (D, P, ...) database keyframes
    positions_db: torch.Tensor,  # (D, 3)
    radius: float = 5.0,
    max_n: int = 25,
    device="cuda",
) -> metrics.RecallResult:
    """The evaluate.py protocol proper: a query run retrieved against a
    separate database run, ground truth by pose distance."""
    clouds_q, positions_q = _on(device, clouds_q, positions_q)
    clouds_db, positions_db = _on(device, clouds_db, positions_db)
    describe, cross = METHODS[method]
    dists = cross(describe(clouds_q), describe(clouds_db))
    pos = metrics.make_positives(positions_q, positions_db, radius=radius)
    return metrics.recall_at_n(dists, pos, pos.any(dim=1), max_n=max_n)
