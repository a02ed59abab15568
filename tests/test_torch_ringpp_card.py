"""RING++ on the card against the port's CPU path. The k-NN's cross term
is the same float32 FMA chain on both devices (`ops/pointcloud._cross`),
so distances, neighbour lists and covariances are bit-equal. The eigen
features then pass arccos / cos / pow / log, which round differently on
the card (ROADMAP Queue 3, inherent): the descriptor is held to
RINGPP_CLOSE_FRAC of its entries within 1e-4 of the largest, the
fraction measured on these inputs on an NVIDIA H100 (95.984 %). Needs a
CUDA card; the card machine has no JAX:

    python -m pytest --noconftest -o addopts= -m gpu tests/test_torch_ringpp_card.py
"""
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.loop import bev, ring
from mr_slam_torch.ops import pointcloud as pcl
from torch_parity import make_scans

RINGPP_CLOSE_FRAC = 0.95983


@pytest.mark.gpu
def test_ringpp_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    world = synthetic.default_world(9)
    traj = synthetic.circle_trajectory(4, radius=20.0, laps=0.3)
    host = pcl.voxel_downsample(make_scans(world, traj, 4, seed=0, n_rings=32, n_azimuth=1024),
                                0.2, 4096)
    card = pcl.PointCloud(host.xyz.cuda(), host.mask.cuda())
    m = host.mask
    d, idx = pcl.knn(card.xyz, card, 8)
    d_h, idx_h = pcl.knn(host.xyz, host, 8)
    assert torch.equal(idx.cpu()[m], idx_h[m]) and torch.equal(d.cpu()[m], d_h[m])
    _, cov, _ = pcl.covariances_knn(card, 8)
    _, cov_h, _ = pcl.covariances_knn(host, 8)
    assert torch.equal(cov.cpu()[m], cov_h[m])
    got = ring.describe_ringpp(bev.eigen_feature_bev(card, 120, 120, k=8)).tirings.cpu()
    want = ring.describe_ringpp(bev.eigen_feature_bev(host, 120, 120, k=8)).tirings
    close = float(((got - want).abs() <= 1e-4 * float(want.abs().max())).float().mean())
    print(f"RING++ entries within 1e-4 of the largest: {100 * close:.3f} %")
    assert close >= RINGPP_CLOSE_FRAC
