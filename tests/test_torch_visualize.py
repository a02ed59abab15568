"""The port's PNG renders (`eval/visualize.py`) and its demo example
(`mr_slam_torch/examples/demo_synthetic.py`'s path at a small size): the
three plots write non-empty PNG files from a small port `SlamResult`.
Skips where matplotlib is not installed (the plots import it lazily)."""
import importlib.util

import numpy as np
import pytest

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import visualize
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.runtime import pipeline as tpipe
from mr_slam_torch.runtime.config import KeyframeCfg, LoopCfg, OdometryCfg, PGOCfg, SlamConfig

pytestmark = pytest.mark.skipif(importlib.util.find_spec("matplotlib") is None,
                                reason="matplotlib is not installed")

PNG = b"\x89PNG\r\n\x1a\n"


@pytest.fixture(scope="module")
def result():
    cfg = SlamConfig(
        n_robots=2,
        odometry=OdometryCfg(table_size=1 << 14, scan_capacity=2048, insert_capacity=4096),
        keyframes=KeyframeCfg(dist_thresh=1.5, capacity=16, points_per_kf=2048),
        loops=LoopCfg(dist_thresh=0.4, min_separation=2, verify_capacity=4096,
                      fitness_thresh=0.3),
        pgo=PGOCfg(node_capacity=64, edge_capacity=128),
    )
    world = synthetic.default_world(0)
    trajs = [synthetic.circle_trajectory(6, radius=10.0, laps=0.2, phase=p) for p in (0.0, 0.4)]
    scans = [synthetic.scan_batch(world, t, n_rings=16, n_azimuth=256,
                                  rng=np.random.default_rng(r)) for r, t in enumerate(trajs)]
    res = tpipe.run(scans, cfg, origins=[tse3.index(t, 0) for t in trajs], device="cpu")
    return res, cfg


def assert_png(path):
    data = path.read_bytes()
    assert data.startswith(PNG) and len(data) > 1000


def test_plot_map(result, tmp_path):
    res, _ = result
    visualize.plot_map(str(tmp_path / "map.png"), res)
    assert_png(tmp_path / "map.png")


def test_plot_elevation_and_costmap(result, tmp_path):
    res, cfg = result
    emap, feats, cm = tpipe.build_elevation(res, cfg, size=120)
    assert int(emap.valid.sum()) > 0
    visualize.plot_elevation(str(tmp_path / "elevation.png"), emap, feats)
    visualize.plot_elevation(str(tmp_path / "height.png"), emap)
    visualize.plot_costmap(str(tmp_path / "costmap.png"), cm)
    for name in ("elevation.png", "height.png", "costmap.png"):
        assert_png(tmp_path / name)
