"""The traffic generator is deterministic per seed, and the frozen copies
of the port's generators give the port's arrays."""
import numpy as np
import pytest
import torch

from helpers import ROOT  # noqa: F401  (puts the repo on the path)
from slambench import scenes, traffic
from slambench.reference.slamref.geometry import se3
from slambench.reference.slamref.ops.pointcloud import PointCloud

MIX = {"world": {"seed": 7, "extent_m": 60.0, "boxes": 36},
       "road": {"layout": "convoy", "radius_m": 22.0, "pace_m": 0.1, "gap_m": 4.0, "rest_frames": 2},
       "robots": 2, "stamp_period_s": 0.1, "stamp_offset_s": 0.03, "frames_per_robot": 6,
       "prefix_frames_per_robot": 2, "sample_every_frames": 2}
SENSOR = {"rings": 8, "azimuth": 64, "noise_m": 0.03, "point_times": "sweep_end", "imu_samples": 4}


def _stream(seed):
    return traffic.generate(MIX, SENSOR, seed, "cpu")


def test_same_seed_same_stream_other_seed_other_noise():
    a, b, c = _stream(2**31 + 5), _stream(2**31 + 5), _stream(2**31 + 6)
    for r in range(2):
        assert torch.equal(a.xyz[r], b.xyz[r]) and torch.equal(a.times[r], b.times[r])
        assert all(torch.equal(x, y) for x, y in zip(a.imu[r], b.imu[r]))
        assert not torch.equal(a.xyz[r], c.xyz[r])
        assert torch.equal(a.mask[r], c.mask[r]) or a.mask[r].float().mean() > 0.5
    assert a.order == c.order and a.prefix == 4


@pytest.mark.parametrize("layout", ["convoy", "spread"])
def test_roads_keep_their_pace(layout):
    mix = dict(MIX, road=dict(MIX["road"], layout=layout, rest_frames=0))
    t = traffic.road(mix, 1, 20).t
    step = torch.linalg.norm(t[1:] - t[:-1], dim=-1)
    assert torch.allclose(step, torch.full_like(step, 0.1), atol=1e-4)


def test_world_road_and_imu_are_the_ports():
    from mr_slam_torch.datasets import synthetic

    w, pw = scenes.default_world(7, 60.0, 36), synthetic.default_world(7, extent=60.0, n_boxes=36)
    assert np.array_equal(w.boxes, pw.boxes)
    a = scenes.circle_trajectory(9, radius=22.0, laps=0.1, phase=0.3, ccw=False)
    b = synthetic.circle_trajectory(9, radius=22.0, laps=0.1, phase=0.3, ccw=False)
    assert torch.equal(a.R, b.R) and torch.equal(a.t, b.t)
    for x, y in zip(scenes.imu_for_trajectory(a, 0.1, n_sub=5),
                    synthetic.imu_for_trajectory(b, 0.1, n_sub=5)):
        assert torch.equal(x, y)


def test_raycast_is_the_ports_with_the_same_draw():
    from mr_slam_torch.datasets import synthetic
    from mr_slam_torch.geometry.se3 import Pose as PPose

    world = scenes.default_world(7, 60.0, 36)
    traj = scenes.circle_trajectory(3, radius=22.0, laps=0.02)
    draw = np.random.default_rng(11).standard_normal((3, 8, 64))
    mine = scenes.scan_batch(world, traj, 8, 64, 0.03, torch.from_numpy(draw.astype(np.float32)))
    port = synthetic.scan_batch(synthetic.World(world.boxes), PPose(traj.R, traj.t), n_rings=8,
                                n_azimuth=64, noise=0.03, rng=np.random.default_rng(11))
    assert torch.equal(mine.xyz, port.xyz) and torch.equal(mine.mask, port.mask)


def test_point_times_and_shear_are_the_ports():
    import chip_smoke
    from mr_slam_torch.frontend import preprocess
    from mr_slam_torch.geometry.se3 import Pose as PPose
    from mr_slam_torch.ops import pointcloud as ppcl

    g = torch.Generator().manual_seed(3)
    xyz = torch.randn((2, 50, 3), generator=g) * 10.0
    mask = torch.rand((2, 50), generator=g) > 0.2
    model = preprocess.LidarModel(8, 15.0, -25.0, scan_period=0.1)
    t = scenes.relative_times(xyz, 0.1)
    assert torch.equal(t, preprocess.relative_times(xyz, model, start_azimuth=0.0))
    traj = scenes.circle_trajectory(3, radius=12.0, laps=0.05)
    rel = se3.between(se3.index(traj, slice(0, 2)), se3.index(traj, slice(1, 3)))
    batch = scenes.shear_to_end_batch(PointCloud(xyz, mask), rel, t)
    for i in range(2):
        one = scenes.shear_to_end(PointCloud(xyz[i], mask[i]), se3.index(rel, i), t[i])
        port = chip_smoke.shear_to_end(ppcl.PointCloud(xyz[i], mask[i]),
                                       PPose(rel.R[i], rel.t[i]), t[i])
        assert torch.equal(one.xyz, port.xyz)
        assert torch.equal(batch.xyz[i], one.xyz)
