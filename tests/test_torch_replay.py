"""The real-format replay chain: loaders (`datasets/loaders.py`), the
port's native scan log (`csrc/scanlog.cpp` through `native.py`), the
bag feeders (`datasets/replay.py`) and the sequence artifact
(`datasets/sequence_artifact.py`), against the reference package.

Bounds: decoded files equal to the reference's exactly; the tiny
artifact's digest equal to the reference test's golden digest; a scan
log read back as written; and `run_session` of both packages on a
2-robot x 6-frame 16x256 artifact with the same frames and keyframes
and ATE within 10 % + 2 cm. The port runs on the CPU."""
import os

import numpy as np
import pytest
import torch

from mr_slam_torch import native as tnative
from mr_slam_torch.datasets import loaders as tload
from mr_slam_torch.datasets import replay as trep
from mr_slam_torch.datasets import sequence_artifact as tsa
from mr_slam_torch.datasets import synthetic
from mr_slam_torch.runtime import config as tcfg
from mr_slam_torch.runtime import online as tonline
from mr_slam_tpu.datasets import loaders as jload
from mr_slam_tpu.datasets import sequence_artifact as jsa
from mr_slam_tpu.runtime import config as jcfg
from tests.test_sequence_artifact import GOLDEN_TINY_DIGEST


def test_nclt_and_kitti_loaders_match_reference(tmp_path):
    rng = np.random.default_rng(0)
    rec = rng.integers(0, 256, (300, 8), dtype=np.uint8)
    rec.tofile(tmp_path / "nclt.bin")
    kitti = rng.normal(0, 20, (250, 4)).astype("<f4")
    kitti.tofile(tmp_path / "kitti.bin")
    for fn, name in (("load_nclt_velodyne_bin", "nclt.bin"), ("load_kitti_bin", "kitti.bin")):
        for cap in (None, 128, 512):
            got = getattr(tload, fn)(str(tmp_path / name), cap)
            want = getattr(jload, fn)(str(tmp_path / name), cap)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
    rows = np.array([[1335704127712909.0, 1.5, -2.5, 0.1, 0.01, -0.02, 1.57],
                     [1335704127812909.0, 1.6, -2.4, 0.1, 0.01, -0.02, 1.58]])
    np.savetxt(tmp_path / "gt.csv", rows, delimiter=",")
    np.testing.assert_array_equal(tload.load_nclt_groundtruth(str(tmp_path / "gt.csv")),
                                  jload.load_nclt_groundtruth(str(tmp_path / "gt.csv")))
    poses = rng.normal(size=(3, 12))
    np.savetxt(tmp_path / "poses.txt", poses)
    np.testing.assert_array_equal(tload.load_kitti_poses(str(tmp_path / "poses.txt")),
                                  jload.load_kitti_poses(str(tmp_path / "poses.txt")))
    vdir = tmp_path / "velodyne"
    vdir.mkdir()
    for i in range(3):
        kitti[: 50 * (i + 1)].tofile(vdir / f"{i:06d}.bin")
    got = list(tload.iter_kitti_sequence(str(vdir), 200))
    assert [g[0] for g in got] == [0, 1, 2]
    assert [int(g[2].sum()) for g in got] == [50, 100, 150]


def test_tiny_artifact_digest_is_the_reference_golden(tmp_path):
    m = tsa.generate(str(tmp_path), frames=4, robots=2, n_rings=16, n_azimuth=256)
    assert m["digest"] == GOLDEN_TINY_DIGEST
    assert m == jsa.generate(str(tmp_path / "ref"), frames=4, robots=2, n_rings=16,
                             n_azimuth=256)


def test_scanlog_roundtrip(tmp_path):
    rng = np.random.default_rng(1)
    path = str(tmp_path / "a.scanlog")
    w = tnative.ScanLogWriter(path, max_points=128)
    written = []
    for i in range(5):
        pose = rng.normal(size=12).astype(np.float32)
        xyz = rng.normal(0, 5, (40 + 30 * i, 3)).astype(np.float32)  # the last two clip
        w.write(0.1 * i, pose, xyz)
        written.append((0.1 * i, pose, xyz[:128]))
    w.close()
    r = tnative.ScanLogReader(path)
    assert (r.n_frames, r.max_points) == (5, 128)
    got = list(r)
    r.close()
    assert len(got) == 5
    for (stamp, pose, xyz), (gs, gp, gx, n) in zip(written, got):
        assert gs == stamp and n == xyz.shape[0]
        np.testing.assert_array_equal(gp, pose)
        np.testing.assert_array_equal(gx[:n], xyz)
        assert (gx[n:] == 1e6).all()


def test_scanlog_bag_merges_by_stamp(tmp_path):
    rng = np.random.default_rng(2)
    paths = {}
    for r in range(2):
        p = str(tmp_path / f"robot{r}.scanlog")
        w = tnative.ScanLogWriter(p, max_points=64)
        for i in range(3):
            pose12 = np.eye(3, 4, dtype=np.float32).reshape(-1)
            pose12[3] = r  # t_x = robot id
            w.write(i * 0.1 + r * 0.03, pose12, rng.normal(0, 5, (64 - 10 * i, 3)))
        w.close()
        paths[r] = p
    frames = list(trep.scanlog_bag(paths))
    assert [f.stamp for f in frames] == sorted(f.stamp for f in frames)
    assert [f.robot for f in frames] == [0, 1, 0, 1, 0, 1]
    assert [int(f.scan.mask.sum()) for f in frames] == [64, 64, 54, 54, 44, 44]
    assert frames[1].origin.t.tolist() == [1.0, 0.0, 0.0] and frames[2].origin is None
    assert float(frames[4].scan.xyz[~frames[4].scan.mask].min()) == 1e6


def test_synthetic_bag_drives_a_session():
    world = synthetic.default_world(5)
    trajs = [synthetic.circle_trajectory(4, radius=22.0, laps=0.05, phase=np.pi * r)
             for r in range(2)]
    bag = trep.synthetic_bag(world, trajs, 4, n_rings=8, n_azimuth=128)
    assert [(f.robot, round(f.stamp, 2)) for f in bag[:3]] == [(0, 0.0), (1, 0.03), (0, 0.1)]
    assert bag[0].origin is not None and bag[2].origin is None
    sess = tonline.OnlineSlam(tcfg.SlamConfig(
        odometry=tcfg.OdometryCfg(table_size=1 << 12, scan_capacity=512, insert_capacity=1024),
        keyframes=tcfg.KeyframeCfg(capacity=8, points_per_kf=512)), device="cpu")
    assert trep.replay(bag, sess) == 8
    assert set(sess.robots) == {0, 1} and all(c >= 1 for c in sess.kf_counts.values())
    imu_bag = trep.synthetic_bag(world, trajs, 2, n_rings=8, n_azimuth=128, with_imu=True,
                                 imu_sub=5)
    assert [f.imu is None for f in imu_bag] == [True, True, False, False]
    assert imu_bag[2].imu[0].shape == (5, 3) and imu_bag[2].imu[2].shape == (5,)


def config(m):
    return m.SlamConfig(
        odometry=m.OdometryCfg(table_size=1 << 15, scan_capacity=2048, insert_capacity=4096),
        keyframes=m.KeyframeCfg(dist_thresh=1.5, capacity=32, points_per_kf=2048),
        loops=m.LoopCfg(dist_thresh=0.75, min_separation=8, candidates=2, verify_capacity=4096,
                        fitness_thresh=0.15),
        pgo=m.PGOCfg(node_capacity=64, edge_capacity=128),
    )


def test_run_session_matches_reference(tmp_path):
    """2 robots x 6 frames at 16x256, ~1.8 m of arc per frame."""
    root = str(tmp_path / "seq")
    tsa.generate(root, frames=6, robots=2, n_rings=16, n_azimuth=256, laps=0.08)
    got = tsa.run_session(root, cfg=config(tcfg), scanlog_dir=str(tmp_path), device="cpu")
    want = jsa.run_session(root, cfg=config(jcfg))
    assert got["frames"] == want["frames"] == 12
    assert got["keyframes"] == want["keyframes"] >= 6
    assert abs(got["ate_rmse_m"] - want["ate_rmse_m"]) <= 0.1 * want["ate_rmse_m"] + 0.02, \
        (got, want)
    assert got["ate_rmse_m"] < 0.5
    assert os.path.exists(tmp_path / "robot0.scanlog")


def test_run_session_default_device_is_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("CUDA present: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA"):
        tsa.run_session(str(tmp_path))
