"""The port's multi-process runtime (`parallel/multihost.py`,
`pipeline._allgather_loops`, `pipeline.run_backend(group=...)`) on gloo
ranks on the CPU.

  * `_allgather_loops`: each rank's share of a set of loop records
    (pair index modulo the ranks) all-gathered and sorted by pair index
    gives back every record, with `rel`, fitness and descriptor distance
    bit for bit.
  * Two worker processes (`examples/multihost_worker.py`) at
    `tests/test_multihost.py`'s size (2 robots x 8 frames, 16 x 256 rays,
    its config; scans drawn with numpy) against the port's
    single-process `pipeline.run(device="cpu")` on the same scans: the
    front-end products bitwise equal (one PyTorch thread in every
    process, the same code in the same order), the same accepted loops,
    the optimized poses within 1e-4 (m, and on rotation entries: only
    the edge-sharded solve's all-reduce sums in another order), the two
    ranks' poses bitwise equal, and both runs' keyframe positions within
    the reference test's 0.5 m of the truth."""
import numpy as np
import pytest
import torch

from mr_slam_torch.examples import multihost_worker as worker
from mr_slam_torch.geometry import se3
from mr_slam_torch.ops import pointcloud as pcl
from mr_slam_torch.runtime import pipeline
from mr_slam_torch.runtime.config import SlamConfig
from tests import torch_dist
from tests import torch_parity  # noqa: F401  (one PyTorch thread, as in the workers)


def _loops(n, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        R = np.linalg.qr(rng.normal(size=(3, 3)))[0].astype(np.float32)
        out.append((int(rng.integers(0, 6)), dict(
            robot_a=int(rng.integers(0, 3)), kf_a=int(rng.integers(0, 200)),
            robot_b=int(rng.integers(0, 3)), kf_b=int(rng.integers(0, 200)),
            rel=(R, rng.normal(size=3).astype(np.float32)),
            fitness=float(np.float32(rng.random())),
            desc_dist=float(np.float32(rng.random())) if i % 3 else float("inf"),
        )))
    return out


@pytest.mark.parametrize("world", (2, 4))
def test_allgather_loops_round_trip(world, tmp_path):
    loops = _loops(23)
    outs = torch_dist.run_ranks(torch_dist.allgather_loops, world, tmp_path, loops, 64)
    want = sorted(loops, key=lambda x: x[0])
    for merged in outs:
        got = sorted(merged, key=lambda x: x[0])
        assert [pi for pi, _ in got] == [pi for pi, _ in want]
        for (_, a), (_, b) in zip(got, want):
            for k in ("robot_a", "kf_a", "robot_b", "kf_b", "fitness", "desc_dist"):
                assert a[k] == b[k], k
            assert np.array_equal(a["rel"][0], b["rel"][0])
            assert np.array_equal(a["rel"][1], b["rel"][1])


@pytest.fixture(scope="module")
def two_processes(tmp_path_factory):
    out = tmp_path_factory.mktemp("multihost")
    worker.launch(2, dict(MRSLAM_DEVICE="cpu", MRSLAM_OUT=str(out), MRSLAM_ROBOTS="2",
                          MRSLAM_FRAMES="8"), timeout_s=300)
    ranks = [dict(np.load(out / f"rank{p}.npz")) for p in range(2)]
    inputs, trajs = worker.scenario(2, 8)
    cfg = SlamConfig.from_json(str(inputs["cfg"]))
    single = pipeline.run(
        [pcl.PointCloud(torch.from_numpy(inputs["xyz"][r]), torch.from_numpy(inputs["mask"][r]))
         for r in range(2)],
        cfg, origins=[se3.index(t, 0) for t in trajs], device="cpu")
    return ranks, single, trajs


def test_frontends_bitwise_equal(two_processes):
    import json

    ranks, single, _ = two_processes
    want = [worker.robot_digests(rr) for rr in single.robots]
    for rk in ranks:
        assert json.loads(str(rk["stats"]))["runs"][0]["digests"] == want


def test_same_loops(two_processes):
    ranks, single, _ = two_processes
    for rk in ranks:
        assert np.array_equal(rk["loops_0"], worker.loop_rows(single.loops))


def test_poses_match_single_process(two_processes):
    ranks, single, _ = two_processes
    assert np.array_equal(ranks[0]["opt_t_0"], ranks[1]["opt_t_0"])
    assert np.array_equal(ranks[0]["opt_R_0"], ranks[1]["opt_R_0"])
    assert np.array_equal(ranks[0]["node_of"], single.node_of)
    valid = single.graph.node_valid.numpy()
    np.testing.assert_allclose(ranks[0]["opt_t_0"][valid], single.opt_poses.t.numpy()[valid],
                               atol=1e-4, rtol=0)
    np.testing.assert_allclose(ranks[0]["opt_R_0"][valid], single.opt_poses.R.numpy()[valid],
                               atol=1e-4, rtol=0)


def test_both_track_the_truth(two_processes):
    ranks, single, trajs = two_processes
    for r in range(2):
        true_kf = trajs[r].t.numpy()[single.robots[r].kf_frame_idx]
        ids = single.node_of[r][single.node_of[r] >= 0]
        err_mh = np.linalg.norm(ranks[0]["opt_t_0"][ids] - true_kf, axis=-1).max()
        err_single = np.linalg.norm(single.opt_poses.t.numpy()[ids] - true_kf, axis=-1).max()
        assert err_mh < 0.5 and err_single < 0.5, (r, err_mh, err_single)
        assert np.array_equal(ranks[0][f"kf_{r}"], single.robots[r].kf_frame_idx)


def test_bench_split_and_cores_roof(tmp_path):
    rec = worker.bench(2, 2, 3, "cpu", reps=1, timeout_s=300, log_dir=tmp_path / "group")
    assert rec["processes"] == 2 and rec["robots"] == 2 and rec["frames"] == 3
    assert rec["bench_fps"] > 0 and set(rec["split_ms"]) == {"frontend", "feed", "replicate"}
    assert all(v >= 0 for v in rec["split_ms"].values())
    texts = worker.launch(2, worker._bench_env(1, 3, "cpu", 1), timeout_s=300,
                          log_dir=tmp_path / "roof", independent=True)
    recs = worker._bench_records(texts)
    assert [r["processes"] for r in recs] == [1, 1]   # each alone, no group
    assert worker.bench_roof(2, 3, "cpu", reps=1, timeout_s=300,
                             log_dir=tmp_path / "roof2") > 0


@pytest.mark.parametrize("device, cards, num, local, want", [
    ("cpu", 0, 4, None, "gloo"),     # CPU ranks
    ("cuda", 1, 3, "3", "gloo"),     # three ranks of one host share its card
    ("cuda", 1, 3, None, "gloo"),    # no LOCAL_WORLD_SIZE: every rank on this host
    ("cuda", 2, 3, "3", "gloo"),     # more local ranks than cards
    ("cuda", 4, 4, "4", "nccl"),     # one host, one card a rank
    ("cuda", 4, 4, None, "nccl"),    # the same, every rank on this host by default
    ("cuda", 1, 2, "1", "nccl"),     # two hosts of one card each, one rank a host
    ("cuda", 2, 8, "2", "nccl"),     # four hosts of two cards
])
def test_choose_backend_reads_this_host(monkeypatch, device, cards, num, local, want):
    from mr_slam_torch.parallel import multihost

    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    if local is None:
        monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    else:
        monkeypatch.setenv("LOCAL_WORLD_SIZE", local)
    backend, why = multihost.choose_backend(torch.device(device), num)
    assert backend == want, why


def test_launch_tells_each_worker_its_local_layout(tmp_path, monkeypatch):
    """`launch` sets LOCAL_WORLD_SIZE for every worker of a group (all its
    ranks are on this host), and none for independent workers; the
    worker reads it in `choose_backend`."""
    import subprocess

    seen = []

    class Fake:
        def __init__(self, args, env, **kw):
            seen.append(env.get("LOCAL_WORLD_SIZE"))
            self.returncode = 0

        def poll(self):
            return 0

        def wait(self):
            return 0

    monkeypatch.setattr(subprocess, "Popen", Fake)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "7")  # the caller's own is not passed on
    worker.launch(3, {}, log_dir=tmp_path / "group")
    worker.launch(2, {}, log_dir=tmp_path / "alone", independent=True)
    assert seen == ["3", "3", "3", None, None]
