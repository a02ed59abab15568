"""Place-recognition evaluation of the port against the reference:
`eval/metrics` (`recall_at_n`, `make_positives`, `relative_pose_error`),
`eval/recall_harness` (every method of `METHODS`, self-retrieval and the
cross-run protocol) and the native descriptor index
(`native.DescriptorKNN`).

Inputs: two laps of the radius-20 ring road of world 9, 36 keyframes of
16x512 rays, raycast once with numpy. Tolerances: `recall_at_n` and
`make_positives` exact on shared inputs; RPE 1e-6; recall@1 of each
method within one query of the reference's (descriptor rounding may swap
a near-tied nearest neighbour); the kd-tree's neighbours equal and
distances within 1e-6 of the reference's."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch import native as tnative
from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import metrics as tmet, recall_harness as trh
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_tpu import native as jnative
from mr_slam_tpu.eval import metrics as jmet, recall_harness as jrh
from tests.torch_parity import cloud_to_jax, make_scans, pose_to_jax, to_jax

N = 36
KW = dict(radius=6.0, min_separation=8, max_n=5)


@pytest.fixture(scope="module")
def laps():
    world = synthetic.default_world(9)
    traj = synthetic.circle_trajectory(N, radius=20.0, laps=2.0)
    return make_scans(world, traj, N, seed=0, n_rings=16, n_azimuth=512), traj


def test_recall_at_n_and_positives_exact():
    rng = np.random.default_rng(0)
    pos_q = rng.uniform(-20, 20, (30, 3)).astype(np.float32)
    pos_db = rng.uniform(-20, 20, (120, 3)).astype(np.float32)
    dists = rng.random((30, 120)).astype(np.float32)
    dists[:, 5] = dists[:, 7]  # ties rank by index
    dists[3, :10] = np.inf
    for exclude in (-1, 0):
        p = tmet.make_positives(torch.from_numpy(pos_q), torch.from_numpy(pos_db), 9.0, exclude)
        jp = jmet.make_positives(jnp.asarray(pos_q), jnp.asarray(pos_db), 9.0, exclude)
        np.testing.assert_array_equal(p.numpy(), np.asarray(jp))
    valid = p.any(dim=1)
    got = tmet.recall_at_n(torch.from_numpy(dists), p, valid, max_n=25)
    want = jmet.recall_at_n(jnp.asarray(dists), jp, to_jax(valid), max_n=25)
    np.testing.assert_array_equal(got.recall_at_n.numpy(), np.asarray(want.recall_at_n))
    assert float(got.top1_percent) == float(want.top1_percent)
    assert 0.0 < float(got.recall_at_n[-1]) <= 1.0


def test_relative_pose_error(laps):
    _, traj = laps
    rng = np.random.default_rng(2)
    noisy = tse3.Pose(traj.R, traj.t + torch.from_numpy(
        rng.normal(0, 0.05, traj.t.shape).astype(np.float32)))
    for delta in (1, 3):
        got = float(tmet.relative_pose_error(noisy, traj, delta))
        want = float(jmet.relative_pose_error(pose_to_jax(noisy), pose_to_jax(traj), delta))
        assert abs(got - want) <= 1e-6 and got > 0.01


@pytest.mark.parametrize("method", list(trh.METHODS))
def test_recall_on_revisits_matches_reference(laps, method):
    clouds, traj = laps
    got = trh.evaluate_method(method, clouds, traj.t, device="cpu", **KW)
    want = jrh.evaluate_method(method, cloud_to_jax(clouds), to_jax(traj.t), **KW)
    r, jr = got.recall_at_n.numpy(), np.asarray(want.recall_at_n)
    idx = torch.arange(N)
    pos = tmet.make_positives(traj.t, traj.t, KW["radius"]) \
        & ~(torch.abs(idx[:, None] - idx[None, :]) < KW["min_separation"])
    n_valid = int(pos.any(dim=1).sum())
    assert n_valid >= 10
    assert abs(r[0] - jr[0]) <= 1.0 / n_valid + 1e-6, (r, jr)
    assert np.all(np.diff(r) >= 0)
    assert r[0] >= 0.3  # every method beats chance on revisits


def test_evaluate_cross(laps):
    """The cross-run protocol: lap 2 queried against lap 1."""
    clouds, traj = laps
    h = N // 2
    q = tpcl.PointCloud(clouds.xyz[h:], clouds.mask[h:])
    db = tpcl.PointCloud(clouds.xyz[:h], clouds.mask[:h])
    got = trh.evaluate_cross("ring", q, traj.t[h:], db, traj.t[:h], radius=6.0, max_n=5,
                             device="cpu")
    want = jrh.evaluate_cross("ring", cloud_to_jax(q), to_jax(traj.t[h:]), cloud_to_jax(db),
                              to_jax(traj.t[:h]), radius=6.0, max_n=5)
    np.testing.assert_allclose(got.recall_at_n.numpy(), np.asarray(want.recall_at_n),
                               rtol=0, atol=1.0 / h + 1e-6)
    assert float(got.recall_at_n[0]) >= 0.8


def test_harness_needs_cuda_unless_told():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    cloud = tpcl.PointCloud(torch.zeros((2, 8, 3)), torch.ones((2, 8), dtype=torch.bool))
    with pytest.raises(RuntimeError, match="CUDA"):
        trh.evaluate_method("fasthist", cloud, torch.zeros((2, 3)))
    with pytest.raises(RuntimeError, match="CUDA"):
        trh.evaluate_cross("fasthist", cloud, torch.zeros((2, 3)), cloud, torch.zeros((2, 3)))


def test_descriptor_knn_matches_reference():
    rng = np.random.default_rng(3)
    db = rng.standard_normal((300, 24)).astype(np.float32)
    port, ref = tnative.DescriptorKNN(24), jnative.DescriptorKNN(24)
    for v in db:
        port.insert(v)
        ref.insert(v)
    assert len(port) == len(ref) == 300
    for q in rng.standard_normal((5, 24)):
        i, d = port.knn(q, 7)
        ji, jd = ref.knn(q, 7)
        np.testing.assert_array_equal(i, ji)
        np.testing.assert_allclose(d, jd, rtol=0, atol=1e-6)
        brute = np.linalg.norm(db - q.astype(np.float32), axis=1)
        np.testing.assert_array_equal(i, np.argsort(brute, kind="stable")[:7])
    with pytest.raises(ValueError, match="dim"):
        port.insert(np.zeros(5))
    port.close()
    with pytest.raises(ValueError, match="closed"):
        port.knn(db[0], 1)
