"""Batched loop stage of the port against the reference, on the
`circle_store` setup of `tests/test_loopstage.py` (one robot on a closed
radius-10 circle, keyframes at the true poses). The store is built once
by the port and handed to both packages.

Bounds: identical top-k candidate sets and accepted loop sets; verified
relative poses within 1 cm and 0.1 deg; fitness on the same side of the
accept gate and within 0.05.

Why fitness is loose: it is scored against the permissive grid (leaf
0.5) built from the 0.4-leaf verify cloud, so most cells hold one or two
points. A two-point cell has a rank-1 covariance; after the 1e-9 I
regularizer its two small eigenvalues are f32 rounding noise, and the
planarity test (lambda0 < 0.1 lambda1) that picks point-to-plane over
centroid distance is decided by that noise — in the reference as much
as in the port (on one table and one pose the two packages still differ
through libm rounding, see `test_torch_registration.py`). The reference
itself therefore scores these loops only to ~0.05 (ROADMAP, Queue 3);
the poses are the tight check."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.frontend import keyframes as tkf
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.runtime import loopstage as tls, pipeline as tpipe
from mr_slam_torch.runtime.config import KeyframeCfg, LoopCfg, SlamConfig
from mr_slam_tpu.frontend import keyframes as jkf
from mr_slam_tpu.runtime import loopstage as jls, pipeline as jpipe
from mr_slam_tpu.runtime.config import KeyframeCfg as JKeyframeCfg
from mr_slam_tpu.runtime.config import LoopCfg as JLoopCfg
from mr_slam_tpu.runtime.config import SlamConfig as JSlamConfig
from tests.torch_parity import make_scans, pose_to_jax, rot_err_deg, to_jax

CFG_KW = dict(
    keyframes=dict(dist_thresh=1.0, capacity=32, points_per_kf=4096),
    loops=dict(method="scancontext", dist_thresh=0.4, min_separation=4,
               candidates=2, verify_capacity=8192, fitness_thresh=0.3),
)
CFG = SlamConfig(keyframes=KeyframeCfg(**CFG_KW["keyframes"]), loops=LoopCfg(**CFG_KW["loops"]))
JCFG = JSlamConfig(keyframes=JKeyframeCfg(**CFG_KW["keyframes"]),
                   loops=JLoopCfg(**CFG_KW["loops"]))


def store_to_jax(s: tkf.KeyframeStore) -> jkf.KeyframeStore:
    return jkf.KeyframeStore(
        xyz=to_jax(s.xyz), mask=to_jax(s.mask), poses=pose_to_jax(s.poses),
        stamps=to_jax(s.stamps), count=jnp.int32(int(s.count)),
        last_pose=pose_to_jax(s.last_pose),
    )


@pytest.fixture(scope="module")
def circle_store():
    world = synthetic.default_world(3)
    n = 20
    traj = synthetic.circle_trajectory(n, radius=10.0, laps=1.0)
    scans = make_scans(world, traj, n, seed=0, n_rings=16, n_azimuth=512)
    store = tkf.init(32, 4096)
    for i in range(n):
        store, _ = tkf.maybe_add(
            store, tkf.pcl.PointCloud(scans.xyz[i], scans.mask[i]), tse3.index(traj, i),
            torch.tensor(0.1 * i), dist_thresh=1.0, leaf=0.2,
        )
    return store, store_to_jax(store)


def test_retrieve_same_top_k(circle_store):
    store, jstore = circle_store
    descs = tpipe.compute_descriptors(store, CFG)
    jdescs = jpipe.compute_descriptors(jstore, JCFG)
    np.testing.assert_allclose(descs["sc"].numpy(), np.asarray(jdescs["sc"]), atol=1e-5)
    qi = torch.arange(store.capacity)
    d, i, *_ = tls.retrieve(descs, qi, store.poses.t, descs, store.poses.t, store.count,
                            CFG, same_robot=True)
    jd, ji, *_ = jls.retrieve(jdescs, jnp.arange(store.capacity, dtype=jnp.int32),
                              jstore.poses.t, jdescs, jstore.poses.t, jstore.count,
                              JCFG, same_robot=True)
    # rows >= count are capacity padding (all-zero descriptors, tied
    # distances) that the host discards
    K = int(store.count)
    d, i, jd, ji = d.numpy()[:K], i.numpy()[:K], np.asarray(jd)[:K], np.asarray(ji)[:K]
    finite = np.isfinite(jd)
    np.testing.assert_array_equal(np.isfinite(d), finite)
    np.testing.assert_array_equal(i[finite], ji[finite])
    np.testing.assert_allclose(d[finite], jd[finite], atol=1e-5)


def test_verify_chunk_matches_reference(circle_store):
    store, jstore = circle_store
    descs = tpipe.compute_descriptors(store, CFG)
    loops = tls.search_pair_loops(store, descs, store, descs, CFG, same_robot=True)
    assert len(loops) >= 1, "revisit on a closed circle must verify"
    K = int(store.count)
    # the accepted loops plus a padded chunk of arbitrary pairs
    pairs = [(l["kf_a"], l["kf_b"]) for l in loops][:4] + [(K - 1, 2), (K - 2, 1)]
    pairs = (pairs + [(0, 0)] * tls.CHUNK)[: tls.CHUNK]
    ia = torch.tensor([p[0] for p in pairs])
    ib = torch.tensor([p[1] for p in pairs])
    yaw = torch.zeros(tls.CHUNK)
    rel, fit = tls.verify_chunk(store, store, ia, ib, yaw, CFG, same_robot=True)
    jrel, jfit = jls.verify_chunk(jstore, jstore, to_jax(ia.int()), to_jax(ib.int()),
                                  to_jax(yaw), JCFG, True)
    gate = CFG.loops.fitness_thresh
    np.testing.assert_array_equal(fit.numpy() < gate, np.asarray(jfit) < gate)
    np.testing.assert_allclose(fit.numpy(), np.asarray(jfit), atol=0.05)
    np.testing.assert_allclose(rel.t.numpy(), np.asarray(jrel.t), atol=0.01)
    for a, b in zip(rel.R.numpy(), np.asarray(jrel.R)):
        assert rot_err_deg(a, b) < 0.1


def test_search_pair_loops_same_accepted_set(circle_store):
    store, jstore = circle_store
    loops = tls.search_pair_loops(store, tpipe.compute_descriptors(store, CFG),
                                  store, tpipe.compute_descriptors(store, CFG),
                                  CFG, same_robot=True)
    jdescs = jpipe.compute_descriptors(jstore, JCFG)
    jloops = jls.search_pair_loops(jstore, jdescs, jstore, jdescs, JCFG, same_robot=True)
    assert {(l["kf_a"], l["kf_b"]) for l in loops} == {(l["kf_a"], l["kf_b"]) for l in jloops}
