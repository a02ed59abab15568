"""Place descriptors of the port against the reference: `ops/pointcloud`'s
k-NN helpers, `loop/bev`, `loop/ring`, `loop/scancontext.retrieve`,
`loop/disco`, `loop/m2dp`, `loop/fast_histogram`, and the pipeline's
`describe_one` / `compute_descriptors` / `_descriptor_distances` for every
`LoopCfg.method`. Inputs: 16x512-ray scans of a radius-20 ring road,
raycast once with numpy and fed to both packages.

Tolerances, each where it is used:
  * point-cloud helpers, k-NN (distances and indices), neighbourhood
    covariances, occupancy / max-height BEVs, histograms: exact;
  * eigen-feature BEV: 1e-2 absolute, 95 % of cells bit-equal — the
    covariances are bit-equal, but `eigvalsh3`'s arccos / cos round by an
    ulp against the reference's, and omnivariance (a cube root of a
    product with a near-zero eigenvalue) and eigen-entropy magnify that;
  * Radon, RING / RING++ descriptors: 1e-5 relative to the largest
    entry (libm sin / cos and sum order);
  * `radon_backproject`: the adjoint identity to 1e-4 relative;
  * correlation distances 1e-5; shifts equal wherever the two best
    angles score more than 1e-5 apart (the port sums over columns before
    its inverse FFT, the reference after);
  * SE(2) hypotheses within 1e-3 m and 1e-4 rad;
  * DiSCO signatures 1e-6, spectra 1e-4 relative, yaws equal outside
    near-ties, the phase-correlation confidence 1e-3 (the cross-spectrum
    is normalized bin by bin, tiny bins included); M2DP within 5e-4 (PCA
    axes and SVD of another library);
  * through `compute_descriptors`: ScanContext 1e-6 relative (the ring
    key's mean), RING 1e-5; RING++ 5e-2 relative (a 1e-2 cell of the
    eigen-feature BEV above moves every ray through it, and the channel's
    normalization), its correlation distances 5e-3."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.frontend import keyframes as tkf
from mr_slam_torch.geometry import se3 as tse3
from mr_slam_torch.loop import bev as tbev, disco as tdisco, fast_histogram as thist
from mr_slam_torch.loop import m2dp as tm2dp, ring as tring, scancontext as tsc
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_torch.runtime import config as tcfg, pipeline as tpipe
from mr_slam_tpu.loop import bev as jbev, disco as jdisco, fast_histogram as jhist
from mr_slam_tpu.loop import m2dp as jm2dp, ring as jring, scancontext as jsc
from mr_slam_tpu.ops import pointcloud as jpcl
from mr_slam_tpu.runtime import config as jcfg, pipeline as jpipe
from tests.torch_parity import cloud_to_jax, make_scans, to_jax

N_KF = 6


@pytest.fixture(scope="module")
def clouds():
    """N_KF body-frame scans along a radius-20 ring road (16x512 rays)."""
    world = synthetic.default_world(9)
    traj = synthetic.circle_trajectory(N_KF, radius=20.0, laps=0.3)
    return make_scans(world, traj, N_KF, seed=0, n_rings=16, n_azimuth=512)


def one(clouds, i=0):
    c = tpcl.PointCloud(clouds.xyz[i], clouds.mask[i])
    return c, cloud_to_jax(c)


def rel_err(a, b) -> float:
    a, b = np.asarray(a), np.asarray(b)
    dt = np.complex128 if np.iscomplexobj(a) or np.iscomplexobj(b) else np.float64
    a, b = a.astype(dt), b.astype(dt)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


# --------------------------------------------------------------------------
# ops/pointcloud
# --------------------------------------------------------------------------


def test_cloud_helpers_exact(clouds):
    c, jc = one(clouds)
    half = tpcl.PointCloud(c.xyz, c.mask & (torch.arange(c.xyz.shape[0]) % 3 == 0))
    jhalf = cloud_to_jax(half)
    for got, want in (
        (tpcl.compact(half), jpcl.compact(jhalf)),
        (tpcl.pad_to(half, 9000), jpcl.pad_to(jhalf, 9000)),
        (tpcl.pad_to(half, 3000), jpcl.pad_to(jhalf, 3000)),
        (tpcl.crop_radius(c, (1.0, -2.0, 0.0), 15.0), jpcl.crop_radius(jc, (1.0, -2.0, 0.0), 15.0)),
        (tpcl.make(c.xyz[:100]), jpcl.make(to_jax(c.xyz[:100]))),
    ):
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_array_equal(got.xyz.numpy(), np.asarray(want.xyz))


def test_knn_and_covariances_exact(clouds):
    """Distances, neighbour indices (lower index first among equal
    distances) and covariances bit-equal, batched over two clouds."""
    batch = tpcl.PointCloud(clouds.xyz[:2], clouds.mask[:2])
    d, i = tpcl.knn(batch.xyz, batch, 8)
    mean, cov, valid = tpcl.covariances_knn(batch, 8)
    for b in range(2):
        _, jc = one(clouds, b)
        jd, ji = jpcl.knn(jc.xyz, jc, 8)
        m = clouds.mask[b].numpy()
        np.testing.assert_array_equal(d[b].numpy()[m], np.asarray(jd)[m])
        np.testing.assert_array_equal(i[b].numpy()[m], np.asarray(ji)[m])
        jmean, jcov, jvalid = jpcl.covariances_knn(jc, 8)
        np.testing.assert_array_equal(valid[b].numpy(), np.asarray(jvalid))
        np.testing.assert_array_equal(mean[b].numpy()[m], np.asarray(jmean)[m])
        np.testing.assert_array_equal(cov[b].numpy()[m], np.asarray(jcov)[m])


def test_knn_cross_term_is_the_cpu_matmul(clouds):
    """The k-NN cross term, a float32 FMA chain with exact float64
    products, is bit-equal to the CPU matmul it replaced, on the clouds
    RING++'s eigen-feature BEV takes its neighbourhoods from."""
    q = 2.0 * clouds.xyz[:2]
    got = tpcl._cross(q, clouds.xyz[:2])
    want = q @ clouds.xyz[:2].transpose(-1, -2)
    assert got.dtype == torch.float32 and got.shape == want.shape == (2, 8192, 8192)
    assert torch.equal(got, want)
# --------------------------------------------------------------------------


def test_occupancy_bevs_exact(clouds):
    batch = tpcl.PointCloud(clouds.xyz[:3], clouds.mask[:3])
    norm = tbev.normalize_cloud(batch, z_min=0.3)
    cart = tbev.cartesian_occupancy(norm, z_bins=2)
    polar = tbev.polar_occupancy(batch, 40, 120, z_bins=20, z_min=0.3)
    height = tbev.polar_max_height(batch)
    for b in range(3):
        _, jc = one(clouds, b)
        jn = jbev.normalize_cloud(jc, z_min=0.3)
        np.testing.assert_array_equal(norm.xyz[b].numpy(), np.asarray(jn.xyz))
        np.testing.assert_array_equal(cart[b].numpy(), np.asarray(jbev.cartesian_occupancy(jn, z_bins=2)))
        np.testing.assert_array_equal(
            polar[b].numpy(), np.asarray(jbev.polar_occupancy(jc, 40, 120, z_bins=20, z_min=0.3)))
        np.testing.assert_array_equal(height[b].numpy(), np.asarray(jbev.polar_max_height(jc)))
    assert cart.sum() > 100 and polar.sum() > 100


def test_eigen_feature_bev(clouds):
    batch = tpcl.PointCloud(clouds.xyz[:2], clouds.mask[:2])
    fb = tbev.eigen_feature_bev(batch, 120, 120, k=8).numpy()
    for b in range(2):
        _, jc = one(clouds, b)
        want = np.asarray(jbev.eigen_feature_bev(jc, 120, 120, k=8))
        assert fb[b].shape == want.shape == (6, 120, 120)
        np.testing.assert_allclose(fb[b], want, rtol=0, atol=1e-2)
        assert (fb[b] == want).mean() >= 0.95
        assert (want != 0).sum() > 1000


# --------------------------------------------------------------------------
# loop/ring
# --------------------------------------------------------------------------


@pytest.fixture(scope="module")
def occ(clouds):
    """Cartesian occupancy BEVs (N_KF, 120, 120) of the scans."""
    return tbev.cartesian_occupancy(tbev.normalize_cloud(
        tpcl.PointCloud(clouds.xyz, clouds.mask)))[:, 0]


def test_angles_are_the_references():
    for n, stop in ((120, np.pi), (4, np.pi), (16, np.pi / 2), (7, np.pi)):
        np.testing.assert_array_equal(tring.angles(n, stop),
                                      np.asarray(jnp.linspace(0.0, stop, n, endpoint=False)))


def test_radon_and_radon_mxu(occ):
    sino = tring.radon(occ[:3])
    mxu = tring.radon_mxu(occ[:2])
    for b in range(3):
        assert rel_err(sino[b], jring.radon(to_jax(occ[b]))) < 1e-5
    for b in range(2):
        assert rel_err(mxu[b], jring.radon_mxu(to_jax(occ[b]))) < 1e-5


def test_radon_backproject_is_the_adjoint(occ):
    rng = np.random.default_rng(0)
    y = torch.from_numpy(rng.standard_normal((120, 120)).astype(np.float32))
    x = occ[0]
    bp = tring.radon_backproject(y, 120)
    lhs = float(torch.sum(tring.radon(x).double() * y.double()))
    rhs = float(torch.sum(x.double() * bp.double()))
    assert abs(lhs - rhs) <= 1e-4 * abs(lhs)
    assert rel_err(bp, jring.radon_backproject(to_jax(y), 120)) < 1e-5
    rec = tring.fbp(tring.radon(x), 120)
    assert rel_err(rec, jring.fbp(jring.radon(to_jax(x)), 120)) < 1e-4


def test_describe_and_describe_ringpp(clouds, occ):
    d = tring.describe(occ[:2])
    for b in range(2):
        j = jring.describe(to_jax(occ[b]))
        assert rel_err(d.sinogram[b], j.sinogram) < 1e-5
        assert rel_err(d.tiring[b], j.tiring) < 1e-5
    # the reference's 3-D input averages per-channel sinograms
    stack = torch.stack([occ[0], occ[1]])
    j3 = jring.describe(to_jax(stack))
    assert rel_err(tring.describe(stack, channels=True).tiring, j3.tiring) < 1e-5
    # RING++ from one shared feature BEV (the reference's)
    _, jc = one(clouds)
    jfb = jbev.eigen_feature_bev(jc, 120, 120, k=8)
    pp = tring.describe_ringpp(torch.from_numpy(np.array(jfb)))
    jpp = jring.describe_ringpp(jfb)
    assert rel_err(pp.sinograms, jpp.sinograms) < 1e-5
    assert rel_err(pp.tirings, jpp.tirings) < 1e-5


def _scores64(q: np.ndarray, db: np.ndarray) -> np.ndarray:
    """Normalized correlation scores (D, A) in float64: sum over every
    axis but the angle axis (-2) of the circular correlation."""
    fq = np.fft.fft(q.astype(np.float64), axis=-2)
    fd = np.fft.fft(db.astype(np.float64), axis=-2)
    corr = np.fft.ifft(np.conj(fq)[None] * fd, axis=-2).real
    s = corr.sum(axis=tuple(range(1, corr.ndim - 2)) + (corr.ndim - 1,))
    norm = np.linalg.norm(q) * np.sqrt((db.astype(np.float64) ** 2).reshape(len(db), -1).sum(1))
    return s / norm[:, None]


def _assert_shifts_match(shift, jshift, scores, tol=1e-5):
    top2 = np.sort(scores, axis=-1)[:, -2:]
    clear = top2[:, 1] - top2[:, 0] > tol
    assert clear.mean() > 0.5
    np.testing.assert_array_equal(np.asarray(shift)[clear], np.asarray(jshift)[clear])


def test_correlate(occ):
    tiring = tring.describe(occ).tiring                  # (N_KF, A, W)
    dist, shift = tring.correlate(tiring[:3], tiring)   # a batch of 3 queries
    for q in range(3):
        jd, js = jring.correlate(to_jax(tiring[q]), to_jax(tiring))
        np.testing.assert_allclose(dist[q].numpy(), np.asarray(jd), rtol=0, atol=1e-5)
        _assert_shifts_match(shift[q], js, _scores64(tiring[q].numpy(), tiring.numpy()))
    assert float(dist[0, 0]) < 1e-5  # a descriptor against itself


def test_correlate_multichannel(clouds):
    _, jc = one(clouds)
    jfb = np.array(jbev.eigen_feature_bev(jc, 120, 120, k=8))
    rng = np.random.default_rng(1)
    # a database of the BEV, its channels rolled, and noisy copies
    db = np.stack([jfb, np.roll(jfb, 30, axis=-1), jfb + rng.random(jfb.shape).astype(np.float32)])
    t = tring.describe_ringpp(torch.from_numpy(db)).tirings
    dist, shift = tring.correlate_multichannel(t[0], t)
    jd, js = jring.correlate_multichannel(to_jax(t[0]), to_jax(t))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jd), rtol=0, atol=1e-5)
    _assert_shifts_match(shift, js, _scores64(t[0].numpy(), t.numpy()))


def test_rows_shift_yaw_and_se2_hypotheses(occ):
    sino = tring.describe(occ).sinogram
    shift = torch.tensor([0, 37, -5, 119, 60, 3])
    np.testing.assert_array_equal(tring.rotate_rows(sino, shift)[1].numpy(),
                                  np.asarray(jring.rotate_rows(to_jax(sino[1]), 37)))
    aligned = tring.align_sinogram(sino, shift)
    for b in range(N_KF):
        np.testing.assert_array_equal(
            aligned[b].numpy(), np.asarray(jring.align_sinogram(to_jax(sino[b]), int(shift[b]))))
    np.testing.assert_array_equal(tring.shift_to_yaw(shift, 120).numpy(),
                                  np.asarray(jring.shift_to_yaw(to_jax(shift), 120)))
    cand = torch.roll(sino, 1, dims=0)
    yaws, xys, res = tring.se2_hypotheses(sino, cand, shift)
    for b in range(N_KF):
        jy, jxy, jres = jring.se2_hypotheses(to_jax(sino[b]), to_jax(cand[b]), int(shift[b]))
        np.testing.assert_allclose(yaws[b].numpy(), np.asarray(jy), rtol=0, atol=1e-4)
        np.testing.assert_allclose(xys[b].numpy(), np.asarray(jxy), rtol=0, atol=1e-3)
        np.testing.assert_allclose(res[b].numpy(), np.asarray(jres), rtol=1e-4, atol=1e-5)


def test_se2_hypotheses_recover_a_planar_motion():
    """The reference test's blob world (`tests/test_loop_verify.py`):
    the better hypothesis recovers yaw and translation."""
    rng = np.random.default_rng(0)
    pts = rng.uniform(-45, 45, (4000, 2))
    blobs = rng.uniform(-40, 40, (30, 2))
    pts = pts[np.linalg.norm(pts[:, None] - blobs[None], axis=-1).min(1) < 6.0]
    pa = np.concatenate([pts, rng.uniform(0.5, 4.0, (pts.shape[0], 1))], 1)
    phi, t = -1.2, np.array([2.0, 9.0])
    pb = pa.copy()
    pb[:, :2] = pa[:, :2] @ np.array([[np.cos(phi), -np.sin(phi)], [np.sin(phi), np.cos(phi)]]).T + t
    descs = [tring.describe(tbev.cartesian_occupancy(tbev.normalize_cloud(
        tpcl.make(torch.from_numpy(p.astype(np.float32)))))[0]) for p in (pa, pb)]
    _, shift = tring.correlate(descs[0].tiring, descs[1].tiring[None])
    yaws, xys, res = tring.se2_hypotheses(descs[0].sinogram, descs[1].sinogram, shift[0])
    k = int(torch.argmin(res))
    assert abs((float(yaws[k]) - phi + np.pi) % (2 * np.pi) - np.pi) < 0.1
    assert float(np.linalg.norm(xys[k].numpy() - t)) < 3.0


# --------------------------------------------------------------------------
# scancontext.retrieve, disco, m2dp, fast_histogram
# --------------------------------------------------------------------------


def test_scancontext_retrieve(clouds):
    keys = tsc.ring_key(tsc.describe(tpcl.PointCloud(clouds.xyz, clouds.mask)))
    mask = torch.tensor([True, True, False, True, True, True])
    got = tsc.retrieve(keys[:2], keys, mask)
    for q in range(2):
        np.testing.assert_allclose(got[q].numpy(),
                                   np.asarray(jsc.retrieve(to_jax(keys[q]), to_jax(keys), to_jax(mask))),
                                   rtol=1e-6, atol=1e-6)


def test_disco(clouds):
    batch = tpcl.PointCloud(clouds.xyz, clouds.mask)
    d = tdisco.describe(tbev.polar_occupancy(batch, 40, 120, z_bins=20))
    jds = [jdisco.describe(jbev.polar_occupancy(one(clouds, b)[1], 40, 120, z_bins=20))
           for b in range(N_KF)]
    for b, j in enumerate(jds):
        np.testing.assert_allclose(d.signature[b].numpy(), np.asarray(j.signature), rtol=0,
                                   atol=1e-6)
        assert rel_err(d.spectrum[b], j.spectrum) < 1e-4
    assert d.spectrum.dtype == torch.complex64
    mask = torch.tensor([True] * (N_KF - 1) + [False])
    dist = tdisco.distance(d.signature[:2], d.signature, mask)
    jsig = jnp.stack([j.signature for j in jds])
    yaw, conf = tdisco.relative_yaw(d.spectrum[:, None], d.spectrum)     # (N_KF, N_KF)
    for q in range(2):
        np.testing.assert_allclose(dist[q].numpy(), np.asarray(
            jdisco.distance(jds[q].signature, jsig, to_jax(mask))), rtol=0, atol=1e-5)
    for q in range(N_KF):
        for c in range(N_KF):
            jy, jc = jdisco.relative_yaw(jds[q].spectrum, jds[c].spectrum)
            np.testing.assert_allclose(float(conf[q, c]), float(jc), rtol=0, atol=1e-3)
            surface = np.fft.ifft2(
                (lambda x: x / np.maximum(np.abs(x), 1e-9))(
                    np.asarray(jds[q].spectrum, np.complex128)
                    * np.conj(np.asarray(jds[c].spectrum, np.complex128)))).real.ravel()
            top2 = np.sort(surface)[-2:]
            if top2[1] - top2[0] > 1e-5:
                assert float(yaw[q, c]) == float(jy), (q, c)


def test_m2dp(clouds):
    dirs = torch.tensor([[0.0, 0.0, 1.0], [1e-4, 0.0, 1.0], [0.0, 0.0, -1.0], [1.0, 0.0, 0.0],
                         [0.3, -0.4, 0.86]])
    ex, ey = tm2dp.projection_basis(dirs)
    jex, jey = jm2dp.projection_basis(to_jax(dirs))
    np.testing.assert_allclose(ex.numpy(), np.asarray(jex), rtol=0, atol=1e-6)
    np.testing.assert_allclose(ey.numpy(), np.asarray(jey), rtol=0, atol=1e-6)
    d = tm2dp.describe(tpcl.PointCloud(clouds.xyz[:3], clouds.mask[:3]))
    assert d.shape == (3, 4 * 16 + 8 * 16)
    for b in range(3):
        np.testing.assert_allclose(d[b].numpy(), np.asarray(jm2dp.describe(one(clouds, b)[1])),
                                   rtol=0, atol=5e-4)


def test_fast_histogram(clouds):
    h = thist.describe(tpcl.PointCloud(clouds.xyz, clouds.mask))
    jh = jnp.stack([jhist.describe(one(clouds, b)[1]) for b in range(N_KF)])
    np.testing.assert_array_equal(h.numpy(), np.asarray(jh))
    np.testing.assert_allclose(thist.distance(h[:2], h)[1].numpy(),
                               np.asarray(jhist.distance(jh[1], jh)), rtol=1e-6, atol=1e-7)


# --------------------------------------------------------------------------
# runtime/pipeline: every method through describe_one / compute_descriptors
# --------------------------------------------------------------------------

METHODS = ["scancontext", "ring", "ringpp", "disco", "m2dp", "fasthist"]
DESC_TOL = dict(scancontext=1e-6, ring=1e-5, ringpp=5e-2, disco=1e-4, m2dp=5e-4, fasthist=0.0)


@pytest.fixture(scope="module")
def store(clouds):
    """A capacity-8 keyframe store (points_per_kf 2048) of the scans."""
    world_traj = synthetic.circle_trajectory(N_KF, radius=20.0, laps=0.3)
    s = tkf.init(8, 2048)
    for i in range(N_KF):
        s, _ = tkf.maybe_add(s, tpcl.PointCloud(clouds.xyz[i], clouds.mask[i]),
                             tse3.index(world_traj, i), torch.tensor(float(i)),
                             dist_thresh=0.0, leaf=0.2)
    return s


def configs(method):
    kw = dict(method=method, bev_z_min=0.3)
    return tcfg.SlamConfig(loops=tcfg.LoopCfg(**kw)), jcfg.SlamConfig(loops=jcfg.LoopCfg(**kw))


@pytest.mark.parametrize("method", METHODS)
def test_compute_descriptors_and_distances(store, method):
    from tests.test_torch_loopstage import store_to_jax

    cfg, jc = configs(method)
    jstore = store_to_jax(store)
    descs = tpipe.compute_descriptors(store, cfg)
    jdescs = jpipe.compute_descriptors(jstore, jc)
    assert sorted(descs) == sorted(jdescs)
    one_ = tpipe.describe_one(tpcl.PointCloud(store.xyz[2], store.mask[2]), cfg)
    for k in descs:
        want = np.asarray(jdescs[k])
        assert descs[k].shape == want.shape and descs[k].dtype == one_[k].dtype, k
        assert str(want.dtype) == str(descs[k].dtype).replace("torch.", ""), k
        got = descs[k].numpy()
        tol = DESC_TOL[method] * max(np.abs(want).max(), 1e-30)
        np.testing.assert_allclose(got, want, rtol=0, atol=tol, err_msg=k)
        np.testing.assert_array_equal(one_[k].numpy(), got[2], err_msg=k)
    qi = torch.arange(N_KF)
    d, yaw = tpipe._descriptor_distances(descs, qi, descs, cfg)
    assert d.shape == yaw.shape == (N_KF, 8)
    dist_tol = dict(ringpp=5e-3, m2dp=1e-3).get(method, 1e-5)
    for q in range(N_KF):
        jd, jy = jpipe._descriptor_distances(jdescs, q, jdescs, jc)
        np.testing.assert_allclose(d[q].numpy(), np.asarray(jd), rtol=0, atol=dist_tol)
        if method in ("m2dp", "fasthist"):
            assert not yaw[q].any()


def test_run_raises_without_cuda():
    cfg = tcfg.SlamConfig()
    cloud = tpcl.PointCloud(torch.zeros((1, 8, 3)), torch.ones((1, 8), dtype=torch.bool))
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.run([cloud], cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        tpipe.run([cloud], cfg, device="cuda")
