"""The functions that close the ported geometry, grid, PCM and pipeline
modules, against the reference on the same numpy inputs: the se3
constructors and `interpolate` (1e-6), `solve3` / `plane_fit` (1e-5
relative), `nearest_cell` and `_sym6_from_cov` (equal),
`max_clique_greedy` (the same indices), `intra_cycle_distances` (1e-5
relative) and `odom_space_candidates` (equal lists)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.backend import pcm as tpcm
from mr_slam_torch.frontend import keyframes as tkf
from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_torch.ops import linalg3 as tl3, voxel_grid as tvg
from mr_slam_torch.runtime import pipeline as tpipe
from mr_slam_torch.runtime.config import LoopCfg, SlamConfig
from mr_slam_tpu.backend import pcm as jpcm
from mr_slam_tpu.frontend import keyframes as jkf
from mr_slam_tpu.geometry import se3 as jse3
from mr_slam_tpu.ops import linalg3 as jl3, voxel_grid as jvg
from mr_slam_tpu.runtime import pipeline as jpipe
from mr_slam_tpu.runtime.config import LoopCfg as JLoopCfg, SlamConfig as JSlamConfig
from tests.torch_parity import grid_to_jax, pose_to_jax, structured_cloud, to_jax

SE3_TOL = 1e-6


def _f32(x):
    return np.asarray(x, np.float32)


def random_poses(seed: int, n: int) -> tse3.Pose:
    rng = np.random.default_rng(seed)
    return tse3.Pose(tso3.exp(torch.from_numpy(_f32(rng.normal(0, 0.8, (n, 3))))),
                     torch.from_numpy(_f32(rng.normal(0, 5.0, (n, 3)))))


def assert_pose_close(pt, pj, atol=SE3_TOL):
    np.testing.assert_allclose(pt.R.numpy(), np.asarray(pj.R), atol=atol, rtol=0)
    np.testing.assert_allclose(pt.t.numpy(), np.asarray(pj.t), atol=atol, rtol=0)


def test_from_matrix_and_from_rt():
    p = random_poses(0, 16)
    T = p.matrix()
    np.testing.assert_array_equal(T.numpy(), np.asarray(pose_to_jax(p).matrix()))
    assert_pose_close(tse3.from_matrix(T), jse3.from_matrix(to_jax(T)), atol=0)
    assert_pose_close(tse3.from_rt(p.R, p.t), jse3.from_rt(to_jax(p.R), to_jax(p.t)), atol=0)


def test_from_quat_trans():
    rng = np.random.default_rng(1)
    q = rng.normal(size=(16, 4))
    q = _f32(q / np.linalg.norm(q, axis=-1, keepdims=True))
    t = _f32(rng.normal(0, 3, (16, 3)))
    assert_pose_close(tse3.from_quat_trans(torch.from_numpy(q), torch.from_numpy(t)),
                      jse3.from_quat_trans(jnp.asarray(q), jnp.asarray(t)))


def test_from_xyzrpy():
    rng = np.random.default_rng(2)
    v = _f32(np.c_[rng.normal(0, 10, (16, 3)), rng.uniform(-3, 3, (16, 3))])
    assert_pose_close(tse3.from_xyzrpy(torch.from_numpy(v)), jse3.from_xyzrpy(jnp.asarray(v)))


@pytest.mark.parametrize("alpha", [0.0, 0.3, 0.5, 1.0])
@pytest.mark.parametrize("span", ["near", "far"])
def test_interpolate(alpha, span):
    """`near`: b a small motion away from a (0.1 rad, 1 m: the sweeps
    and frames `interpolate` serves), within 1e-6. `far`: unrelated
    poses, relative rotations up to ~3 rad, where log's arccos / sin
    round an ulp apart in the two packages and the rotation parts by up
    to 2e-6: held to 5e-6."""
    a = random_poses(3, 8)
    d = random_poses(4, 8)
    if span == "near":
        b = tse3.compose(a, tse3.Pose(tso3.exp(0.1 * tso3.log(d.R)), 0.2 * d.t))
    else:
        b = d
    al = torch.full((8,), alpha)
    got = tse3.interpolate(a, b, al)
    assert_pose_close(got, jse3.interpolate(pose_to_jax(a), pose_to_jax(b), to_jax(al)),
                      atol=SE3_TOL if span == "near" else 5e-6)
    if alpha in (0.0, 1.0):  # the ends are the inputs
        end = a if alpha == 0.0 else b
        np.testing.assert_allclose(got.t.numpy(), end.t.numpy(), atol=1e-4)


def test_solve3():
    rng = np.random.default_rng(5)
    M = rng.normal(size=(64, 3, 3))
    A = _f32(M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(3))
    b = _f32(rng.normal(size=(64, 3)))
    got = tl3.solve3(torch.from_numpy(A), torch.from_numpy(b)).numpy()
    np.testing.assert_allclose(got, np.asarray(jl3.solve3(jnp.asarray(A), jnp.asarray(b))),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(got, np.linalg.solve(A.astype(np.float64), b[..., None])[..., 0],
                               rtol=1e-3, atol=1e-4)


@pytest.mark.parametrize("weighted", [False, True])
def test_plane_fit(weighted):
    rng = np.random.default_rng(6)
    n = _f32(rng.normal(size=(32, 3)))
    n /= np.linalg.norm(n, axis=-1, keepdims=True)
    u = np.cross(n, [0.3, 0.5, 0.8])
    u /= np.linalg.norm(u, axis=-1, keepdims=True)
    v = np.cross(n, u)
    ab = rng.uniform(-1, 1, (32, 5, 2))
    pts = _f32(rng.normal(0, 5, (32, 1, 3)) + ab[..., :1] * u[:, None] + ab[..., 1:] * v[:, None]
               + 0.01 * rng.normal(size=(32, 5, 3)))
    w = _f32(rng.uniform(0.2, 1.0, (32, 5))) if weighted else None
    tn, td, tm = tl3.plane_fit(torch.from_numpy(pts), None if w is None else torch.from_numpy(w))
    jn, jd, jm = jl3.plane_fit(jnp.asarray(pts), None if w is None else jnp.asarray(w))
    for a, b in ((tn, jn), (td, jd), (tm, jm)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)


def test_nearest_cell_and_sym6():
    pc = structured_cloud(7, 2048)
    grid = tvg.build(pc, 1.0, 1 << 12)
    jgrid = grid_to_jax(grid)  # one table for both packages
    rng = np.random.default_rng(8)
    q = torch.from_numpy(_f32(np.r_[pc.xyz.numpy()[:256],
                                    rng.uniform(-15, 15, (256, 3))]))
    got = tvg.nearest_cell(grid, q)
    ref = jvg.nearest_cell(jgrid, to_jax(q))
    assert 200 < int(got[0].sum()) < 512  # found and missing cells both occur
    for a, b in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    cov = grid.cov
    np.testing.assert_array_equal(tvg._sym6_from_cov(cov).numpy(),
                                  np.asarray(jvg._sym6_from_cov(to_jax(cov))))


def random_graph(seed: int, n: int = 40) -> np.ndarray:
    """A planted 12-clique in a G(n, 0.3) graph."""
    rng = np.random.default_rng(seed)
    adj = rng.random((n, n)) < 0.3
    adj = adj | adj.T
    members = rng.choice(n, 12, replace=False)
    adj[np.ix_(members, members)] = True
    np.fill_diagonal(adj, False)
    return adj


@pytest.mark.parametrize("seed", range(5))
def test_max_clique_greedy(seed):
    adj = random_graph(seed)
    got = tpcm.max_clique_greedy(adj)
    np.testing.assert_array_equal(got, jpcm.max_clique_greedy(adj))
    assert all(adj[i, j] for i in got for j in got if i != j)  # a clique
    assert len(got) <= len(tpcm.max_clique(adj))                # no larger than the exact one


def test_intra_cycle_distances():
    L = 24
    xa, xb = random_poses(10, L), random_poses(11, L)
    odo = tse3.between(xa, xb)
    noise = random_poses(12, L)
    meas = tse3.compose(odo, tse3.Pose(tso3.exp(0.05 * tso3.log(noise.R)), 0.1 * noise.t))
    rng = np.random.default_rng(13)
    ia = torch.from_numpy(rng.integers(0, 100, L))
    ib = torch.from_numpy(rng.integers(0, 100, L))
    kw = dict(odo_drift_t=0.02, odo_drift_r=0.002, step_len=2.0)
    got = tpcm.intra_cycle_distances(xa, xb, meas, ia, ib, **kw).numpy()
    ref = jpcm.intra_cycle_distances(pose_to_jax(xa), pose_to_jax(xb), pose_to_jax(meas),
                                     jnp.asarray(ia.numpy().astype(np.int32)),
                                     jnp.asarray(ib.numpy().astype(np.int32)), **kw)
    np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5)


def test_odom_space_candidates():
    K, cap = 30, 40
    rng = np.random.default_rng(14)
    t = np.zeros((cap, 3), np.float32)
    t[:K] = np.cumsum(rng.normal(0, 1.0, (K, 3)) * [1, 1, 0.05], axis=0) % 12.0
    poses = tse3.Pose(tso3.exp(torch.zeros(cap, 3)), torch.from_numpy(t))
    store = tkf.KeyframeStore(
        xyz=torch.zeros(cap, 4, 3), mask=torch.zeros(cap, 4, dtype=torch.bool), poses=poses,
        stamps=torch.zeros(cap), count=torch.tensor(K), last_pose=tse3.index(poses, K - 1))
    jstore = jkf.KeyframeStore(
        xyz=to_jax(store.xyz), mask=to_jax(store.mask), poses=pose_to_jax(poses),
        stamps=to_jax(store.stamps), count=jnp.int32(K), last_pose=pose_to_jax(store.last_pose))
    found = 0
    for radius, cands in ((0.0, 3), (4.0, 3), (6.0, 5)):
        cfg = SlamConfig(loops=LoopCfg(odom_radius=radius, candidates=cands, min_separation=3))
        jcfg = JSlamConfig(loops=JLoopCfg(odom_radius=radius, candidates=cands, min_separation=3))
        for qi in range(K):
            got = tpipe.odom_space_candidates(store, qi, cfg)
            assert got == jpipe.odom_space_candidates(jstore, qi, jcfg)
            found += len(got)
    assert found > 0
