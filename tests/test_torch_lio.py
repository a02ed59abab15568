"""The FAST-LIO-style IEKF of the port against the reference
(`frontend/lio.py`, and `ops/linalg3`'s scaled 24x24 solves) on the same
numpy inputs: the reference tests' circle (world 3, radius 25, 0.05
laps, 16x512 rays), IMU packets of `synthetic.imu_for_trajectory`
without noise, shared states converted through numpy.

Tolerances: the scaled inverse and solve on SPD matrices of condition
~1e6, error against a float64 solution at most 2 x the reference's +
1e-6 (the port solves in float64, the reference in float32);
`imu_init` 1e-6; one `propagate` packet: R, p, v within 1e-5, P
within 1e-4 of its largest entry; `undistort` 1e-5; one `update` from a
shared propagated state against a room's map: pose within 1e-4 m and
1e-3 degrees, the other states 1e-4, P 1e-3 of its largest entry (on a
scan's points 25 m out the fixed point moves by millimetres with the
summation order, as in `test_torch_features.py`); a 12-frame
`step` run by ATE within 1.25 x the reference's + 0.05 m."""
import numpy as np
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.eval import metrics as tmet
from mr_slam_torch.frontend import lio as tlio
from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_torch.ops import linalg3 as tl3, pointcloud as tpcl, voxel_grid as tvg
from mr_slam_tpu.frontend import lio as jlio
from mr_slam_tpu.ops import linalg3 as jl3
from tests.torch_parity import (
    cloud_to_jax, lio_state_to_jax, lio_state_to_torch, make_scans, room, rot_diff_deg, to_jax,
    to_torch,
)

N = 12
END = 0.0999  # synthetic scans are instantaneous at the sweep end


@pytest.fixture(scope="module")
def run():
    """(traj, scans (N, 8192), imu packets (N-1, 10)) of the circle."""
    world = synthetic.default_world(3)
    traj = synthetic.circle_trajectory(N, radius=25.0, laps=0.05)
    scans = make_scans(world, traj, N, seed=0, n_rings=16, n_azimuth=512)
    return traj, scans, synthetic.imu_for_trajectory(traj, frame_dt=0.1, n_sub=10)


def packet(imu, i, mod=tlio):
    g, a, d = imu
    if mod is jlio:
        return jlio.ImuSample(to_jax(g[i]), to_jax(a[i]), to_jax(d[i]))
    return tlio.ImuSample(g[i], a[i], d[i])


def start(traj, config):
    s = tlio.init(config, tse3.index(traj, 0))
    return s._replace(v=(traj.t[1] - traj.t[0]) / 0.1)


def spd(seed, n=24, cond=1e6):
    """An SPD matrix of condition ~cond, its rows and columns scaled over
    four decades (an IEKF information matrix's mix of blocks)."""
    rng = np.random.default_rng(seed)
    Q, _ = np.linalg.qr(rng.standard_normal((n, n)))
    A = (Q * np.logspace(0, np.log10(cond), n)) @ Q.T
    s = np.logspace(-2, 2, n)[rng.permutation(n)]
    return (A * s[:, None] * s[None, :]).astype(np.float32), rng.standard_normal(n).astype(np.float32)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_scaled_psd_inverse_and_solve(seed):
    A, b = spd(seed)
    A64, b64 = A.astype(np.float64), b.astype(np.float64)
    inv64, x64 = np.linalg.inv(A64), np.linalg.solve(A64, b64)

    def err(x, ref):
        return float(np.linalg.norm(np.asarray(x, np.float64) - ref) / np.linalg.norm(ref))

    for got, want, ref in (
        (tl3.inv_psd_scaled(torch.from_numpy(A)), jl3.inv_psd_scaled(to_jax(A)), inv64),
        (tl3.solve_psd_scaled(torch.from_numpy(A), torch.from_numpy(b)),
         jl3.solve_psd_scaled(to_jax(A), to_jax(b)), x64),
    ):
        assert err(got, ref) <= 2.0 * err(want, ref) + 1e-6, (err(got, ref), err(want, ref))
    # a batch solves as its members do
    Ab = torch.stack([torch.from_numpy(spd(s)[0]) for s in (seed, seed + 3)])
    xb = tl3.solve_psd_scaled(Ab, torch.ones(2, 24))
    torch.testing.assert_close(xb[1], tl3.solve_psd_scaled(Ab[1], torch.ones(24)), rtol=1e-6,
                               atol=0)


def test_init_and_imu_init():
    for kw in (dict(), dict(estimate_extrinsics=True, estimate_gravity=True)):
        got, want = tlio.init(tlio.LioConfig(table_size=1 << 10, **kw)), \
            jlio.init(jlio.LioConfig(table_size=1 << 10, **kw))
        for f in ("R", "p", "v", "P", "grav", "R_li", "t_li"):
            np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(want, f)))
    tilt = tso3.exp(torch.tensor([0.12, -0.08, 0.0]))
    state = tlio.init(tlio.LioConfig(table_size=1 << 10))._replace(R=tilt)
    rng = np.random.default_rng(0)
    f = tilt.T @ torch.tensor([0.0, 0.0, 9.81])
    imu = tlio.ImuSample(
        gyro=torch.tensor([0.004, -0.002, 0.003]) + torch.from_numpy(
            rng.normal(0, 1e-3, (50, 3)).astype(np.float32)),
        acc=f + torch.from_numpy(rng.normal(0, 1e-2, (50, 3)).astype(np.float32)),
        dt=torch.full((50,), 0.01),
    )
    got = tlio.imu_init(state, imu)
    want = jlio.imu_init(lio_state_to_jax(state), jlio.ImuSample(*(to_jax(x) for x in imu)))
    np.testing.assert_allclose(got.bg.numpy(), np.asarray(want.bg), atol=1e-6)
    np.testing.assert_allclose(got.grav.numpy(), np.asarray(want.grav), atol=1e-6)


@pytest.mark.parametrize("est", [False, True])
def test_propagate_one_packet(run, est):
    traj, _, imu = run
    cfg = tlio.LioConfig(table_size=1 << 10, estimate_extrinsics=est, estimate_gravity=est,
                         gravity_rw=1e-6 if est else 0.0)
    state = start(traj, cfg)._replace(bg=torch.tensor([1e-3, -2e-3, 5e-4]),
                                      ba=torch.tensor([0.01, 0.0, -0.02]))
    got, (Rs, ps) = tlio.propagate(state, packet(imu, 3), cfg)
    want, (jRs, jps) = jlio.propagate(lio_state_to_jax(state), packet(imu, 3, jlio),
                                      jlio.LioConfig(**cfg._asdict()))
    for f in ("R", "p", "v"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=1e-5)
    np.testing.assert_allclose(Rs.numpy(), np.asarray(jRs), atol=1e-5)
    np.testing.assert_allclose(ps.numpy(), np.asarray(jps), atol=1e-5)
    P, jP = got.P.numpy(), np.asarray(want.P)
    assert np.abs(P - jP).max() <= 1e-4 * np.abs(jP).max()
    assert np.trace(P[:6, :6]) > np.trace(state.P[:6, :6].numpy())  # uncertainty grows


def test_undistort(run):
    """Points stamped over the sweep against the propagated packet of
    the reference, with a 10 degree / 10 cm extrinsic; times beyond both
    ends of the packet clip to its first and last sample."""
    traj, scans, imu = run
    cfg = jlio.LioConfig(table_size=1 << 10)
    _, (jRs, jps) = jlio.propagate(lio_state_to_jax(start(traj, tlio.LioConfig(table_size=1 << 10))),
                                   packet(imu, 0, jlio), cfg)
    Rs, ps = to_torch(jRs), to_torch(jps)
    scan = tpcl.PointCloud(scans.xyz[1], scans.mask[1])
    t = torch.from_numpy(np.random.default_rng(0).uniform(-0.01, 0.11, scan.xyz.shape[0])
                         .astype(np.float32))
    imu_t = torch.cumsum(imu[2][0], 0) - imu[2][0]
    ext = tse3.Pose(tso3.exp(torch.tensor([0.17, 0.0, 0.09])), torch.tensor([0.1, -0.05, 0.1]))
    for R_li, t_li in ((None, None), (ext.R, ext.t)):
        got = tlio.undistort(scan, t, Rs, ps, Rs[-1], ps[-1], imu_t, R_li=R_li, t_li=t_li)
        want = jlio.undistort(cloud_to_jax(scan), to_jax(t), jRs, jps, jRs[-1], jps[-1],
                              to_jax(imu_t), R_li=None if R_li is None else to_jax(R_li),
                              t_li=None if t_li is None else to_jax(t_li))
        m = scan.mask.numpy()
        np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
        np.testing.assert_allclose(got.xyz.numpy()[m], np.asarray(want.xyz)[m], atol=1e-5)


@pytest.mark.parametrize("est", [False, True])
def test_update_from_a_shared_state(run, est):
    """A room's map (`torch_parity.room`) and a downsampled view of it
    from a lidar 0.2 m and 1.5 degrees off the propagated state, which
    the reference propagates through the circle's packet 1 from the
    origin; with `est`, extrinsic and gravity are estimated too."""
    _, _, imu = run
    cfg = tlio.LioConfig(table_size=1 << 14, estimate_extrinsics=est, estimate_gravity=est)
    jcfg = jlio.LioConfig(**cfg._asdict())
    planes, lines = room(0, 20000, 400)
    state = tlio.init(cfg)
    state = state._replace(grid=tvg.insert(state.grid, tpcl.make(torch.cat([planes, lines]))),
                           v=torch.tensor([1.0, 0.5, 0.0]), frame=1)
    jprop, _ = jlio.propagate(lio_state_to_jax(state), packet(imu, 1, jlio), jcfg)
    prop = lio_state_to_torch(jprop)
    true = tse3.compose(tse3.Pose(tso3.exp(torch.tensor([0.005, -0.01, 0.02])),
                                  torch.tensor([0.15, -0.1, 0.05])), prop.pose())
    planes, lines = room(1, 3000, 100)
    scan = tpcl.make(tse3.apply(tse3.inverse(true), torch.cat([planes, lines])))
    ds = tpcl.voxel_downsample(scan, 0.4, 4096, bounds=((-150.0,) * 3, (150.0,) * 3))
    got, inl = tlio.update(prop, ds, cfg)
    want, jinl = jlio.update(jprop, cloud_to_jax(ds), jcfg)
    assert float(torch.linalg.norm(got.p - to_torch(want.p))) <= 1e-4
    assert rot_diff_deg(got.R, want.R) <= 1e-3
    assert abs(int(inl) - int(jinl)) <= 0.005 * int(jinl) and int(inl) > 500  # gate-edge points
    for f in ("v", "bg", "ba", "t_li", "grav"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(want, f)), atol=1e-4)
    P, jP = got.P.numpy(), np.asarray(want.P)
    assert np.abs(P - jP).max() <= 1e-3 * np.abs(jP).max()
    assert np.trace(P[:6, :6]) < np.trace(prop.P[:6, :6].numpy())  # the update contracts P
    assert float(torch.linalg.norm(got.p - true.t)) < 0.02


def test_step_run_by_ate(run):
    """12 frames of `step` (the reference test's loop, frame i + 1 after
    packet i), ATE of the positions against the truth."""
    traj, scans, imu = run
    cfg = tlio.LioConfig(table_size=1 << 16)
    jcfg = jlio.LioConfig(table_size=1 << 16)
    state = start(traj, cfg)
    jstate = lio_state_to_jax(state)
    ps, jps = [traj.t[0]], [traj.t[0]]
    pt = torch.full((scans.xyz.shape[1],), END)
    for i in range(N - 1):
        scan = tpcl.PointCloud(scans.xyz[i + 1], scans.mask[i + 1])
        state, _ = tlio.step(state, scan, pt, packet(imu, i), cfg)
        jstate, _ = jlio.step(jstate, cloud_to_jax(scan), to_jax(pt), packet(imu, i, jlio), jcfg)
        ps.append(state.p)
        jps.append(to_torch(jstate.p))
    assert state.frame == int(jstate.frame) == N - 1
    eye = torch.eye(3).expand(N, 3, 3)
    a_port = float(tmet.ate(tse3.Pose(eye, torch.stack(ps)), traj).rmse)
    a_ref = float(tmet.ate(tse3.Pose(eye, torch.stack(jps)), traj).rmse)
    assert a_port <= 1.25 * a_ref + 0.05, (a_port, a_ref)
    assert float(torch.linalg.norm(state.p - traj.t[-1])) < 0.5
