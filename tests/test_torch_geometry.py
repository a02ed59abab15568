"""so3 / se3 / linalg3 of the port against the reference, same numpy
inputs. Tolerance 1e-5, relative to max(1, |reference|): these are the
same closed forms evaluated in f32 by both packages, so only libm and
summation order differ (a few ulp). The eigen-decomposition gets 5e-5:
its arccos amplifies an ulp of its argument near +-1."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mr_slam_torch.geometry import se3 as tse3, so3 as tso3
from mr_slam_torch.ops import linalg3 as tl
from mr_slam_tpu.geometry import se3 as jse3, so3 as jso3
from mr_slam_tpu.ops import linalg3 as jl
from tests.torch_parity import pose_to_jax, to_jax

TOL = 1e-5
RNG = np.random.default_rng(0)
# rotation vectors: generic, tiny (Taylor branches), near pi
W = np.concatenate([
    RNG.normal(0, 1.0, (64, 3)),
    RNG.normal(0, 1e-5, (8, 3)),
    (np.pi - 1e-3) * np.eye(3),
]).astype(np.float32)
XI = np.concatenate([RNG.normal(0, 2.0, (W.shape[0], 3)), W], axis=1).astype(np.float32)


def close(a, b, tol=TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err = np.max(np.abs(a - b) / np.maximum(1.0, np.abs(b)))
    assert err <= tol, err


def tposes():
    return tse3.exp(torch.from_numpy(XI))


def jposes():
    return jse3.exp(jnp.asarray(XI))


class TestSO3:
    def test_hat_vee(self):
        close(tso3.hat(torch.from_numpy(W)), jso3.hat(jnp.asarray(W)))
        close(tso3.vee(tso3.hat(torch.from_numpy(W))), W)

    def test_exp(self):
        close(tso3.exp(torch.from_numpy(W)), jso3.exp(jnp.asarray(W)))

    def test_log(self):
        R = jso3.exp(jnp.asarray(W[:-3]))  # near-pi axis signs are arbitrary
        close(tso3.log(torch.from_numpy(np.array(R))), jso3.log(R))

    def test_log_near_pi_is_a_valid_axis(self):
        R = np.array(jso3.exp(jnp.asarray(W[-3:])))
        wt = tso3.log(torch.from_numpy(R))
        # near pi the axis comes from sqrt((R_kk + 1) / 2), which keeps
        # only about half of the f32 digits
        close(tso3.exp(wt), R, 1e-3)

    def test_project(self):
        M = RNG.normal(0, 1, (32, 3, 3)).astype(np.float32)
        close(tso3.project(torch.from_numpy(M)), jso3.project(jnp.asarray(M)))

    def test_yaw_rot(self):
        yaw = RNG.uniform(-4, 4, 50).astype(np.float32)
        close(tse3.yaw_rot(torch.from_numpy(yaw)), jso3.yaw_rot(jnp.asarray(yaw)))


class TestSE3:
    def test_exp(self):
        t, j = tposes(), jposes()
        close(t.R, j.R)
        close(t.t, j.t)  # |t| up to ~10

    def test_log(self):
        j = jse3.exp(jnp.asarray(XI[:-3]))
        t = tse3.Pose(torch.from_numpy(np.array(j.R)), torch.from_numpy(np.array(j.t)))
        close(tse3.log(t), jse3.log(j))

    def test_compose_inverse_between_apply(self):
        t, j = tposes(), jposes()
        t2 = tse3.Pose(t.R.flip(0), t.t.flip(0))
        j2 = pose_to_jax(t2)
        jt = pose_to_jax(t)
        for a, b in ((tse3.compose(t, t2), jse3.compose(jt, j2)),
                     (tse3.between(t, t2), jse3.between(jt, j2)),
                     (tse3.inverse(t), jse3.inverse(jt))):
            close(a.R, b.R)
            close(a.t, b.t)
        pts = RNG.normal(0, 5, (t.t.shape[0], 20, 3)).astype(np.float32)
        close(tse3.apply(t, torch.from_numpy(pts)), jse3.apply(jt, jnp.asarray(pts)))

    def test_normalize_stack_index_identity(self):
        t = tposes()
        noisy = tse3.Pose(t.R + 1e-3, t.t)
        close(tse3.normalize(noisy).R, jse3.normalize(pose_to_jax(noisy)).R)
        s = tse3.stack([tse3.index(t, 0), tse3.index(t, 1)])
        close(s.t, t.t[:2])
        close(tse3.identity((2,)).R, jse3.identity((2,)).R)


def spd(n, seed):
    r = np.random.default_rng(seed)
    A = r.normal(0, 1, (n, 3, 3))
    return (A @ np.swapaxes(A, -1, -2) + 0.1 * np.eye(3)).astype(np.float32)


class TestLinalg3:
    def test_det_inv(self):
        A = spd(64, 1)
        close(tl.det3(torch.from_numpy(A)), jl.det3(jnp.asarray(A)))
        close(tl.inv3(torch.from_numpy(A)), jl.inv3(jnp.asarray(A)))
        close(tl.inv3(torch.from_numpy(A)) @ torch.from_numpy(A), np.broadcast_to(np.eye(3), A.shape))

    def test_eigh3_matches_reference(self):
        A = spd(256, 2)
        wt, Vt = tl.eigh3(torch.from_numpy(A))
        wj, Vj = jl.eigh3(jnp.asarray(A))
        close(wt, wj, 5e-5)
        # same closed form: same eigenvector signs, not just the same span
        close(Vt, Vj, 5e-5)

    def test_eigh3_degenerate_same_basis(self):
        A = np.stack([np.eye(3), np.diag([1.0, 1.0, 2.0]), np.zeros((3, 3))]).astype(np.float32)
        wt, Vt = tl.eigh3(torch.from_numpy(A))
        wj, Vj = jl.eigh3(jnp.asarray(A))
        close(wt, wj)
        close(Vt, Vj)

    @pytest.mark.parametrize("batch", [(), (7,)])
    def test_solve_psd(self, batch):
        A = spd(int(np.prod(batch)) or 1, 3)
        H = np.zeros((A.shape[0], 6, 6), np.float32)
        H[:, :3, :3] = A
        H[:, 3:, 3:] = A + np.eye(3, dtype=np.float32)
        H = H.reshape(*batch, 6, 6)
        b = RNG.normal(0, 1, (*batch, 6)).astype(np.float32)
        xt = tl.solve_psd(torch.from_numpy(H), torch.from_numpy(b))
        xj = jl.solve_psd(jnp.asarray(H), jnp.asarray(b))
        close(xt, xj)
        close(torch.einsum("...ij,...j->...i", torch.from_numpy(H), xt), b)
