"""DiscoNet training in the port against the reference's flax / optax
loop, both started from one flax parameter tree (`DiscoNet(base=4)`,
BEVs of 8 x 40 x 120, K = 4 negatives): the quadruplet loss within 1e-5
relative, one step's gradients leaf by leaf within 1e-4 of the leaf's
largest magnitude, and the losses of 5 Adam steps within 1e-3 relative;
the gradient of the FFT-magnitude signature; and (`slow`, as the
reference's `tests/test_disco_training.py`) trained recall@1 above the
passthrough descriptor's."""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.loop import bev as tbev, disco as tdisco, disco_net as tnet
from mr_slam_tpu.loop import disco_net as jnet
from chip_smoke import disco_recall
from tests.torch_parity import flax_to_state_dict

Z, K, LR = 8, 4, 3e-4


@pytest.fixture(scope="module")
def setup():
    """Shared flax parameters and a pool of 12 sparse random BEVs."""
    rng = np.random.default_rng(0)
    pool = (rng.random((12, Z, 40, 120)) < 0.08).astype(np.float32)
    model = jnet.DiscoNet(base=4)
    params = model.init(jax.random.PRNGKey(1), jnp.asarray(pool[0]))
    return model, params, pool


def port_net(params) -> tnet.DiscoNet:
    net = tnet.DiscoNet(tdisco.DiscoParams(z_bins=Z), base=4)
    net.load_state_dict(flax_to_state_dict(params))
    return net


def jax_loss(model, params, a, p, ns, on):
    f = lambda b: model.apply(params, b)
    return jnet.quadruplet_loss(f(a), f(p), jax.vmap(f)(ns), f(on))


def quadruplet(pool, step):
    """(anchor, positive, K negatives, other negative) of step `step`."""
    idx = np.roll(np.arange(12), -step)
    return pool[idx[0]], pool[idx[1]], pool[idx[2:2 + K]], pool[idx[2 + K]]


def test_loss_and_gradients_match_flax(setup):
    model, params, pool = setup
    q = quadruplet(pool, 0)
    jl, jg = jax.value_and_grad(lambda pr: jax_loss(model, pr, *map(jnp.asarray, q)))(params)
    net = port_net(params)
    loss = tnet.quadruplet_forward(net, *map(torch.from_numpy, q))
    loss.backward()
    assert float(jl) > 0.0
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=1e-5)
    want = flax_to_state_dict(jg)
    got = {name: p.grad for name, p in net.named_parameters()}
    assert set(got) == set(want)
    for name, g in want.items():
        scale = float(torch.abs(g).max())
        assert scale > 0.0, name
        err = float(torch.abs(got[name] - g).max())
        assert err <= 1e-4 * scale, (name, err, scale)


def test_quadruplet_loss_lazy_maxima_split_ties():
    """`amax` splits the gradient among tied maxima, as `jnp.max` does."""
    a = np.zeros(4, np.float32)
    p = np.array([0.1, 0, 0, 0], np.float32)
    negs = np.array([[0.3, 0, 0, 0], [0.3, 0, 0, 0], [0, 0.5, 0, 0]], np.float32)
    on = np.array([0, 0, 0.4, 0], np.float32)
    jg = jax.grad(jnet.quadruplet_loss, argnums=2)(*map(jnp.asarray, (a, p, negs, on)))
    tn = torch.from_numpy(negs).requires_grad_()
    tnet.quadruplet_loss(*map(torch.from_numpy, (a, p)), tn, torch.from_numpy(on)).backward()
    np.testing.assert_allclose(tn.grad.numpy(), np.asarray(jg), rtol=1e-6, atol=1e-7)


def test_five_adam_steps_match_optax(setup):
    model, params, pool = setup
    tx = optax.adam(LR)
    state = jnet.TrainState(params=params, opt_state=tx.init(params), step=jnp.int32(0))
    net = tnet.DiscoNet(tdisco.DiscoParams(z_bins=Z), base=4)
    tstate = tnet.create_train_state(torch.Generator().manual_seed(0), net,
                                     torch.from_numpy(pool[0]), lr=LR)
    net.load_state_dict(flax_to_state_dict(params))
    jl, tl = [], []
    for step in range(5):
        q = quadruplet(pool, step)
        state, loss = jnet.train_step(state, model, tx, *map(jnp.asarray, q))
        tstate, tloss = tnet.train_step(tstate, *map(torch.from_numpy, q))
        jl.append(float(loss))
        tl.append(float(tloss))
    assert tstate.step == 5
    np.testing.assert_allclose(tl, jl, rtol=1e-3)
    assert tl[-1] != tl[0]


def test_create_train_state_draws_from_its_generator():
    sample = torch.zeros(Z, 40, 120)
    a = tnet.create_train_state(torch.Generator().manual_seed(3), tnet.DiscoNet(
        tdisco.DiscoParams(z_bins=Z), base=4), sample)
    b = tnet.create_train_state(torch.Generator().manual_seed(3), tnet.DiscoNet(
        tdisco.DiscoParams(z_bins=Z), base=4), sample)
    for (n, x), (_, y) in zip(a.model.state_dict().items(), b.model.state_dict().items()):
        assert torch.equal(x, y), n
    assert isinstance(a.optimizer, torch.optim.Adam) and a.step == 0


def test_signature_gradient_matches_jax():
    """d/dimg of w . signature(img): fft2, |.|, fftshift, the central crop
    and the clamped norm, against JAX's autodiff of the same chain."""
    rng = np.random.default_rng(4)
    img = rng.random((2, 40, 120)).astype(np.float32)
    w = rng.standard_normal((2, 1024)).astype(np.float32)
    p = tdisco.DiscoParams()
    r0, c0 = (p.n_rings - p.sig_rows) // 2, (p.n_sectors - p.sig_cols) // 2

    def jsig(x):
        mag = jnp.fft.fftshift(jnp.abs(jnp.fft.fft2(x)), axes=(-2, -1))
        sig = mag[..., r0:r0 + p.sig_rows, c0:c0 + p.sig_cols].reshape(*x.shape[:-2], -1)
        return sig / jnp.maximum(jnp.linalg.norm(sig, axis=-1, keepdims=True), 1e-9)

    want = jax.grad(lambda x: jnp.sum(jnp.asarray(w) * jsig(x)))(jnp.asarray(img))
    x = torch.from_numpy(img).requires_grad_()
    sig, _ = tdisco.signature(x, p)
    np.testing.assert_allclose(sig.detach().numpy(), np.asarray(jsig(jnp.asarray(img))),
                               atol=1e-6)
    torch.sum(torch.from_numpy(w) * sig).backward()
    g = np.asarray(want)
    np.testing.assert_allclose(x.grad.numpy(), g, atol=1e-4 * np.abs(g).max(), rtol=0)


@pytest.mark.slow
def test_trained_beats_passthrough_recall():
    """The reference's protocol (`chip_smoke.disco_recall`, which the
    card's smoke run drives too): 30 frames of a two-lap circle at 16 x
    256 rays, 8-height BEVs, `base=4`, 8 epochs at lr 3e-4."""
    world = synthetic.default_world(9)
    n = 30
    traj = synthetic.circle_trajectory(n, radius=20.0, laps=2.0)
    clouds = synthetic.scan_batch(world, traj, n_rings=16, n_azimuth=256,
                                  rng=np.random.default_rng(0))
    bevs = tbev.polar_occupancy(clouds, 40, 120, z_bins=8)
    r1_pass, r1_learned = disco_recall(bevs, traj.t.numpy(), torch.Generator().manual_seed(1))
    assert r1_learned > r1_pass, (r1_learned, r1_pass)
