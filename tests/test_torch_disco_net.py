"""DiscoNet's forward pass in the port against the reference's flax model
on carried-over parameters (`disco_net.state_dict_from_flax`), and the
layer conventions it rests on.

Tolerances: signatures within 1e-5 (float32 convolutions summed in
another order; the signature is unit-norm); the bilinear 2x upsamplings
within 1e-6; GELU and Corr2Softmax within 1e-6."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from mr_slam_torch.datasets import synthetic
from mr_slam_torch.loop import bev as tbev, disco as tdisco, disco_net as tnet
from mr_slam_torch.ops import pointcloud as tpcl
from mr_slam_tpu.loop import disco_net as jnet
from tests.torch_parity import make_scans, to_jax


@pytest.fixture(scope="module")
def bevs():
    """Polar BEVs (3, 20, 40, 120) of three 16x512 scans."""
    world = synthetic.default_world(5)
    traj = synthetic.circle_trajectory(3, radius=20.0, laps=0.2)
    sc = make_scans(world, traj, 3, seed=1)
    return tbev.polar_occupancy(tpcl.PointCloud(sc.xyz, sc.mask), 40, 120, z_bins=20)


@pytest.mark.parametrize("base", [4, 16])
def test_forward_matches_flax(bevs, base):
    model = jnet.DiscoNet(base=base)
    params = model.init(jax.random.PRNGKey(base), to_jax(bevs[0]))
    net = tnet.DiscoNet(base=base)
    net.load_state_dict(tnet.state_dict_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        sig = net(bevs)                                   # batched (3, 1024)
    assert sig.shape == (3, 1024)
    for b in range(3):
        want = np.asarray(model.apply(params, to_jax(bevs[b])))
        np.testing.assert_allclose(sig[b].numpy(), want, rtol=0, atol=1e-5)
        np.testing.assert_allclose(float(torch.linalg.norm(sig[b])), 1.0, atol=1e-5)
    with torch.no_grad():
        np.testing.assert_allclose(net(bevs[1]).numpy(), sig[1].numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", [(10, 30), (20, 60)])
def test_bilinear_upsampling_matches_jax_resize(shape):
    """2x bilinear upsampling, border rows and columns included."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal((1, *shape, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 2 * shape[0], 2 * shape[1], 3),
                                       "bilinear"))
    got = F.interpolate(torch.from_numpy(x).permute(0, 3, 1, 2), size=(2 * shape[0], 2 * shape[1]),
                        mode="bilinear", align_corners=False).permute(0, 2, 3, 1).numpy()
    for rows in (slice(0, 1), slice(-1, None), slice(None)):
        np.testing.assert_allclose(got[:, rows], want[:, rows], rtol=0, atol=1e-6)


def test_gelu_and_corr2softmax_match_flax():
    import flax.linen as nn

    x = np.linspace(-6, 6, 101, dtype=np.float32)
    np.testing.assert_allclose(F.gelu(torch.from_numpy(x), approximate="tanh").numpy(),
                               np.asarray(nn.gelu(jnp.asarray(x))), rtol=0, atol=1e-6)
    corr = np.random.default_rng(1).standard_normal((4, 120)).astype(np.float32) * 0.1
    layer = jnet.Corr2Softmax()
    params = layer.init(jax.random.PRNGKey(0), jnp.asarray(corr))
    port = tnet.Corr2Softmax()
    port.load_state_dict(tnet.corr2softmax_state_from_flax(jax.tree.map(np.asarray, params)))
    with torch.no_grad():
        np.testing.assert_allclose(port(torch.from_numpy(corr)).numpy(),
                                   np.asarray(layer.apply(params, jnp.asarray(corr))),
                                   rtol=0, atol=1e-6)


def test_signature_head_is_discos(bevs):
    """The network's head is the passthrough descriptor's FFT pipeline."""
    img = torch.sum(bevs, dim=-3)
    sig, spec = tdisco.signature(img)
    d = tdisco.describe(bevs)
    assert torch.equal(sig, d.signature) and torch.equal(spec, d.spectrum)
