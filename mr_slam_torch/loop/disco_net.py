"""Learned DiSCO: the network and its quadruplet training (port of
`mr_slam_tpu/loop/disco_net.py`: `ConvBlock`, `UNet`, `Corr2Softmax`,
`DiscoNet`, `quadruplet_loss`, `TrainState`, `create_train_state`,
`train_step`).

A small UNet over the multi-height polar BEV fuses its height slices into
one map; the descriptor head is `disco.signature`'s FFT pipeline, so a
trained network drops into the same retrieval path as the passthrough
variant. The reference's layers are flax's, and its parameter trees load
here through `state_dict_from_flax`:

  * flax `Conv` kernels are HWIO, PyTorch's OIHW; "SAME" is padding 1;
  * `flax.linen.gelu` is the tanh approximation;
  * `nn.avg_pool((2, 2), (2, 2))` is `avg_pool2d(2)`;
  * `jax.image.resize(..., "bilinear")` to twice the size samples at
    half-pixel centres and renormalizes its triangle weights over the
    samples inside the image, so a border pixel takes its edge sample:
    `interpolate(mode="bilinear", align_corners=False)`, which clamps to
    the edge, gives the same values.

Inputs are (..., z_bins, R, S) (NCHW with optional batch). Training is
optax's `adam` as `torch.optim.Adam` with the same constants (betas 0.9 /
0.999, eps 1e-8 outside the square root); the lazy maxima of the loss are
`torch.amax`, which splits the gradient evenly among tied maxima as
`jnp.max` does. `create_train_state` draws flax's initializers from a
torch generator, so its draws differ from flax's: parity starts both
packages from one flax tree through `state_dict_from_flax`, which maps a
gradient tree of the same structure as well.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from . import disco


class ConvBlock(nn.Module):
    def __init__(self, cin: int, features: int):
        super().__init__()
        self.convs = nn.ModuleList([nn.Conv2d(cin, features, 3, padding=1),
                                    nn.Conv2d(features, features, 3, padding=1)])

    def forward(self, x):
        for conv in self.convs:
            x = F.gelu(conv(x), approximate="tanh")
        return x


class UNet(nn.Module):
    """Small UNet over the polar BEV (B, z_bins, R, S) -> one fused
    channel (B, R, S)."""

    def __init__(self, cin: int, base: int = 16):
        super().__init__()
        b = base
        # creation order = the reference's ConvBlock_0..4
        self.blocks = nn.ModuleList([
            ConvBlock(cin, b), ConvBlock(b, 2 * b), ConvBlock(2 * b, 4 * b),
            ConvBlock(6 * b, 2 * b), ConvBlock(3 * b, b),
        ])
        self.head = nn.Conv2d(b, 1, 1)

    def forward(self, x):
        e1 = self.blocks[0](x)
        e2 = self.blocks[1](F.avg_pool2d(e1, 2))
        b = self.blocks[2](F.avg_pool2d(e2, 2))
        u2 = F.interpolate(b, size=e2.shape[-2:], mode="bilinear", align_corners=False)
        u2 = self.blocks[3](torch.cat([u2, e2], dim=1))
        u1 = F.interpolate(u2, size=e1.shape[-2:], mode="bilinear", align_corners=False)
        u1 = self.blocks[4](torch.cat([u1, e1], dim=1))
        return self.head(u1)[:, 0]


class Corr2Softmax(nn.Module):
    """Learned affine temperature for phase-correlation logits
    (`DiSCO.py:337`): softmax(a * corr + b)."""

    def __init__(self):
        super().__init__()
        self.scale = nn.Parameter(torch.tensor(10.0))
        self.bias = nn.Parameter(torch.tensor(0.0))

    def forward(self, corr):
        return torch.softmax(self.scale * corr + self.bias, dim=-1)


class DiscoNet(nn.Module):
    def __init__(self, params_cfg: disco.DiscoParams = disco.DiscoParams(), base: int = 16):
        super().__init__()
        self.params_cfg = params_cfg
        self.unet = UNet(params_cfg.z_bins, base)

    def forward(self, polar_bev):
        """(..., z_bins, R, S) -> unit signatures (..., sig_rows *
        sig_cols)."""
        lead = polar_bev.shape[:-3]
        x = polar_bev.reshape(-1, *polar_bev.shape[-3:])
        feat = self.unet(x)
        sig, _ = disco.signature(feat, self.params_cfg)
        return sig.reshape(*lead, -1)


def quadruplet_loss(
    anchor: torch.Tensor,
    positive: torch.Tensor,
    negatives: torch.Tensor,   # (K, D)
    other_neg: torch.Tensor,
    margin1: float = 0.5,
    margin2: float = 0.2,
) -> torch.Tensor:
    """DiSCO's quadruplet loss with lazy (max over negatives) hinges:
    max relu(m1 + d(a, p) - d(a, n)) + max relu(m2 + d(a, p) - d(n*, n))."""
    d_pos = torch.sum((anchor - positive) ** 2)
    d_neg = torch.sum((anchor[None] - negatives) ** 2, dim=-1)
    d_on = torch.sum((other_neg[None] - negatives) ** 2, dim=-1)
    l1 = torch.amax(torch.relu(margin1 + d_pos - d_neg))
    l2 = torch.amax(torch.relu(margin2 + d_pos - d_on))
    return l1 + l2


class TrainState(NamedTuple):
    model: DiscoNet
    optimizer: torch.optim.Optimizer
    step: int


def _reset_parameters(model: nn.Module, generator: torch.Generator) -> None:
    """flax's `Conv` initializers, drawn from `generator`: lecun-normal
    kernels (a normal of variance 1 / fan_in truncated at two standard
    deviations, rescaled to that variance) and zero biases. PyTorch's
    default (kaiming-uniform weights, uniform biases) starts this UNet
    with a bias-dominated output whose signature barely depends on the
    input, and the quadruplet loss then has no gradient to follow."""
    with torch.no_grad():
        for m in model.modules():
            if isinstance(m, nn.Conv2d):
                std = (1.0 / m.weight[0].numel()) ** 0.5 / 0.87962566103423978
                nn.init.trunc_normal_(m.weight, 0.0, std, -2.0 * std, 2.0 * std,
                                      generator=generator)
                nn.init.zeros_(m.bias)


def create_train_state(
    generator: torch.Generator,
    model: DiscoNet,
    sample_bev: torch.Tensor,
    lr: float = 1e-3,
) -> TrainState:
    """A training state for `model` on the device of `sample_bev`: its
    parameters drawn from `generator` and optax-default Adam at `lr`.
    Loading a state dict into `model` afterwards (flax parameters
    through `state_dict_from_flax`) starts the same optimizer there."""
    _reset_parameters(model, generator)
    model.to(sample_bev.device)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    return TrainState(model, opt, 0)


def quadruplet_forward(model: DiscoNet, anchor_bev, positive_bev, negative_bevs,
                       other_neg_bev) -> torch.Tensor:
    """The quadruplet loss of one (anchor, positive, K negatives, other
    negative) sample, every BEV through the network in one batch."""
    sigs = model(torch.cat([anchor_bev[None], positive_bev[None], negative_bevs,
                            other_neg_bev[None]]))
    return quadruplet_loss(sigs[0], sigs[1], sigs[2:-1], sigs[-1])


def train_step(
    state: TrainState,
    anchor_bev: torch.Tensor,       # (z, R, S)
    positive_bev: torch.Tensor,
    negative_bevs: torch.Tensor,    # (K, z, R, S)
    other_neg_bev: torch.Tensor,
):
    """One Adam step on one quadruplet. Returns (state, loss before the
    step)."""
    state.optimizer.zero_grad(set_to_none=True)
    loss = quadruplet_forward(state.model, anchor_bev, positive_bev, negative_bevs,
                              other_neg_bev)
    loss.backward()
    state.optimizer.step()
    return state._replace(step=state.step + 1), loss.detach()


def _conv(p: dict) -> tuple:
    kernel = np.asarray(p["kernel"])                        # HWIO
    return (torch.from_numpy(np.array(kernel.transpose(3, 2, 0, 1))),  # a writable OIHW copy
            torch.from_numpy(np.array(p["bias"])))


def state_dict_from_flax(params: dict) -> dict:
    """The port's `DiscoNet.state_dict()` from the reference's flax
    parameter tree (`model.init(...)` output, leaves as numpy arrays);
    the outer {"params": ...} wrapper is optional. A gradient tree of
    the same structure maps the same way, to the layout of each
    parameter's `.grad`."""
    p = params.get("params", params)["UNet_0"]
    out = {}
    for i in range(5):
        for j in range(2):
            w, b = _conv(p[f"ConvBlock_{i}"][f"Conv_{j}"])
            out[f"unet.blocks.{i}.convs.{j}.weight"] = w
            out[f"unet.blocks.{i}.convs.{j}.bias"] = b
    out["unet.head.weight"], out["unet.head.bias"] = _conv(p["Conv_0"])
    return out


def corr2softmax_state_from_flax(params: dict) -> dict:
    """`Corr2Softmax.state_dict()` from its flax parameters."""
    p = params.get("params", params)
    return {"scale": torch.tensor(float(np.asarray(p["scale"]))),
            "bias": torch.tensor(float(np.asarray(p["bias"])))}
