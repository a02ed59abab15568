"""Learned DiSCO, forward pass (port of `mr_slam_tpu/loop/disco_net.py`:
`ConvBlock`, `UNet`, `Corr2Softmax`, `DiscoNet`).

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

Inputs are (..., z_bins, R, S) (NCHW with optional batch). Training (the
quadruplet loss and its optimizer) is not ported.
"""
from __future__ import annotations

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


def _conv(p: dict) -> tuple:
    kernel = np.asarray(p["kernel"])                        # HWIO
    return (torch.from_numpy(np.array(kernel.transpose(3, 2, 0, 1))),  # a writable OIHW copy
            torch.from_numpy(np.array(p["bias"])))


def state_dict_from_flax(params: dict) -> dict:
    """The port's `DiscoNet.state_dict()` from the reference's flax
    parameter tree (`model.init(...)` output, leaves as numpy arrays);
    the outer {"params": ...} wrapper is optional."""
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
