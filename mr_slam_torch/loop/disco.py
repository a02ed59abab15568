"""DiSCO descriptors: rotation-invariant FFT-magnitude signatures (port of
`mr_slam_tpu/loop/disco.py`: `describe`, `distance`, `relative_yaw`).

A polar BEV (height-sliced occupancy over 40 rings x 120 sectors) is
collapsed over height, 2-D FFT'd, and the central crop of the fftshifted
magnitude is the 1024-d place signature: a rotation of the scene shifts
the sector axis circularly, which changes only the FFT's phase. The
complex64 spectrum is kept for the relative yaw (phase correlation of two
stored spectra, `calcRelOri`).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch


class DiscoParams(NamedTuple):
    n_rings: int = 40
    n_sectors: int = 120
    z_bins: int = 20
    sig_rows: int = 32   # central crop: sig_rows x sig_cols = 1024
    sig_cols: int = 32


class DiscoDescriptor(NamedTuple):
    signature: torch.Tensor  # (..., 1024) rotation-invariant
    spectrum: torch.Tensor   # (..., n_rings, n_sectors) complex64 — for yaw


def signature(img: torch.Tensor, params: DiscoParams = DiscoParams()):
    """(signature (..., sig_rows * sig_cols), spectrum) of height-collapsed
    images (..., n_rings, n_sectors): the normalized central crop of the
    fftshifted |FFT2|."""
    spec = torch.fft.fft2(img)
    mag = torch.fft.fftshift(torch.abs(spec), dim=(-2, -1))
    r0 = (params.n_rings - params.sig_rows) // 2
    c0 = (params.n_sectors - params.sig_cols) // 2
    sig = mag[..., r0:r0 + params.sig_rows, c0:c0 + params.sig_cols].reshape(
        *mag.shape[:-2], -1)
    sig = sig / torch.clamp(torch.sqrt(torch.sum(sig * sig, dim=-1, keepdim=True)), min=1e-9)
    return sig, spec


def describe(polar_bev: torch.Tensor, params: DiscoParams = DiscoParams()) -> DiscoDescriptor:
    """polar_bev: (..., z_bins, n_rings, n_sectors) occupancy."""
    sig, spec = signature(torch.sum(polar_bev, dim=-3), params)
    return DiscoDescriptor(signature=sig, spectrum=spec)


def distance(query_sig: torch.Tensor, db_sigs: torch.Tensor, db_mask: torch.Tensor):
    """L2 distances (..., D) of query signatures (..., F) against a
    database (D, F); invalid entries +inf."""
    diff = db_sigs - query_sig[..., None, :]
    d = torch.sqrt(torch.sum(diff * diff, dim=-1))
    return torch.where(db_mask, d, torch.inf)


def relative_yaw(query_spec: torch.Tensor, cand_spec: torch.Tensor):
    """Phase correlation between stored spectra (broadcasting (..., R, S))
    -> (yaw, confidence): ifft2 of the normalized cross-spectrum peaks at
    the circular sector shift; sector width 2 pi / n_sectors. The first
    maximal bin wins ties, as in the reference."""
    n_sectors = query_spec.shape[-1]
    cross = query_spec * torch.conj(cand_spec)
    cross = cross / torch.clamp(torch.abs(cross), min=1e-9)
    surface = torch.fft.ifft2(cross).real                          # (..., R, S)
    flat = surface.reshape(*surface.shape[:-2], -1)
    peak, idx = torch.max(flat, dim=-1)
    shift_s = idx % n_sectors
    shift = torch.where(shift_s >= n_sectors // 2, shift_s - n_sectors, shift_s)
    yaw = shift.to(torch.float32) * (2 * math.pi / n_sectors)
    return yaw, peak - torch.mean(flat, dim=-1)
