"""Inputs and weights, made from the run's seed on the run's device.

The spectra and images follow the distributions of the project's
synthetic generators (``make_dummy_spectra``: continuum, twelve Gaussian
lines whose depths follow ``log_g`` and ``M_H``, noise; ``make_dummy_images``:
a class colour and a class-placed bright square over uniform noise, scaled
and normalised with CIFAR-10's channel statistics), drawn in a few large
calls from a ``torch.Generator`` on the device. The same seed and device
give the same arrays.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from benchlib.dims import Dims, param_shapes

CIFAR_MEAN = (0.4914, 0.4822, 0.4465)
CIFAR_STD = (0.2470, 0.2435, 0.2616)
WEIGHT_STD = 0.02


def generator(seed: int, device, stream: int) -> torch.Generator:
    """A generator for one of a run's streams (weights, train data, ...)."""
    return torch.Generator(device=device).manual_seed(seed * 16 + stream)


def spectra(n: int, length: int, g: torch.Generator, device) -> Dict[str, np.ndarray]:
    """``{wave, flux, error, params}`` as the data module's in-memory source."""
    def u(lo, hi, *shape):
        return torch.rand(*shape, generator=g, device=device, dtype=torch.float64) * (hi - lo) + lo

    wave = torch.linspace(3800.0, 9000.0, length, device=device, dtype=torch.float64)
    params = {k: u(lo, hi, n) for k, lo, hi in (
        ("T_eff", 3500.0, 9000.0), ("log_g", 0.0, 5.0), ("M_H", -2.5, 0.5),
        ("a_M", -0.25, 0.5), ("C_M", -0.5, 0.5), ("redshift", 0.0, 1e-4), ("mag", 16.0, 22.0))}
    x = (wave - wave[0]) / (wave[-1] - wave[0])
    flux = 1.0 + 0.3 * (((params["T_eff"] - 3500.0) / 5500.0)[:, None] - 0.5) * (x - 0.5)
    n_lines = 12
    centers = u(wave[0].item() + 100, wave[-1].item() - 100, n_lines)
    widths = u(2.0, 15.0, n_lines)
    strength = u(0.1, 0.6, n_lines)
    scale = 0.35 + 0.45 * params["log_g"] / 5.0 + 0.20 * (params["M_H"] + 2.5) / 3.0
    profile = torch.exp(-0.5 * ((wave[None, :] - centers[:, None]) / widths[:, None]) ** 2)
    flux = flux - (scale[:, None] * strength[None, :]) @ profile
    floor = 0.01
    error = floor + floor * torch.rand(n, length, generator=g, device=device)
    flux = (flux.float() + torch.randn(n, length, generator=g, device=device) * floor).clamp_min(0)
    snr = flux.norm(dim=-1) / error.norm(dim=-1)
    params["snr"] = snr.double()
    return {"wave": wave.float().cpu().numpy(), "flux": flux.cpu().numpy(),
            "error": error.cpu().numpy(),
            "params": {k: v.cpu().numpy() for k, v in params.items()}}


def images(n: int, side: int, classes: int, g: torch.Generator, device):
    """(NHWC float32 images, int32 labels) as the image data module holds them."""
    labels = torch.randint(0, classes, (n,), generator=g, device=device)
    img = torch.randint(0, 64, (n, side, side, 3), generator=g, device=device,
                        dtype=torch.int16)
    ch = torch.nn.functional.one_hot(labels % 3, 3).to(torch.int16)
    img += (ch * (64 + 8 * (labels // 3)).to(torch.int16)[:, None])[:, None, None, :]
    pos = (labels * side // classes) % max(1, side - 8)
    r = torch.arange(side, device=device)
    inside = (r[None, :] >= pos[:, None]) & (r[None, :] < pos[:, None] + 8)
    img += (96 * (inside[:, :, None] & inside[:, None, :]).to(torch.int16))[..., None]
    x = img.clamp(0, 255).float() / 255.0
    mean = torch.tensor(CIFAR_MEAN, device=device)
    std = torch.tensor(CIFAR_STD, device=device)
    x = (x - mean) / std
    return x.cpu().numpy(), labels.to(torch.int32).cpu().numpy()


def weights(d: Dims, g: torch.Generator, device) -> Dict[str, torch.Tensor]:
    """Every parameter, fp32 (what the program holds; it computes in the
    configuration's precision), from one normal draw: N(0, 0.02) for
    matrices, embeddings and biases; LayerNorm scales 1 and shifts 0."""
    shapes = param_shapes(d)
    sizes = [int(np.prod(s)) for _, s in shapes]
    flat = torch.randn(sum(sizes), generator=g, device=device) * WEIGHT_STD
    out = {}
    for (name, shape), part in zip(shapes, flat.split(sizes)):
        if ".layernorm" in name or name.startswith("vit.layernorm"):
            part = torch.ones_like(part) if name.endswith("weight") else torch.zeros_like(part)
        out[name] = part.view(shape)
    return out
