"""Latent weights and batch norms drawn from the seed on the device.

Every draw is a few large calls on one ``torch.Generator`` of the device
the run uses; the small derivations after them run on the host in
float64 and hand back float32 CPU tensors, the type the program packs
from.  The batch norms follow the configuration files' ``assumed``
block: each layer's thresholds lie inside the spread of that layer's
pre-activations, gamma takes both signs, and every threshold is a
half-integer, so no integer pre-activation lies within rounding of one.
"""
from __future__ import annotations

import math

import torch

BN_EPS = 1e-5
# uint8 pixels uniform in 0..255: mean and standard deviation.
PIXEL_CENTRE = 127.5
PIXEL_SPREAD = math.sqrt((256 ** 2 - 1) / 12)
# The largest of four independent normal draws: mean and standard
# deviation in units of one draw's (a 2x2 max pool before the BN).
POOL_SHIFT = 1.0294
POOL_SCALE = 0.7012
NEGATIVE_GAMMA = 0.3


def uniform_weights(gen: torch.Generator, shapes: list, device) -> list:
    """Latent weights uniform in [-1, 1), one draw for all ``shapes``."""
    sizes = [math.prod(s) for s in shapes]
    flat = (torch.rand(sum(sizes), generator=gen, device=device) * 2 - 1).cpu()
    return [w.reshape(s) for w, s in zip(flat.split(sizes), shapes)]


def first_layer_centre(w: torch.Tensor) -> torch.Tensor:
    """Mean pre-activation of each output of a layer on raw pixels:
    ``w`` is (N, ...) latent weights, served as their signs."""
    signs = torch.where(w >= 0, 1.0, -1.0).reshape(w.shape[0], -1)
    return PIXEL_CENTRE * signs.sum(dim=1).double()


def first_layer_spread(k: int) -> float:
    return PIXEL_SPREAD * math.sqrt(k)


def pooled(centre: torch.Tensor, spread):
    """Centre and spread after a 2x2 max pool."""
    return centre + POOL_SHIFT * spread, spread * POOL_SCALE


def batch_norms(gen: torch.Generator, centres: list, spreads: list,
                device) -> list:
    """One inference batch norm per layer: ``centres[i]`` is a (C,) tensor,
    ``spreads[i]`` a (C,) tensor or a number, of layer ``i``'s
    pre-activations.  Returns dicts of float32 CPU tensors ``gamma``,
    ``beta``, ``mean``, ``var``."""
    sizes = [c.numel() for c in centres]
    total = sum(sizes)
    u = torch.rand(3, total, generator=gen, device=device,
                   dtype=torch.float64).cpu()
    n = torch.randn(2, total, generator=gen, device=device,
                    dtype=torch.float64).cpu()
    centre = torch.cat([c.double() for c in centres])
    spread = torch.cat([torch.as_tensor(s, dtype=torch.float64)
                        .expand(c.numel()) for c, s in zip(centres, spreads)])
    gamma = (0.5 + u[0]) * torch.where(u[1] < NEGATIVE_GAMMA, -1.0, 1.0)
    var = spread ** 2 * (0.5 + 1.5 * u[2])
    beta = n[0]
    tau = torch.floor(centre + 0.5 * spread * n[1]) + 0.5
    mean = tau + beta * torch.sqrt(var + BN_EPS) / gamma
    out = []
    for g, b, m, v in zip(*(t.float().split(sizes)
                            for t in (gamma, beta, mean, var))):
        out.append({"gamma": g, "beta": b, "mean": m, "var": v})
    return out
