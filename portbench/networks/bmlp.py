"""The binary MLP of a ``"network": "bmlp"`` configuration: its input
shape, its data from the seed, its work for the roofline, and the port's
packed forward over it (``repro_torch.models.cnn.make_packed_forward``)."""
from __future__ import annotations

import math

import torch

from portbench import draw, roofline


def input_shape(cfg: dict) -> tuple:
    return (cfg["sizes"][0],)


def n_outputs(cfg: dict) -> int:
    return cfg["sizes"][-1]


def make_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """Latent weights and batch norms in ``init_bmlp``'s layout."""
    sizes = cfg["sizes"]
    ws = draw.uniform_weights(gen, [(n, k) for k, n in
                                    zip(sizes[:-1], sizes[1:])], device)
    centres = [draw.first_layer_centre(ws[0])]
    spreads = [draw.first_layer_spread(sizes[0])]
    for k, n in zip(sizes[1:-1], sizes[2:]):
        centres.append(torch.zeros(n, dtype=torch.float64))
        spreads.append(math.sqrt(k))
    return {"layers": [{"w": w} for w in ws],
            "bns": draw.batch_norms(gen, centres, spreads, device)}


def work(cfg: dict) -> list:
    """The network's layers for ``roofline.least_time_s``."""
    sizes = cfg["sizes"]
    layers = [roofline.first_dense("dense0", sizes[0], sizes[1])]
    last = len(sizes) - 2
    for j in range(1, last + 1):
        layers.append(roofline.binary_dense(f"dense{j}", sizes[j],
                                            sizes[j + 1], logits=j == last))
    return layers


def build(cfg: dict, params: dict, device):
    """The port's packed forward: ``pack_bmlp`` then
    ``make_packed_forward`` on ``device``."""
    from repro_torch.models import cnn
    spec = cnn.BMLPSpec(sizes=tuple(cfg["sizes"]),
                        nbits_input=cfg["nbits_input"])
    packed = cnn.pack_bmlp(params, spec, device=device)
    return cnn.make_packed_forward(packed, dense_stack="auto")
