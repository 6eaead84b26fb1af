"""The binary CNN of a ``"network": "bcnn"`` configuration: its input
shape, its data from the seed, its work for the roofline, and the port's
packed forward over it (``repro_torch.models.cnn.make_packed_forward``)."""
from __future__ import annotations

import math

import torch

from portbench import draw, roofline


def input_shape(cfg: dict) -> tuple:
    return (*cfg["input_hw"], cfg["c_in"])


def n_outputs(cfg: dict) -> int:
    return cfg["dense"][-1]


def _stages(cfg: dict):
    """Per conv stage: input (H, W), C_in, C_out, output (H, W) after any
    pool, and whether it pools; then the flattened width."""
    (h, w), c = cfg["input_hw"], cfg["c_in"]
    out = []
    for st in cfg["stages"]:
        oh, ow = (h // 2, w // 2) if st["pool"] else (h, w)
        out.append(((h, w), c, st["c_out"], (oh, ow), st["pool"]))
        h, w, c = oh, ow, st["c_out"]
    return out, h * w * c


def make_params(cfg: dict, gen: torch.Generator, device) -> dict:
    """Latent weights and batch norms in ``init_bcnn``'s layout."""
    k = cfg["ksize"]
    stages, flat = _stages(cfg)
    dims = [flat, *cfg["dense"]]
    shapes = [(c_out, k, k, c_in) for _, c_in, c_out, _, _ in stages]
    shapes += [(n, kk) for kk, n in zip(dims[:-1], dims[1:])]
    ws = draw.uniform_weights(gen, shapes, device)
    centres, spreads = [], []
    for i, (_, c_in, c_out, _, pool) in enumerate(stages):
        taps = k * k * c_in
        if i == 0:
            centre = draw.first_layer_centre(ws[0])
            spread = draw.first_layer_spread(taps)
        else:
            centre, spread = torch.zeros(c_out, dtype=torch.float64), \
                math.sqrt(taps)
        if pool:
            centre, spread = draw.pooled(centre, spread)
        centres.append(centre)
        spreads.append(spread)
    for kk, n in zip(dims[:-1], dims[1:]):
        centres.append(torch.zeros(n, dtype=torch.float64))
        spreads.append(math.sqrt(kk))
    bns = draw.batch_norms(gen, centres, spreads, device)
    n_conv = len(stages)
    return {"convs": [{"w": w} for w in ws[:n_conv]],
            "conv_bns": bns[:n_conv],
            "denses": [{"w": w} for w in ws[n_conv:]],
            "dense_bns": bns[n_conv:]}


def work(cfg: dict) -> list:
    """The network's layers for ``roofline.least_time_s``."""
    k = cfg["ksize"]
    stages, flat = _stages(cfg)
    layers = []
    for i, (hw, c_in, c_out, out_hw, _) in enumerate(stages):
        make = roofline.first_conv if i == 0 else roofline.binary_conv
        layers.append(make(f"conv{i}", hw, c_in, c_out, k, out_hw))
    dims = [flat, *cfg["dense"]]
    last = len(dims) - 2
    for j, (kk, n) in enumerate(zip(dims[:-1], dims[1:])):
        layers.append(roofline.binary_dense(f"dense{j}", kk, n,
                                            logits=j == last))
    return layers


def build(cfg: dict, params: dict, device):
    """The port's packed forward: ``pack_bcnn`` then
    ``make_packed_forward`` on ``device``."""
    from repro_torch.models import cnn
    spec = cnn.BCNNSpec(
        input_hw=tuple(cfg["input_hw"]), c_in=cfg["c_in"],
        stages=tuple(cnn.ConvStage(s["c_out"], pool=s["pool"])
                     for s in cfg["stages"]),
        dense=tuple(cfg["dense"]), ksize=cfg["ksize"],
        nbits_input=cfg["nbits_input"])
    packed = cnn.pack_bcnn(params, spec, device=device)
    return cnn.make_packed_forward(packed, dense_stack="auto")
