"""Plain PyTorch reference of the BinaryNet CIFAR-10 CNN.

Every hidden layer is ``sign(BN(maxpool?(conv(h, sign(W)))))``, the
first on the raw pixels, the last dense layer ``BN(h @ sign(W).T)``;
sign(0) = +1, SAME zero padding, NHWC flattening before the dense
layers.  It reads only the configuration, the latent weights, the batch
norms and the input, all made by the benchmark.

``dtype=torch.float32`` is the reference: the products in float32 with
TF32 off, exact for these integers, and the batch norms in float64.
Any other ``dtype`` computes everything in it: the control.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

BN_EPS = 1e-5


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _batchnorm(bn: dict, z: torch.Tensor, dtype) -> torch.Tensor:
    """Per channel, on dim 1 (NCHW or (B, N))."""
    tail = (1,) * (z.dim() - 2)
    g, b, m, v = (bn[k].to(z.device, dtype).reshape(-1, *tail)
                  for k in ("gamma", "beta", "mean", "var"))
    return (z.to(dtype) - m) / torch.sqrt(v + BN_EPS) * g + b


def logits(cfg: dict, params: dict, x: torch.Tensor,
           dtype=torch.float32) -> torch.Tensor:
    """(B, H, W, C) uint8 -> (B, classes) logits, float64 for the
    reference, ``dtype`` for the control."""
    bn_dtype = torch.float64 if dtype == torch.float32 else dtype
    dev = x.device
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        h = x.to(dtype).permute(0, 3, 1, 2)
        pad = cfg["ksize"] // 2
        for conv, bn, st in zip(params["convs"], params["conv_bns"],
                                cfg["stages"]):
            w = _sign(conv["w"].to(dev, dtype)).permute(0, 3, 1, 2)
            z = F.conv2d(h, w, padding=pad)
            if st["pool"]:
                z = F.max_pool2d(z, 2)
            h = _sign(_batchnorm(bn, z, bn_dtype)).to(dtype)
        h = h.permute(0, 2, 3, 1).reshape(h.shape[0], -1)
        n = len(params["denses"])
        for i, (dense, bn) in enumerate(zip(params["denses"],
                                            params["dense_bns"])):
            z = _batchnorm(bn, h @ _sign(dense["w"].to(dev, dtype)).T,
                           bn_dtype)
            if i < n - 1:
                h = _sign(z).to(dtype)
        return z
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags


def output_step(params: dict) -> torch.Tensor:
    """One step of the output layer's integer pre-activation in logit
    units, |gamma| / sqrt(var + eps) per class, float64."""
    bn = params["dense_bns"][-1]
    return bn["gamma"].double().abs() / torch.sqrt(bn["var"].double()
                                                   + BN_EPS)
