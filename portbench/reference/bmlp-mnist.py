"""Plain PyTorch reference of the BinaryNet MNIST MLP.

Every hidden layer is ``sign(BN(h @ sign(W).T))``, the first on the raw
uint8 pixels, the last ``BN(h @ sign(W).T)``; sign(0) = +1.  It reads
only the configuration, the latent weights, the batch norms and the
input, all made by the benchmark.

``dtype=torch.float32`` is the reference: the products in float32 with
TF32 off, exact for these integers, and the batch norms in float64.
Any other ``dtype`` computes everything in it: the control.
"""
from __future__ import annotations

import torch

BN_EPS = 1e-5


def _sign(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x >= 0, 1.0, -1.0).to(x.dtype)


def _batchnorm(bn: dict, z: torch.Tensor, dtype) -> torch.Tensor:
    g, b, m, v = (bn[k].to(z.device, dtype)
                  for k in ("gamma", "beta", "mean", "var"))
    return (z.to(dtype) - m) / torch.sqrt(v + BN_EPS) * g + b


def logits(cfg: dict, params: dict, x: torch.Tensor,
           dtype=torch.float32) -> torch.Tensor:
    """(B, K) uint8 -> (B, classes) logits, float64 for the reference,
    ``dtype`` for the control."""
    bn_dtype = torch.float64 if dtype == torch.float32 else dtype
    dev = x.device
    flag = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        h = x.to(dtype)
        n = len(params["layers"])
        for i, (layer, bn) in enumerate(zip(params["layers"],
                                            params["bns"])):
            z = _batchnorm(bn, h @ _sign(layer["w"].to(dev, dtype)).T,
                           bn_dtype)
            if i < n - 1:
                h = _sign(z).to(dtype)
        return z
    finally:
        torch.backends.cuda.matmul.allow_tf32 = flag


def output_step(params: dict) -> torch.Tensor:
    """One step of the output layer's integer pre-activation in logit
    units, |gamma| / sqrt(var + eps) per class, float64."""
    bn = params["bns"][-1]
    return bn["gamma"].double().abs() / torch.sqrt(bn["var"].double()
                                                   + BN_EPS)
