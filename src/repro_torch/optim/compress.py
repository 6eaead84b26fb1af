"""1-bit gradient compression with error feedback (signSGD-EF), the
reference's ``optim/compress.py``.

Before the data-parallel all-reduce each worker would send sign(g + e),
one bit per element plus one float scale a tensor, and keep the
quantization error e for the next step (Seide et al. 2014; Karimireddy et
al. 2019).  This is the gradient transform whose numerics match that
compressed communication.  It writes in place: the compressed gradient
into ``grads``, the new error into ``error``.
"""
from __future__ import annotations

import torch

from repro_torch.optim.adamw import slices
from repro_torch.tree import sorted_leaves, tree_map


def signsgd_ef_init(params):
    """A float32 zero error buffer like ``params``."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)


def signsgd_ef_compress(grads, error):
    """Returns (compressed grads, new error), the trees passed in.

    compressed = scale * sign(g + e), scale = mean(|g + e|) per tensor;
    e' = (g + e) - compressed, with the compressed value before its cast
    to the gradient's dtype.
    """
    for g, e in zip(sorted_leaves(grads), sorted_leaves(error)):
        total = None
        for gs, es in slices(g, e):
            es.add_(gs.to(torch.float32))                 # g + e
            part = torch.sum(torch.abs(es))
            total = part if total is None else total + part
        scale = total / e.numel()
        for gs, es in slices(g, e):
            comp = torch.sign(es) * scale
            gs.copy_(comp)
            es.sub_(comp)
    return grads, error
