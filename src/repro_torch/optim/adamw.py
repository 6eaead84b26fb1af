"""AdamW with float32 master weights and binary-latent clipping (paper
§4.4), the reference's ``optim/adamw.py``.

The paper trains binary networks by accumulating gradients into float
latent weights and clipping them to [-1, 1], so that they stay where
sign() is informative.  With ``clip_latent`` on, ``adamw_update`` clips
every leaf of the tree, as the reference's code does.

The update is written into the params, ``mu`` and ``nu`` in place, a
slice of each leaf at a time: the reference's step donates its state, and
an out-of-place update of a 3B-parameter model would hold two copies of
all three trees at once.  The returned trees are the ones passed in.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core import binarize as B
from repro_torch.tree import sorted_leaves, tree_map

# Elements of a leaf that one slice of the update works on: its float32
# temporaries stay at 256 MiB whatever the leaf's size.
SLICE = 1 << 26


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    clip_latent: bool = False      # binary mode: clip latents to [-1, 1]


def _device(tree) -> torch.device:
    return next(sorted_leaves(tree)).device


def adamw_init(params) -> dict:
    """Zero moments like ``params`` and a 0-d int32 step counter, on the
    params' device."""
    def zeros(tree):
        return tree_map(torch.zeros_like, tree)
    return {"mu": zeros(params), "nu": zeros(params),
            "step": torch.zeros((), dtype=torch.int32,
                                device=_device(params))}


def slices(*ts: torch.Tensor):
    """Matching flat slices of ``SLICE`` elements of same-shaped tensors
    (views: writes go to the tensors)."""
    flats = [t.view(-1) for t in ts]
    for i in range(0, flats[0].numel(), SLICE):
        yield tuple(f[i:i + SLICE] for f in flats)


def sum_sq(t: torch.Tensor) -> torch.Tensor:
    """The float32 sum of squares of ``t``, a ``SLICE`` at a time."""
    total = None
    for (s,) in slices(t):
        part = torch.sum(torch.square(s.to(torch.float32)))
        total = part if total is None else total + part
    return total


def global_norm(tree) -> torch.Tensor:
    """The float32 norm of every leaf together: each leaf's sum of squares,
    those sums added in the reference's leaf order
    (``tree.sorted_leaves``)."""
    total = None
    for leaf in sorted_leaves(tree):
        s = sum_sq(leaf)
        total = s if total is None else total + s
    return torch.sqrt(total)


def step_scalars(cfg: AdamWConfig, step: torch.Tensor, gn: torch.Tensor,
                 lr_scale=1.0) -> tuple:
    """(clip scale, 1 / (1 - b1^t), 1 / (1 - b2^t), lr) of the step whose
    counter already reads ``step`` and whose gradients' norm is ``gn``."""
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gn, min=1e-12),
                        max=1.0)
    t = step.to(torch.float32)
    return (scale, 1.0 / (1 - cfg.b1 ** t), 1.0 / (1 - cfg.b2 ** t),
            cfg.lr * lr_scale)


def update_leaf(cfg: AdamWConfig, p_full, g_full, m_full, v_full,
                scalars: tuple) -> None:
    """One leaf's AdamW update in place, a ``SLICE`` at a time, with the
    step's :func:`step_scalars`."""
    scale, mu_hat_s, nu_hat_s, lr = scalars
    b1, b2 = cfg.b1, cfg.b2
    for p, g, m, v in slices(p_full, g_full, m_full, v_full):
        g = g.to(torch.float32) * scale
        m.mul_(b1).add_((1 - b1) * g)
        v.mul_(b2).add_((1 - b2) * g * g)
        u = (m * mu_hat_s) / (torch.sqrt(v * nu_hat_s) + cfg.eps)
        p32 = p.to(torch.float32)
        newp = p32 - lr * (u + cfg.weight_decay * p32)
        if cfg.clip_latent:
            newp = B.clip_latent(newp)
        p.copy_(newp)


def adamw_update(cfg: AdamWConfig, params, grads, state, lr_scale=1.0):
    """One AdamW step, in place.  ``grads`` has the params' structure (any
    float dtype; float32 is used).  Returns (params, {"mu", "nu", "step"},
    the gradients' global norm before clipping)."""
    step = state["step"]
    step.add_(1)
    gn = global_norm(grads)
    scalars = step_scalars(cfg, step, gn, lr_scale)
    leaves = zip(*(list(sorted_leaves(tree))       # key order may differ
                   for tree in (params, grads, state["mu"], state["nu"])))
    for p_full, g_full, m_full, v_full in leaves:
        update_leaf(cfg, p_full, g_full, m_full, v_full, scalars)
    return params, {"mu": state["mu"], "nu": state["nu"], "step": step}, gn
