"""RG-LRU recurrent block, Griffin / RecurrentGemma (arXiv:2402.19427;
the reference's ``models/rglru.py``):

    r_t = sigmoid(W_a x_t + b_a)                      (recurrence gate)
    i_t = sigmoid(W_x x_t + b_x)                      (input gate)
    a_t = exp(-c * softplus(Lambda) * r_t)            (log-space decay)
    h_t = a_t h_{t-1} + sqrt(1 - a_t^2) * (i_t * x_t)

Two branches of width ``lru_width``, (linear -> GeLU) and (linear ->
causal conv1d -> RG-LRU), merged multiplicatively and projected back to
d_model.  The full-sequence forward runs the linear recurrence
h_t = a_t h_{t-1} + b_t as a loop over the sequence (the reference uses
an associative scan: the same recurrence in another order of float
operations); decode is one step of it.  The branch projections are
quant-aware linears; the gates' recurrence stays float.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models import linear as LN
from repro_torch.models.ffn import gelu


def _width(cfg) -> int:
    return cfg.rglru.lru_width or cfg.d_model


def init_rglru_block(gen: torch.Generator, cfg) -> dict:
    d = cfg.d_model
    w = _width(cfg)
    r = cfg.rglru
    # Lambda so that a^c lies in [0.9, 0.999] at r = 1 (paper App. A)
    u = C.uniform(gen, (w,), 0.9 ** 2, 0.999 ** 2)
    lam = torch.log(torch.expm1(-torch.log(u) / (2 * r.c_exponent)))
    return {
        "w_gelu": LN.init_linear(gen, d, w),
        "w_rec_in": LN.init_linear(gen, d, w),
        "conv_w": C.randn(gen, (r.conv_width, w), 0.1),
        "conv_b": C.zeros(gen, (w,)),
        "wa": LN.init_linear(gen, w, w),
        "ba": C.zeros(gen, (w,)),
        "wx": LN.init_linear(gen, w, w),
        "bx": C.zeros(gen, (w,)),
        "lambda_p": lam,
        "w_out": LN.init_linear(gen, w, d),
    }


def _gates(params: dict, cfg, x: torch.Tensor,
           own: torch.Tensor | None = None):
    """x: (..., W) float32 -> (a, gated input b), both (..., W') float32,
    W' the width of ``params``' gate vectors.  ``own``: this position's
    columns of ``x`` (tensor parallelism: ``wa``/``wx`` read the whole
    width, the recurrence only its own); ``x`` itself by default."""
    r = cfg.rglru
    own = x if own is None else own
    ra = torch.sigmoid(
        LN.apply_linear(params["wa"], x, cfg.quant, dtype=torch.float32)
        + params["ba"])
    ix = torch.sigmoid(
        LN.apply_linear(params["wx"], x, cfg.quant, dtype=torch.float32)
        + params["bx"])
    log_a = -r.c_exponent * F.softplus(params["lambda_p"]) * ra
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (ix * own)
    return a, b


def linear_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t h_{t-1} + b_t along axis 1 from h_0 = 0: (B, S, W)."""
    hs = [b[:, 0]]
    for t in range(1, a.shape[1]):
        hs.append(a[:, t] * hs[-1] + b[:, t])
    return torch.stack(hs, dim=1)


def _branches(params: dict, cfg, x: torch.Tensor, conv_init=None):
    """(GeLU branch, conv output, conv state), float32 (B, S, W)."""
    gelu_branch = gelu(LN.apply_linear(params["w_gelu"], x, cfg.quant,
                                       dtype=torch.float32))
    rec = LN.apply_linear(params["w_rec_in"], x, cfg.quant,
                          dtype=torch.float32)
    rec, conv_state = C.causal_conv1d(rec, params["conv_w"],
                                      params["conv_b"], conv_init)
    return gelu_branch, rec, conv_state


def width_split(cfg, m: int) -> bool:
    """Whether the RG-LRU block splits over ``m`` model positions on
    whole units: ``m`` divides the width (the recurrence is
    elementwise)."""
    return _width(cfg) % m == 0


def parallel_traffic(cfg, tokens: int, dtype, m: int) -> list:
    """The traffic entries (``common.Parallel``) of one tensor-parallel
    block on ``tokens`` rows of ``dtype`` over ``m`` positions: the input
    fanned out, the float32 conv output gathered (W / m columns a
    position) and fanned out whole to ``wa``/``wx``, the partial outputs
    of ``w_out`` summed."""
    d, w = cfg.d_model, _width(cfg)
    return (C.fan_traffic(tokens * d, dtype)
            + [("gather", tokens * w // m, 4)]
            + C.fan_traffic(tokens * w, torch.float32)
            + LN.row_parallel_traffic(cfg.quant, tokens * d, d))


def _block_parallel(par, cfg, x: torch.Tensor) -> torch.Tensor:
    """The block over the positions of ``par`` (a ``common.Parallel``):
    ``w_gelu``, ``w_rec_in``, the conv and the recurrence's vectors split
    over the width; each position runs its columns of both branches and
    of the recurrence.  ``wa``/``wx`` (W x W) are split over their
    columns and read the whole conv output, which is split over the
    width: it is gathered over ``model`` (counted) and given to every
    position.  GSPMD makes the same choice: the weights' placement is
    fixed by the rules (W x W / m a position), and moving the
    (B, S, W) activation is the one way to meet the column split without
    moving W x W weights.  ``w_out`` is row-parallel."""
    dt = cfg.activation_dtype
    made = [_branches(t, cfg, xj)
            for t, xj in zip(par.trees, par.fan(x))]
    whole = par.fan(par.gather([rec for _, rec, _ in made]))
    ys = []
    for t, (gelu_branch, rec, _), wj in zip(par.trees, made, whole):
        a, b = _gates(t, cfg, wj, own=rec)
        ys.append((gelu_branch * linear_scan(a, b)).to(dt))
    return LN.apply_row_parallel(par, [t["w_out"] for t in par.trees], ys,
                                 cfg.quant, dtype=dt)


def rglru_block_forward(params, cfg, x: torch.Tensor, *,
                        init_cache: dict | None = None,
                        return_cache: bool = False):
    """x: (B, S, D) -> (B, S, D).  ``params`` may be a
    ``common.Parallel`` (:func:`width_split`), without a cache."""
    if isinstance(params, C.Parallel):
        if init_cache is not None or return_cache:
            raise ValueError("the tensor-parallel RG-LRU block is the train "
                             "step's; prefill and decode run whole")
        return _block_parallel(params, cfg, x)
    dt = cfg.activation_dtype
    conv_init = init_cache["conv"] if init_cache else None
    gelu_branch, rec, conv_state = _branches(params, cfg, x, conv_init)
    a, b = _gates(params, cfg, rec)                      # (B,S,W)
    if init_cache:
        # fold h0 into the first step: h_1 = a_1 h_0 + b_1
        b = b.clone()
        b[:, 0, :] = b[:, 0, :] + a[:, 0, :] * init_cache["h"]
    h = linear_scan(a, b)
    y = (gelu_branch * h).to(dt)
    out = LN.apply_linear(params["w_out"], y, cfg.quant, dtype=dt)
    if return_cache:
        return out, {"conv": conv_state, "h": h[:, -1, :]}
    return out


def init_rglru_cache(cfg, batch: int, device=None) -> dict:
    w = _width(cfg)
    return {"conv": torch.zeros((batch, cfg.rglru.conv_width - 1, w),
                                dtype=torch.float32, device=device),
            "h": torch.zeros((batch, w), dtype=torch.float32,
                             device=device)}


def rglru_block_decode(params: dict, cfg, x: torch.Tensor, cache: dict):
    """x: (B, 1, D), one step of the recurrence.  Returns (y, cache): the
    new state is written into ``cache`` in place."""
    dt = cfg.activation_dtype
    gelu_branch = gelu(LN.apply_linear(params["w_gelu"], x, cfg.quant,
                                       dtype=torch.float32))
    rec = LN.apply_linear(params["w_rec_in"], x, cfg.quant,
                          dtype=torch.float32)
    conv_in = torch.cat([cache["conv"], rec], dim=1)
    y_conv = (conv_in * params["conv_w"][None]).sum(dim=1, keepdim=True) \
        + params["conv_b"]
    a, b = _gates(params, cfg, y_conv)                   # (B,1,W)
    h = a[:, 0] * cache["h"] + b[:, 0]
    y = (gelu_branch[:, 0] * h).to(dt)[:, None, :]
    out = LN.apply_linear(params["w_out"], y, cfg.quant, dtype=dt)
    cache["conv"].copy_(conv_in[:, 1:, :])
    cache["h"].copy_(h)
    return out, cache
