"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain (GELU/squared-ReLU)
(the reference's ``models/ffn.py``).  Every projection is a quant-aware
linear, so the paper's binary modes apply uniformly.  GELU is the tanh
approximation, as ``jax.nn.gelu``'s default."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as C
from repro_torch.models import linear as LN


def gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def _act(name: str, x: torch.Tensor) -> torch.Tensor:
    if name == "gelu":
        return gelu(x)
    if name == "silu":
        return F.silu(x)
    if name == "relu2":                       # nemotron squared-ReLU
        r = F.relu(x)
        return r * r
    raise ValueError(name)


def is_gated(ffn_type: str) -> bool:
    return ffn_type in ("swiglu", "geglu")


def init_ffn(gen: torch.Generator, cfg, d_ff: int | None = None) -> dict:
    d = cfg.d_model
    f = d_ff if d_ff is not None else cfg.d_ff
    p = {"w_up": LN.init_linear(gen, d, f),
         "w_down": LN.init_linear(gen, f, d)}
    if is_gated(cfg.ffn_type):
        p["w_gate"] = LN.init_linear(gen, d, f)
    return p


def _hidden(params: dict, cfg, x: torch.Tensor,
            column: bool = False) -> torch.Tensor:
    """The activation before the down projection, in the activation
    dtype.  ``column``: a tensor-parallel position's float32 input copy
    (``linear.apply_linear``)."""
    dt = cfg.activation_dtype
    up = LN.apply_linear(params["w_up"], x, cfg.quant, dtype=dt,
                         column=column)
    t = cfg.ffn_type
    if t in ("swiglu", "geglu"):
        gate = LN.apply_linear(params["w_gate"], x, cfg.quant, dtype=dt,
                               column=column)
        act = F.silu if t == "swiglu" else gelu
        return act(gate.to(torch.float32)).to(dt) * up
    return _act(t, up.to(torch.float32)).to(dt)


def apply_ffn(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).  ``params`` may be a
    ``common.Parallel`` (tensor parallelism over ``model`` where it
    divides d_ff): :func:`ffn_parallel` on ``x`` at every position."""
    if isinstance(params, C.Parallel):
        return ffn_parallel(params, cfg, params.fan(x))
    return LN.apply_linear(params["w_down"], _hidden(params, cfg, x),
                           cfg.quant, dtype=cfg.activation_dtype)


def parallel_traffic(cfg, tokens: int, dtype) -> list:
    """The traffic entries (``common.Parallel``) of one tensor-parallel
    :func:`apply_ffn` on ``tokens`` rows of ``dtype``: the input fanned
    out, the partial outputs of ``w_down`` summed."""
    d = cfg.d_model
    return (C.fan_traffic(tokens * d, dtype)
            + LN.row_parallel_traffic(cfg.quant, tokens * d, d))


def ffn_parallel(par, cfg, xs: list) -> torch.Tensor:
    """The FFN over the positions of ``par``, ``xs[j]`` position j's
    input: ``w_up`` and ``w_gate`` column-parallel on the same columns,
    ``w_down`` row-parallel, its partial outputs summed."""
    hs = [_hidden(t, cfg, xj, column=True) for t, xj in zip(par.trees, xs)]
    return LN.apply_row_parallel(par, [t["w_down"] for t in par.trees], hs,
                                 cfg.quant, dtype=cfg.activation_dtype)
