"""Feed-forward blocks: gated (SwiGLU/GeGLU) and plain (GELU/squared-ReLU)
(the reference's ``models/ffn.py``).  Every projection is a quant-aware
linear, so the paper's binary modes apply uniformly.  GELU is the tanh
approximation, as ``jax.nn.gelu``'s default."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def apply_ffn(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    dt = cfg.activation_dtype
    up = LN.apply_linear(params["w_up"], x, cfg.quant, dtype=dt)
    t = cfg.ffn_type
    if t in ("swiglu", "geglu"):
        gate = LN.apply_linear(params["w_gate"], x, cfg.quant, dtype=dt)
        act = F.silu if t == "swiglu" else gelu
        h = act(gate.to(torch.float32)).to(dt) * up
    else:
        h = _act(t, up.to(torch.float32)).to(dt)
    return LN.apply_linear(params["w_down"], h, cfg.quant, dtype=dt)
