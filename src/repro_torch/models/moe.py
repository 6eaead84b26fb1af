"""Mixture-of-Experts FFN with capacity-based gather/scatter dispatch (the
reference's ``models/moe.py``).

Tokens are grouped per sequence (G = B groups of Tg = S tokens) and each
group dispatches into per-expert slot buffers of capacity
C = ceil-to-4(Tg * top_k / E * capacity_factor), at least 4.  The slot of
a (token, choice) is its running count in its expert (a cumsum over the
(T*K, E) one-hot); choices past capacity are dropped (GShard/Switch):

    slot_token[e, c] -> token index (or -1)     scatter
    x_disp[e, c, :]  =  x[slot_token]           gather
    y[t, :]         +=  w_slot * expert_e(x_disp)[e, c]   scatter-add

Top-k breaks ties toward the lower expert index, as ``jax.lax.top_k``
does: the probabilities are sorted with a stable descending sort.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.core import binarize as B
from repro_torch.core.quantize import QuantMode
from repro_torch.models import common as C
from repro_torch.models import ffn as FF
from repro_torch.models import linear as LN
from repro_torch.models.common import randn


def _expert_w(p: dict, cfg) -> torch.Tensor:
    """Expert weight under the quant policy: FLOAT -> raw; BINARY* ->
    sign(W) times a per-(expert, output-channel) alpha, with the STE.  The
    expert weights stay unpacked (``maybe_pack_tree`` packs only
    ``{"w"}`` linears), as in the reference."""
    w = p["we"]
    if cfg.quant.mode == QuantMode.FLOAT:
        return w
    return B.binarize_ste(w) * LN.latent_alpha(w, -2, keepdim=True)


def init_moe(gen: torch.Generator, cfg) -> dict:
    m = cfg.moe
    d, f, e = cfg.d_model, m.d_ff_expert, m.num_experts
    p = {
        "router": LN.init_linear(gen, d, e),
        "we_up": {"we": randn(gen, (e, d, f), d ** -0.5)},
        "we_down": {"we": randn(gen, (e, f, d), f ** -0.5)},
    }
    if FF.is_gated(cfg.ffn_type):
        p["we_gate"] = {"we": randn(gen, (e, d, f), d ** -0.5)}
    if m.shared_experts:
        p["shared"] = FF.init_ffn(gen, cfg,
                                  d_ff=m.d_ff_expert * m.shared_experts)
    return p


def _capacity(tg: int, m) -> int:
    c = int(tg * m.top_k / m.num_experts * m.capacity_factor)
    return max(4, -(-c // 4) * 4)


def _dispatch_indices(sel: torch.Tensor, e: int, c: int):
    """sel: (T, K) expert ids.  Returns (slot_token (E, C) [-1 pad],
    slot_flatidx (E, C), the index into the T*K flat choices, -1 pad)."""
    t, k = sel.shape
    flat = sel.reshape(t * k).to(torch.int64)
    onehot = F.one_hot(flat, e).to(torch.int32)               # (T*K, E)
    pos = torch.cumsum(onehot, dim=0) * onehot - 1            # pos in expert
    pos = pos.amax(dim=1).to(torch.int64)                     # (T*K,)
    keep = pos < c
    dest = torch.where(keep, flat * c + pos, e * c)           # overflow slot
    slot_flatidx = torch.full((e * c + 1,), -1, dtype=torch.int32,
                              device=sel.device)
    slot_flatidx[dest] = torch.arange(t * k, dtype=torch.int32,
                                      device=sel.device)
    slot_flatidx = slot_flatidx[:-1].reshape(e, c)
    slot_token = torch.where(slot_flatidx >= 0,
                             torch.div(slot_flatidx, k,
                                       rounding_mode="floor"), -1)
    return slot_token, slot_flatidx


def top_k(probs: torch.Tensor, k: int):
    """The k largest along the last axis, ties to the lower index."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _gate_act(cfg):
    return F.silu if cfg.ffn_type == "swiglu" else FF.gelu


def _experts(params: dict, cfg, xg: torch.Tensor, top_w: torch.Tensor,
             slots: list, rows: slice) -> torch.Tensor:
    """The experts of ``params`` (every expert of the layer, or one
    position's, ``rows`` of the layer's slot tables) on their slots: the
    (G, Tg, D) float32 sum of their weighted outputs.  ``slots``: per
    group (slot_token, slot_flatidx) over the layer's E experts."""
    dt = cfg.activation_dtype
    tg, d = xg.shape[1:]
    w_up = _expert_w(params["we_up"], cfg).to(dt)
    w_gate = (_expert_w(params["we_gate"], cfg).to(dt)
              if "we_gate" in params else None)
    w_down = _expert_w(params["we_down"], cfg).to(dt)
    ys = []
    for gi, (slot_token, slot_flatidx) in enumerate(slots):
        slot_token, slot_flatidx = slot_token[rows], slot_flatidx[rows]
        tok = torch.clamp(slot_token, min=0).to(torch.int64)
        x_disp = xg[gi][tok] * (slot_token >= 0)[..., None]   # (E, C, D)
        # x_disp's gradient at its own precision: float32 partials at a
        # tensor-parallel position (its float32 copy of x)
        up = LN.share_product(x_disp, w_up, dt)               # (E, C, F)
        if w_gate is not None:
            gate = LN.share_product(x_disp, w_gate, dt)
            h = _gate_act(cfg)(gate.to(torch.float32)).to(dt) * up
        else:
            h = FF.gelu(up.to(torch.float32)).to(dt)
        y_disp = torch.matmul(h, w_down)                      # (E, C, D)
        w_flat = top_w[gi].reshape(-1)
        w_slot = torch.where(
            slot_flatidx >= 0,
            w_flat[torch.clamp(slot_flatidx, min=0).to(torch.int64)],
            torch.zeros((), dtype=w_flat.dtype, device=w_flat.device))
        y = torch.zeros((tg, d), dtype=torch.float32, device=xg.device)
        y.index_add_(0, tok.reshape(-1),
                     (y_disp.to(torch.float32) * w_slot[..., None])
                     .reshape(-1, d))
        ys.append(y)
    return torch.stack(ys)


def experts_split(cfg, m: int) -> bool:
    """Whether the MoE layer splits over ``m`` model positions on whole
    units: ``m`` divides the experts (and the shared experts' width)."""
    moe = cfg.moe
    return moe.num_experts % m == 0 and (
        not moe.shared_experts
        or moe.d_ff_expert * moe.shared_experts % m == 0)


def parallel_traffic(cfg, tokens: int, dtype) -> list:
    """The traffic entries (``common.Parallel``) of one expert-parallel
    :func:`apply_moe` on ``tokens`` rows of ``dtype``: the input and the
    float32 routing weights fanned out, the float32 expert outputs summed,
    and the shared experts' ``w_down`` partial outputs summed."""
    d = cfg.d_model
    out = (C.fan_traffic(tokens * d, dtype)
           + C.fan_traffic(tokens * cfg.moe.top_k, torch.float32)
           + [("reduce", tokens * d, 4)])
    if cfg.moe.shared_experts:
        out += LN.row_parallel_traffic(cfg.quant, tokens * d, d)
    return out


def apply_moe(params, cfg, x: torch.Tensor) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D).

    ``params`` may be a ``common.Parallel`` (expert parallelism over
    ``model``, :func:`experts_split`): the router runs once, replicated;
    top-k and the dispatch use the global expert ids and the capacity the
    global E (a per-position E would change C, and so which choices are
    dropped); position j runs the slots of its E / m experts, and the
    positions' float32 outputs are summed.  Shared experts run as the
    tensor-parallel FFN on the same positions."""
    m = cfg.moe
    dt = cfg.activation_dtype
    b, s, d = x.shape
    g, tg = b, s
    xg = x.reshape(g, tg, d)
    par = params if isinstance(params, C.Parallel) else None
    whole = par.trees[0] if par is not None else params

    logits = LN.apply_linear(whole["router"], xg, cfg.quant,
                             dtype=torch.float32)             # (G, Tg, E)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, m.top_k)                      # (G, Tg, K)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    c = _capacity(tg, m)
    slots = [_dispatch_indices(top_e[gi], m.num_experts, c)
             for gi in range(g)]
    if par is None:
        y = _experts(params, cfg, xg, top_w, slots, slice(None))
        y = y.reshape(b, s, d).to(dt)
        if "shared" in params:
            y = y + FF.apply_ffn(params["shared"], cfg, x)
        return y
    xs, tws = par.fan(x), par.fan(top_w)
    per = m.num_experts // par.size
    y = par.reduce([
        _experts(t, cfg, xj.reshape(g, tg, d), twj,
                 [(st.to(xj.device), sf.to(xj.device)) for st, sf in slots],
                 slice(j * per, (j + 1) * per))
        for j, (t, xj, twj) in enumerate(zip(par.trees, xs, tws))])
    y = y.reshape(b, s, d).to(dt)
    if "shared" in whole:
        y = y + FF.ffn_parallel(par.sub("shared"), cfg, xs)
    return y


def moe_dense_reference(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    """The O(T*E) dense oracle: every expert on every token, combined by
    the router weights."""
    m = cfg.moe
    dt = torch.float32
    logits = LN.apply_linear(params["router"], x, cfg.quant, dtype=dt)
    probs = torch.softmax(logits, dim=-1)
    top_w, top_e = top_k(probs, m.top_k)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    up = torch.einsum("bsd,edf->bsef", x.to(dt),
                      _expert_w(params["we_up"], cfg).to(dt))
    if "we_gate" in params:
        gate = torch.einsum("bsd,edf->bsef", x.to(dt),
                            _expert_w(params["we_gate"], cfg).to(dt))
        h = _gate_act(cfg)(gate) * up
    else:
        h = FF.gelu(up)
    y_all = torch.einsum("bsef,efd->bsed", h,
                         _expert_w(params["we_down"], cfg).to(dt))
    mask = F.one_hot(top_e, m.num_experts).to(dt)             # (B,S,K,E)
    w_per_e = torch.einsum("bske,bsk->bse", mask, top_w)
    y = torch.einsum("bsed,bse->bsd", y_all, w_per_e)
    if "shared" in params:
        y = y + FF.apply_ffn(params["shared"], cfg, x).to(dt)
    return y.to(cfg.activation_dtype)
