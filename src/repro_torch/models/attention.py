"""Attention: GQA with a chunked online softmax (the reference's
``models/attention.py``).

Supports GQA/MQA, causal and sliding-window masks, the attention softcap
(gemma-2), partial RoPE (chatglm), M-RoPE (qwen2-vl), QK-norm (qwen3),
cross-attention (whisper), and one-token decode against a KV cache, a
ring buffer for local layers, in the activation dtype or int8 with a
per-(token, head) scale.  The float stack's attention is plain tensor
ops, as in the reference; the packed binary LM's attention kernel (K8)
is not on this path.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common as C
from repro_torch.models import linear as LN

NEG_INF = -1e30


def init_attention(gen: torch.Generator, cfg, *, cross: bool = False
                   ) -> dict:
    d, hq, hkv, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, \
        cfg.head_dim
    p = {
        "wq": LN.init_linear(gen, d, hq * hd),
        "wk": LN.init_linear(gen, d, hkv * hd),
        "wv": LN.init_linear(gen, d, hkv * hd),
        "wo": LN.init_linear(gen, hq * hd, d),
    }
    if cfg.qk_norm:
        p["q_norm"] = C.init_rmsnorm(gen, hd)
        p["k_norm"] = C.init_rmsnorm(gen, hd)
    del cross
    return p


# ---------------------------------------------------------------------------
# projections + rope
# ---------------------------------------------------------------------------

def _project_qkv(params: dict, cfg, x: torch.Tensor,
                 kv_src: torch.Tensor | None = None, column: bool = False):
    dt = cfg.activation_dtype
    kv_src = x if kv_src is None else kv_src
    b, sq = x.shape[:2]
    skv = kv_src.shape[1]
    q = LN.apply_linear(params["wq"], x, cfg.quant, dtype=dt, column=column)
    k = LN.apply_linear(params["wk"], kv_src, cfg.quant, dtype=dt,
                        column=column)
    v = LN.apply_linear(params["wv"], kv_src, cfg.quant, dtype=dt,
                        column=column)
    q = q.reshape(b, sq, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, skv, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, skv, cfg.num_kv_heads, cfg.head_dim)
    if cfg.qk_norm:
        q = C.apply_rmsnorm(params["q_norm"], q)
        k = C.apply_rmsnorm(params["k_norm"], k)
    return q, k, v


def _rope(cfg, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
    if cfg.rope_style == "none":
        return x
    if cfg.rope_style == "mrope":
        pos3 = positions[None].expand(3, *positions.shape)
        half = cfg.head_dim // 2
        t = half // 4
        rem = half - t
        sections = (t, rem // 2, rem - rem // 2)
        return C.apply_mrope(x, pos3, sections=sections, base=cfg.rope_base)
    frac = cfg.rope_fraction if cfg.rope_style == "partial" else 1.0
    return C.apply_rope(x, positions, fraction=frac, base=cfg.rope_base)


# ---------------------------------------------------------------------------
# chunked attention core (prefill, full-sequence forward)
# ---------------------------------------------------------------------------

def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool, window: int | None = None,
                      attn_softcap: float | None = None,
                      q_offset: int = 0, q_chunk: int = 1024,
                      kv_chunk: int = 1024) -> torch.Tensor:
    """Online-softmax attention over q and kv chunks.

    q: (B, Sq, Hq, D); k, v: (B, Skv, Hkv, D) with Hq % Hkv == 0.
    ``q_offset``: absolute position of q[0] relative to k[0].  ``window``:
    positions with q_pos - k_pos >= window are masked.  Returns (B, Sq,
    Hq, D) in q's dtype; accumulation in float32.
    """
    b, sq, hq, d = q.shape
    _, skv, hkv, _ = k.shape
    g = hq // hkv
    scale = d ** -0.5
    dev = q.device
    q_chunk = min(q_chunk, sq)
    kv_chunk = min(kv_chunk, skv)
    nq = -(-sq // q_chunk)
    nkv = -(-skv // kv_chunk)
    sq_p, skv_p = nq * q_chunk, nkv * kv_chunk

    qp = C.pad_seq(q, sq_p).reshape(b, nq, q_chunk, hkv, g, d)
    kp = C.pad_seq(k, skv_p).reshape(b, nkv, kv_chunk, hkv, d)
    vp = C.pad_seq(v, skv_p).reshape(b, nkv, kv_chunk, hkv, d)
    q_pos = (q_offset + torch.arange(sq_p, device=dev)).reshape(nq, q_chunk)
    k_pos = torch.arange(skv_p, device=dev).reshape(nkv, kv_chunk)
    k_valid = (torch.arange(skv_p, device=dev) < skv).reshape(nkv, kv_chunk)

    outs = []
    for i in range(nq):
        qb = qp[:, i].to(torch.float32)               # (B, qc, Hkv, G, D)
        qpos = q_pos[i]
        m = torch.full((b, hkv, g, q_chunk), NEG_INF, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, g, q_chunk), dtype=torch.float32,
                        device=dev)
        acc = torch.zeros((b, hkv, g, q_chunk, d), dtype=torch.float32,
                          device=dev)
        for j in range(nkv):
            kb = kp[:, j].to(torch.float32)
            vb = vp[:, j].to(torch.float32)
            kpos = k_pos[j]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qb, kb) * scale
            if attn_softcap is not None:
                s = attn_softcap * torch.tanh(s / attn_softcap)
            mask = k_valid[j][None, :]
            if causal:
                mask = mask & (qpos[:, None] >= kpos[None, :])
            if window is not None:
                mask = mask & (qpos[:, None] - kpos[None, :] < window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vb)
            m = m_new
        out = acc / torch.clamp(l, min=1e-30)[..., None]  # (B,Hkv,G,qc,D)
        outs.append(torch.einsum("bhgqd->bqhgd", out))
    out = torch.stack(outs, dim=1).reshape(b, sq_p, hq, d)[:, :sq]
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# full-sequence forward
# ---------------------------------------------------------------------------

def _attend(params: dict, cfg, x: torch.Tensor, positions: torch.Tensor,
            kind: str, causal: bool, kv_src: torch.Tensor | None,
            column: bool = False):
    """Projections, rope and attention: (out (B, S, H * hd) before the
    output projection, k, v).  ``column``: a tensor-parallel position's
    float32 input copies (``linear.apply_linear``)."""
    q, k, v = _project_qkv(params, cfg, x, kv_src, column)
    is_cross = kv_src is not None
    if not is_cross:
        q = _rope(cfg, q, positions)
        k = _rope(cfg, k, positions)
    window = cfg.window_size if kind == "local" else None
    out = chunked_attention(q, k, v, causal=causal and not is_cross,
                            window=window, attn_softcap=cfg.attn_softcap)
    b, s = x.shape[:2]
    return out.reshape(b, s, -1), k, v


def heads_split(cfg, m: int) -> bool:
    """Whether attention splits over ``m`` model positions on whole
    units: ``m`` divides the query and the KV heads, so every GQA group
    stays at one position."""
    return cfg.num_heads % m == 0 and cfg.num_kv_heads % m == 0


def parallel_traffic(cfg, tokens: int, dtype, kv_tokens: int | None = None,
                     kv_dtype=None) -> list:
    """The traffic entries (``common.Parallel``) of one tensor-parallel
    call on ``tokens`` rows of ``dtype``: the input fanned out (for cross
    attention the ``kv_tokens`` rows of ``kv_dtype`` too), the partial
    outputs of ``wo`` summed."""
    d = cfg.d_model
    out = C.fan_traffic(tokens * d, dtype)
    if kv_tokens is not None:
        out += C.fan_traffic(kv_tokens * d, kv_dtype)
    return out + LN.row_parallel_traffic(cfg.quant, tokens * d, d)


def attention_forward(params, cfg, x: torch.Tensor, *,
                      positions: torch.Tensor, kind: str = "global",
                      causal: bool = True,
                      kv_src: torch.Tensor | None = None,
                      return_kv: bool = False):
    """x: (B, S, D) -> (B, S, D).  kind: 'global' | 'local'.  ``kv_src``
    makes it cross-attention (no rope on cross).

    ``params`` may be a ``common.Parallel`` (tensor parallelism over
    ``model``, :func:`heads_split`): position j runs its heads, its
    columns of ``wq``/``wk``/``wv`` and its rows of ``wo``, as the body
    of a config with ``num_heads / m`` and ``num_kv_heads / m`` heads
    (scale, softcap, window and rope are per head); the partial outputs
    are summed over the positions (``linear.apply_row_parallel``)."""
    if isinstance(params, C.Parallel):
        if return_kv:
            raise ValueError("return_kv: the tensor-parallel attention is "
                             "the train step's; prefill runs whole")
        m = params.size
        local = dataclasses.replace(cfg, num_heads=cfg.num_heads // m,
                                    num_kv_heads=cfg.num_kv_heads // m)
        xs = params.fan(x)
        kvs = params.fan(kv_src) if kv_src is not None else [None] * m
        outs = [_attend(t, local, xj, positions.to(xj.device), kind, causal,
                        kvj, column=True)[0]
                for t, xj, kvj in zip(params.trees, xs, kvs)]
        return LN.apply_row_parallel(params, [t["wo"] for t in params.trees],
                                     outs, cfg.quant,
                                     dtype=cfg.activation_dtype)
    out, k, v = _attend(params, cfg, x, positions, kind, causal, kv_src)
    y = LN.apply_linear(params["wo"], out, cfg.quant,
                        dtype=cfg.activation_dtype)
    if return_kv:
        return y, (k, v)
    return y


# ---------------------------------------------------------------------------
# decode (one token, KV cache)
# ---------------------------------------------------------------------------

def _kv_quantize(x: torch.Tensor):
    """(..., D) -> (int8 values, bfloat16 absmax-over-D scale).  The
    rounding is half to even, as the reference's."""
    x32 = x.to(torch.float32)
    amax = torch.amax(torch.abs(x32), dim=-1, keepdim=True)
    scale = torch.clamp(amax, min=1e-6) / 127.0
    q = torch.clamp(torch.round(x32 / scale), -127, 127)
    return q.to(torch.int8), scale[..., 0].to(torch.bfloat16)


def _kv_dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale.to(torch.float32)[..., None]


def init_attn_cache(cfg, batch: int, max_len: int, kind: str = "global",
                    dtype=None, device=None) -> dict:
    dtype = dtype or cfg.activation_dtype
    size = min(max_len, cfg.window_size) if kind == "local" else max_len
    shape = (batch, size, cfg.num_kv_heads, cfg.head_dim)
    if cfg.kv_cache_dtype == "int8":
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=torch.bfloat16,
                                       device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def _write_slot(buf: torch.Tensor, val: torch.Tensor, slot: int) -> None:
    """Write ``val`` (B, 1, ...) into ``buf`` at ``slot`` of axis 1, in
    place, the slot clamped into range as a dynamic update slice is."""
    slot = min(max(slot, 0), buf.shape[1] - 1)
    buf[:, slot:slot + 1] = val


def attention_decode(params: dict, cfg, x: torch.Tensor, cache: dict,
                     idx: int, *, kind: str = "global",
                     cross_kv: tuple | None = None):
    """One-token decode.  x: (B, 1, D); ``idx``: the absolute position
    being generated.  Local layers use a ring buffer of ``window_size``
    slots (slot = pos % size); global layers index the full cache.
    Returns (y, cache): the new K/V is written into ``cache`` in place.
    ``cross_kv`` is refused: cross-attention is
    :func:`cross_attention_decode`."""
    if cross_kv is not None:
        raise NotImplementedError(
            "attention_decode does not consume cross_kv; call "
            "cross_attention_decode with the precomputed encoder K/V "
            "(see models/encdec.py) instead of passing it here")
    idx = int(idx)
    b = x.shape[0]
    q, k, v = _project_qkv(params, cfg, x)             # (B,1,H*,D)
    pos = torch.full((b, 1), idx, dtype=torch.int32, device=x.device)
    q = _rope(cfg, q, pos)
    k = _rope(cfg, k, pos)

    size = cache["k"].shape[1]
    slot = idx % size if kind == "local" else idx
    # The live slots: a global layer's mask is j <= idx, and a ring's
    # window is its own size, so both read the first min(idx + 1, size)
    # slots and every one of them is valid.
    live = min(idx + 1, size)
    if cfg.kv_cache_dtype == "int8":
        kq, ks = _kv_quantize(k)
        vq, vs = _kv_quantize(v)
        for name, val in (("k", kq), ("v", vq), ("k_scale", ks),
                          ("v_scale", vs)):
            _write_slot(cache[name], val, slot)
        ck = _kv_dequantize(cache["k"][:, :live], cache["k_scale"][:, :live])
        cv = _kv_dequantize(cache["v"][:, :live], cache["v_scale"][:, :live])
    else:
        _write_slot(cache["k"], k, slot)
        _write_slot(cache["v"], v, slot)
        ck, cv = cache["k"][:, :live], cache["v"][:, :live]

    y = _decode_score(q, ck, cv, cfg)
    out = LN.apply_linear(params["wo"], y.reshape(b, 1, -1), cfg.quant,
                          dtype=cfg.activation_dtype)
    return out, cache


def _decode_score(q, ck, cv, cfg):
    """One query row against every key of ``ck``/``cv``, in float32 as the
    reference computes it."""
    b, _, hq, d = q.shape
    hkv = cfg.num_kv_heads
    g = hq // hkv
    qg = q.reshape(b, hkv, g, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.to(torch.float32),
                     ck.to(torch.float32)) * d ** -0.5
    if cfg.attn_softcap is not None:
        s = cfg.attn_softcap * torch.tanh(s / cfg.attn_softcap)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, cv.to(torch.float32))
    return o.reshape(b, 1, hq, d).to(cfg.activation_dtype)


def cross_attention_decode(params: dict, cfg, x: torch.Tensor,
                           cross_k: torch.Tensor, cross_v: torch.Tensor):
    """Decoder cross-attention against precomputed encoder K/V."""
    b = x.shape[0]
    dt = cfg.activation_dtype
    q = LN.apply_linear(params["wq"], x, cfg.quant, dtype=dt)
    q = q.reshape(b, 1, cfg.num_heads, cfg.head_dim)
    y = _decode_score(q, cross_k, cross_v, cfg)
    return LN.apply_linear(params["wo"], y.reshape(b, 1, -1), cfg.quant,
                           dtype=dt)
