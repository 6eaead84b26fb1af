"""The decoder stack of the model zoo, and the packed binary LM (the
reference's ``models/transformer.py``).

The float half (``:32-270`` there) assembles any registry config's
decoder from pattern segments: a segment is one pass through
``cfg.attention_pattern`` repeated over its groups, its params a tuple
(one tree per pattern position) of trees stacked over the groups, the
reference's layout, so weights cross over leaf for leaf; a Python loop
over the group axis takes ``lax.scan``'s place.  Layer kinds: 'global' |
'local' (attention), 'rec' (RG-LRU), 'ssm' (Mamba-2); every kind but
'ssm' is followed by an FFN or MoE sub-block.

  init_stack / stack_forward / init_cache / stack_prefill / stack_decode

The packed binary LM (``:280-419`` there): every projection (Q, K, V, O, the FFN's up and down projections, the LM
head) is a sign-binarized XNOR-popcount GEMM over packed operands; the
FFN up-projection keeps the fused BN-sign-repack epilogue, so its int32
activation never leaves the kernel; attention runs through the binary
attention kernel (``kernels.ops.binary_attention``).  The residual
stream and the embedding table stay float; there are no norms, because
every projection input is sign-binarized at once, which is
scale-invariant.  Layer kinds: ``'global'`` is causal attention, any
other kind causal sliding-window attention over ``window_size`` keys.

  init_binary_lm(gen, spec)          -> float weights + BN
  pack_transformer(params, spec)     -> the packed tree, on the card
  transformer_forward_packed(...)    -> last-token logits

One layer of the forward is two functions, so that each half can be held
against the reference on its own: :func:`attention_half` (residual ->
q, k, v and the attention output) and :func:`update_half` (residual and
attention output -> the next residual).
"""
from __future__ import annotations

import torch

from repro_torch.configs import LMSpec
from repro_torch.core import binary_layers as L
from repro_torch.kernels import ops as kops
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import ffn as F
from repro_torch.models import linear as LN
from repro_torch.models import moe as M
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.cnn import _check_device, to_device
from repro_torch.tree import tree_index, tree_map, tree_stack


# ---------------------------------------------------------------------------
# The float stack: segments, layers, caches
# ---------------------------------------------------------------------------

def segments_of(cfg) -> list[tuple[tuple[str, ...], int]]:
    """[(pattern, n_groups), ...] covering exactly num_layers layers."""
    period = cfg.pattern_period
    n_full, leftover = divmod(cfg.num_layers, period)
    segs: list[tuple[tuple[str, ...], int]] = []
    if n_full:
        segs.append((tuple(cfg.attention_pattern), n_full))
    if leftover:
        segs.append((tuple(cfg.attention_pattern[:leftover]), 1))
    return segs


def _has_ffn(cfg, kind: str) -> bool:
    return kind != "ssm" and (cfg.d_ff > 0 or cfg.moe is not None)


def init_layer(gen: torch.Generator, cfg, kind: str) -> dict:
    p: dict = {"ln1": C.init_norm(gen, cfg.norm_type, cfg.d_model)}
    if kind in ("global", "local"):
        p["attn"] = A.init_attention(gen, cfg)
    elif kind == "rec":
        p["rec"] = R.init_rglru_block(gen, cfg)
    elif kind == "ssm":
        p["ssm"] = S.init_mamba2(gen, cfg)
    else:
        raise ValueError(kind)
    if _has_ffn(cfg, kind):
        p["ln2"] = C.init_norm(gen, cfg.norm_type, cfg.d_model)
        p["mlp"] = (M.init_moe(gen, cfg) if cfg.moe is not None
                    else F.init_ffn(gen, cfg))
    return p


def _mlp(params: dict, cfg, x: torch.Tensor) -> torch.Tensor:
    if "mlp" not in params:
        return x
    h2 = C.apply_norm(cfg.norm_type, params["ln2"], x)
    y = (M.apply_moe(params["mlp"], cfg, h2) if cfg.moe is not None
         else F.apply_ffn(params["mlp"], cfg, h2))
    return x + y


def apply_layer(params: dict, cfg, kind: str, x: torch.Tensor,
                positions: torch.Tensor) -> torch.Tensor:
    h = C.apply_norm(cfg.norm_type, params["ln1"], x)
    if kind in ("global", "local"):
        mix = A.attention_forward(params["attn"], cfg, h,
                                  positions=positions, kind=kind)
    elif kind == "rec":
        mix = R.rglru_block_forward(params["rec"], cfg, h)
    else:
        mix = S.mamba2_forward(params["ssm"], cfg, h)
    return _mlp(params, cfg, x + mix)


def init_stack(gen: torch.Generator, cfg, device) -> list:
    """A list of segments; each segment is a tuple (one entry per pattern
    position) of trees stacked over the segment's groups.  Layers are
    drawn from ``gen`` in depth order, a group at a time, and copied into
    the stacked buffers on ``device`` at once, so that only one group's
    trees exist beside them."""
    stack = []
    for pattern, n in segments_of(cfg):
        seg = None
        for g in range(n):
            group = tuple(init_layer(gen, cfg, kind) for kind in pattern)
            if seg is None:
                seg = tree_map(lambda t: torch.empty(
                    (n, *t.shape), dtype=t.dtype, device=device), group)
            tree_map(lambda buf, t, g=g: buf[g].copy_(t), seg, group)
            del group
        stack.append(seg)
    return stack


def stack_forward(stack: list, cfg, x: torch.Tensor,
                  positions: torch.Tensor, *, remat: bool = True
                  ) -> torch.Tensor:
    """The decoder stack on a full sequence.  With ``remat`` and autograd
    recording, each group's body runs under ``common.remat``: the
    backward pass recomputes a group's activations from its input, so
    only the group inputs are kept (the reference's ``jax.checkpoint``
    with ``nothing_saveable`` around its scan body).  Without autograd
    nothing is kept either way, and the values never change.  A segment
    may also be a list of its groups' trees (``common.layer_of``)."""

    def group_body(h, group, pattern):
        for pos, kind in enumerate(pattern):
            h = apply_layer(group[pos], cfg, kind, h, positions)
        return h

    body = C.remat(group_body, remat)
    for (pattern, n), seg_params in zip(segments_of(cfg), stack):
        for g in range(n):
            x = body(x, C.layer_of(seg_params, g), pattern)
    return x


def init_cache(cfg, batch: int, max_len: int, device=None) -> list:
    """The decode cache, mirroring the stack's segments."""
    cache = []
    for pattern, n in segments_of(cfg):
        seg = []
        for kind in pattern:
            if kind in ("global", "local"):
                one = A.init_attn_cache(cfg, batch, max_len, kind,
                                        device=device)
            elif kind == "rec":
                one = R.init_rglru_cache(cfg, batch, device=device)
            else:
                one = S.init_mamba2_cache(cfg, batch, device=device)
            seg.append(tree_stack([one] * n))
        cache.append(tuple(seg))
    return cache


def apply_layer_decode(params: dict, cfg, kind: str, x: torch.Tensor,
                       cache: dict, idx: int):
    h = C.apply_norm(cfg.norm_type, params["ln1"], x)
    if kind in ("global", "local"):
        mix, new_cache = A.attention_decode(params["attn"], cfg, h, cache,
                                            idx, kind=kind)
    elif kind == "rec":
        mix, new_cache = R.rglru_block_decode(params["rec"], cfg, h, cache)
    else:
        mix, new_cache = S.mamba2_decode(params["ssm"], cfg, h, cache)
    return _mlp(params, cfg, x + mix), new_cache


def stack_decode(stack: list, cache: list, cfg, x: torch.Tensor, idx: int):
    """One-token decode through the whole stack.  x: (B, 1, D).  Returns
    (x, cache): each layer writes its step into its own slice of the
    stacked cache, in place."""
    for (pattern, n), seg_params, seg_cache in zip(segments_of(cfg), stack,
                                                   cache):
        for g in range(n):
            group, group_cache = tree_index(seg_params, g), \
                tree_index(seg_cache, g)
            for pos, kind in enumerate(pattern):
                x, _ = apply_layer_decode(group[pos], cfg, kind, x,
                                          group_cache[pos], idx)
    return x, cache


def _ring_from_full(k: torch.Tensor, window: int) -> torch.Tensor:
    """Full-sequence K/V (B, S, ...) -> the decode ring layout (B, window,
    ...), for value tensors (B, S, H, D) and scales (B, S, H)."""
    bsz, s = k.shape[:2]
    w = min(window, s)
    slots = (s - w + torch.arange(w, device=k.device)) % window
    ring = torch.zeros((bsz, window, *k.shape[2:]), dtype=k.dtype,
                       device=k.device)
    ring[:, slots] = k[:, s - w:]
    return ring


def apply_layer_prefill(params: dict, cfg, kind: str, x: torch.Tensor,
                        positions: torch.Tensor, max_len: int):
    h = C.apply_norm(cfg.norm_type, params["ln1"], x)
    if kind in ("global", "local"):
        mix, (k, v) = A.attention_forward(params["attn"], cfg, h,
                                          positions=positions, kind=kind,
                                          return_kv=True)
        if cfg.kv_cache_dtype == "int8":
            kq, ks = A._kv_quantize(k)
            vq, vs = A._kv_quantize(v)
            parts = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        else:
            parts = {"k": k, "v": v}
        if kind == "local":
            size = min(max_len, cfg.window_size)
            new_cache = {n: _ring_from_full(t, size)
                         for n, t in parts.items()}
        else:
            new_cache = {n: C.pad_seq(t, max_len) for n, t in parts.items()}
    elif kind == "rec":
        mix, new_cache = R.rglru_block_forward(params["rec"], cfg, h,
                                               return_cache=True)
    else:
        mix, new_cache = S.mamba2_forward(params["ssm"], cfg, h,
                                          return_cache=True)
    return _mlp(params, cfg, x + mix), new_cache


def stack_prefill(stack: list, cfg, x: torch.Tensor,
                  positions: torch.Tensor, max_len: int):
    """The full-sequence forward that also returns the decode cache."""
    cache_all = []
    for (pattern, n), seg_params in zip(segments_of(cfg), stack):
        per_group = []
        for g in range(n):
            group = tree_index(seg_params, g)
            caches = []
            for pos, kind in enumerate(pattern):
                x, c = apply_layer_prefill(group[pos], cfg, kind, x,
                                           positions, max_len)
                caches.append(c)
            per_group.append(tuple(caches))
        cache_all.append(tree_stack(per_group))
    return x, cache_all


# ---------------------------------------------------------------------------
# The packed binary LM
# ---------------------------------------------------------------------------

# The values ``dense_stack`` takes, as in the reference; the per-layer FFN
# is one fused stage, so there is no stack to make resident and the value
# is not used.
DENSE_STACK_MODES = ("auto", "resident", "layered")


def _lm_d_ff(spec: LMSpec) -> int:
    if spec.d_ff > 0:
        return spec.d_ff
    if spec.moe_d_ff_expert is not None:
        return spec.moe_d_ff_expert
    return spec.d_model


def init_binary_lm(gen: torch.Generator, spec: LMSpec, device=None) -> dict:
    """Float weights for :func:`pack_transformer`, standard normal from
    ``gen`` on ``device`` (the generator's device by default), one (out,
    in) matrix per projection; the FFN's BN is the identity."""
    device = gen.device if device is None else torch.device(device)
    d, hq, hkv, hd = (spec.d_model, spec.num_heads, spec.num_kv_heads,
                      spec.head_dim)
    f = _lm_d_ff(spec)

    def mat(n, m):
        return torch.randn((n, m), generator=gen, device=device)

    blocks = []
    for _ in range(spec.num_layers):
        blocks.append({
            "wq": mat(hq * hd, d), "wk": mat(hkv * hd, d),
            "wv": mat(hkv * hd, d), "wo": mat(d, hq * hd),
            "w1": mat(f, d),
            "bn1": {k: t.to(device)
                    for k, t in L.init_batchnorm(f).items()},
            "w2": mat(d, f),
        })
    return {"embed": mat(spec.vocab_size, d),
            "head": mat(spec.vocab_size, d), "blocks": blocks}


def _pack_dense(w: torch.Tensor) -> dict:
    """``binary_layers.pack_binary_dense``, a slice of rows at a time."""
    return {"w_packed": LN.pack_rows(w), "k_true": w.shape[1]}


def pack_transformer(params: dict, spec: LMSpec, *, max_len: int = 16,
                     device="cuda") -> dict:
    """One-time weight packing for the packed forward, on ``device``.

    It packs on the device the params are on, then moves the packed tree;
    the default device is the card, and without one it raises.  Returns
    per-layer packed projections, the folded BN-sign threshold of the FFN
    up-projection, the float32 embedding table, the packed head and a
    ``meta`` dict of the shapes and masks the forward reads (``seq_len``
    fixes the serving example shape).
    """
    device = _check_device(device)
    d, hq, hkv, hd = (spec.d_model, spec.num_heads, spec.num_kv_heads,
                      spec.head_dim)
    kinds = tuple(spec.layer_kind(i) for i in range(spec.num_layers))
    blocks = []
    for lp in params["blocks"]:
        blk = {w: _pack_dense(lp[w])
               for w in ("wq", "wk", "wv", "wo", "w1", "w2")}
        blk["fold1"] = L.fold_bn_sign(to_device(lp["bn1"],
                                                lp["w1"].device))
        blocks.append(to_device(blk, device))
    return {"blocks": blocks,
            "embed": params["embed"].to(device, torch.float32),
            "head": to_device(_pack_dense(params["head"]), device),
            "meta": {"name": spec.name, "d_model": d, "num_heads": hq,
                     "num_kv_heads": hkv, "head_dim": hd,
                     "d_ff": _lm_d_ff(spec), "vocab_size": spec.vocab_size,
                     "seq_len": max_len, "window_size": spec.window_size,
                     "attn_softcap": spec.attn_softcap, "kinds": kinds}}


def layer_window(meta: dict, kind: str) -> int | None:
    """The attention window of a layer kind: None for ``'global'``."""
    return None if kind == "global" else meta["window_size"]


def attention_half(blk: dict, meta: dict, x: torch.Tensor, *,
                   window: int | None, backend: str = "auto"):
    """First half of a layer: residual x (B, S, D) float32 -> (q, k, v,
    attn).  q, k, v are the int32 projections, (B*S, Hq*hd) and (B*S,
    Hkv*hd); attn is the (B, S, Hq, hd) float32 attention output.
    Launches ``bitpack`` x3, the int32 GEMM x3 and the attention kernel."""
    d, hq, hkv, hd = (meta["d_model"], meta["num_heads"],
                      meta["num_kv_heads"], meta["head_dim"])
    b, s = x.shape[:2]
    xp = kops.bitpack(x.reshape(b * s, d), backend=backend)
    q, k, v = (kops.binary_matmul_packed(xp, blk[w]["w_packed"], k_true=d,
                                         backend=backend)
               for w in ("wq", "wk", "wv"))
    # float32 * Python float multiplies by the constant rounded to float32,
    # as XLA does.
    attn = kops.binary_attention(
        q.reshape(b, s, hq, hd).to(torch.float32),
        k.reshape(b, s, hkv, hd).to(torch.float32),
        v.reshape(b, s, hkv, hd).to(torch.float32) * (1.0 / d),
        causal=True, window=window, attn_softcap=meta["attn_softcap"],
        backend=backend)
    return q, k, v, attn


def update_half(blk: dict, meta: dict, x: torch.Tensor, attn: torch.Tensor,
                *, backend: str = "auto") -> torch.Tensor:
    """Second half of a layer: residual x (B, S, D) and attention output
    (B, S, Hq, hd) -> the next residual.  The output projection, then the
    FFN: fused up-projection (GEMM + folded BN-sign + re-bitpack) and the
    down-projection on its packed output.  Launches ``bitpack`` x2, the
    int32 GEMM x2 and the fused GEMM x1."""
    d, hq, hd, f = (meta["d_model"], meta["num_heads"], meta["head_dim"],
                    meta["d_ff"])
    b, s = x.shape[:2]
    ap = kops.bitpack(attn.reshape(b * s, hq * hd), backend=backend)
    o = kops.binary_matmul_packed(ap, blk["wo"]["w_packed"], k_true=hq * hd,
                                  backend=backend)
    x = x + o.reshape(b, s, d).to(torch.float32) * (1.0 / (hq * hd))
    hp = kops.bitpack(x.reshape(b * s, d), backend=backend)
    h1 = kops.binary_matmul_bn_sign_packed(
        hp, blk["w1"]["w_packed"], blk["fold1"]["tau"],
        blk["fold1"]["flip"], k_true=d, backend=backend)
    y = kops.binary_matmul_packed(h1, blk["w2"]["w_packed"], k_true=f,
                                  backend=backend)
    return x + y.reshape(b, s, d).to(torch.float32) * (1.0 / f)


def head_logits(packed: dict, x: torch.Tensor, *,
                backend: str = "auto") -> torch.Tensor:
    """Last-token logits (B, vocab) float32 from the residual (B, S, D)."""
    lp = kops.bitpack(x[:, -1], backend=backend)
    logits = kops.binary_matmul_packed(lp, packed["head"]["w_packed"],
                                       k_true=packed["meta"]["d_model"],
                                       backend=backend)
    return logits.to(torch.float32)


def embed(packed: dict, tokens: torch.Tensor) -> torch.Tensor:
    """The float32 residual (B, S, D) of integer ids (B, S)."""
    return packed["embed"][tokens.to(device=packed["embed"].device,
                                     dtype=torch.int64)]


def check_dense_stack(dense_stack: str) -> None:
    if dense_stack not in DENSE_STACK_MODES:
        raise ValueError(f"unknown dense_stack {dense_stack!r}")


def transformer_forward_packed(packed: dict, tokens: torch.Tensor, *,
                               backend: str = "auto",
                               dense_stack: str = "auto") -> torch.Tensor:
    """Packed binary-LM forward: ``tokens`` (B, S) integer ids of any
    integer dtype -> last-token logits (B, vocab) float32.

    Per layer: ``bitpack`` x5, the int32 GEMM x5, the fused GEMM x1 and
    the attention kernel x1; the head adds ``bitpack`` x1 and the int32
    GEMM x1.  ``dense_stack`` is accepted for signature parity with the
    BMLP and BCNN forwards and validated against
    :data:`DENSE_STACK_MODES`.
    """
    check_dense_stack(dense_stack)
    meta = packed["meta"]
    x = embed(packed, tokens)
    for blk, kind in zip(packed["blocks"], meta["kinds"]):
        _, _, _, attn = attention_half(blk, meta, x,
                                       window=layer_window(meta, kind),
                                       backend=backend)
        x = update_half(blk, meta, x, attn, backend=backend)
    return head_logits(packed, x, backend=backend)
