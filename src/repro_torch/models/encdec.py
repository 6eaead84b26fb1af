"""Encoder-decoder backbone, whisper-base (the reference's
``models/encdec.py``).

The conv/audio frontend is a stub: callers pass precomputed frame
embeddings (B, S_enc, d_model).  This module is the transformer backbone:
a bidirectional encoder, a causal decoder with cross-attention,
sinusoidal encoder positions and learned decoder positions (whisper
conventions).  Layers are stacked over depth as in the reference, and a
Python loop over the depth axis takes ``lax.scan``'s place.
"""
from __future__ import annotations

import torch

from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import ffn as F
from repro_torch.models import linear as LN
from repro_torch.tree import tree_index, tree_stack


def init_encdec_stack(gen: torch.Generator, cfg) -> dict:
    def enc_layer():
        return {"ln1": C.init_norm(gen, cfg.norm_type, cfg.d_model),
                "attn": A.init_attention(gen, cfg),
                "ln2": C.init_norm(gen, cfg.norm_type, cfg.d_model),
                "mlp": F.init_ffn(gen, cfg)}

    def dec_layer():
        return {"ln1": C.init_norm(gen, cfg.norm_type, cfg.d_model),
                "attn": A.init_attention(gen, cfg),
                "ln_x": C.init_norm(gen, cfg.norm_type, cfg.d_model),
                "xattn": A.init_attention(gen, cfg, cross=True),
                "ln2": C.init_norm(gen, cfg.norm_type, cfg.d_model),
                "mlp": F.init_ffn(gen, cfg)}

    enc = tree_stack([enc_layer() for _ in range(cfg.encoder_layers)])
    dec = tree_stack([dec_layer() for _ in range(cfg.num_layers)])
    return {
        "enc": enc, "dec": dec,
        "enc_ln_out": C.init_norm(gen, cfg.norm_type, cfg.d_model),
        "dec_pos": C.randn(gen, (cfg.max_position, cfg.d_model), 0.01),
    }


def _depth(tree) -> int:
    if isinstance(tree, list):
        return len(tree)
    return tree["ln1"]["scale"].shape[0]


def encode(params: dict, cfg, frames: torch.Tensor, *,
           remat: bool = True) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed frame embeddings.  With ``remat``
    and autograd recording, each layer's activations are recomputed in
    the backward pass (``common.remat``); the values never change."""
    b, s, _ = frames.shape
    pos = C.sinusoidal_positions(s, cfg.d_model,
                                 device=frames.device).to(frames.dtype)
    x = frames + pos[None]
    positions = torch.arange(s, device=frames.device)[None].expand(b, s)

    def body(h, lp):
        h = h + A.attention_forward(
            lp["attn"], cfg, C.apply_norm(cfg.norm_type, lp["ln1"], h),
            positions=positions, causal=False)
        return h + F.apply_ffn(lp["mlp"], cfg,
                               C.apply_norm(cfg.norm_type, lp["ln2"], h))

    body = C.remat(body, remat)
    for i in range(_depth(params["enc"])):
        x = body(x, C.layer_of(params["enc"], i))
    return C.apply_norm(cfg.norm_type, params["enc_ln_out"], x)


def decode_train(params: dict, cfg, x: torch.Tensor, enc_out: torch.Tensor,
                 positions: torch.Tensor, *, remat: bool = True
                 ) -> torch.Tensor:
    """Teacher-forced decoder pass.  x: (B, S_dec, D) token embeddings.
    ``remat`` as in :func:`encode`."""
    x = x + params["dec_pos"][:x.shape[1]].to(x.dtype)[None]

    def body(h, lp):
        h = h + A.attention_forward(
            lp["attn"], cfg, C.apply_norm(cfg.norm_type, lp["ln1"], h),
            positions=positions)
        h = h + A.attention_forward(
            lp["xattn"], cfg, C.apply_norm(cfg.norm_type, lp["ln_x"], h),
            positions=positions, kv_src=enc_out)
        return h + F.apply_ffn(lp["mlp"], cfg,
                               C.apply_norm(cfg.norm_type, lp["ln2"], h))

    body = C.remat(body, remat)
    for i in range(_depth(params["dec"])):
        x = body(x, C.layer_of(params["dec"], i))
    return x


# ---------------------------------------------------------------------------
# decode (serving): self-attention cache + precomputed cross K/V
# ---------------------------------------------------------------------------

def init_encdec_cache(params: dict, cfg, batch: int, max_len: int,
                      enc_len: int) -> dict:
    device = params["dec_pos"].device
    self_c = tree_stack([A.init_attn_cache(cfg, batch, max_len,
                                           device=device)
                         for _ in range(cfg.num_layers)])
    shape = (cfg.num_layers, batch, enc_len, cfg.num_kv_heads, cfg.head_dim)
    dt = cfg.activation_dtype
    cross = {"k": torch.zeros(shape, dtype=dt, device=device),
             "v": torch.zeros(shape, dtype=dt, device=device)}
    return {"self": self_c, "cross": cross}


def precompute_cross_kv(params: dict, cfg, enc_out: torch.Tensor) -> dict:
    """Cross-attention K/V of the encoder output, per decoder layer."""
    b, s, _ = enc_out.shape
    dt = cfg.activation_dtype
    ks, vs = [], []
    for i in range(_depth(params["dec"])):
        lp = tree_index(params["dec"], i)
        k = LN.apply_linear(lp["xattn"]["wk"], enc_out, cfg.quant, dtype=dt)
        v = LN.apply_linear(lp["xattn"]["wv"], enc_out, cfg.quant, dtype=dt)
        ks.append(k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim))
        vs.append(v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim))
    return {"k": torch.stack(ks), "v": torch.stack(vs)}


def decode_step(params: dict, cfg, x: torch.Tensor, cache: dict, idx: int):
    """One-token decoder step.  x: (B, 1, D) embedded token.  Returns (x,
    cache): each layer's self-attention K/V is written into the stacked
    cache in place."""
    idx = int(idx)
    pos = params["dec_pos"]
    pos_emb = pos[min(max(idx, 0), pos.shape[0] - 1)]
    x = x + pos_emb[None, None].to(x.dtype)
    for i in range(_depth(params["dec"])):
        lp = tree_index(params["dec"], i)
        a, _ = A.attention_decode(
            lp["attn"], cfg, C.apply_norm(cfg.norm_type, lp["ln1"], x),
            tree_index(cache["self"], i), idx)
        x = x + a
        x = x + A.cross_attention_decode(
            lp["xattn"], cfg, C.apply_norm(cfg.norm_type, lp["ln_x"], x),
            cache["cross"]["k"][i], cache["cross"]["v"][i])
        x = x + F.apply_ffn(lp["mlp"], cfg,
                            C.apply_norm(cfg.norm_type, lp["ln2"], x))
    return x, cache
