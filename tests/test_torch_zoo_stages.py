"""The model zoo in the configs' own bfloat16, stage by stage: each layer
of the port gets the reference's input (and, decoding, the reference's
cache of that layer) and its output is held to the reference's, on all
ten reduced registry configs in the three quant modes (packed weights in
the binary modes).

Contract (bfloat16 runs).  Per layer of the prefill, its output and
every leaf of its cache, and per layer of one decode step from the
reference's prefill cache, its output and new cache, within rtol = atol
= 2^-6 (two bfloat16 steps at the values' scale).  Measured: the reference
run op by op rounds every op to bfloat16 as the port does, and almost
every layer output and cache leaf is equal bit for bit; the largest
difference seen was one bfloat16 step (0.015625 at values in [2, 4), a
local layer of gemma2-9b in float mode).  In ``binary`` mode the inputs
of the packed linears are recorded on both sides: a packed bit may differ
only where the reference value lies within 2^-6 of the tensor's largest
magnitude of 0, and a layer in which a bit differs is not compared whole
(none did).  Whisper's layers are the reference's own attention, FFN and
norm functions composed as its ``encode`` and ``decode_step`` bodies.
"""
import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import attention as JA
from repro.models import common as JC
from repro.models import encdec as JED
from repro.models import ffn as JF
from repro.models import linear as JLN
from repro.models import model as JM
from repro.models import transformer as JTF
from repro.utils import tree as JT
from repro_torch import convert as CV
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import ffn as TF_
from repro_torch.models import linear as TLN
from repro_torch.models import model as TM
from repro_torch.models import transformer as TTF
from repro_torch.tree import tree_index

from _zoo import MODES, NAMES, assert_close, batch, configs, np_of, weights

BF16_TOL = dict(rtol=2 ** -6, atol=2 ** -6)
BIT_SLACK = 2 ** -6
B, S, MAX_LEN = 2, 12, 16


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@contextlib.contextmanager
def _recording():
    """Record the activations every packed linear gets, on both sides."""
    rec = {"ref": [], "port": []}
    jfn, tfn = JLN._apply_packed, TLN._apply_packed

    def jwrap(params, x, quant, dtype):
        rec["ref"].append(np_of(x))
        return jfn(params, x, quant, dtype)

    def twrap(params, x, quant, dtype):
        rec["port"].append(np_of(x))
        return tfn(params, x, quant, dtype)

    JLN._apply_packed, TLN._apply_packed = jwrap, twrap
    try:
        yield rec
    finally:
        JLN._apply_packed, TLN._apply_packed = jfn, tfn


def _flips(rec, what):
    """Packed bits of the port's packed-linear inputs against the
    reference's: the count that differ, each only near 0."""
    assert len(rec["port"]) == len(rec["ref"]), what
    n = 0
    for got, want in zip(rec["port"], rec["ref"]):
        assert got.shape == want.shape, what
        differ = (got >= 0) != (want >= 0)
        slack = BIT_SLACK * np.abs(want).max()
        assert np.all(np.abs(want[differ]) <= slack), what
        n += int(differ.sum())
    rec["port"].clear()
    rec["ref"].clear()
    return n


def _stage(rec, what, got, want):
    """Hold one stage: trees of outputs, unless a packed bit flipped."""
    if _flips(rec, what):
        return
    jl = jax.tree_util.tree_leaves(want)
    tl = [t for t in jax.tree_util.tree_leaves(
        got, is_leaf=lambda t: isinstance(t, torch.Tensor))]
    assert len(jl) == len(tl), what
    for i, (g, w) in enumerate(zip(tl, jl)):
        assert_close(g, w, BF16_TOL, f"{what} leaf {i}")


def _to_port(x):
    return CV.tree_to_torch(x, float_dtype=None)


def _decoder_stages(cfg, tcfg, jp, tp, jb, rec):
    x = JM._embed_in(jp, cfg, jb)
    assert_close(TM._embed_in(tp, tcfg, _to_port(jb)), x, dict(rtol=0,
                                                             atol=0))
    pos = jnp.broadcast_to(jnp.arange(S, dtype=jnp.int32)[None], (B, S))
    tpos = torch.from_numpy(np.array(pos))
    layers = []
    for (pattern, n), js, ts in zip(JTF.segments_of(cfg), jp["stack"],
                                    tp["stack"]):
        for g in range(n):
            jg, tg = JT.tree_index(js, g), tree_index(ts, g)
            for p, kind in enumerate(pattern):
                layers.append((kind, jg[p], tg[p]))
    caches = []
    for i, (kind, jl, tl) in enumerate(layers):
        want = JTF.apply_layer_prefill(jl, cfg, kind, x, pos, MAX_LEN)
        got = TTF.apply_layer_prefill(tl, tcfg, kind, _to_port(x), tpos,
                                      MAX_LEN)
        _stage(rec, f"prefill layer {i} ({kind})", got, want)
        caches.append(want[1])
        x = want[0]
    tok = jnp.asarray(np.arange(B, dtype=np.int32)[:, None] * 7 + 1)
    x = JC.embed(jp["embed"], tok, cfg.activation_dtype) * jnp.asarray(
        cfg.d_model ** 0.5, cfg.activation_dtype)
    for i, ((kind, jl, tl), cache) in enumerate(zip(layers, caches)):
        want = JTF.apply_layer_decode(jl, cfg, kind, x, cache, jnp.int32(S))
        got = TTF.apply_layer_decode(tl, tcfg, kind, _to_port(x),
                                     _to_port(cache), S)
        _stage(rec, f"decode layer {i} ({kind})", got, want)
        x = want[0]


def _whisper_stages(cfg, tcfg, jp, tp, jb, rec):
    """The encoder's and the decoder's layers, each from the reference's
    input; the decode step's layers from a cache of one prefilled step."""
    norm = cfg.norm_type
    frames = jb["enc_embeds"].astype(cfg.activation_dtype)
    s_enc = frames.shape[1]
    x = frames + JC.sinusoidal_positions(s_enc, cfg.d_model).astype(
        frames.dtype)[None]
    pos = jnp.broadcast_to(jnp.arange(s_enc)[None], (B, s_enc))
    tpos = torch.from_numpy(np.array(pos))

    def enc_layer(mod_a, mod_c, mod_f, c, lp, h, p):
        h = h + mod_a.attention_forward(lp["attn"], c, mod_c.apply_norm(
            norm, lp["ln1"], h), positions=p, causal=False)
        return h + mod_f.apply_ffn(lp["mlp"], c,
                                   mod_c.apply_norm(norm, lp["ln2"], h))

    for i in range(cfg.encoder_layers):
        jl = JT.tree_index(jp["encdec"]["enc"], i)
        tl = tree_index(tp["encdec"]["enc"], i)
        want = enc_layer(JA, JC, JF, cfg, jl, x, pos)
        got = enc_layer(TA, TC, TF_, tcfg, tl, _to_port(x), tpos)
        _stage(rec, f"encoder layer {i}", got, want)
        x = want
    enc_out = JC.apply_norm(norm, jp["encdec"]["enc_ln_out"], x)
    cache = JM.init_cache(jp, cfg, B, MAX_LEN, enc_len=s_enc)
    cache["cross"] = JED.precompute_cross_kv(jp["encdec"], cfg, enc_out)
    rec["ref"].clear()          # the reference's cross K/V, not a stage

    def dec_layer(mod_a, mod_c, mod_f, c, lp, h, sc, ck, cv, idx):
        a, nc = mod_a.attention_decode(
            lp["attn"], c, mod_c.apply_norm(norm, lp["ln1"], h), sc, idx)
        h = h + a
        h = h + mod_a.cross_attention_decode(
            lp["xattn"], c, mod_c.apply_norm(norm, lp["ln_x"], h), ck, cv)
        return h + mod_f.apply_ffn(lp["mlp"], c, mod_c.apply_norm(
            norm, lp["ln2"], h)), nc

    tok = jnp.asarray(np.arange(B, dtype=np.int32)[:, None] * 7 + 1)
    for step in range(2):
        x = JC.embed(jp["embed"], tok, cfg.activation_dtype) * jnp.asarray(
            cfg.d_model ** 0.5, cfg.activation_dtype)
        x = x + jp["encdec"]["dec_pos"][step][None, None].astype(x.dtype)
        new_self = []
        for i in range(cfg.num_layers):
            jl = JT.tree_index(jp["encdec"]["dec"], i)
            tl = tree_index(tp["encdec"]["dec"], i)
            sc = JT.tree_index(cache["self"], i)
            ck, cv = cache["cross"]["k"][i], cache["cross"]["v"][i]
            want = dec_layer(JA, JC, JF, cfg, jl, x, sc, ck, cv,
                             jnp.int32(step))
            got = dec_layer(TA, TC, TF_, tcfg, tl, _to_port(x),
                            _to_port(sc), _to_port(ck), _to_port(cv), step)
            _stage(rec, f"decode step {step} layer {i}", got, want)
            x = want[0]
            new_self.append(want[1])
        cache["self"] = JT.tree_stack(new_self)


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_bfloat16_stage_by_stage(name, mode):
    cfg, tcfg = configs(name, mode, dtype="bfloat16")
    assert tcfg.activation_dtype == torch.bfloat16
    jp, tp = weights(cfg, 0, packed=mode != "float")
    jb, _ = batch(cfg, np.random.default_rng(2), B, S)
    with _recording() as rec:
        if cfg.encoder_layers:
            _whisper_stages(cfg, tcfg, jp, tp, jb, rec)
        else:
            _decoder_stages(cfg, tcfg, jp, tp, jb, rec)
