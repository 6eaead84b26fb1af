"""The port's packed binary LM (``models/transformer.py``) and the plain
version of its attention kernel against the JAX reference on the same
weights and inputs.

Parity contract.  Everything but the attention output is integers, packed
words or single IEEE operations, so q, k and v (int32), the packed words,
the fused FFN output, the residual stream and the logits must be equal.
The attention output is a float softmax: it must agree within rtol = atol
= 2e-5, the reference's own tolerance between its kernel and its oracle
(``tests/test_binary_attention.py``).  Its packed bits may differ only
where the reference value lies within 4e-5 of 0 (V is scaled by 1/d, so
|attn| <= 1).

The forward is held stage by stage against one fixed reference backend:
each layer's first half gets the reference's residual, its second half
the reference's residual and attention output.  The whole forward's
logits must equal the reference's when no attention bit differs.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.kernels import ops as JOPS
from repro.models import cnn as JC
from repro.models import transformer as TF
from repro_torch import configs as TCFG
from repro_torch import convert as CV
from repro_torch.core import binarize as TB
from repro_torch.kernels import binary_attention as TBA
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.models import cnn as TC
from repro_torch.models import transformer as TT

ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
BIT_SLACK = 4e-5          # |ref| within which a packed attention bit may flip


# ---------------------------------------------------------------------------
# The attention kernel's plain version
# ---------------------------------------------------------------------------

# (B, Sq, Skv, Hq, Hkv, D, Dv), keyword arguments
ATTN_CASES = {
    "plain": ((2, 8, 8, 4, 2, 16, 16), {}),
    "window_softcap": ((1, 37, 37, 6, 2, 40, 24),
                       dict(window=5, attn_softcap=50.0)),
    "q_offset": ((2, 3, 19, 4, 4, 64, 32), dict(q_offset=16)),
    "not_causal_window": ((1, 5, 40, 2, 2, 33, 33),
                          dict(causal=False, window=7)),
    # Skv - 1 + window = 7: the rows at qpos 7, 8 and 9 see no key and
    # average V uniformly over the 6 keys.
    "rows_without_keys": ((1, 4, 6, 2, 1, 16, 16),
                          dict(window=2, q_offset=6)),
}


def _qkv(shape, seed):
    b, sq, skv, hq, hkv, d, dv = shape
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(b, sq, hq, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, d)).astype(np.float32),
            rng.normal(size=(b, skv, hkv, dv)).astype(np.float32))


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_attention_plain_version_matches_reference(case):
    """The dispatcher's plain version on real Q/K and the kernel's plain
    version on packed Q/K (what the card holds K8 against) against the
    reference's exact-softmax oracle."""
    shape, kw = ATTN_CASES[case]
    q, k, v = _qkv(shape, len(case))
    want = np.asarray(JOPS.binary_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), backend="jnp", **kw))
    tq, tk, tv = map(torch.from_numpy, (q, k, v))
    got = TOPS.binary_attention(tq, tk, tv, backend="torch", **kw)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)
    packed = TREF.binary_attention_packed_ref(
        TB.pack_bits(tq), TB.pack_bits(tk), tv, d_true=shape[5], **kw)
    np.testing.assert_allclose(packed.numpy(), want, **ATTN_TOL)


def test_rows_without_keys_average_every_key():
    shape, kw = ATTN_CASES["rows_without_keys"]
    q, k, v = _qkv(shape, 0)
    got = TOPS.binary_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    mean = v.repeat(2, axis=2).mean(axis=1)              # GQA group 2
    np.testing.assert_allclose(got[0, 1:].numpy(), mean[0][None].repeat(
        3, axis=0), **ATTN_TOL)


@pytest.mark.parametrize("case", ["plain", "window_softcap", "q_offset",
                                  "not_causal_window"])
def test_attention_plain_version_matches_pallas(case):
    """Against the reference's Pallas kernel (interpret).  The rows with
    no unmasked key are left out: the Pallas kernel also averages in its
    zero-padded KV rows (``binary_attention.py:89-113``), the oracle and
    the port average over the Skv keys."""
    shape, kw = ATTN_CASES[case]
    q, k, v = _qkv(shape, len(case) + 1)
    want = np.asarray(JOPS.binary_attention(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), backend="pallas",
        **kw))
    got = TOPS.binary_attention(*map(torch.from_numpy, (q, k, v)), **kw)
    np.testing.assert_allclose(got.numpy(), want, **ATTN_TOL)


def test_attention_scale_is_float32():
    for d in (16, 40, 128, 256):
        assert TBA.attention_scale(d) == float(np.float32(d) ** -0.5)


@pytest.mark.parametrize("backend", ["auto", "torch", "cuda"])
def test_attention_window_must_be_positive(backend):
    q, k, v = map(torch.from_numpy, _qkv((1, 4, 4, 2, 1, 16, 16), 0))
    with pytest.raises(ValueError, match="window"):
        TOPS.binary_attention(q, k, v, window=0, backend=backend)


def test_attention_cuda_backend_and_wrapper_refuse_cpu_tensors():
    q, k, v = map(torch.from_numpy, _qkv((1, 4, 4, 2, 1, 16, 16), 0))
    with pytest.raises(ValueError, match="CUDA"):
        TOPS.binary_attention(q, k, v, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        TBA.binary_attention_packed(TB.pack_bits(q), TB.pack_bits(k), v,
                                    d_true=16)
    assert "binary_attention" in TOPS.KERNELS


# ---------------------------------------------------------------------------
# Configurations
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("spec", [TCFG.GEMMA2_9B, TCFG.STARCODER2_3B],
                         ids=lambda s: s.name)
def test_lm_specs_copy_the_reference_configs(spec):
    name = spec.name
    assert CV.lm_spec(get_config(name)) == spec
    assert CV.lm_spec(get_config(name, reduced=True)) == spec.reduced()
    ref = get_config(name)
    assert [spec.layer_kind(i) for i in range(5)] == \
        [ref.layer_kind(i) for i in range(5)]


# ---------------------------------------------------------------------------
# The forward, stage by stage
# ---------------------------------------------------------------------------

def _ref_attention_half(blk, meta, x, window, backend):
    """``transformer.py:390-400``, from ``repro.kernels.ops`` calls."""
    d, hq, hkv, hd = (meta["d_model"], meta["num_heads"],
                      meta["num_kv_heads"], meta["head_dim"])
    b, s = x.shape[:2]
    xp = JOPS.bitpack(x.reshape(b * s, d), backend=backend)
    q, k, v = (JOPS.binary_matmul_packed(xp, blk[w]["w_packed"], k_true=d,
                                         backend=backend)
               for w in ("wq", "wk", "wv"))
    attn = JOPS.binary_attention(
        q.reshape(b, s, hq, hd).astype(jnp.float32),
        k.reshape(b, s, hkv, hd).astype(jnp.float32),
        v.reshape(b, s, hkv, hd).astype(jnp.float32) * (1.0 / d),
        causal=True, window=window, attn_softcap=meta["attn_softcap"],
        backend=backend)
    return q, k, v, attn


def _ref_update_half(blk, meta, x, attn, backend):
    """``transformer.py:401-414``."""
    d, hq, hd, f = (meta["d_model"], meta["num_heads"], meta["head_dim"],
                    meta["d_ff"])
    b, s = x.shape[:2]
    ap = JOPS.bitpack(attn.reshape(b * s, hq * hd), backend=backend)
    o = JOPS.binary_matmul_packed(ap, blk["wo"]["w_packed"], k_true=hq * hd,
                                  backend=backend)
    x = x + o.reshape(b, s, d).astype(jnp.float32) * (1.0 / (hq * hd))
    hp = JOPS.bitpack(x.reshape(b * s, d), backend=backend)
    h1 = JOPS.binary_matmul_bn_sign_packed(
        hp, blk["w1"]["w_packed"], blk["fold1"]["tau"],
        blk["fold1"]["flip"], k_true=d, backend=backend)
    y = JOPS.binary_matmul_packed(h1, blk["w2"]["w_packed"], k_true=f,
                                  backend=backend)
    return x + y.reshape(b, s, d).astype(jnp.float32) * (1.0 / f)


def _ref_stages(packed, tokens, backend):
    """The reference forward, layer by layer: per layer the residual in,
    q, k, v and the attention output; then the final residual and the
    logits."""
    meta = packed["meta"]
    x = packed["embed"][jnp.asarray(tokens).astype(jnp.int32)]
    layers = []
    for blk, kind in zip(packed["blocks"], meta["kinds"]):
        window = None if kind == "global" else meta["window_size"]
        q, k, v, attn = _ref_attention_half(blk, meta, x, window, backend)
        layers.append({"x": np.array(x), "q": np.asarray(q),
                       "k": np.asarray(k), "v": np.asarray(v),
                       "attn": np.array(attn), "window": window})
        x = _ref_update_half(blk, meta, x, attn, backend)
    lp = JOPS.bitpack(x[:, -1], backend=backend)
    logits = JOPS.binary_matmul_packed(lp, packed["head"]["w_packed"],
                                       k_true=meta["d_model"],
                                       backend=backend).astype(jnp.float32)
    return layers, np.array(x), np.asarray(logits)


def _setup(cfg, seed, bsz, seq):
    """Reference params with the FFN's BN randomized from numpy in both
    trees, both packed trees (checked equal word for word) and ids."""
    params = TF.init_binary_lm(jax.random.PRNGKey(seed), cfg)
    rng = np.random.default_rng(seed)
    for blk in params["blocks"]:
        c = blk["bn1"]["gamma"].shape[0]
        sign = np.where(rng.random(c) < 0.3, -1.0, 1.0)
        blk["bn1"] = {
            "gamma": jnp.asarray(rng.uniform(0.3, 1.5, c) * sign,
                                 jnp.float32),
            "beta": jnp.asarray(rng.normal(size=c), jnp.float32),
            "mean": jnp.asarray(rng.normal(size=c) * 3, jnp.float32),
            "var": jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)}
    jp = TF.pack_transformer(params, cfg, max_len=seq)
    tp = TT.pack_transformer(CV.params_to_torch(params), CV.lm_spec(cfg),
                             max_len=seq, device="cpu")
    _assert_packed_equal(jp, tp)
    dtype = np.uint8 if cfg.vocab_size <= 256 else np.int32
    tokens = rng.integers(0, cfg.vocab_size, (bsz, seq)).astype(dtype)
    return jp, tp, tokens


def _words_equal(tw, jw):
    np.testing.assert_array_equal(CV.words_to_numpy(tw), np.asarray(jw))


def _assert_packed_equal(jp, tp):
    assert tp["meta"] == jp["meta"]
    assert len(tp["blocks"]) == len(jp["blocks"])
    for a, b in zip(jp["blocks"], tp["blocks"]):
        assert set(a) == set(b)
        for w in ("wq", "wk", "wv", "wo", "w1", "w2"):
            _words_equal(b[w]["w_packed"], a[w]["w_packed"])
            assert b[w]["k_true"] == a[w]["k_true"]
        for f in ("tau", "flip"):
            np.testing.assert_array_equal(b["fold1"][f].numpy(),
                                          np.asarray(a["fold1"][f]))
    _words_equal(tp["head"]["w_packed"], jp["head"]["w_packed"])
    np.testing.assert_array_equal(tp["embed"].numpy(),
                                  np.asarray(jp["embed"]))


def _flipped_bits(got, want):
    """Packed attention bits of the port against the reference's: the
    number that differ, after asserting that each lies where the reference
    value is within BIT_SLACK of 0."""
    flat = want.reshape(-1, want.shape[-2] * want.shape[-1])
    differ = (got.reshape(flat.shape) >= 0) != (flat >= 0)
    assert np.all(np.abs(flat[differ]) <= BIT_SLACK), flat[differ]
    return int(differ.sum())


def _check_stages(jp, tp, tokens, backend):
    """Mirror == the reference's forward; then each half of each port
    layer against the mirror's stage, the head, and the whole forward."""
    layers, x_last, logits = _ref_stages(jp, tokens, backend)
    np.testing.assert_array_equal(
        logits, np.asarray(TF.transformer_forward_packed(
            jp, jnp.asarray(tokens), backend=backend)))
    meta = tp["meta"]
    flips = 0
    for i, (blk, st) in enumerate(zip(tp["blocks"], layers)):
        x = torch.from_numpy(st["x"])
        q, k, v, attn = TT.attention_half(blk, meta, x, window=st["window"],
                                          backend="torch")
        for name, t in (("q", q), ("k", k), ("v", v)):
            np.testing.assert_array_equal(t.numpy(), st[name],
                                          err_msg=f"layer {i} {name}")
        np.testing.assert_allclose(attn.numpy(), st["attn"], **ATTN_TOL,
                                   err_msg=f"layer {i} attention")
        flips += _flipped_bits(attn.numpy(), st["attn"])
        x_next = layers[i + 1]["x"] if i + 1 < len(layers) else x_last
        np.testing.assert_array_equal(
            TT.update_half(blk, meta, x, torch.from_numpy(st["attn"]),
                           backend="torch").numpy(), x_next,
            err_msg=f"layer {i} residual")
    np.testing.assert_array_equal(
        TT.head_logits(tp, torch.from_numpy(x_last)).numpy(), logits)
    got = TT.transformer_forward_packed(tp, torch.from_numpy(tokens))
    assert got.dtype == torch.float32 and got.shape == logits.shape
    if flips == 0:
        np.testing.assert_array_equal(got.numpy(), logits)
    return flips


def _ragged():
    return dataclasses.replace(get_config("gemma2-9b", reduced=True),
                               name="ragged", d_model=72, head_dim=40,
                               d_ff=100, num_heads=6, num_kv_heads=3,
                               vocab_size=300)


@pytest.mark.parametrize("name,bsz,seq", [
    ("gemma2-9b", 2, 8), ("gemma2-9b", 2, 20), ("starcoder2-3b", 2, 8),
    ("starcoder2-3b", 2, 20), ("ragged", 2, 20)])
def test_forward_stage_by_stage_matches_reference(name, bsz, seq):
    """Reduced registry configs (S = 20 is longer than the window of 8,
    so the local layers mask) and a ragged spec (d_model 72, head_dim 40:
    two words with a tail, d_ff 100, GQA 6 over 3)."""
    cfg = _ragged() if name == "ragged" else get_config(name, reduced=True)
    jp, tp, tokens = _setup(cfg, 7, bsz, seq)
    flips = _check_stages(jp, tp, tokens, "jnp")
    print(f"{name} ({bsz}, {seq}): {flips} packed attention bits differ")


def test_forward_full_width_one_layer_matches_reference():
    """gemma2-9b at its published widths (d_model 3584, 16 query heads over
    8 KV heads of 256, d_ff 14336, softcap 50, window 4096) with one
    (local) layer and the vocab cut from 256000 to 4096 to keep the CPU
    run small: about 147 M float parameters a framework."""
    cfg = dataclasses.replace(get_config("gemma2-9b"), num_layers=1,
                              vocab_size=4096)
    jp, tp, tokens = _setup(cfg, 1, 1, 8)
    flips = _check_stages(jp, tp, tokens, "jnp")
    print(f"gemma2-9b full width (1, 8): {flips} attention bits differ")


def test_forward_matches_reference_pallas_kernels():
    """Reduced starcoder2-3b against the reference's Pallas kernels
    (interpret), stage by stage under the same rule."""
    jp, tp, tokens = _setup(get_config("starcoder2-3b", reduced=True), 5,
                            2, 8)
    flips = _check_stages(jp, tp, tokens, "pallas")
    print(f"starcoder2-3b pallas (2, 8): {flips} attention bits differ")


# ---------------------------------------------------------------------------
# Init and the serving seams
# ---------------------------------------------------------------------------

def test_init_binary_lm_matches_reference_shapes():
    cfg = get_config("gemma2-9b", reduced=True)
    want = TF.init_binary_lm(jax.random.PRNGKey(0), cfg)
    got = TT.init_binary_lm(torch.Generator().manual_seed(0),
                            CV.lm_spec(cfg))
    shapes = jax.tree_util.tree_map(lambda a: tuple(a.shape), want)
    assert jax.tree_util.tree_map(
        lambda t: tuple(t.shape), got,
        is_leaf=lambda t: isinstance(t, torch.Tensor)) == shapes
    for a, b in zip(want["blocks"], got["blocks"]):
        for f in ("gamma", "beta", "mean", "var"):
            np.testing.assert_array_equal(b["bn1"][f].numpy(),
                                          np.asarray(a["bn1"][f]))


def test_pack_transformer_needs_a_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device works")
    spec = TCFG.GEMMA2_9B.reduced()
    params = TT.init_binary_lm(torch.Generator().manual_seed(0), spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TT.pack_transformer(params, spec)


def test_serving_seams_on_a_transformer_tree():
    cfg = get_config("gemma2-9b", reduced=True)
    jp, tp, tokens = _setup(cfg, 3, 3, 12)
    assert TC.packed_kind(tp) == "transformer"
    assert TC.packed_input_shape(tp) == (12,) == JC.packed_input_shape(jp)
    assert TC.packed_dense_kw_words(tp) == JC.packed_dense_kw_words(jp)
    want = TT.transformer_forward_packed(tp, torch.from_numpy(tokens))
    for mode in TT.DENSE_STACK_MODES:
        fwd = TC.make_packed_forward(tp, dense_stack=mode)
        for dtype in (np.uint8, np.int32, np.int64):
            assert torch.equal(fwd(tokens.astype(dtype)), want)
        assert torch.equal(fwd(torch.from_numpy(tokens)), want)
    fwd = TC.make_packed_forward(tp)
    for bad in (tokens[:, :-1], tokens.astype(np.float32),
                tokens.astype(bool)):
        with pytest.raises(ValueError, match="integer"):
            fwd(bad)
    for mode in ("per_layer", "bogus"):
        with pytest.raises(ValueError, match="dense_stack"):
            TC.make_packed_forward(tp, dense_stack=mode)
        with pytest.raises(ValueError, match="dense_stack"):
            TT.transformer_forward_packed(tp, torch.from_numpy(tokens),
                                          dense_stack=mode)


@pytest.mark.parametrize("kind", ["bcnn", "bmlp"])
def test_packed_dense_kw_words_of_the_networks(kind):
    if kind == "bmlp":
        jspec = JC.BMLPSpec(sizes=(100, 40, 96, 33, 10))
        jp = JC.pack_bmlp(JC.init_bmlp(jax.random.PRNGKey(0), jspec), jspec)
        spec = CV.bmlp_spec(jspec)
        tp = TC.pack_bmlp(TC.init_bmlp(torch.Generator().manual_seed(0),
                                       spec), spec, device="cpu")
    else:
        jspec = JC.BCNNSpec(input_hw=(8, 8), stages=(
            JC.ConvStage(40), JC.ConvStage(64, True)), dense=(70, 10))
        jp = JC.pack_bcnn(JC.init_bcnn(jax.random.PRNGKey(0), jspec), jspec)
        spec = CV.bcnn_spec(jspec)
        tp = TC.pack_bcnn(TC.init_bcnn(torch.Generator().manual_seed(0),
                                       spec), spec, device="cpu")
    assert TC.packed_dense_kw_words(tp) == JC.packed_dense_kw_words(jp)
