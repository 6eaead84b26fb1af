"""The model zoo's modules one by one against the JAX reference on the
same inputs (numpy seeds) and weights (the reference's, crossed over):
``common``, ``linear``, ``ffn``, ``attention``, ``moe``, ``ssm``,
``rglru``, ``encdec``, the stack's helpers and the tree converter.

Contract.  Packed words, ``alpha``, MoE dispatch indices, int8 KV values
and every packed linear in ``binary`` mode (an integer dot times alpha)
are equal exactly; both routes of a binary dot give the same integers.
Float outputs in float32 agree within rtol = atol = 1e-4 (the reference
runs XLA's CPU kernels, the port PyTorch's: the same operations in
another order of rounding).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config
from repro.core import binarize as JB
from repro.core.quantize import GemmStrategy as JGS
from repro.models import attention as JA
from repro.models import common as JC
from repro.models import encdec as JED
from repro.models import ffn as JF
from repro.models import linear as JLN
from repro.models import model as JM
from repro.models import moe as JMOE
from repro.models import rglru as JR
from repro.models import ssm as JS
from repro.models import transformer as JTF
from repro_torch import convert as CV
from repro_torch.core import binarize as TB
from repro_torch.core.quantize import GemmStrategy as TGS
from repro_torch.kernels import ops as TOPS
from repro_torch.models import attention as TA
from repro_torch.models import common as TC
from repro_torch.models import encdec as TED
from repro_torch.models import ffn as TF_
from repro_torch.models import linear as TLN
from repro_torch.models import moe as TMOE
from repro_torch.models import rglru as TR
from repro_torch.models import ssm as TS
from repro_torch.models import transformer as TTF
from repro_torch.tree import leaves_with_path, tree_stack

from _zoo import (F32_TOL, NAMES, assert_close, assert_tree_close, configs,
                  np_of)

EXACT = dict(rtol=0, atol=0)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rand(seed, *shape, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale
         ).astype(np.float32)
    return jnp.asarray(x), torch.from_numpy(x.copy())


def _cross(tree):
    return CV.tree_to_torch(tree)


def _with_quant(name, mode, **quant):
    cfg, _ = configs(name, mode)
    if quant:
        cfg = dataclasses.replace(cfg, quant=dataclasses.replace(cfg.quant,
                                                                 **quant))
    return cfg, CV.arch_config(cfg)


# ---------------------------------------------------------------------------
# common
# ---------------------------------------------------------------------------

def test_norms():
    jx, tx = _rand(0, 2, 5, 24)
    js, ts = _rand(1, 24, scale=0.3)
    jb, tb = _rand(2, 24)
    assert_close(TC.apply_rmsnorm({"scale": ts}, tx),
                 JC.apply_rmsnorm({"scale": js}, jx), F32_TOL)
    assert_close(TC.apply_layernorm({"scale": ts, "bias": tb}, tx),
                 JC.apply_layernorm({"scale": js, "bias": jb}, jx), F32_TOL)
    assert_close(TC.apply_rmsnorm({"scale": ts}, tx.to(torch.bfloat16)),
                 JC.apply_rmsnorm({"scale": js}, jx.astype(jnp.bfloat16)),
                 dict(rtol=2 ** -7, atol=2 ** -7))


@pytest.mark.parametrize("fraction", [1.0, 0.5])
def test_rope(fraction):
    jx, tx = _rand(3, 2, 7, 3, 16)
    pos = np.random.default_rng(4).integers(0, 300, (2, 7)).astype(np.int32)
    assert_close(TC.apply_rope(tx, torch.from_numpy(pos), fraction=fraction,
                               base=10000.0),
                 JC.apply_rope(jx, jnp.asarray(pos), fraction=fraction,
                               base=10000.0), F32_TOL)


def test_mrope_and_its_text_identity():
    jx, tx = _rand(5, 2, 6, 2, 32)
    pos3 = np.random.default_rng(6).integers(0, 50, (3, 2, 6)).astype(
        np.int32)
    got = TC.apply_mrope(tx, torch.from_numpy(pos3), sections=(4, 6, 6),
                         base=1e6)
    assert_close(got, JC.apply_mrope(jx, jnp.asarray(pos3),
                                     sections=(4, 6, 6), base=1e6), F32_TOL)
    pos = torch.arange(6)[None].expand(2, 6)
    assert_close(TC.apply_mrope(tx, pos[None].expand(3, 2, 6),
                                sections=(4, 6, 6)),
                 TC.apply_rope(tx, pos), dict(rtol=1e-6, atol=1e-6))
    with pytest.raises(ValueError, match="sections"):
        TC.apply_mrope(tx, pos[None].expand(3, 2, 6), sections=(4, 4, 4))


def test_sinusoids_softcap_embeddings_dense():
    assert_close(TC.sinusoidal_positions(40, 24),
                 JC.sinusoidal_positions(40, 24), F32_TOL)
    jx, tx = _rand(7, 3, 9, scale=80.0)
    assert_close(TC.softcap(tx, 30.0), JC.softcap(jx, 30.0), F32_TOL)
    assert TC.softcap(tx, None) is tx
    jt, tt = _rand(8, 50, 16)
    toks = np.array([[0, 49, 3], [7, 7, 1]], np.int32)
    for dt, jdt in ((torch.float32, jnp.float32),
                    (torch.bfloat16, jnp.bfloat16)):
        e = TC.embed({"table": tt}, torch.from_numpy(toks), dt)
        assert_close(e, JC.embed({"table": jt}, jnp.asarray(toks), jdt),
                     EXACT)
    jh, th = _rand(9, 2, 3, 16)
    assert_close(TC.unembed({"table": tt}, th, torch.float32),
                 JC.unembed({"table": jt}, jh, jnp.float32), F32_TOL)
    jw, tw = _rand(10, 16, 5)
    assert_close(TC.dense({"w": tw}, th), JC.dense({"w": jw}, jh), F32_TOL)


# ---------------------------------------------------------------------------
# binarize additions and linear
# ---------------------------------------------------------------------------

def test_binarize_ste_forward_and_backward():
    x = np.array([-2.0, -1.0, -0.5, 0.0, 0.3, 1.0, 1.5], np.float32)
    g = np.arange(1, 8, dtype=np.float32)
    want_y = JB.binarize_ste(jnp.asarray(x))
    want_g = jax.vjp(JB.binarize_ste, jnp.asarray(x))[1](jnp.asarray(g))[0]
    tx = torch.from_numpy(x).requires_grad_(True)
    y = TB.binarize_ste(tx)
    y.backward(torch.from_numpy(g))
    assert_close(y.detach(), want_y, EXACT)
    assert_close(tx.grad, want_g, EXACT)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_binary_dot_unpacked(dtype):
    jx, tx = _rand(11, 3, 70)
    jw, tw = _rand(12, 9, 70)
    jwp, twp = JB.pack_bits(jw), TB.pack_bits(tw)
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    assert_close(TB.binary_dot_unpacked_mxu(tx, twp, 70, dtype=tdt),
                 JB.binary_dot_unpacked_mxu(jx, jwp, 70, dtype=jdt),
                 F32_TOL if dtype == "float32" else dict(rtol=2 ** -7,
                                                          atol=2 ** -7))


@pytest.mark.parametrize("shape", [(64, 40), (3, 100, 33), (2, 2, 31, 64)])
def test_pack_linear_words_and_alpha_equal(shape):
    """Words and alpha equal the reference's bit for bit, stacked or not
    (``alpha`` sums in the reference's order, ``linear.row_mean``)."""
    jw, tw = _rand(13, *shape)
    want = JLN.pack_linear({"w": jw})
    got = TLN.pack_linear({"w": tw})
    np.testing.assert_array_equal(CV.words_to_numpy(got["w_packed"]),
                                  np.asarray(want["w_packed"]))
    assert_close(got["alpha"], want["alpha"], EXACT)


def test_maybe_pack_tree_packs_only_linears():
    cfg, tcfg = _with_quant("recurrentgemma-9b", "binary")
    jp = JM.init_model(jax.random.PRNGKey(0), cfg)
    tp = _cross(jp)
    got = TLN.maybe_pack_tree(tp, tcfg.quant, device="cpu")
    want = JLN.maybe_pack_tree(jp, cfg.quant)
    assert_tree_close(got, want, EXACT, "packed tree")
    assert got["embed"]["table"] is tp["embed"]["table"]
    flt = TLN.maybe_pack_tree(tp, dataclasses.replace(
        tcfg.quant, mode=type(tcfg.quant.mode)("float")), device="cpu")
    pairs = list(zip(leaves_with_path(flt), leaves_with_path(tp)))
    assert pairs and all(a is b for (_, a), (_, b) in pairs)


@pytest.mark.parametrize("strategy", ["vpu_xnor", "mxu_unpack", "auto"])
@pytest.mark.parametrize("mode,packed", [
    ("float", False), ("binary_weight", False), ("binary", False),
    ("binary_weight", True), ("binary", True)])
def test_apply_linear(mode, strategy, packed):
    """Every mode, strategy and form (float mode has no packed form); a
    packed binary linear is an integer dot times alpha, so it is held
    exactly."""
    cfg, tcfg = _with_quant("gemma2-9b", mode,
                            strategy=JGS(strategy))
    assert tcfg.quant.strategy == TGS(strategy)
    jx, tx = _rand(14, 2, 5, 72)
    jw, tw = _rand(15, 72, 40, scale=0.1)
    jp, tp = {"w": jw}, {"w": tw}
    if packed:
        jp, tp = JLN.pack_linear(jp), TLN.pack_linear(tp)
    want = JLN.apply_linear(jp, jx, cfg.quant, dtype=jnp.float32)
    got = TLN.apply_linear(tp, tx, tcfg.quant, dtype=torch.float32)
    tol = EXACT if packed and mode == "binary" else F32_TOL
    assert_close(got, want, tol)


def test_binary_routes_give_the_same_integers():
    """The XNOR route (``ops.bitpack`` + ``ops.binary_matmul_packed``)
    and the unpack route on the same packed weights, rows on both sides
    of the AUTO rule's 256; the XNOR route's packed activations equal the
    reference's ``pack_bits`` word for word."""
    _, tcfg = _with_quant("gemma2-9b", "binary")
    tw = torch.from_numpy(np.random.default_rng(16).normal(
        size=(70, 33)).astype(np.float32))
    tp = TLN.pack_linear({"w": tw})
    for rows in (3, 257):
        jx, tx = _rand(17 + rows, rows, 70)
        outs = [TLN.apply_linear(tp, tx, dataclasses.replace(
            tcfg.quant, strategy=TGS(s)), dtype=torch.float32)
            for s in ("vpu_xnor", "mxu_unpack", "auto")]
        assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0],
                                                             outs[2])
        np.testing.assert_array_equal(
            CV.words_to_numpy(TOPS.bitpack(tx)), np.asarray(
                JB.pack_bits(JB.sign_pm1(jx))))
    assert tcfg.quant.resolve_strategy(256, 1, 1) == TGS.VPU_XNOR
    assert tcfg.quant.resolve_strategy(257, 1, 1) == TGS.MXU_UNPACK


def test_xnor_route_on_cuda_backend_refuses_cpu_tensors():
    _, tcfg = _with_quant("gemma2-9b", "binary")
    tp = TLN.pack_linear({"w": torch.ones(64, 8)})
    q = dataclasses.replace(tcfg.quant, backend="cuda")
    with pytest.raises(ValueError, match="CUDA"):
        TLN.apply_linear(tp, torch.ones(2, 64), q)


# ---------------------------------------------------------------------------
# ffn
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("ffn_type", ["swiglu", "geglu", "gelu", "relu2",
                                      "silu"])
def test_ffn(ffn_type):
    cfg, _ = _with_quant("gemma2-9b", "float")
    cfg = dataclasses.replace(cfg, ffn_type=ffn_type)
    tcfg = CV.arch_config(cfg)
    jp = JF.init_ffn(jax.random.PRNGKey(1), cfg)
    jx, tx = _rand(20, 2, 3, cfg.d_model)
    assert_close(TF_.apply_ffn(_cross(jp), tcfg, tx),
                 JF.apply_ffn(jp, cfg, jx), F32_TOL)


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kw", [
    dict(causal=True), dict(causal=True, window=3, attn_softcap=20.0),
    dict(causal=False), dict(causal=True, q_offset=5),
    dict(causal=True, window=4, q_chunk=3, kv_chunk=4)],
    ids=["causal", "window_softcap", "bidirectional", "q_offset",
         "chunks"])
def test_chunked_attention(kw):
    """GQA 6 over 2; the last case walks several q and kv chunks with
    padded tails."""
    jq, tq = _rand(21, 2, 11, 6, 8)
    jk, tk = _rand(22, 2, 11 + kw.get("q_offset", 0), 2, 8)
    jv, tv = _rand(23, 2, 11 + kw.get("q_offset", 0), 2, 8)
    assert_close(TA.chunked_attention(tq, tk, tv, **kw),
                 JA.chunked_attention(jq, jk, jv, **kw), F32_TOL)


@pytest.mark.parametrize("name", ["gemma2-9b", "chatglm3-6b",
                                  "qwen2-vl-72b", "qwen3-moe-30b-a3b"])
def test_attention_forward_with_kv(name):
    """Standard, partial (chatglm) and M-RoPE (qwen2-vl) rotary, QK-norm
    (qwen3), local window (gemma2)."""
    cfg, tcfg = _with_quant(name, "float")
    jp = JA.init_attention(jax.random.PRNGKey(2), cfg)
    jx, tx = _rand(24, 2, 10, cfg.d_model)
    pos = np.broadcast_to(np.arange(10, dtype=np.int32), (2, 10))
    kind = cfg.attention_pattern[0]
    kind = kind if kind in ("global", "local") else "global"
    want = JA.attention_forward(jp, cfg, jx, positions=jnp.asarray(pos),
                                kind=kind, return_kv=True)
    got = TA.attention_forward(_cross(jp), tcfg, tx,
                               positions=torch.from_numpy(pos.copy()),
                               kind=kind, return_kv=True)
    assert_tree_close(got, want, F32_TOL)


def test_cross_attention_forward_and_decode():
    cfg, tcfg = _with_quant("whisper-base", "float")
    jp = JA.init_attention(jax.random.PRNGKey(3), cfg, cross=True)
    tp = _cross(jp)
    jx, tx = _rand(25, 2, 4, cfg.d_model)
    je, te = _rand(26, 2, 9, cfg.d_model)
    pos = np.broadcast_to(np.arange(4, dtype=np.int32), (2, 4))
    assert_close(TA.attention_forward(tp, tcfg, tx, kv_src=te,
                                      positions=torch.from_numpy(pos.copy())),
                 JA.attention_forward(jp, cfg, jx, kv_src=je,
                                      positions=jnp.asarray(pos)), F32_TOL)
    jk, tk = _rand(27, 2, 9, cfg.num_kv_heads, cfg.head_dim)
    jv, tv = _rand(28, 2, 9, cfg.num_kv_heads, cfg.head_dim)
    assert_close(TA.cross_attention_decode(tp, tcfg, tx[:, :1], tk, tv),
                 JA.cross_attention_decode(jp, cfg, jx[:, :1], jk, jv),
                 F32_TOL)
    with pytest.raises(NotImplementedError, match="cross_attention_decode"):
        TA.attention_decode(tp, tcfg, tx[:, :1], {}, 0, cross_kv=(tk, tv))


@pytest.mark.parametrize("kv", ["bf16", "int8"])
@pytest.mark.parametrize("kind,max_len", [("local", 64), ("local", 5),
                                          ("global", 24)])
def test_attention_decode_walk(kind, max_len, kv):
    """Twenty decode steps from an empty cache: the local ring wraps
    (window 8, and a ring of 5 when max_len is below the window), the
    global cache fills; int8 values and scales equal exactly."""
    cfg, _ = _with_quant("gemma2-9b", "float")
    cfg = dataclasses.replace(cfg, kv_cache_dtype=kv, attn_softcap=50.0)
    tcfg = CV.arch_config(cfg)
    jp = JA.init_attention(jax.random.PRNGKey(4), cfg)
    tp = _cross(jp)
    jc = JA.init_attn_cache(cfg, 2, max_len, kind)
    tc = TA.init_attn_cache(tcfg, 2, max_len, kind)
    assert_tree_close(tc, jc, EXACT, "empty cache")
    for idx in range(20):
        jx, tx = _rand(30 + idx, 2, 1, cfg.d_model)
        jy, jc = JA.attention_decode(jp, cfg, jx, jc, jnp.int32(idx),
                                     kind=kind)
        ty, tc = TA.attention_decode(tp, tcfg, tx, tc, idx, kind=kind)
        assert_close(ty, jy, F32_TOL, f"step {idx}")
        if kv == "int8":
            assert_tree_close(tc, jc, EXACT, f"step {idx} cache")
        else:
            assert_tree_close(tc, jc, F32_TOL, f"step {idx} cache")


def test_kv_quantize_rounds_half_to_even():
    x = np.array([[0.5, 1.5, 2.5, -0.5, 127.0]], np.float32)
    jq, js = JA._kv_quantize(jnp.asarray(x))
    tq, ts = TA._kv_quantize(torch.from_numpy(x))
    assert_close(tq, jq, EXACT)
    assert_close(ts, js, EXACT)
    assert_close(TA._kv_dequantize(tq, ts), JA._kv_dequantize(jq, js), EXACT)


# ---------------------------------------------------------------------------
# moe
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("t,k,e,c", [(16, 2, 4, 4), (9, 1, 4, 8),
                                     (30, 3, 5, 4)])
def test_dispatch_indices(seed, t, k, e, c):
    """Equal to the reference's, overflowing slots dropped alike."""
    sel = np.random.default_rng(seed).integers(0, e, (t, k)).astype(np.int32)
    want = JMOE._dispatch_indices(jnp.asarray(sel), e, c)
    got = TMOE._dispatch_indices(torch.from_numpy(sel), e, c)
    for g, w in zip(got, want):
        assert_close(g, w, EXACT)


def test_capacity_and_top_k_ties():
    for name in ("llama4-maverick-400b-a17b", "qwen3-moe-30b-a3b"):
        for full in (False, True):
            cfg, tcfg = _with_quant(name, "float")
            if full:
                cfg = get_config(name)
                tcfg = CV.arch_config(cfg)
            for tg in (1, 7, 12, 100, 4096):
                assert TMOE._capacity(tg, tcfg.moe) == JMOE._capacity(
                    tg, cfg.moe)
    probs = np.array([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.4, 0.1],
                      [0.3, 0.2, 0.3, 0.2]], np.float32)
    for k in (1, 2, 3):
        wv, wi = jax.lax.top_k(jnp.asarray(probs), k)
        gv, gi = TMOE.top_k(torch.from_numpy(probs), k)
        assert_close(gi, wi, EXACT)
        assert_close(gv, wv, EXACT)


@pytest.mark.parametrize("mode", ["float", "binary_weight", "binary"])
@pytest.mark.parametrize("name", ["llama4-maverick-400b-a17b",
                                  "qwen3-moe-30b-a3b"])
def test_apply_moe(name, mode):
    cfg, tcfg = _with_quant(name, mode)
    jp = JMOE.init_moe(jax.random.PRNGKey(5), cfg)
    jx, tx = _rand(40, 2, 12, cfg.d_model)
    assert_close(TMOE.apply_moe(_cross(jp), tcfg, tx),
                 JMOE.apply_moe(jp, cfg, jx), F32_TOL)


@pytest.mark.parametrize("name", ["llama4-maverick-400b-a17b",
                                  "qwen3-moe-30b-a3b"])
def test_moe_ample_capacity_matches_dense(name):
    """With capacity for every choice no token drops, so the dispatched
    MoE equals the dense oracle, on both sides."""
    cfg, _ = _with_quant(name, "float")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=8.0))
    tcfg = CV.arch_config(cfg)
    jp = JMOE.init_moe(jax.random.PRNGKey(6), cfg)
    tp = _cross(jp)
    jx, tx = _rand(41, 2, 10, cfg.d_model)
    dense = TMOE.moe_dense_reference(tp, tcfg, tx)
    assert_close(dense, JMOE.moe_dense_reference(jp, cfg, jx), F32_TOL)
    assert_close(TMOE.apply_moe(tp, tcfg, tx), np_of(dense), F32_TOL)


# ---------------------------------------------------------------------------
# ssm
# ---------------------------------------------------------------------------

def test_segsum_and_ssd_chunked():
    ja, ta = _rand(50, 2, 3, 8, scale=0.3)
    assert_close(TS._segsum(ta), JS._segsum(ja), F32_TOL)
    jx, tx = _rand(51, 2, 16, 4, 8)
    jl, tl = _rand(52, 2, 16, 4, scale=0.1)
    jb, tb = _rand(53, 2, 16, 2, 6)
    jc, tc = _rand(54, 2, 16, 2, 6)
    js, ts = _rand(55, 2, 4, 8, 6)
    want = JS.ssd_chunked(jx, -jnp.abs(jl), jb, jc, 4, init_state=js)
    got = TS.ssd_chunked(tx, -tl.abs(), tb, tc, 4, init_state=ts)
    assert_tree_close(got, want, F32_TOL)


@pytest.mark.parametrize("mode", ["float", "binary"])
@pytest.mark.parametrize("fused", [True, False])
def test_mamba2_forward_cache_and_decode(fused, mode):
    """Fused and split projections; a sequence not a multiple of the
    chunk, continued from its cache, then decode steps."""
    cfg, _ = _with_quant("mamba2-1.3b", mode)
    cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
        cfg.ssm, fused_proj=fused))
    tcfg = CV.arch_config(cfg)
    jp = JS.init_mamba2(jax.random.PRNGKey(7), cfg)
    if mode != "float":
        jp = JLN.maybe_pack_tree(jp, cfg.quant)
    tp = _cross(jp)
    assert set(tp) == set(TS.init_mamba2(torch.Generator().manual_seed(0),
                                         tcfg))
    jx, tx = _rand(56, 2, 11, cfg.d_model)
    jy, jc = JS.mamba2_forward(jp, cfg, jx, return_cache=True)
    ty, tc = TS.mamba2_forward(tp, tcfg, tx, return_cache=True)
    assert_close(ty, jy, F32_TOL)
    assert_tree_close(tc, jc, F32_TOL, "cache")
    jx2, tx2 = _rand(57, 2, 5, cfg.d_model)
    assert_close(TS.mamba2_forward(tp, tcfg, tx2, init_cache=tc),
                 JS.mamba2_forward(jp, cfg, jx2, init_cache=jc), F32_TOL)
    for i in range(3):
        jx1, tx1 = _rand(58 + i, 2, 1, cfg.d_model)
        jy, jc = JS.mamba2_decode(jp, cfg, jx1, jc)
        ty, tc = TS.mamba2_decode(tp, tcfg, tx1, tc)
        assert_close(ty, jy, F32_TOL, f"decode {i}")
        assert_tree_close(tc, jc, F32_TOL, f"decode {i} cache")


# ---------------------------------------------------------------------------
# rglru
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["float", "binary"])
def test_rglru_forward_cache_and_decode(mode):
    cfg, tcfg = _with_quant("recurrentgemma-9b", mode)
    jp = JR.init_rglru_block(jax.random.PRNGKey(8), cfg)
    if mode != "float":
        jp = JLN.maybe_pack_tree(jp, cfg.quant)
    tp = _cross(jp)
    jx, tx = _rand(60, 2, 9, cfg.d_model)
    jy, jc = JR.rglru_block_forward(jp, cfg, jx, return_cache=True)
    ty, tc = TR.rglru_block_forward(tp, tcfg, tx, return_cache=True)
    assert_close(ty, jy, F32_TOL)
    assert_tree_close(tc, jc, F32_TOL, "cache")
    jx2, tx2 = _rand(61, 2, 4, cfg.d_model)
    assert_close(TR.rglru_block_forward(tp, tcfg, tx2, init_cache=tc),
                 JR.rglru_block_forward(jp, cfg, jx2, init_cache=jc),
                 F32_TOL)
    for i in range(3):
        jx1, tx1 = _rand(62 + i, 2, 1, cfg.d_model)
        jy, jc = JR.rglru_block_decode(jp, cfg, jx1, jc)
        ty, tc = TR.rglru_block_decode(tp, tcfg, tx1, tc)
        assert_close(ty, jy, F32_TOL, f"decode {i}")
        assert_tree_close(tc, jc, F32_TOL, f"decode {i} cache")


# ---------------------------------------------------------------------------
# encdec, the stack's helpers, trees
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["float", "binary"])
def test_encdec(mode):
    cfg, tcfg = _with_quant("whisper-base", mode)
    jp = JED.init_encdec_stack(jax.random.PRNGKey(9), cfg)
    if mode != "float":
        jp = JLN.maybe_pack_tree(jp, cfg.quant)
    tp = _cross(jp)
    jf, tf = _rand(70, 2, 7, cfg.d_model)
    jenc = JED.encode(jp, cfg, jf)
    tenc = TED.encode(tp, tcfg, tf)
    assert_close(tenc, jenc, F32_TOL, "encode")
    jx, tx = _rand(71, 2, 5, cfg.d_model)
    pos = np.broadcast_to(np.arange(5, dtype=np.int32), (2, 5))
    assert_close(TED.decode_train(tp, tcfg, tx, tenc,
                                  torch.from_numpy(pos.copy())),
                 JED.decode_train(jp, cfg, jx, jenc, jnp.asarray(pos)),
                 F32_TOL, "decode_train")
    jc = JED.init_encdec_cache(jp, cfg, 2, 8, 7)
    tc = TED.init_encdec_cache(tp, tcfg, 2, 8, 7)
    assert_tree_close(tc, jc, EXACT, "empty cache")
    jc["cross"] = JED.precompute_cross_kv(jp, cfg, jenc)
    tc["cross"] = TED.precompute_cross_kv(tp, tcfg, tenc)
    assert_tree_close(tc["cross"], jc["cross"], F32_TOL, "cross")
    for i in range(3):
        jx1, tx1 = _rand(72 + i, 2, 1, cfg.d_model)
        jy, jc = JED.decode_step(jp, cfg, jx1, jc, jnp.int32(i))
        ty, tc = TED.decode_step(tp, tcfg, tx1, tc, i)
        assert_close(ty, jy, F32_TOL, f"decode {i}")
        assert_tree_close(tc, jc, F32_TOL, f"decode {i} cache")


@pytest.mark.parametrize("name", NAMES)
def test_segments_and_cache_layout(name):
    cfg, tcfg = _with_quant(name, "float")
    assert TTF.segments_of(tcfg) == JTF.segments_of(cfg)
    for full in (True, False):
        ref = get_config(name, reduced=not full)
        assert TTF.segments_of(CV.arch_config(ref)) == JTF.segments_of(ref)
    if not cfg.encoder_layers:
        assert_tree_close(TTF.init_cache(tcfg, 3, 10),
                          JTF.init_cache(cfg, 3, 10), EXACT, "cache")


@pytest.mark.parametrize("s,window", [(3, 8), (8, 8), (13, 8), (13, 5)])
def test_ring_from_full(s, window):
    jk, tk = _rand(80, 2, s, 2, 4)
    assert_close(TTF._ring_from_full(tk, window),
                 JTF._ring_from_full(jk, window), EXACT)
    assert_close(TTF._ring_from_full(tk[..., 0], window),
                 JTF._ring_from_full(jk[..., 0], window), EXACT)


def test_tree_converter_keeps_kinds_and_words():
    words = np.array([[0, 1, 0xFFFFFFFF, 0x80000000]], np.uint32)
    tree = {"a": (jnp.ones((2,), jnp.bfloat16), [jnp.asarray(words)]),
            "b": jnp.arange(3, dtype=jnp.int8), "c": None}
    got = CV.tree_to_torch(tree)
    assert isinstance(got["a"], tuple) and isinstance(got["a"][1], list)
    assert got["a"][0].dtype == torch.float32
    assert got["a"][1][0].dtype == torch.int32
    np.testing.assert_array_equal(CV.words_to_numpy(got["a"][1][0]), words)
    assert got["b"].dtype == torch.int8 and got["c"] is None
    kept = CV.tree_to_torch(tree, float_dtype=None)
    assert kept["a"][0].dtype == torch.bfloat16
    stacked = tree_stack([{"x": (torch.ones(2),)}] * 3)
    assert isinstance(stacked["x"], tuple) and stacked["x"][0].shape == (3, 2)
