"""The port's model zoo (``repro_torch.models.model``) against the JAX
reference, serving: ``prefill`` and ``decode_step`` on all ten reduced
registry configs in the three quant modes (``logits_fn`` is
``test_torch_zoo_logits.py``).

Contract.  The configs run in float32 (``dataclasses.replace(cfg,
dtype="float32")``) and every output is held within rtol = atol = 1e-4:
on the weights packed by ``maybe_pack_tree`` (float mode: the float
weights) ``prefill``'s last-token logits and every leaf of its cache,
then three ``decode_step``s from that cache, logits and cache.
The encoder-decoder's prefill returns no cache, as the reference's; its
decode runs from ``init_cache`` with ``encdec.precompute_cross_kv``.  In
``binary`` mode the packed dots are integers, so no packed activation
bit may differ for the logits to agree (the integer dots themselves are
held exactly in ``test_torch_zoo_layers.py``); the configs' own bfloat16
is held stage by stage in ``test_torch_zoo_stages.py``.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import encdec as JED
from repro.models import model as JM
from repro_torch import convert as CV
from repro_torch.models import encdec as TED
from repro_torch.models import model as TM
from repro_torch.tree import tree_map

from _zoo import (F32_TOL, MODES, NAMES, assert_close, assert_tree_close,
                  batch, configs, weights)

B, S, MAX_LEN, STEPS = 2, 12, 16, 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _copy(tree):
    return tree_map(torch.clone, tree)


@functools.lru_cache(maxsize=None)
def _serving(name, mode):
    """Prefill and decode on the packed weights, both packages; each
    reference run once for the module."""
    cfg, tcfg = configs(name, mode)
    jp, tp = weights(cfg, 0, packed=mode != "float")
    rng = np.random.default_rng(1)
    jb, tb = batch(cfg, rng, B, S)
    tl, tc = TM.prefill(tp, tcfg, tb, MAX_LEN)
    # a decode step writes into the cache it is given: keep copies
    out = {"prefill": ((tl, _copy(tc)), JM.prefill(jp, cfg, jb, MAX_LEN))}
    jc = out["prefill"][1][1]
    if cfg.encoder_layers:
        jenc = JED.encode(jp["encdec"], cfg, jb["enc_embeds"])
        tenc = TED.encode(tp["encdec"], tcfg, tb["enc_embeds"])
        jc = JM.init_cache(jp, cfg, B, MAX_LEN, enc_len=10)
        jc["cross"] = JED.precompute_cross_kv(jp["encdec"], cfg, jenc)
        tc = TM.init_cache(tp, tcfg, B, MAX_LEN, enc_len=10)
        tc["cross"] = TED.precompute_cross_kv(tp["encdec"], tcfg, tenc)
        out["cross"] = (tc["cross"], jc["cross"])
    steps = []
    for i in range(STEPS):
        tok = rng.integers(0, cfg.vocab_size, (B, 1)).astype(np.int32)
        jl, jc = JM.decode_step(jp, cfg, jnp.asarray(tok), jc,
                                jnp.int32(S + i))
        tl, tc = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tc, S + i)
        steps.append(((tl, _copy(tc)), (jl, jc)))
    out["decode"] = steps
    return out


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_prefill_logits_and_cache(name, mode):
    (tl, tc), (jl, jc) = _serving(name, mode)["prefill"]
    assert_close(tl, jl, F32_TOL, "prefill logits")
    if jc is None:
        assert tc is None
    else:
        assert_tree_close(tc, jc, F32_TOL, "prefill cache")


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", NAMES)
def test_decode_steps(name, mode):
    out = _serving(name, mode)
    if "cross" in out:
        assert_tree_close(out["cross"][0], out["cross"][1], F32_TOL,
                          "cross K/V")
    for i, ((tl, tc), (jl, jc)) in enumerate(out["decode"]):
        assert_close(tl, jl, F32_TOL, f"decode {i} logits")
        assert_tree_close(tc, jc, F32_TOL, f"decode {i} cache")


def test_int8_kv_cache_prefill_and_decode():
    """``kv_cache_dtype='int8'``: the int8 values and bfloat16 scales of
    the prefill cache equal the reference's exactly (round half to even on
    both sides), then a decode step within the float32 tolerance."""
    cfg, _ = configs("gemma2-9b", "float")
    cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    tcfg = CV.arch_config(cfg)
    jp, tp = weights(cfg, 6, packed=False)
    jb, tb = batch(cfg, np.random.default_rng(7), B, S)
    tl, tc = TM.prefill(tp, tcfg, tb, MAX_LEN)
    jl, jc = JM.prefill(jp, cfg, jb, MAX_LEN)
    assert_close(tl, jl, F32_TOL, "prefill logits")
    for seg_t, seg_j in zip(tc["stack"], jc["stack"]):
        for t, j in zip(seg_t, seg_j):
            assert t["k"].dtype == torch.int8
            for f in ("k", "v", "k_scale", "v_scale"):
                assert_close(t[f], j[f], dict(rtol=0, atol=0), f)
    tok = np.array([[3], [200]], np.int32)
    tl, _ = TM.decode_step(tp, tcfg, torch.from_numpy(tok), tc, S)
    jl, _ = JM.decode_step(jp, cfg, jnp.asarray(tok), jc, jnp.int32(S))
    assert_close(tl, jl, F32_TOL, "decode logits")
