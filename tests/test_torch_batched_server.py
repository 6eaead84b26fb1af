"""The port's ``BatchedServer`` (``repro_torch.train.serve``) against the
reference's on the same weights and requests: a ragged mix of prompts
over a ring of slots (``examples/serve_binary_lm.py``'s mix), slot reuse,
truncation when the shared cache runs out, and resubmission.

Contract.  Float32 configs; every request's emitted tokens, its
``truncated`` flag and the order of the returned requests are equal, and
after the run every leaf of the server's cache (freed slots zeroed) is
within rtol = atol = 1e-4 of the reference's.  The reference jits its
decode step, the port runs it eagerly.
"""
import numpy as np
import pytest
import torch

from repro.train import serve as JSV
from repro_torch.models import linear as TLN
from repro_torch.models import model as TM
from repro_torch.train import serve as TSV

from repro_torch.tree import leaves_with_path

from _zoo import F32_TOL, assert_tree_close, configs, weights


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _requests(cfg, n, prompt_len, max_new, seed):
    rng = np.random.default_rng(seed)
    prompts = [rng.integers(0, cfg.vocab_size,
                            (prompt_len + i % 3,)).astype(np.int32)
               for i in range(n)]
    return ([JSV.Request(rid=i, prompt=p, max_new=max_new + i % 2)
             for i, p in enumerate(prompts)],
            [TSV.Request(rid=i, prompt=torch.from_numpy(p.copy()),
                         max_new=max_new + i % 2)
             for i, p in enumerate(prompts)])


def _run(name, mode, slots, max_len, n, prompt_len, max_new, seed):
    cfg, tcfg = configs(name, mode)
    jp, tp = weights(cfg, seed, packed=mode != "float")
    jsrv = JSV.BatchedServer(cfg, jp, batch_slots=slots, max_len=max_len)
    tsrv = TSV.BatchedServer(tcfg, tp, batch_slots=slots, max_len=max_len,
                             device="cpu")
    jreq, treq = _requests(cfg, n, prompt_len, max_new, seed + 1)
    return jsrv, tsrv, jreq, treq


def _check(jdone, tdone, jsrv, tsrv):
    assert [r.rid for r in tdone] == [r.rid for r in jdone]
    for t, j in zip(tdone, jdone):
        assert t.truncated == j.truncated, t.rid
        assert t.out == [int(v) for v in j.out], t.rid
    assert tsrv.idx == jsrv.idx
    assert_tree_close(tsrv.cache, jsrv.cache, F32_TOL, "server cache")


# (config, mode): every family's cache layout in the slot ring: GQA
# attention with a local ring (gemma2-9b), MQA and the RG-LRU state
# (recurrentgemma-9b), the SSM state (mamba2-1.3b), MoE (qwen3), the
# encoder-decoder's self and cross caches (whisper-base), and the
# example's starcoder2-3b in binary_weight.
CASES = [("starcoder2-3b", "binary_weight"), ("gemma2-9b", "binary"),
         ("recurrentgemma-9b", "binary_weight"), ("mamba2-1.3b", "binary"),
         ("qwen3-moe-30b-a3b", "binary"), ("whisper-base", "float")]


@pytest.mark.parametrize("name,mode", CASES)
def test_ragged_mix_with_slot_reuse(name, mode):
    """Six requests over four slots: two wait for a freed slot, whose
    cache rows are zeroed before reuse."""
    jsrv, tsrv, jreq, treq = _run(name, mode, slots=4, max_len=40, n=6,
                                  prompt_len=5, max_new=4, seed=0)
    jdone = jsrv.submit_and_run(jreq)
    tdone = tsrv.submit_and_run(treq)
    assert all(not r.truncated for r in tdone) and len(tdone) == 6
    _check(jdone, tdone, jsrv, tsrv)


@pytest.mark.parametrize("name,mode", CASES[:3])
def test_truncation_and_resubmission(name, mode):
    """A cache of 14 positions: in-flight requests come back truncated
    with their partial output, queued ones truncated and empty; a second
    call restarts every request cleanly on a fresh window."""
    jsrv, tsrv, jreq, treq = _run(name, mode, slots=2, max_len=14, n=5,
                                  prompt_len=4, max_new=5, seed=3)
    jdone = jsrv.submit_and_run(jreq)
    tdone = tsrv.submit_and_run(treq)
    assert any(r.truncated and r.out for r in tdone)
    assert any(r.truncated and not r.out for r in tdone)
    _check(jdone, tdone, jsrv, tsrv)
    jdone = jsrv.submit_and_run(jreq[:2])
    tdone = tsrv.submit_and_run(treq[:2])
    _check(jdone, tdone, jsrv, tsrv)


def test_step_factories_match_the_model_functions():
    cfg, tcfg = configs("gemma2-9b", "binary")
    _, tp = weights(cfg, 5, packed=True)
    toks = torch.from_numpy(np.arange(16, dtype=np.int32).reshape(2, 8))
    logits, cache = TSV.make_prefill_step(tcfg, 12)(tp, {"tokens": toks})
    want_logits, want_cache = TM.prefill(tp, tcfg, {"tokens": toks}, 12)
    assert torch.equal(logits, want_logits)
    step = TSV.make_decode_step(tcfg)
    got = step(tp, cache, toks[:, :1], 8)
    want = TM.decode_step(tp, tcfg, toks[:, :1], want_cache, 8)
    assert torch.equal(got[0], want[0])


@pytest.mark.parametrize("entry", ["init_model", "maybe_pack_tree",
                                   "BatchedServer"])
def test_entry_points_default_to_the_card(monkeypatch, entry):
    """Without ``device=`` the zoo's entry points place their trees on the
    card, so without one they raise instead of running on the CPU."""
    cfg, tcfg = configs("starcoder2-3b", "binary")
    _, tp = weights(cfg, 0, packed=False)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    calls = {
        "init_model": lambda: TM.init_model(torch.Generator(), tcfg),
        "maybe_pack_tree": lambda: TLN.maybe_pack_tree(tp, tcfg.quant),
        "BatchedServer": lambda: TSV.BatchedServer(tcfg, tp, 2, 8),
    }
    with pytest.raises(RuntimeError, match="no CUDA device"):
        calls[entry]()


def test_server_updates_its_one_cache_in_place():
    """Each step writes into the server's one cache: the tensors it holds
    after a run are the ones it made, and a decode step returns the cache
    it was given."""
    cfg, tcfg = configs("recurrentgemma-9b", "float")
    _, tp = weights(cfg, 3, packed=False)
    tsrv = TSV.BatchedServer(tcfg, tp, batch_slots=2, max_len=16,
                             device="cpu")
    before = [t for _, t in leaves_with_path(tsrv.cache)]
    _, treq = _requests(cfg, 3, 4, 3, 4)
    tsrv.submit_and_run(treq)
    after = [t for _, t in leaves_with_path(tsrv.cache)]
    assert len(after) == len(before)
    assert all(a is b for a, b in zip(after, before))
    cache = TM.init_cache(tp, tcfg, 2, 16)
    _, got = TM.decode_step(tp, tcfg, torch.zeros((2, 1), dtype=torch.int32),
                            cache, 0)
    assert got is cache
