"""One train step of the port against the reference's jitted step, from
the same state and numpy batch, on the SSM, MoE, encoder-decoder and
hybrid registry configs (reduced, float32) in ``float`` and ``binary``
mode, ``binary_weight`` on qwen3-moe-30b-a3b; and ``remat`` on the
port's forward, and only where a gradient is taken
(``test_torch_train_step_dense.py`` has the other five configs).

The step's contract is ``tests/_train.py``'s.  ``remat`` must change no
value: the forward and every gradient ``torch.equal`` with it on and
off, while the tensors autograd keeps outside the recomputed layers
shrink.
"""
import pytest
import torch

from repro_torch.models import model as TM
from repro_torch.tree import leaves_with_path, tree_map

import _train as T

NAMES = ("mamba2-1.3b", "llama4-maverick-400b-a17b", "qwen3-moe-30b-a3b",
         "whisper-base", "recurrentgemma-9b")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("mode", ["float", "binary"])
@pytest.mark.parametrize("name", NAMES)
def test_train_step_matches_reference(name, mode):
    jout, tout, lr = T.both_steps(name, mode)
    T.assert_step_close(jout, tout, lr)
    if mode == "binary":
        for _, t in T.leaves(tout[0]["params"]):
            assert float(t.abs().max()) <= 1.0


def test_binary_weight_train_step():
    jout, tout, lr = T.both_steps("qwen3-moe-30b-a3b", "binary_weight")
    T.assert_step_close(jout, tout, lr)


def _forward_and_grads(params, cfg, batch, remat):
    leaves = [t for _, t in leaves_with_path(params)]
    kept = [0]

    def pack(t):
        kept[0] += t.numel() * t.element_size()
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        x = TM.forward(params, cfg, batch, remat=remat)
    r = torch.randn(x.shape, generator=torch.Generator().manual_seed(0))
    grads = torch.autograd.grad((x.float() * r).sum(), leaves,
                                allow_unused=True)
    return x.detach(), grads, kept[0]


@pytest.mark.parametrize("name,mode", [
    ("starcoder2-3b", "float"), ("starcoder2-3b", "binary"),
    ("mamba2-1.3b", "float"), ("qwen3-moe-30b-a3b", "float"),
    ("whisper-base", "binary"), ("recurrentgemma-9b", "float")])
def test_remat_changes_no_value(name, mode):
    cfg, tcfg = T.configs(name, mode)
    _, ts = T.states(cfg, T.train_configs()[0])
    params = tree_map(lambda t: t.requires_grad_(True), ts["params"])
    batch = T.tbatch(T.batch_np(cfg))
    x0, g0, kept0 = _forward_and_grads(params, tcfg, batch, False)
    x1, g1, kept1 = _forward_and_grads(params, tcfg, batch, True)
    assert torch.equal(x0, x1)
    assert len(g0) == len(g1)
    for a, b in zip(g0, g1):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert kept1 < kept0 / 2, (kept1, kept0)
    assert any(a is not None and bool(a.abs().max() > 0) for a in g1)


@pytest.mark.parametrize("name", ["whisper-base", "starcoder2-3b"])
def test_remat_only_where_a_gradient_is_taken(name, monkeypatch):
    """A prefill on params that need no gradient (serving), or a forward
    under ``no_grad``, runs no layer under ``torch.utils.checkpoint``; a
    forward on params that need one does."""
    from repro_torch.models import common as TC
    calls = []

    def counted(fn, *args, **kw):
        calls.append(fn)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kw)

    monkeypatch.setattr(TC, "checkpoint", counted)
    cfg, tcfg = T.configs(name)
    _, ts = T.states(cfg, T.train_configs()[0])
    batch = T.tbatch(T.batch_np(cfg))
    TM.prefill(ts["params"], tcfg, batch, 32)
    assert calls == []
    params = tree_map(lambda t: t.requires_grad_(True)
                      if t.is_floating_point() else t, ts["params"])
    with torch.no_grad():
        TM.forward(params, tcfg, batch)
    assert calls == []
    TM.forward(params, tcfg, batch)
    assert calls
