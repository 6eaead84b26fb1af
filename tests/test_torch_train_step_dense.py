"""One train step of the port (``repro_torch.train.trainer``) against the
reference's jitted step, from the same state and numpy batch: the dense
and vision-backbone registry configs (reduced, float32) in ``float`` and
``binary`` mode, ``binary_weight`` on starcoder2-3b, ``microbatches``,
``compress_grads`` and ``grads_bf16`` on starcoder2-3b, and ``loss_fn``
(``test_torch_train_step_mixed.py`` has the other five configs).

The contract is ``tests/_train.py``'s.  ``grads_bf16`` differentiates
with respect to bfloat16 casts, so its moments are held within 2^-5 of
each value plus 1e-2 of the tree's largest and its gradient norm within
rtol 1e-4 (bfloat16 gradients rounded along other paths); its params as
the others'.
"""
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import model as JM
from repro_torch.models import model as TM

import _train as T

NAMES = ("nemotron-4-15b", "chatglm3-6b", "gemma2-9b", "starcoder2-3b",
         "qwen2-vl-72b")


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
    jout, tout, lr = T.both_steps("starcoder2-3b", "binary_weight")
    T.assert_step_close(jout, tout, lr)


@pytest.mark.parametrize("mode", ["float", "binary"])
def test_microbatches(mode):
    cfg, _ = T.configs("starcoder2-3b", mode)
    jout, tout, lr = T.both_steps("starcoder2-3b", mode,
                                  nb=T.batch_np(cfg, b=4), microbatches=4)
    T.assert_step_close(jout, tout, lr)


def test_compress_grads():
    cfg, _ = T.configs("starcoder2-3b")
    jout, tout, lr = T.both_steps("starcoder2-3b", compress_grads=True)
    T.assert_step_close(jout, tout, lr)
    T.assert_moments_close(jout[0]["ef_error"], tout[0]["ef_error"],
                           "ef_error")


@pytest.mark.parametrize("mode", ["float", "binary"])
def test_grads_bf16(mode):
    jout, tout, lr = T.both_steps("starcoder2-3b", mode, grads_bf16=True)
    T.assert_step_close(jout, tout, lr,
                        step_tol=dict(rtol=1e-4),
                        moment_tol=(2.0 ** -5, 1e-2))


@pytest.mark.parametrize("s,masked", [(600, 0.0), (600, 0.3), (7, 0.5),
                                      (7, 1.0)])
def test_loss_fn(s, masked):
    """S past one 512-row chunk and not a multiple of it (the last chunk
    padded), some labels -1, or all of them (the loss is then 0).  Held to
    the reference's ``loss_fn`` and to the cross-entropy of ``logits_fn``
    over the labels that count, within rtol 1e-5."""
    cfg, tcfg = T.configs("starcoder2-3b")
    jp, ts = T.states(cfg, T.train_configs()[0])
    nb = T.batch_np(cfg, b=2, s=s)
    rng = np.random.default_rng(s)
    nb["labels"][rng.random(nb["labels"].shape) < masked] = -1
    want = float(JM.loss_fn(jp["params"], cfg, T.jbatch(nb)))
    got = TM.loss_fn(ts["params"], tcfg, T.tbatch(nb))
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(float(got), want, rtol=1e-5, atol=1e-7)
    logits = TM.logits_fn(ts["params"], tcfg, T.tbatch(nb)).float()
    labels = torch.from_numpy(nb["labels"]).long()
    if (labels >= 0).any():
        ce = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                             labels.reshape(-1), ignore_index=-1)
        np.testing.assert_allclose(float(got), float(ce), rtol=1e-5)
    else:
        assert float(got) == 0.0
