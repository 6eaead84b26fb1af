"""One train step of the port at starcoder2-3b's own bfloat16 activations
(reduced), in ``float`` and ``binary`` mode, against the reference's step
from the same state and numpy batch: the bfloat16 casts, the STE masks
around bfloat16 activations and the chunked loss on bfloat16 hidden
states, differentiated.

Contract.  Against the reference's step run op by op
(``jax.disable_jit``), which rounds every op to bfloat16 as the port
does: the loss within rtol 1e-5, ``grad_norm`` within rtol 5e-4, and
``mu`` (0.1 x the clipped gradient) within 2e-2 of each leaf's largest
value.  Measured on the CPU over batch seeds 0-2: loss 0 to 2.5e-07,
``grad_norm`` 2.2e-06 to 5.8e-05, ``mu`` 4.6e-04 to 4.9e-03.

Against the reference's jitted step, in ``float`` mode: the loss within
rtol 1e-3, ``grad_norm`` within rtol 5e-3, ``mu`` within 5e-2 of each
leaf's largest (measured: 1.9e-04 to 2.3e-04, 1.4e-04 to 1.1e-03, 1.3e-02
to 1.5e-02).  XLA fuses the jitted step's bfloat16 elementwise ops and
skips their roundings.  In ``binary`` mode that moves activations across
0 and STE masks across +-1, so the jitted step is no reference there:
for batch seeds 1 and 2 its loss reads 1.8e-03 and 1.3e-02 from the
port's and its ``mu`` up to 1.3 of a leaf's largest, where the op-by-op
step reads 8.0e-08 and 1.2e-03.
"""
import jax
import numpy as np
import pytest
import torch

from repro.train import trainer as JTR
from repro_torch.train import trainer as TTR

import _train as T

NAME = "starcoder2-3b"
OP_BY_OP = dict(loss=1e-5, grad_norm=5e-4, mu=2e-2)
JITTED = dict(loss=1e-3, grad_norm=5e-3, mu=5e-2)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _steps(mode, seed, jit):
    cfg, tcfg = T.configs(NAME, mode, dtype="bfloat16")
    assert tcfg.activation_dtype == torch.bfloat16
    jtc, ttc = T.train_configs()
    js, ts = T.states(cfg, jtc)
    nb = T.batch_np(cfg, seed=seed)
    ref = JTR.make_train_step(cfg, jtc)
    if jit:
        jout = jax.jit(ref)(js, T.jbatch(nb))
    else:
        with jax.disable_jit():
            jout = ref(js, T.jbatch(nb))
    return jout, TTR.make_train_step(tcfg, ttc)(ts, T.tbatch(nb))


def _assert_close(jout, tout, tol):
    (js, jm), (ts, tm) = jout, tout
    for k in ("loss", "grad_norm"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), rtol=tol[k],
                                   err_msg=k)
    np.testing.assert_allclose(float(tm["lr"]), float(jm["lr"]), rtol=1e-6)
    want = T._np_leaves(js["opt"]["mu"], False)
    got = T._np_leaves(ts["opt"]["mu"], True)
    assert len(want) == len(got)
    for i, (a, b) in enumerate(zip(want, got)):
        top = np.abs(a).max()
        assert np.abs(a - b).max() <= tol["mu"] * top, (i, top)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("mode", ["float", "binary"])
def test_bf16_step_matches_reference_op_by_op(mode, seed):
    jout, tout = _steps(mode, seed, jit=False)
    _assert_close(jout, tout, OP_BY_OP)
    if mode == "binary":
        for _, t in T.leaves(tout[0]["params"]):
            assert float(t.abs().max()) <= 1.0


def test_bf16_float_step_matches_jitted_reference():
    _assert_close(*_steps("float", 0, jit=True), JITTED)
