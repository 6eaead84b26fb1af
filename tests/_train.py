"""Shared set-up of the training parity tests (``test_torch_train_*.py``,
``test_torch_trainer_system.py``): a reference train state carried across
with ``repro_torch.convert.train_state_to_torch``, one numpy batch fed to
both packages, both steps, and the comparison.  Not a test module.

Contract (configs in float32, one step from the same state and batch):

* ``loss``, ``grad_norm`` and ``lr`` within rtol 1e-5;
* ``mu`` and ``nu``, leaf for leaf, within 1e-4 of each value plus 1e-5 of
  the largest value of the tree;
* every param within 1e-6 wherever the step's gradient is above 1e-5 of
  the tree's largest.  At the first step Adam divides each gradient by
  its own magnitude, so where a gradient is float noise (a top-1 router's
  or a dead unit's, 1e-11 where others are 1e-3) its sign, and so the
  update, is noise in the reference too: there the params are held to
  the step's bound, 2 lr (1 + weight_decay |p|) apart at most;
* in the binary modes every leaf within [-1, 1].
"""
import dataclasses

import jax
import jax.numpy as jnp
import jax.tree_util as jtu
import numpy as np
import torch

from repro.configs import get_config
from repro.train import trainer as JTR
from repro_torch import convert as CV
from repro_torch.train import trainer as TTR

from _zoo import leaves, np_of

STEP_TOL = dict(rtol=1e-5)
MOMENT_RTOL, MOMENT_ATOL = 1e-4, 1e-5
PARAM_ATOL, NOISE = 1e-6, 1e-5
B, S = 2, 16


def configs(name, mode="float", dtype="float32", reduced=True):
    cfg = dataclasses.replace(get_config(name, quant=mode, reduced=reduced),
                              dtype=dtype)
    return cfg, CV.arch_config(cfg)


def train_configs(**kw):
    kw = {"lr": 1e-3, "warmup": 2, "total_steps": 10, **kw}
    return JTR.TrainConfig(**kw), TTR.TrainConfig(**kw)


def batch_np(cfg, seed=0, b=B, s=S, enc_len=10):
    rng = np.random.default_rng(seed)
    out = {"tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
           "labels": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32)}
    if cfg.encoder_layers:
        out["enc_embeds"] = rng.normal(
            size=(b, enc_len, cfg.d_model)).astype(np.float32)
    return out


def jbatch(nb):
    return {k: jnp.asarray(v) for k, v in nb.items()}


def tbatch(nb):
    return {k: torch.from_numpy(np.array(v)) for k, v in nb.items()}


def states(cfg, tc, seed=0):
    """The reference's initial state and the port's copy of it."""
    js = JTR.init_train_state(jax.random.PRNGKey(seed), cfg, tc)
    return js, CV.train_state_to_torch(js)


def both_steps(name, mode="float", nb=None, **tc_kw):
    """One step of each package from the same state and numpy batch:
    ((ref state, ref metrics), (port state, port metrics), lr)."""
    cfg, tcfg = configs(name, mode)
    jtc, ttc = train_configs(**tc_kw)
    js, ts = states(cfg, jtc)
    nb = batch_np(cfg) if nb is None else nb
    jout = jax.jit(JTR.make_train_step(cfg, jtc))(js, jbatch(nb))
    tout = TTR.make_train_step(tcfg, ttc)(ts, tbatch(nb))
    return jout, tout, jtc.lr


def _np_leaves(tree, port):
    if port:
        return [np_of(t) for _, t in leaves(tree)]
    return [np.asarray(a, dtype=np.float32) if np.asarray(a).dtype.kind
            == "f" else np.asarray(a) for a in jtu.tree_leaves(tree)]


def assert_moments_close(want, got, what, rtol=MOMENT_RTOL,
                         atol=MOMENT_ATOL):
    """Leaf for leaf within ``rtol`` of each value plus ``atol`` of the
    tree's largest value."""
    w, g = _np_leaves(want, False), _np_leaves(got, True)
    assert len(w) == len(g), what
    top = max(np.abs(a).max() for a in w)
    for i, (a, b) in enumerate(zip(w, g)):
        np.testing.assert_allclose(b, a, rtol=rtol, atol=atol * top,
                                   err_msg=f"{what} leaf {i}")


def assert_step_close(jout, tout, lr, *, grads=None, wd=0.1,
                      param_atol=PARAM_ATOL, step_tol=STEP_TOL,
                      moment_tol=(MOMENT_RTOL, MOMENT_ATOL)):
    """The module docstring's contract.  ``grads``: the reference's
    step gradient per leaf (numpy, its leaf order), which picks the
    params held to ``param_atol``; by default taken from ``mu`` (at the
    first step ``mu`` is 0.1 x the clipped gradient)."""
    (js, jm), (ts, tm) = jout, tout
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]),
                                   err_msg=k, **step_tol)
    for k in ("mu", "nu"):
        assert_moments_close(js["opt"][k], ts["opt"][k], k, *moment_tol)
    assert int(ts["opt"]["step"]) == int(js["opt"]["step"])
    if grads is None:
        grads = _np_leaves(js["opt"]["mu"], False)
    top = max(np.abs(g).max() for g in grads)
    w, g = _np_leaves(js["params"], False), _np_leaves(ts["params"], True)
    assert len(w) == len(g) == len(grads)
    for i, (a, b, gr) in enumerate(zip(w, g, grads)):
        d = np.abs(a - b)
        held = np.abs(gr) > NOISE * top
        assert (d[held] <= param_atol).all(), (i, d[held].max())
        assert (d <= 2 * lr * (1 + wd * np.abs(a)) + param_atol).all(), \
            (i, d.max())
