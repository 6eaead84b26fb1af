"""The port's optimizers (``repro_torch.optim``) against the JAX
reference's (``repro.optim``) on the same numpy inputs, and the
reference's own property tests (``tests/test_trainer_optim.py``) repeated
on the port.

Tolerances (float32): the schedule within rtol 1e-6; an AdamW step's
params, ``mu``, ``nu`` and gradient norm within rtol 1e-6 / atol 1e-7
(the same operations in the same order, the norm's leaf sums added in the
reference's leaf order, which a tree of exact leaf sums holds bit for
bit); signSGD-EF's compressed gradients and error within rtol 1e-5 /
atol 1e-6 (each step's per-tensor mean is summed in another order, and
the error carries that last-place difference on).  The port updates in
place: every call here gets its own copies.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as JOPT
from repro.optim import compress as JCMP
from repro.optim.schedule import cosine_schedule as j_cosine
from repro_torch.optim import adamw as TOPT
from repro_torch.optim import compress as TCMP
from repro_torch.optim.schedule import cosine_schedule as t_cosine
from repro_torch.tree import sorted_leaves, tree_map

TOL = dict(rtol=1e-6, atol=1e-7)
EF_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(seed, scale=1.0):
    """A nested tree like a model's: dict keys out of sorted order, a
    list, a stacked leaf."""
    rng = np.random.default_rng(seed)

    def r(*shape):
        return (rng.normal(size=shape) * scale).astype(np.float32)
    return {"w": r(16, 8), "b": r(8), "stack": [{"z": r(3, 4, 5),
                                                   "a": r(3, 5)}],
            "head": {"w": r(8, 4)}}


def _j(tree):
    return jax.tree.map(jnp.asarray, tree)


def _t(tree):
    return tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _close(got, want, what="", tol=TOL):
    """Leaf for leaf by path, the port's tree against the reference's."""
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            _close(got[k], want[k], f"{what}/{k}", tol)
    elif isinstance(want, (list, tuple)):
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{what}/{i}", tol)
    else:
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   err_msg=what, **tol)


@pytest.mark.parametrize("warmup,total", [(100, 10000), (5, 60), (0, 1),
                                          (10, 10)])
def test_cosine_schedule(warmup, total):
    steps = np.arange(0, 61, dtype=np.int32)
    want = np.asarray(j_cosine(jnp.asarray(steps), warmup=warmup,
                               total=total))
    got = t_cosine(torch.from_numpy(steps), warmup=warmup, total=total)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    for s in (0, 7, 60):                  # a Python int step too
        assert float(t_cosine(s, warmup=warmup, total=total)) == \
            pytest.approx(float(want[s]), rel=1e-6, abs=1e-7)


@pytest.mark.parametrize("grad_scale,clip_latent,steps", [
    (1e-3, False, 3),         # the gradient clip inactive
    (10.0, False, 3),         # active: the global norm is far above 1
    (10.0, True, 3),          # and the latents clipped to [-1, 1]
])
def test_adamw_update(grad_scale, clip_latent, steps):
    cfg_kw = dict(lr=0.05, clip_latent=clip_latent)
    jcfg, tcfg = JOPT.AdamWConfig(**cfg_kw), TOPT.AdamWConfig(**cfg_kw)
    params = _tree(0)
    jp, tp = _j(params), _t(params)
    js, ts = JOPT.adamw_init(jp), TOPT.adamw_init(tp)
    assert ts["step"].dtype == torch.int32 and ts["step"].dim() == 0
    for i in range(steps):
        g = _tree(10 + i, grad_scale)
        lr_scale = np.float32(0.5 + 0.25 * i)
        jp, js, jgn = JOPT.adamw_update(jcfg, jp, _j(g), js,
                                        jnp.asarray(lr_scale))
        out = TOPT.adamw_update(tcfg, tp, _t(g), ts,
                                torch.tensor(lr_scale))
        assert out[0] is tp and out[1]["mu"] is ts["mu"]   # in place
        tp, ts, tgn = out
        np.testing.assert_allclose(float(tgn), float(jgn), rtol=1e-6)
        _close(tp, jp, "params")
        _close(ts["mu"], js["mu"], "mu")
        _close(ts["nu"], js["nu"], "nu")
        assert int(ts["step"]) == int(js["step"]) == i + 1
    if clip_latent:
        assert max(float(t.abs().max()) for t in sorted_leaves(tp)) <= 1.0
    if grad_scale > 1:
        assert float(tgn) > 1.0          # the clip was active


def test_global_norm_adds_leaf_sums_in_the_reference_order():
    """Every leaf sum exact (one element each), so only the order of the
    additions rounds: 2^24 first and eight 1s after it stay 2^24, the 1s
    first make 2^24 + 8.  Keys inserted out of sorted order."""
    tree = {f"z{i}": np.ones(1, np.float32) for i in range(8)}
    tree["m"] = np.full(1, 4096.0, np.float32)
    want = JOPT._global_norm(_j(tree))
    got = TOPT.global_norm(_t(tree))
    assert float(got) == float(want) == 4096.0
    np.testing.assert_allclose(float(TOPT.global_norm(_t(_tree(3)))),
                               float(JOPT._global_norm(_j(_tree(3)))),
                               rtol=1e-6)


def test_adamw_update_slices_a_large_leaf(monkeypatch):
    """A leaf longer than one slice updates as one elementwise pass."""
    monkeypatch.setattr(TOPT, "SLICE", 7)
    cfg = TOPT.AdamWConfig(lr=0.05)
    p = _tree(4)
    g = _tree(5)
    tp, ts, _ = TOPT.adamw_update(cfg, _t(p), _t(g), TOPT.adamw_init(_t(p)))
    jp, js, _ = JOPT.adamw_update(JOPT.AdamWConfig(lr=0.05), _j(p), _j(g),
                                  JOPT.adamw_init(_j(p)))
    _close(tp, jp, "params")
    _close(ts["nu"], js["nu"], "nu")


@pytest.mark.parametrize("steps", [1, 4])
def test_signsgd_ef_compress(steps):
    params = _tree(0)
    je, te = JCMP.signsgd_ef_init(_j(params)), TCMP.signsgd_ef_init(
        _t(params))
    for i in range(steps):
        g = _tree(20 + i)
        jc, je = JCMP.signsgd_ef_compress(_j(g), je)
        tg = _t(g)
        tc, te2 = TCMP.signsgd_ef_compress(tg, te)
        assert tc is tg and te2 is te                      # in place
        _close(tc, jc, "compressed", EF_TOL)
        _close(te, je, "error", EF_TOL)


def test_signsgd_ef_error_feedback_property():
    """The reference's EF invariant on the port: the sum of the sent
    values tracks the sum of the true gradients, the residual bounded by
    the last error; each step sends one magnitude a tensor."""
    gen = torch.Generator().manual_seed(0)
    err = TCMP.signsgd_ef_init({"w": torch.zeros(64)})
    total_true = torch.zeros(64)
    total_sent = torch.zeros(64)
    for _ in range(50):
        g = {"w": torch.randn(64, generator=gen)}
        total_true += g["w"]
        comp, err = TCMP.signsgd_ef_compress(g, err)
        total_sent += comp["w"]
    resid = (total_true - total_sent - err["w"]).abs().max()
    assert float(resid) < 1e-4
    assert len(torch.unique(torch.round(comp["w"], decimals=6))) <= 2


def test_adamw_latent_clip():
    cfg = TOPT.AdamWConfig(lr=1.0, weight_decay=0.0, clip_latent=True)
    params = {"w": torch.tensor([0.95, -0.95])}
    state = TOPT.adamw_init(params)
    new_p, _, _ = TOPT.adamw_update(cfg, params,
                                    {"w": torch.tensor([-1.0, 1.0])}, state)
    assert float(new_p["w"].abs().max()) <= 1.0


def test_adamw_descends_quadratic():
    cfg = TOPT.AdamWConfig(lr=0.1, weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = TOPT.adamw_init(params)
    for _ in range(200):
        params, state, _ = TOPT.adamw_update(cfg, params,
                                             {"w": 2 * params["w"]}, state)
    assert float(params["w"].abs().max()) < 0.2
