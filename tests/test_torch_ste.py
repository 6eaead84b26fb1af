"""The paper's "train with STE, then pack" signature on the port, against
the JAX reference on the CPU.

* ``core.binarize.bitplane_dot`` and ``core.binary_layers.
  apply_binary_conv2d_float`` exactly (integers in float64 on the port);
* the straight-through gradients of a cross-entropy through
  ``bmlp_forward_float`` / ``bcnn_forward_float(..., ste=True)`` against
  ``jax.grad`` on small specs with random BN, within rtol 1e-4 plus 1e-6
  of the leaf's largest gradient (the port's ±1 dots and convs run in
  float64, the reference's in float32); max pooling sends a window's
  gradient to its first maximum, as the reference's does;
* ``ste=True`` changes no forward value (``ste=False`` keeps the numbers
  the rest of the suite holds);
* the paper pipeline: a few STE steps of AdamW with latent clipping, then
  ``pack_*`` and the packed forward equal to the float forward within
  the reference's tolerance (``tests/test_system.py``: rtol 1e-5, atol
  1e-4);
* a reduced binary LM trained by the port's step, packed by
  ``maybe_pack_tree`` (the same words as the reference's packing of the
  same tree): its logits equal ``logits_fn`` on its latent tree within
  rtol = atol = 1e-4, the zoo's float32 tolerance.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.core import binarize as JB
from repro.core import binary_layers as JL
from repro.models import cnn as JC
from repro.models import linear as JLN
from repro_torch import convert as CV
from repro_torch.core import binarize as TB
from repro_torch.core import binary_layers as TL
from repro_torch.models import cnn as TC
from repro_torch.models import linear as TLN
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TOPT
from repro_torch.train import trainer as TR
from repro_torch.tree import sorted_leaves, tree_map

import _train as T
from _zoo import assert_tree_close

PIPELINE_TOL = dict(rtol=1e-5, atol=1e-4)

BMLP = dict(sizes=(16, 32, 24, 10))
BCNN = dict(input_hw=(8, 8), c_in=3,
            stages=((16, False), (16, True), (32, True)), dense=(32, 10))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: the suite runs in several processes at once."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bitplane_dot_is_exact():
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (5, 3, 70)).astype(np.uint8)
    w = np.where(rng.random((9, 70)) < 0.5, -1.0, 1.0).astype(np.float32)
    got = TB.bitplane_dot(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.int32
    exact = x.astype(np.int64) @ w.astype(np.int64).T
    np.testing.assert_array_equal(got.numpy(), exact)
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(JB.bitplane_dot(jnp.asarray(x),
                                                jnp.asarray(w))))


@pytest.mark.parametrize("b,hw,c_in,c_out,stride,padding", [
    (2, (8, 8), 3, 5, 1, "SAME"), (1, (9, 7), 4, 6, 2, "VALID"),
    (2, (6, 6), 33, 8, 2, "SAME"), (1, (5, 5), 64, 3, 1, "VALID")])
def test_apply_binary_conv2d_float_is_exact(b, hw, c_in, c_out, stride,
                                            padding):
    rng = np.random.default_rng(c_in)
    x = rng.normal(size=(b, *hw, c_in)).astype(np.float32)
    w = rng.uniform(-1, 1, (c_out, 3, 3, c_in)).astype(np.float32)
    want = np.asarray(JL.apply_binary_conv2d_float(
        {"w": jnp.asarray(w)}, jnp.asarray(x), stride=stride,
        padding=padding))
    for ste in (False, True):
        got = TL.apply_binary_conv2d_float(
            {"w": torch.from_numpy(w)}, torch.from_numpy(x), stride=stride,
            padding=padding, ste=ste)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want)


def test_clip_latent():
    w = torch.tensor([-3.0, -1.0, -0.5, 0.0, 0.999, 1.0, 2.5])
    np.testing.assert_array_equal(
        TB.clip_latent(w).numpy(),
        np.asarray(JB.clip_latent(jnp.asarray(w.numpy()))))


def _specs(kind):
    if kind == "bmlp":
        return JC.BMLPSpec(**BMLP), TC.BMLPSpec(**BMLP)
    st = tuple(JC.ConvStage(c, p) for c, p in BCNN["stages"])
    jspec = JC.BCNNSpec(input_hw=BCNN["input_hw"], c_in=BCNN["c_in"],
                        stages=st, dense=BCNN["dense"])
    return jspec, CV.bcnn_spec(jspec)


def _net(kind, seed=0, batch=8):
    """Reference params with random BN, the port's copy, a uint8 batch
    and labels."""
    jspec, tspec = _specs(kind)
    init = JC.init_bmlp if kind == "bmlp" else JC.init_bcnn
    jp = init(jax.random.PRNGKey(seed), jspec)
    rng = np.random.default_rng(seed)
    for bn in jp["bns" if kind == "bmlp" else "conv_bns"] + \
            ([] if kind == "bmlp" else jp["dense_bns"]):
        c = bn["gamma"].shape[0]
        bn["gamma"] = jnp.asarray(rng.uniform(0.5, 2, c) * np.where(
            rng.random(c) < 0.2, -1, 1), jnp.float32)
        bn["beta"] = jnp.asarray(rng.normal(size=c), jnp.float32)
        bn["mean"] = jnp.asarray(rng.normal(size=c) * 3, jnp.float32)
        bn["var"] = jnp.asarray(rng.uniform(1, 20, c), jnp.float32)
    shape = (batch, jspec.sizes[0]) if kind == "bmlp" else \
        (batch, *jspec.input_hw, jspec.c_in)
    x = rng.integers(0, 256, shape).astype(np.uint8)
    y = rng.integers(0, 10, batch)
    return jspec, tspec, jp, CV.params_to_torch(jp), x, y


def _j_forward(kind, spec):
    if kind == "bmlp":
        return lambda p, x, ste: JC.bmlp_forward_float(p, x, ste=ste)
    return lambda p, x, ste: JC.bcnn_forward_float(p, x, spec, ste=ste)


def _t_forward(kind, spec):
    if kind == "bmlp":
        return lambda p, x, ste: TC.bmlp_forward_float(p, x, ste=ste)
    return lambda p, x, ste: TC.bcnn_forward_float(p, x, spec, ste=ste)


def _t_loss(fwd, p, x, y):
    return F.cross_entropy(fwd(p, x, True), y)


@pytest.mark.parametrize("kind", ["bmlp", "bcnn"])
def test_ste_gradients_match_jax_grad(kind):
    jspec, tspec, jp, tp, x, y = _net(kind)
    jfwd, tfwd = _j_forward(kind, jspec), _t_forward(kind, tspec)

    def jloss(p):
        logits = jfwd(p, jnp.asarray(x), True)
        return -jnp.mean(jax.nn.log_softmax(logits)[jnp.arange(len(y)), y])

    jl, jg = jax.value_and_grad(jloss)(jp)
    tp = tree_map(lambda t: t.requires_grad_(True), tp)
    tl = _t_loss(tfwd, tp, torch.from_numpy(x), torch.from_numpy(y))
    tl.backward()
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    tg = tree_map(lambda t: t.grad if t.grad is not None
                  else torch.zeros_like(t), tp)
    for path, want in jax.tree_util.tree_leaves_with_path(jg):
        got = tg
        for k in path:
            got = got[getattr(k, "key", getattr(k, "idx", None))]
        want = np.asarray(want)
        np.testing.assert_allclose(
            got.numpy(), want, rtol=1e-4,
            atol=1e-6 * max(float(np.abs(want).max()), 1e-30),
            err_msg=jax.tree_util.keystr(path))
    # the latent weights past the first dense layer learn
    ws = tg["layers"][1:] if kind == "bmlp" else tg["convs"] + tg["denses"]
    assert all(float(w["w"].abs().max()) > 0 for w in ws)


@pytest.mark.parametrize("kind", ["bmlp", "bcnn"])
def test_ste_changes_no_forward_value(kind):
    jspec, tspec, jp, tp, x, _ = _net(kind, seed=1)
    tfwd = _t_forward(kind, tspec)
    xt = torch.from_numpy(x)
    a, b = tfwd(tp, xt, False), tfwd(tp, xt, True)
    assert torch.equal(a, b)
    np.testing.assert_allclose(
        a.numpy(), np.asarray(_j_forward(kind, jspec)(jp, jnp.asarray(x),
                                                      False)),
        rtol=1e-5, atol=1e-4)


@pytest.mark.parametrize("kind", ["bmlp", "bcnn"])
def test_paper_pipeline_train_then_pack(kind):
    """STE training of the latent weights with AdamW and latent clipping
    (the batch norms stay as they are), then pack once and run packed:
    the packed forward equals the float forward of the trained weights."""
    _, tspec, _, tp, x, y = _net(kind, seed=2)
    fwd = _t_forward(kind, tspec)
    xt, yt = torch.from_numpy(x), torch.from_numpy(y)
    names = ("layers",) if kind == "bmlp" else ("convs", "denses")
    cfg = TOPT.AdamWConfig(lr=0.01, clip_latent=True)
    weights = {k: tp[k] for k in names}
    before = tree_map(torch.clone, weights)
    opt = TOPT.adamw_init(weights)
    for _ in range(5):
        leaves = tree_map(lambda t: t.detach().requires_grad_(True), weights)
        _t_loss(fwd, {**tp, **leaves}, xt, yt).backward()
        grads = tree_map(lambda t: t.grad if t.grad is not None
                         else torch.zeros_like(t), leaves)
        TOPT.adamw_update(cfg, weights, grads, opt)
    moved = [not torch.equal(a, b) for a, b in
             zip(sorted_leaves(before), sorted_leaves(weights))]
    assert sum(moved) >= len(moved) - 1       # the BMLP's first layer
    assert all(float(w.abs().max()) <= 1.0 for w in sorted_leaves(weights))
    pack = TC.pack_bmlp if kind == "bmlp" else TC.pack_bcnn
    packed = pack(tp, tspec, device="cpu")
    run = TC.bmlp_forward_packed if kind == "bmlp" else \
        TC.bcnn_forward_packed
    got = run(packed, xt)
    want = fwd(tp, xt, False)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **PIPELINE_TOL)


def test_trained_binary_lm_packs_to_its_latent_logits():
    cfg, tcfg = T.configs("starcoder2-3b", "binary")
    _, ttc = T.train_configs(lr=1e-2)
    _, state = T.states(cfg, T.train_configs()[0])
    step = TR.make_train_step(tcfg, ttc)
    for seed in range(3):
        state, _ = step(state, T.tbatch(T.batch_np(cfg, seed=seed)))
    params = state["params"]
    nb = T.batch_np(cfg, seed=9, b=2, s=12)
    packed = TLN.maybe_pack_tree(params, tcfg.quant, device="cpu")
    # the port packs the trained tree into the reference's words
    jpacked = JLN.maybe_pack_tree(
        jax.tree.map(jnp.asarray, tree_map(lambda t: t.numpy(), params)),
        cfg.quant)
    assert_tree_close(packed, jpacked, dict(rtol=0, atol=0), "packed")
    latent = TM.logits_fn(params, tcfg, T.tbatch(nb))
    got = TM.logits_fn(packed, tcfg, T.tbatch(nb))
    np.testing.assert_allclose(got.numpy(), latent.numpy(), rtol=1e-4,
                               atol=1e-4)
