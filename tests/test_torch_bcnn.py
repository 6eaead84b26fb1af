"""The port's BCNN (layers, packing, packed forward) against the JAX
reference on the same weights and inputs.

Packed plans and int32 values must be equal; logits are compared with
rtol=1e-5, atol=1e-4, because the final batch norm's rsqrt may differ by
an ulp between XLA and PyTorch.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binary_layers as JL
from repro.models import cnn as JC
from repro_torch import convert as CV
from repro_torch.core import binary_layers as TL
from repro_torch.kernels import ops as TOPS
from repro_torch.models import cnn as TC

LOGIT_TOL = dict(rtol=1e-5, atol=1e-4)


def _randomize_bn(params, seed):
    """Random BN statistics with both signs of gamma, made with numpy."""
    rng = np.random.default_rng(seed)
    for bn in params["conv_bns"] + params["dense_bns"]:
        c = bn["gamma"].shape[0]
        sign = np.where(rng.random(c) < 0.3, -1.0, 1.0)
        bn["gamma"] = jnp.asarray(rng.uniform(0.3, 1.5, c) * sign,
                                  jnp.float32)
        bn["beta"] = jnp.asarray(rng.normal(size=c), jnp.float32)
        bn["mean"] = jnp.asarray(rng.normal(size=c) * 3, jnp.float32)
        bn["var"] = jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)
    return params


SPECS = {
    # tests/test_paper_equivalence.py::test_bcnn_fused_path_ragged_channels
    "ragged": (JC.BCNNSpec(input_hw=(8, 8), c_in=3,
                           stages=(JC.ConvStage(20), JC.ConvStage(24, pool=True),
                                   JC.ConvStage(40, pool=True)),
                           dense=(33, 10)), 11, 3),
    # tests/test_paper_equivalence.py::test_bcnn_pallas_backend_matches_jnp:
    # the only spec that pools stage 0 (the int32 maxpool2d)
    "pooled_stage0": (JC.BCNNSpec(input_hw=(8, 8), c_in=3,
                                  stages=(JC.ConvStage(16, pool=True),),
                                  dense=(32, 10)), 7, 2),
    # tests/test_serve_batching.py::_bcnn
    "serve": (JC.BCNNSpec(input_hw=(8, 8), c_in=3,
                          stages=(JC.ConvStage(32),
                                  JC.ConvStage(64, pool=True)),
                          dense=(96, 10)), 1, 5),
}


def _setup(spec, seed, bsz):
    params = _randomize_bn(JC.init_bcnn(jax.random.PRNGKey(seed), spec),
                           seed)
    x = np.random.default_rng(seed + 1).integers(
        0, 256, (bsz, *spec.input_hw, spec.c_in), dtype=np.uint8)
    tparams = CV.params_to_torch(params)
    return params, tparams, x


def _jax_pre_bn(monkeypatch, jpacked, x):
    """The reference's output-layer int32 values: its packed forward with
    the final batch norm taken out."""
    with monkeypatch.context() as m:
        m.setattr(JL, "apply_batchnorm", lambda p, z, eps=1e-5: z)
        return np.asarray(JC.bcnn_forward_packed(jpacked, jnp.asarray(x),
                                                 backend="jnp"))


def _assert_packed_equal(jp, tp):
    for a, b in zip(jp["convs"], tp["convs"]):
        np.testing.assert_array_equal(CV.words_to_numpy(b["w_packed"]),
                                      np.asarray(a["w_packed"]))
        for key in ("correction", "rowsum"):
            if key in a:
                np.testing.assert_array_equal(b[key].numpy(),
                                              np.asarray(a[key]))
        assert {k: v for k, v in a.items() if not hasattr(v, "shape")} == \
            {k: v for k, v in b.items() if not hasattr(v, "shape")}
    for a, b in zip(jp["folded_conv"] + jp["folded_dense"],
                    tp["folded_conv"] + tp["folded_dense"]):
        np.testing.assert_array_equal(b["tau"].numpy(), np.asarray(a["tau"]))
        np.testing.assert_array_equal(b["flip"].numpy(),
                                      np.asarray(a["flip"]))
    for a, b in zip(jp["pool_masks"], tp["pool_masks"]):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(CV.words_to_numpy(b), np.asarray(a))
    for a, b in zip(jp["denses"], tp["denses"]):
        np.testing.assert_array_equal(CV.words_to_numpy(b["w_packed"]),
                                      np.asarray(a["w_packed"]))
        assert a["k_true"] == b["k_true"]


@pytest.mark.parametrize("name", sorted(SPECS))
def test_bcnn_packed_forward_matches_reference(name, monkeypatch):
    spec, seed, bsz = SPECS[name]
    params, tparams, x = _setup(spec, seed, bsz)
    jp = JC.pack_bcnn(params, spec)
    tp = TC.pack_bcnn(tparams, CV.bcnn_spec(spec), device="cpu")
    _assert_packed_equal(jp, tp)
    got_int = TC.bcnn_forward_packed_int(tp, torch.from_numpy(x))
    want_int = _jax_pre_bn(monkeypatch, jp, x)
    np.testing.assert_array_equal(got_int.numpy(), want_int)
    # the rest of the reference's forward: its final batch norm
    want = np.asarray(JL.apply_batchnorm(jp["bn_out"], jnp.asarray(want_int)))
    fwd = TC.make_packed_forward(tp)
    np.testing.assert_allclose(fwd(x).numpy(), want, **LOGIT_TOL)
    np.testing.assert_allclose(
        TC.bcnn_forward_float(tparams, torch.from_numpy(x),
                              CV.bcnn_spec(spec)).numpy(),
        np.asarray(JC.bcnn_forward_float(params, jnp.asarray(x), spec)),
        **LOGIT_TOL)


def test_bcnn_full_width_batch1_matches_reference(monkeypatch):
    """The paper's BCNNSpec() at full width, one image."""
    spec = JC.BCNNSpec()
    params, tparams, x = _setup(spec, 0, 1)
    jp = JC.pack_bcnn(params, spec)
    tp = TC.pack_bcnn(tparams, CV.bcnn_spec(spec), device="cpu")
    _assert_packed_equal(jp, tp)
    got_int = TC.bcnn_forward_packed_int(tp, torch.from_numpy(x))
    np.testing.assert_array_equal(got_int.numpy(),
                                  _jax_pre_bn(monkeypatch, jp, x))


def test_bcnn_pallas_reference_matches_port():
    """One tiny spec through the reference's Pallas kernels (interpret)."""
    spec, seed, bsz = SPECS["pooled_stage0"]
    params, tparams, x = _setup(spec, seed, bsz)
    want = np.asarray(JC.bcnn_forward_packed(
        JC.pack_bcnn(params, spec), jnp.asarray(x), backend="pallas"))
    tp = TC.pack_bcnn(tparams, CV.bcnn_spec(spec), device="cpu")
    np.testing.assert_allclose(TC.bcnn_forward_packed(
        tp, torch.from_numpy(x)).numpy(), want, **LOGIT_TOL)


def test_dense_stack_modes():
    spec, seed, bsz = SPECS["serve"]
    _, tparams, x = _setup(spec, seed, bsz)
    tp = TC.pack_bcnn(tparams, CV.bcnn_spec(spec), device="cpu")
    xt = torch.from_numpy(x)
    auto = TC.bcnn_forward_packed(tp, xt, dense_stack="auto")
    for mode in ("resident", "per_layer"):
        assert torch.equal(auto, TC.bcnn_forward_packed(tp, xt,
                                                        dense_stack=mode))
    with pytest.raises(ValueError, match="dense_stack"):
        TC.make_packed_forward(tp, dense_stack="fused")
    with pytest.raises(ValueError, match="backend"):
        TC.bcnn_forward_packed(tp, xt, backend="pallas")
    with pytest.raises(ValueError, match="CUDA"):
        TC.bcnn_forward_packed(tp, xt, backend="cuda")


def test_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TC.BCNNSpec(input_hw=(4, 4), stages=(TC.ConvStage(8),),
                       dense=(10,))
    params = TC.init_bcnn(torch.Generator().manual_seed(0), spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.pack_bcnn(params, spec)


def test_serving_seams():
    spec, seed, _ = SPECS["serve"]
    _, tparams, _ = _setup(spec, seed, 1)
    tp = TC.pack_bcnn(tparams, CV.bcnn_spec(spec), device="cpu")
    assert TC.packed_kind(tp) == "bcnn"
    assert TC.packed_input_shape(tp) == (8, 8, 3)
    with pytest.raises(ValueError):
        TC.packed_kind({"x": 1})
    fwd = TC.make_packed_forward(tp)
    with pytest.raises(ValueError, match="uint8"):
        fwd(np.zeros((2, 8, 8, 3), np.float32))
    TOPS.reset_launch_counts()
    assert fwd(np.zeros((2, 8, 8, 3), np.uint8)).shape == (2, 10)
    assert sum(TOPS.launch_counts().values()) == 0   # CPU: plain versions


def test_init_bcnn_is_seeded():
    spec = TC.BCNNSpec(input_hw=(4, 4), stages=(TC.ConvStage(8),),
                       dense=(10,))
    a = TC.init_bcnn(torch.Generator().manual_seed(3), spec)
    b = TC.init_bcnn(torch.Generator().manual_seed(3), spec)
    assert torch.equal(a["convs"][0]["w"], b["convs"][0]["w"])
    assert a["convs"][0]["w"].shape == (8, 3, 3, 3)
    assert a["denses"][0]["w"].shape == (10, 4 * 4 * 8)
    w = a["convs"][0]["w"]
    assert w.min() >= -1 and w.max() < 1


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

def _bn_params(c, seed):
    rng = np.random.default_rng(seed)
    return {"gamma": (rng.uniform(0.3, 1.5, c)
                      * np.where(rng.random(c) < 0.5, -1, 1)
                      ).astype(np.float32),
            "beta": rng.normal(size=c).astype(np.float32),
            "mean": (rng.normal(size=c) * 3).astype(np.float32),
            "var": rng.uniform(0.5, 2.0, c).astype(np.float32)}


@pytest.mark.parametrize("c", [10, 40, 128, 20000])
def test_batchnorm_and_fold(c):
    """The folded tau equals the reference bit for bit: the 20000-channel
    case catches a float32 sqrt that is off by an ulp."""
    bn = _bn_params(c, c)
    jbn = {k: jnp.asarray(v) for k, v in bn.items()}
    tbn = {k: torch.from_numpy(v) for k, v in bn.items()}
    jf, tf = JL.fold_bn_sign(jbn), TL.fold_bn_sign(tbn)
    np.testing.assert_array_equal(tf["tau"].numpy(), np.asarray(jf["tau"]))
    np.testing.assert_array_equal(tf["flip"].numpy(), np.asarray(jf["flip"]))
    np.testing.assert_array_equal(CV.words_to_numpy(TL.pool_flip_mask(tf)),
                                  np.asarray(JL.pool_flip_mask(jf)))
    x = np.random.default_rng(1).integers(-60, 60, (5, c)).astype(np.int32)
    np.testing.assert_allclose(
        TL.apply_batchnorm(tbn, torch.from_numpy(x)).numpy(),
        np.asarray(JL.apply_batchnorm(jbn, jnp.asarray(x))), **LOGIT_TOL)
    np.testing.assert_array_equal(
        TL.apply_bn_sign_folded(tf, torch.from_numpy(x)).numpy(),
        np.asarray(JL.apply_bn_sign_folded(jf, jnp.asarray(x))))
    np.testing.assert_array_equal(
        CV.words_to_numpy(TL.apply_bn_sign_folded_packed(
            tf, torch.from_numpy(x))),
        np.asarray(JL.apply_bn_sign_folded_packed(jf, jnp.asarray(x),
                                                  backend="jnp")))


@pytest.mark.parametrize("shape,window,stride", [
    ((2, 8, 8, 5), 2, None), ((1, 7, 9, 3), 2, None), ((2, 6, 6, 4), 3, 2)])
def test_maxpools(shape, window, stride):
    rng = np.random.default_rng(sum(shape))
    x = rng.integers(-100, 100, shape).astype(np.int32)
    np.testing.assert_array_equal(
        TL.maxpool2d(torch.from_numpy(x), window, stride).numpy(),
        np.asarray(JL.maxpool2d(jnp.asarray(x), window, stride)))
    words = rng.integers(0, 2**32, (*shape[:3], 2), dtype=np.uint64
                         ).astype(np.uint32)
    mask = rng.integers(0, 2**32, (2,), dtype=np.uint64).astype(np.uint32)
    np.testing.assert_array_equal(
        CV.words_to_numpy(TL.maxpool2d_packed(
            CV.words_to_torch(words), CV.words_to_torch(mask), window,
            stride)),
        np.asarray(JL.maxpool2d_packed(jnp.asarray(words), jnp.asarray(mask),
                                       window, stride)))


def test_dense_layers():
    rng = np.random.default_rng(5)
    w = rng.uniform(-1, 1, (40, 3 * 33)).astype(np.float32)
    x = rng.normal(size=(4, 3 * 33)).astype(np.float32)
    jw, tw = {"w": jnp.asarray(w)}, {"w": torch.from_numpy(w)}
    np.testing.assert_array_equal(
        TL.apply_binary_dense_float(tw, torch.from_numpy(x)).numpy(),
        np.asarray(JL.apply_binary_dense_float(jw, jnp.asarray(x))))
    for jp, tp in ((JL.pack_binary_dense(jw), TL.pack_binary_dense(tw)),
                   (JL.pack_binary_dense_grouped(jw, 33),
                    TL.pack_binary_dense_grouped(tw, 33))):
        np.testing.assert_array_equal(CV.words_to_numpy(tp["w_packed"]),
                                      np.asarray(jp["w_packed"]))
        assert tp["k_true"] == jp["k_true"]
        xp = np.asarray(jnp.zeros((4, jp["w_packed"].shape[1]), jnp.uint32)
                        + jnp.uint32(0x9E3779B9))
        np.testing.assert_array_equal(
            TL.apply_binary_dense_prepacked(tp, CV.words_to_torch(xp)
                                            ).numpy(),
            np.asarray(JL.apply_binary_dense_prepacked(jp, jnp.asarray(xp),
                                                       backend="jnp")))
        bn = _bn_params(40, 9)
        jf = JL.fold_bn_sign({k: jnp.asarray(v) for k, v in bn.items()})
        tf = TL.fold_bn_sign({k: torch.from_numpy(v) for k, v in bn.items()})
        np.testing.assert_array_equal(
            CV.words_to_numpy(TL.apply_binary_dense_bn_packed(
                tp, tf, CV.words_to_torch(xp))),
            np.asarray(JL.apply_binary_dense_bn_packed(
                jp, jf, jnp.asarray(xp), backend="jnp")))
        np.testing.assert_array_equal(
            CV.words_to_numpy(TL.apply_binary_dense_stack_packed(
                [tp], [tf], CV.words_to_torch(xp))),
            np.asarray(JL.apply_binary_dense_stack_packed(
                [jp], [jf], jnp.asarray(xp), backend="jnp")))
    with pytest.raises(ValueError):
        TL.pack_binary_dense_grouped(tw, 32)
