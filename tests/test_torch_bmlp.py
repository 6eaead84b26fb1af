"""The port's BMLP (paper §6.2: layers, packing, packed forward) against
the JAX reference on the same weights and inputs.

Packed words and int32 values must be equal; logits are compared within
the repo's LOGIT_TOL (``tests/test_paper_equivalence.py``), because the
final batch norm's rsqrt may differ by an ulp between XLA and PyTorch.
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
from repro_torch.kernels import binary_matmul as TBM
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF
from repro_torch.models import cnn as TC

LOGIT_TOL = dict(rtol=1e-4, atol=1e-3)

SMALL = JC.BMLPSpec(sizes=(64, 128, 128, 128, 10))
RAGGED = JC.BMLPSpec(sizes=(100, 40, 96, 33, 10))


def _setup(spec, seed, bsz):
    """Reference params with random BN (both signs of gamma, from numpy),
    the same params as torch tensors, and a uint8 batch."""
    params = JC.init_bmlp(jax.random.PRNGKey(seed), spec)
    rng = np.random.default_rng(seed)
    for bn in params["bns"]:
        c = bn["gamma"].shape[0]
        sign = np.where(rng.random(c) < 0.3, -1.0, 1.0)
        bn["gamma"] = jnp.asarray(rng.uniform(0.3, 1.5, c) * sign,
                                  jnp.float32)
        bn["beta"] = jnp.asarray(rng.normal(size=c), jnp.float32)
        bn["mean"] = jnp.asarray(rng.normal(size=c) * 3, jnp.float32)
        bn["var"] = jnp.asarray(rng.uniform(0.5, 2.0, c), jnp.float32)
    x = rng.integers(0, 256, (bsz, spec.sizes[0]), dtype=np.uint8)
    return params, CV.params_to_torch(params), x


def _jax_pre_bn(monkeypatch, jpacked, x, backend="jnp"):
    """The reference's output-layer int32 values: its packed forward with
    the final batch norm taken out."""
    with monkeypatch.context() as m:
        m.setattr(JL, "apply_batchnorm", lambda p, z, eps=1e-5: z)
        return np.asarray(JC.bmlp_forward_packed(jpacked, jnp.asarray(x),
                                                 backend=backend))


def _assert_packed_equal(jp, tp):
    assert len(jp["layers"]) == len(tp["layers"])
    for a, b in zip(jp["layers"], tp["layers"]):
        np.testing.assert_array_equal(CV.words_to_numpy(b["w_packed"]),
                                      np.asarray(a["w_packed"]))
        assert a["k_true"] == b["k_true"]
        assert set(a) == set(b)
        if "w_rowsum" in a:
            np.testing.assert_array_equal(b["w_rowsum"].numpy(),
                                          np.asarray(a["w_rowsum"]))
            assert a["nbits"] == b["nbits"]
    for a, b in zip(jp["folded"], tp["folded"]):
        np.testing.assert_array_equal(b["tau"].numpy(), np.asarray(a["tau"]))
        np.testing.assert_array_equal(b["flip"].numpy(),
                                      np.asarray(a["flip"]))


@pytest.mark.parametrize("name,spec,seed,bsz", [
    ("small", SMALL, 3, 5), ("ragged", RAGGED, 4, 3)])
def test_bmlp_packed_forward_matches_reference(name, spec, seed, bsz,
                                               monkeypatch):
    params, tparams, x = _setup(spec, seed, bsz)
    jp = JC.pack_bmlp(params, spec)
    tp = TC.pack_bmlp(tparams, CV.bmlp_spec(spec), device="cpu")
    _assert_packed_equal(jp, tp)
    want_int = _jax_pre_bn(monkeypatch, jp, x)
    for mode in ("auto", "resident", "per_layer"):
        got_int = TC.bmlp_forward_packed_int(tp, torch.from_numpy(x),
                                             dense_stack=mode)
        np.testing.assert_array_equal(got_int.numpy(), want_int)
    want = np.asarray(JL.apply_batchnorm(jp["bn_out"], jnp.asarray(want_int)))
    np.testing.assert_allclose(
        TC.bmlp_forward_packed(tp, torch.from_numpy(x)).numpy(), want,
        **LOGIT_TOL)
    np.testing.assert_allclose(
        TC.bmlp_forward_float(tparams, torch.from_numpy(x)).numpy(),
        np.asarray(JC.bmlp_forward_float(params, jnp.asarray(x))),
        **LOGIT_TOL)


def test_bmlp_full_width_matches_reference(monkeypatch):
    """The paper's BMLPSpec() (784 -> 3x4096 -> 10) at full width,
    batch 2."""
    spec = JC.BMLPSpec()
    params, tparams, x = _setup(spec, 0, 2)
    jp = JC.pack_bmlp(params, spec)
    tp = TC.pack_bmlp(tparams, CV.bmlp_spec(spec), device="cpu")
    _assert_packed_equal(jp, tp)
    want_int = _jax_pre_bn(monkeypatch, jp, x)
    got_int = TC.bmlp_forward_packed_int(tp, torch.from_numpy(x))
    np.testing.assert_array_equal(got_int.numpy(), want_int)
    want = np.asarray(JL.apply_batchnorm(jp["bn_out"], jnp.asarray(want_int)))
    got = TC.make_packed_forward(tp)(x).numpy()
    np.testing.assert_allclose(got, want, **LOGIT_TOL)
    np.testing.assert_allclose(
        got, TC.bmlp_forward_float(tparams, torch.from_numpy(x)).numpy(),
        **LOGIT_TOL)


def test_bmlp_pallas_reference_matches_port(monkeypatch):
    """The small spec through the reference's Pallas kernels (interpret):
    per-plane ``bitpack`` + GEMM, ``bn_sign_pack``, the resident stack."""
    params, tparams, x = _setup(SMALL, 3, 4)
    jp = JC.pack_bmlp(params, SMALL)
    want_int = _jax_pre_bn(monkeypatch, jp, x, backend="pallas")
    tp = TC.pack_bmlp(tparams, CV.bmlp_spec(SMALL), device="cpu")
    np.testing.assert_array_equal(
        TC.bmlp_forward_packed_int(tp, torch.from_numpy(x)).numpy(),
        want_int)
    np.testing.assert_allclose(
        TC.bmlp_forward_packed(tp, torch.from_numpy(x)).numpy(),
        np.asarray(JC.bmlp_forward_packed(jp, jnp.asarray(x),
                                          backend="pallas")), **LOGIT_TOL)


# ---------------------------------------------------------------------------
# Layers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,n,bsz", [(784, 40, 3), (33, 10, 1), (64, 96, 6)])
def test_bitplane_dense_stacked_equals_per_plane(k, n, bsz):
    """The port's stacked bit planes (one bitpack, one GEMM) give the
    reference's per-plane result, the per-plane loop's and the integer
    GEMM's, exactly."""
    rng = np.random.default_rng(k + n + bsz)
    w = rng.uniform(-1, 1, (n, k)).astype(np.float32)
    x = rng.integers(0, 256, (bsz, k), dtype=np.uint8)
    x[0, :3] = (0, 255, 128)
    jp = JL.pack_bitplane_dense({"w": jnp.asarray(w)})
    tp = TL.pack_bitplane_dense({"w": torch.from_numpy(w)})
    np.testing.assert_array_equal(tp["w_rowsum"].numpy(),
                                  np.asarray(jp["w_rowsum"]))
    got = TL.apply_bitplane_dense_packed(tp, torch.from_numpy(x))
    want = np.asarray(JL.apply_bitplane_dense_packed(jp, jnp.asarray(x),
                                                     backend="jnp"))
    np.testing.assert_array_equal(got.numpy(), want)
    planes = 2 * torch.from_numpy(x).to(torch.int32)[None] \
        .bitwise_right_shift(torch.arange(8)[:, None, None]).bitwise_and(1) \
        - 1
    acc = 0
    for i in range(8):                       # the reference's per-plane loop
        d = TOPS.binary_matmul_packed(TOPS.bitpack(planes[i].float()),
                                      tp["w_packed"], k_true=k)
        acc = acc + ((d + tp["w_rowsum"]) << i)
    np.testing.assert_array_equal((acc >> 1).numpy(), want)
    np.testing.assert_array_equal(
        TREF.bitplane_dot_ref(torch.from_numpy(x), torch.from_numpy(w)
                              ).numpy(), want)
    np.testing.assert_array_equal(
        TL.apply_bitplane_dense_float({"w": torch.from_numpy(w)},
                                      torch.from_numpy(x)).numpy(),
        np.asarray(JL.apply_bitplane_dense_float({"w": jnp.asarray(w)},
                                                 jnp.asarray(x))))


def test_binary_dense_packed_layer():
    rng = np.random.default_rng(8)
    w = rng.uniform(-1, 1, (40, 70)).astype(np.float32)
    x = rng.normal(size=(2, 3, 70)).astype(np.float32)
    jp = JL.pack_binary_dense({"w": jnp.asarray(w)})
    tp = TL.pack_binary_dense({"w": torch.from_numpy(w)})
    np.testing.assert_array_equal(
        TL.apply_binary_dense_packed(tp, torch.from_numpy(x)).numpy(),
        np.asarray(JL.apply_binary_dense_packed(jp, jnp.asarray(x),
                                                backend="jnp")))


# ---------------------------------------------------------------------------
# The dense-stack residency rule
# ---------------------------------------------------------------------------

def _meta_stack(sizes, k_in_words):
    """Packed weights of a hidden stack, shapes only."""
    ws, kw = [], k_in_words
    for n in sizes:
        ws.append(torch.empty((n, kw), dtype=torch.int32, device="meta"))
        kw = -(-n // 32)
    return ws


def test_dense_stack_fits_rule():
    bmlp = _meta_stack((4096, 4096), 128)           # BMLPSpec() layers 1-2
    bcnn = _meta_stack((1024, 1024), 4 * 4 * 16)    # BCNNSpec() dense 0-1
    assert TBM.dense_stack_bytes(bmlp) == 4_259_840
    assert TBM.dense_stack_bytes(bcnn) == 1_196_032
    assert TBM.dense_stack_fits(bmlp) and TBM.dense_stack_fits(bcnn)
    big = _meta_stack((8192, 8192, 8192), 256)      # 24 MiB of weights
    assert TBM.dense_stack_bytes(big) > TBM.STACK_L2_BUDGET_BYTES
    assert not TBM.dense_stack_fits(big)
    wide = _meta_stack((16,), 4000)                 # rows beyond smem
    assert TBM.dense_stack_bytes(wide) < TBM.STACK_L2_BUDGET_BYTES
    assert not TBM.dense_stack_fits(wide)
    assert not TBM.dense_stack_fits(_meta_stack((32,) * 17, 1))
    assert not TBM.dense_stack_fits([])


# ---------------------------------------------------------------------------
# Serving seams and devices
# ---------------------------------------------------------------------------

def test_bmlp_serving_seams():
    params, tparams, x = _setup(RAGGED, 1, 3)
    tp = TC.pack_bmlp(tparams, CV.bmlp_spec(RAGGED), device="cpu")
    assert TC.packed_kind(tp) == "bmlp"
    assert TC.packed_input_shape(tp) == (100,)
    assert TC.packed_input_shape(tp) == JC.packed_input_shape(
        JC.pack_bmlp(params, RAGGED))
    fwd = TC.make_packed_forward(tp, dense_stack="resident")
    with pytest.raises(ValueError, match="uint8"):
        fwd(np.zeros((2, 100), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        fwd(np.zeros((2, 99), np.uint8))
    with pytest.raises(ValueError, match="dense_stack"):
        TC.make_packed_forward(tp, dense_stack="fused")
    TOPS.reset_launch_counts()
    got = fwd(x)
    assert got.shape == (3, 10)
    assert sum(TOPS.launch_counts().values()) == 0   # CPU: plain versions
    assert torch.equal(got, TC.bmlp_forward_packed(tp, torch.from_numpy(x)))
    with pytest.raises(ValueError, match="CUDA"):
        TC.bmlp_forward_packed(tp, torch.from_numpy(x), backend="cuda")


def test_pack_bmlp_default_device_needs_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    spec = TC.BMLPSpec(sizes=(16, 32, 10))
    params = TC.init_bmlp(torch.Generator().manual_seed(0), spec)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        TC.pack_bmlp(params, spec)


def test_init_bmlp_is_seeded():
    spec = TC.BMLPSpec(sizes=(16, 32, 10))
    a = TC.init_bmlp(torch.Generator().manual_seed(3), spec)
    b = TC.init_bmlp(torch.Generator().manual_seed(3), spec)
    assert [p["w"].shape for p in a["layers"]] == [(32, 16), (10, 32)]
    assert all(torch.equal(p["w"], q["w"])
               for p, q in zip(a["layers"], b["layers"]))
    assert [bn["gamma"].shape for bn in a["bns"]] == [(32,), (10,)]
    packed = TC.pack_bmlp(a, spec, device="cpu")
    assert TC.bmlp_forward_packed(packed, torch.zeros(
        (1, 16), dtype=torch.uint8)).shape == (1, 10)

