"""The port's kernels (their plain versions on the CPU), plans and
dispatch against the JAX reference: packed words and int32 outputs must
be equal.  Each kernel is also held against one tiny Pallas case run in
interpret mode."""
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import binarize as JB
from repro.kernels import binary_conv as JBC
from repro.kernels import ops as JOPS
from repro_torch import convert as CV
from repro_torch.core import binarize as TB
from repro_torch.kernels import binary_conv as TBC
from repro_torch.kernels import binary_matmul as TBM
from repro_torch.kernels import bitpack as TBP
from repro_torch.kernels import fused_epilogue as TFE
from repro_torch.kernels import ops as TOPS
from repro_torch.kernels import ref as TREF


def _rng(*key):
    return np.random.default_rng(zlib.crc32(repr(key).encode()))


def _pm1(rng, shape):
    return rng.uniform(-1, 1, shape).astype(np.float32)


def _words(rng, shape):
    """Packed words of random ±1 data with zero-bit tails: (..., k)."""
    return np.asarray(JB.pack_bits(jnp.asarray(_pm1(rng, shape))))


def _bn(rng, c, k):
    """Thresholds that hit ties (integers), halves and both flips."""
    tau = rng.integers(-k, k + 1, c).astype(np.float32)
    tau += 0.5 * (rng.random(c) < 0.5)
    flip = np.where(rng.random(c) < 0.3, -1.0, 1.0).astype(np.float32)
    return tau, flip


def _t(a):
    """numpy -> torch, words (uint32) as int32 views."""
    a = np.asarray(a)
    return CV.words_to_torch(a) if a.dtype == np.uint32 else \
        torch.from_numpy(np.array(a))


def _eq(got, want):
    got = CV.words_to_numpy(got) if np.asarray(want).dtype == np.uint32 \
        else got.numpy()
    np.testing.assert_array_equal(got, np.asarray(want))


# ---------------------------------------------------------------------------
# K2 bn_sign_pack and the epilogue contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,c", [(1, 40), (6, 10), (4, 128), (3, 33)])
def test_bn_sign_pack_matches_jnp(m, c):
    rng = _rng("bn", m, c)
    x = rng.integers(-50, 50, (m, c)).astype(np.int32)
    tau, flip = _bn(rng, c, 50)
    want = JOPS.bn_sign_pack(jnp.asarray(x), jnp.asarray(tau),
                             jnp.asarray(flip), backend="jnp")
    _eq(TREF.bn_sign_pack_ref(_t(x), _t(tau), _t(flip)), want)
    _eq(TFE.bn_sign_bits_to_words(_t(x), _t(tau), _t(flip)), want)
    _eq(TOPS.bn_sign_pack(_t(x), _t(tau), _t(flip)), want)


def test_bn_sign_pack_matches_pallas():
    rng = _rng("bn-pallas")
    x = rng.integers(-9, 9, (5, 40)).astype(np.int32)
    tau, flip = _bn(rng, 40, 9)
    want = JOPS.bn_sign_pack(jnp.asarray(x), jnp.asarray(tau),
                             jnp.asarray(flip), backend="pallas")
    _eq(TOPS.bn_sign_pack(_t(x), _t(tau), _t(flip)), want)


def test_epilogue_contract_on_ragged_channels():
    """The port leaves tau/flip unpadded; its zero-bit tail equals the
    reference's contract on parameters padded with tau=+inf, flip=+1."""
    from repro.kernels import fused_epilogue as JFE
    rng = _rng("epi")
    y = rng.integers(-5, 5, (3, 40)).astype(np.int32)
    tau, flip = _bn(rng, 40, 5)
    jt, jf = JFE.pad_bn_params(jnp.asarray(tau), jnp.asarray(flip), 64)
    y64 = jnp.pad(jnp.asarray(y), ((0, 0), (0, 24)))
    want = JFE.bn_sign_bits_to_words(y64, jt, jf)
    _eq(TFE.bn_sign_bits_to_words(_t(y), _t(tau), _t(flip)), want)


# ---------------------------------------------------------------------------
# K5 bitpack
# ---------------------------------------------------------------------------

def _bitpack_input(m, k):
    """Reals with exact zeros, -0.0 and NaN mixed in."""
    rng = _rng("bitpack", m, k)
    x = rng.normal(size=(m, k)).astype(np.float32)
    x.flat[rng.integers(0, m * k, max(1, m * k // 7))] = 0.0
    x.flat[rng.integers(0, m * k, max(1, m * k // 7))] = -0.0
    x.flat[rng.integers(0, m * k, max(1, m * k // 11))] = np.nan
    return x


@pytest.mark.parametrize("m,k", [(1, 1), (37, 31), (1, 33), (37, 784),
                                 (2, 1000)])
def test_bitpack_matches_jnp(m, k):
    x = _bitpack_input(m, k)
    want = JOPS.bitpack(jnp.asarray(x), backend="jnp")
    _eq(TOPS.bitpack(_t(x)), want)
    _eq(TREF.bitpack_ref(_t(x)), want)
    assert CV.words_to_numpy(TOPS.bitpack(_t(np.array([[-0.0, np.nan]],
                                                      np.float32))))[0, 0] \
        == 1


@pytest.mark.parametrize("m,k", [(3, 33), (37, 100)])
def test_bitpack_matches_pallas(m, k):
    x = _bitpack_input(m, k)
    _eq(TOPS.bitpack(_t(x)), JOPS.bitpack(jnp.asarray(x), backend="pallas"))


@pytest.mark.parametrize("dtype", [torch.float64, torch.bfloat16,
                                   torch.float16, torch.int32, torch.uint8])
def test_bitpack_float32_input_keeps_signs(dtype):
    """The card path converts any real dtype to the kernel's float32 with
    every sign kept (float64 underflow and NaN included), so it packs
    what the plain version packs on the original dtype."""
    x = torch.from_numpy(_bitpack_input(5, 70).astype(np.float64) * 50)
    x[0, :4] = torch.tensor([-1e-300, 1e-300, -0.0, float("nan")])
    x = x.to(dtype)
    assert torch.equal(TREF.bitpack_ref(TOPS._as_float32(x)),
                       TREF.bitpack_ref(x))
    assert TOPS._as_float32(x).dtype == torch.float32


# ---------------------------------------------------------------------------
# K4 xnor_gemm, both epilogues, the dense stack (K6) and binary_matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,n,k", [(1, 10, 33), (3, 40, 70), (8, 64, 1024),
                                   (2, 10, 8192)])
def test_gemm_matches_jnp(m, n, k):
    rng = _rng("gemm", m, n, k)
    a, b = _words(rng, (m, k)), _words(rng, (n, k))
    tau, flip = _bn(rng, n, k)
    want = JOPS.binary_matmul_packed(jnp.asarray(a), jnp.asarray(b),
                                     k_true=k, backend="jnp")
    _eq(TREF.binary_matmul_packed_ref(_t(a), _t(b), k), want)
    _eq(TOPS.binary_matmul_packed(_t(a), _t(b), k_true=k), want)
    want = JOPS.binary_matmul_bn_sign_packed(
        jnp.asarray(a), jnp.asarray(b), jnp.asarray(tau), jnp.asarray(flip),
        k_true=k, backend="jnp")
    _eq(TREF.binary_matmul_bn_sign_packed_ref(_t(a), _t(b), _t(tau),
                                              _t(flip), k), want)
    _eq(TOPS.binary_matmul_bn_sign_packed(_t(a), _t(b), _t(tau), _t(flip),
                                          k_true=k), want)


def test_gemm_matches_pallas():
    rng = _rng("gemm-pallas")
    a, b = _words(rng, (3, 70)), _words(rng, (10, 70))
    tau, flip = _bn(rng, 10, 70)
    _eq(TOPS.binary_matmul_packed(_t(a), _t(b), k_true=70),
        JOPS.binary_matmul_packed(jnp.asarray(a), jnp.asarray(b), k_true=70,
                                  backend="pallas"))
    _eq(TOPS.binary_matmul_bn_sign_packed(_t(a), _t(b), _t(tau), _t(flip),
                                          k_true=70),
        JOPS.binary_matmul_bn_sign_packed(
            jnp.asarray(a), jnp.asarray(b), jnp.asarray(tau),
            jnp.asarray(flip), k_true=70, backend="pallas"))


def test_dense_stack_per_layer_matches_jnp():
    rng = _rng("stack")
    x = _words(rng, (4, 100))
    jst, tst, k = [], [], 100
    for n in (33, 40, 10):
        w = _words(rng, (n, k))
        tau, flip = _bn(rng, n, k)
        jst.append({"w_packed": jnp.asarray(w), "k_true": k,
                    "tau": jnp.asarray(tau), "flip": jnp.asarray(flip)})
        tst.append({"w_packed": _t(w), "k_true": k, "tau": _t(tau),
                    "flip": _t(flip)})
        k = n
    want = JOPS.binary_dense_stack_packed(jst, jnp.asarray(x), backend="jnp")
    _eq(TOPS.binary_dense_stack_packed(tst, _t(x)), want)
    _eq(TREF.binary_dense_stack_packed_ref(tst, _t(x)), want)
    _eq(TOPS.binary_dense_stack_packed([], _t(x)), x)


def _stack_case(sizes, k, m, name):
    rng = _rng(name, sizes, k, m)
    x = _words(rng, (m, k))
    jst, tst = [], []
    for n in sizes:
        w = _words(rng, (n, k))
        tau, flip = _bn(rng, n, k)
        jst.append({"w_packed": jnp.asarray(w), "k_true": k,
                    "tau": jnp.asarray(tau), "flip": jnp.asarray(flip)})
        tst.append({"w_packed": _t(w), "k_true": k, "tau": _t(tau),
                    "flip": _t(flip)})
        k = n
    return x, jst, tst


@pytest.mark.parametrize("resident", [True, False, None])
def test_dense_stack_residency_modes_match_jnp(resident):
    x, jst, tst = _stack_case((96, 40, 10), 64, 9, "stack-modes")
    want = JOPS.binary_dense_stack_packed(jst, jnp.asarray(x), backend="jnp",
                                          resident=resident)
    _eq(TOPS.binary_dense_stack_packed(tst, _t(x), resident=resident), want)
    _eq(TOPS.binary_dense_stack_packed([], _t(x), resident=resident), x)


def test_dense_stack_matches_pallas_resident():
    """The ragged stack 64 -> 96 -> 40 through the reference's
    single-launch stack kernel (interpret)."""
    x, jst, tst = _stack_case((96, 40), 64, 5, "stack-pallas")
    want = JOPS.binary_dense_stack_packed(jst, jnp.asarray(x),
                                          backend="pallas", resident=True)
    for resident in (True, False, None):
        _eq(TOPS.binary_dense_stack_packed(tst, _t(x), resident=resident),
            want)


@pytest.mark.parametrize("m,n,k", [(1, 10, 33), (6, 40, 100)])
def test_binary_matmul_matches_reference(m, n, k):
    rng = _rng("matmul", m, n, k)
    a = _bitpack_input(m, k)
    b = rng.normal(size=(n, k)).astype(np.float32)
    want = JOPS.binary_matmul(jnp.asarray(a), jnp.asarray(b), backend="jnp")
    _eq(TOPS.binary_matmul(_t(a), _t(b)), want)
    np.testing.assert_array_equal(
        TREF.binary_matmul_ref(_t(b), _t(a)).numpy(),
        np.asarray(JOPS.binary_matmul(jnp.asarray(b), jnp.asarray(a),
                                      backend="jnp")))
    if m == 1:
        _eq(TOPS.binary_matmul(_t(a), _t(b)),
            JOPS.binary_matmul(jnp.asarray(a), jnp.asarray(b),
                               backend="pallas"))


# ---------------------------------------------------------------------------
# Conv plans, K1 bitplane_conv and K3 conv_bn_sign
# ---------------------------------------------------------------------------

CONV_CASES = [            # (hw, c_in, c_out, k, stride, padding)
    ((8, 8), 3, 40, 3, 1, "SAME"),
    ((9, 9), 33, 10, 3, 2, "SAME"),
    ((9, 7), 20, 40, 3, 2, "VALID"),
    ((6, 6), 64, 33, 1, 1, "SAME"),
    ((7, 8), 16, 8, 3, 2, "VALID"),
]


@pytest.mark.parametrize("hw,c_in,c_out,k,stride,padding", CONV_CASES)
def test_conv_geometry_and_plans(hw, c_in, c_out, k, stride, padding):
    assert TBC.conv_geometry(hw, k, k, stride, padding) == \
        JBC.conv_geometry(hw, k, k, stride, padding)
    w = _pm1(_rng("plan", hw, c_in, c_out), (c_out, k, k, c_in))
    jp = JBC.make_conv_plan(jnp.asarray(w), input_hw=hw, stride=stride,
                            padding=padding)
    tp = TBC.make_conv_plan(torch.from_numpy(w), input_hw=hw, stride=stride,
                            padding=padding)
    assert set(jp) == set(tp)
    for key in jp:
        if key == "w_packed":
            _eq(tp[key], jp[key])
        elif key == "correction":
            np.testing.assert_array_equal(tp[key].numpy(),
                                          np.asarray(jp[key]))
        else:
            assert tp[key] == jp[key], key
    jb = JBC.make_bitplane_conv_plan(jnp.asarray(w), input_hw=hw,
                                     stride=stride, padding=padding)
    tb = TBC.make_bitplane_conv_plan(torch.from_numpy(w), input_hw=hw,
                                     stride=stride, padding=padding)
    assert set(jb) == set(tb)
    np.testing.assert_array_equal(tb["rowsum"].numpy(),
                                  np.asarray(jb["rowsum"]))


def test_conv_geometry_rejects():
    with pytest.raises(ValueError):
        TBC.conv_geometry((8, 8), 3, 3, 1, "FULL")
    with pytest.raises(ValueError):
        TBC.conv_geometry((2, 2), 3, 3, 1, "VALID")


def _conv_case(hw, c_in, c_out, k, stride, padding, bsz=2):
    rng = _rng("conv", hw, c_in, c_out, stride, padding)
    w = _pm1(rng, (c_out, k, k, c_in))
    jplan = JBC.make_conv_plan(jnp.asarray(w), input_hw=hw, stride=stride,
                               padding=padding)
    tplan = TBC.make_conv_plan(torch.from_numpy(w), input_hw=hw,
                               stride=stride, padding=padding)
    x = _words(rng, (bsz, *hw, c_in))
    tau, flip = _bn(rng, c_out, k * k * c_in)
    return jplan, tplan, x, tau, flip


@pytest.mark.parametrize("hw,c_in,c_out,k,stride,padding", CONV_CASES)
def test_conv_bn_sign_matches_jnp(hw, c_in, c_out, k, stride, padding):
    jplan, tplan, x, tau, flip = _conv_case(hw, c_in, c_out, k, stride,
                                            padding)
    from repro.kernels import ref as JREF
    _eq(TREF.binary_conv2d_packed_ref(
            _t(x), tplan["w_packed"], tplan["correction"], kh=k, kw=k,
            stride=stride, pads=tplan["pads"], c_out=c_out,
            k_true=tplan["k_true"]),
        JREF.binary_conv2d_packed_ref(
            jnp.asarray(x), jplan["w_packed"], jplan["correction"], kh=k,
            kw=k, stride=stride, pads=jplan["pads"], c_out=c_out,
            k_true=jplan["k_true"]))
    want = JOPS.binary_conv2d_bn_sign_packed(
        jplan, {"tau": jnp.asarray(tau), "flip": jnp.asarray(flip)},
        jnp.asarray(x), backend="jnp")
    _eq(TOPS.binary_conv2d_bn_sign_packed(
        tplan, {"tau": _t(tau), "flip": _t(flip)}, _t(x)), want)


def test_conv_bn_sign_matches_pallas():
    hw, c_in, c_out, k, stride, padding = (6, 6), 33, 40, 3, 2, "VALID"
    jplan, tplan, x, tau, flip = _conv_case(hw, c_in, c_out, k, stride,
                                            padding, bsz=1)
    want = JOPS.binary_conv2d_bn_sign_packed(
        jplan, {"tau": jnp.asarray(tau), "flip": jnp.asarray(flip)},
        jnp.asarray(x), backend="pallas")
    _eq(TOPS.binary_conv2d_bn_sign_packed(
        tplan, {"tau": _t(tau), "flip": _t(flip)}, _t(x)), want)
    _eq(TREF.binary_conv2d_bn_sign_packed_ref(
        _t(x), tplan["w_packed"], tplan["correction"], _t(tau), _t(flip),
        kh=k, kw=k, stride=stride, pads=tplan["pads"], c_out=c_out,
        k_true=tplan["k_true"]), want)


@pytest.mark.parametrize("hw,c_in,c_out,k,stride,padding", CONV_CASES)
def test_binary_conv_matches_jnp(hw, c_in, c_out, k, stride, padding):
    """K7's function (the int32 packed conv) and the real-operand
    ``binary_conv2d`` against the reference's dispatchers."""
    jplan, tplan, x, _, _ = _conv_case(hw, c_in, c_out, k, stride, padding)
    _eq(TOPS.binary_conv2d_packed(tplan, _t(x)),
        JOPS.binary_conv2d_packed(jplan, jnp.asarray(x), backend="jnp"))
    rng = _rng("conv-real", hw, c_in, c_out, stride, padding)
    xr = rng.normal(size=(2, *hw, c_in)).astype(np.float32)
    w = _pm1(rng, (c_out, k, k, c_in))
    _eq(TOPS.binary_conv2d(_t(xr), _t(w), stride=stride, padding=padding),
        JOPS.binary_conv2d(jnp.asarray(xr), jnp.asarray(w), stride=stride,
                           padding=padding, backend="jnp"))


def test_binary_conv_matches_pallas():
    hw, c_in, c_out, k, stride, padding = (6, 6), 33, 40, 3, 2, "VALID"
    jplan, tplan, x, _, _ = _conv_case(hw, c_in, c_out, k, stride, padding,
                                       bsz=1)
    want = JOPS.binary_conv2d_packed(jplan, jnp.asarray(x), backend="pallas")
    _eq(TOPS.binary_conv2d_packed(tplan, _t(x)), want)
    _eq(TREF.binary_conv2d_packed_ref(
        _t(x), tplan["w_packed"], tplan["correction"], kh=k, kw=k,
        stride=stride, pads=tplan["pads"], c_out=c_out,
        k_true=tplan["k_true"]), want)


def _bitplane_case(hw, c_out, stride, padding, bsz=2):
    rng = _rng("bitplane", hw, c_out, stride, padding)
    w = _pm1(rng, (c_out, 3, 3, 3))
    jplan = JBC.make_bitplane_conv_plan(jnp.asarray(w), input_hw=hw,
                                        stride=stride, padding=padding)
    tplan = TBC.make_bitplane_conv_plan(torch.from_numpy(w), input_hw=hw,
                                        stride=stride, padding=padding)
    x = rng.integers(0, 256, (bsz, *hw, 3), dtype=np.uint8)
    return jplan, tplan, x


@pytest.mark.parametrize("hw,c_out,stride,padding", [
    ((8, 8), 40, 1, "SAME"), ((9, 9), 10, 2, "SAME"),
    ((9, 7), 33, 2, "VALID")])
def test_bitplane_conv_matches_jnp(hw, c_out, stride, padding):
    jplan, tplan, x = _bitplane_case(hw, c_out, stride, padding)
    want = JOPS.bitplane_conv2d_packed(jplan, jnp.asarray(x), backend="jnp")
    _eq(TOPS.bitplane_conv2d_packed(tplan, torch.from_numpy(x)), want)
    planes = TB.pack_bitplanes_uint8(torch.from_numpy(x))
    _eq(TREF.bitplane_conv2d_planes_ref(
        planes, tplan["w_packed"], tplan["rowsum"], kh=3, kw=3,
        stride=stride, pads=tplan["pads"], c_out=c_out,
        k_true=tplan["k_true"], nbits=8), want)


def test_bitplane_conv_matches_pallas():
    jplan, tplan, x = _bitplane_case((5, 5), 10, 1, "SAME", bsz=1)
    want = JOPS.bitplane_conv2d_packed(jplan, jnp.asarray(x),
                                       backend="pallas")
    _eq(TOPS.bitplane_conv2d_packed(tplan, torch.from_numpy(x)), want)


def test_check_geometry_rejects_wrong_out_hw():
    """The conv wrappers check ``out_hw`` against the input before any
    launch."""
    with pytest.raises(ValueError, match="out_hw"):
        TBC._check_geometry(8, 8, 3, 3, 1, ((1, 1), (1, 1)), (7, 8))
    TBC._check_geometry(8, 8, 3, 3, 2, ((0, 1), (0, 1)), (4, 4))


# ---------------------------------------------------------------------------
# Dispatch
# ---------------------------------------------------------------------------

def test_resolve_contract():
    x = torch.zeros(2, dtype=torch.int32)
    assert TOPS._resolve("auto", x) == "torch"
    assert TOPS._resolve("torch", x) == "torch"
    with pytest.raises(ValueError, match="CUDA"):
        TOPS._resolve("cuda", x)
    for bad in ("pallas", "jnp", "gpu", "CUDA", ""):
        with pytest.raises(ValueError, match="unknown backend"):
            TOPS._resolve(bad, x)


def test_cuda_backend_on_cpu_tensor_raises():
    a = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError):
        TOPS.binary_matmul_packed(a, a, k_true=96, backend="cuda")
    with pytest.raises(ValueError):
        TOPS.bn_sign_pack(a, torch.zeros(3), torch.ones(3), backend="cuda")
    with pytest.raises(ValueError):
        TOPS.bitpack(a.float(), backend="cuda")
    with pytest.raises(ValueError):
        TOPS.binary_matmul(a.float(), a.float(), backend="cuda")
    with pytest.raises(ValueError):
        TOPS.binary_dense_stack_packed([], a, backend="cuda")
    with pytest.raises(ValueError):
        TOPS.binary_conv2d(a.float().reshape(1, 1, 2, 3),
                           torch.zeros((4, 1, 1, 3)), backend="cuda")


def test_kernel_wrappers_take_only_cuda_tensors():
    """The wrappers launch kernels and nothing else: a CPU tensor raises
    before any build, and only ``ops`` routes it to a plain version."""
    a = torch.zeros((2, 3), dtype=torch.int32)
    f = torch.zeros(3)
    for call in (
            lambda: TBM.binary_matmul_packed(a, a, k_true=96),
            lambda: TBM.binary_matmul_bn_sign_packed(a, a, f[:2], f[:2],
                                                     k_true=96),
            lambda: TFE.bn_sign_pack(a, f, f),
            lambda: TBC.binary_conv2d_bn_sign_packed(
                a.reshape(1, 1, 2, 3), a, a, f, f, kh=1, kw=1, stride=1,
                pads=((0, 0), (0, 0)), out_hw=(1, 2), c_out=3, k_true=96),
            lambda: TBC.bitplane_conv2d_packed(
                a.reshape(1, 1, 1, 2, 3), a, a, kh=1, kw=1, stride=1,
                pads=((0, 0), (0, 0)), out_hw=(1, 2), c_out=3, k_true=96,
                nbits=1),
            lambda: TBC.binary_conv2d_packed(
                a.reshape(1, 1, 2, 3), a, a, kh=1, kw=1, stride=1,
                pads=((0, 0), (0, 0)), out_hw=(1, 2), c_out=3, k_true=96),
            lambda: TBP.bitpack(f.reshape(1, 3)),
            lambda: TBM.binary_dense_stack_packed(a, [a], [f[:2]], [f[:2]],
                                                  k_trues=[96])):
        with pytest.raises(ValueError, match="CUDA tensors only"):
            call()


def test_cpu_runs_launch_no_kernel():
    TOPS.reset_launch_counts()
    rng = _rng("count")
    a, b = _words(rng, (2, 64)), _words(rng, (10, 64))
    TOPS.binary_matmul_packed(_t(a), _t(b), k_true=64)
    assert TOPS.launch_counts() == dict.fromkeys(TOPS.KERNELS, 0)


def test_build_finds_no_nvcc_without_toolkit(monkeypatch, tmp_path):
    from repro_torch.kernels import _build
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
