"""Every kernel of ``ops.KERNELS`` is a ``repro_torch::`` torch op: its
fake implementation makes exactly the shape and dtype of the kernel's
plain version (``kernels/ref.py``) on the same inputs, ragged shapes
included, and the ``'cuda'`` dispatchers launch through the ops.  The ops
run here on fake card tensors only; on real ones they need the card."""
import zlib

import numpy as np
import pytest
import torch

from repro_torch.analysis import graph
from repro_torch.core import binarize as B
from repro_torch.kernels import binary_conv as bconv
from repro_torch.kernels import library as lib
from repro_torch.kernels import ops
from repro_torch.kernels import ref


def _gen(*key):
    return torch.Generator().manual_seed(zlib.crc32(repr(key).encode()))


def _pm1(gen, *shape):
    return torch.rand(shape, generator=gen) * 2 - 1


def _words(gen, *shape):
    return B.pack_bits(_pm1(gen, *shape))


def _bn(gen, c):
    return (torch.randn(c, generator=gen),
            torch.where(torch.rand(c, generator=gen) < 0.3, -1.0, 1.0))


def _fake_out(kernel, *args):
    """The op's output (shape, dtype) on fake card twins of ``args``."""
    tr = graph.trace(lambda *a: lib.OPS[kernel](*a), *args)
    (out,) = tr.outputs
    assert [op.kernel for op in tr.ops] == [kernel]
    return tr.values[out].shape, tr.values[out].dtype


def _same(got, want):
    assert got == (tuple(want.shape), want.dtype)


def test_every_kernel_is_an_op_with_a_cuda_implementation():
    assert set(lib.OPS) == set(ops.KERNELS) == set(lib.SPECS)
    for name in lib.OPS:
        qual = f"{lib.NAMESPACE}::{name}"
        assert torch._C._dispatch_has_kernel_for_dispatch_key(qual, "CUDA")
        assert not torch._C._dispatch_has_kernel_for_dispatch_key(qual,
                                                                  "CPU")
        assert lib.kernel_of(lib.OPS[name]) == name
    assert lib.kernel_of(torch.ops.aten.add.Tensor) is None


def test_ops_refuse_real_cpu_tensors():
    """Nothing falls back: an op on a CPU tensor has no kernel to run."""
    with pytest.raises(NotImplementedError):
        lib.OPS["bitpack"](torch.zeros(2, 40))


@pytest.mark.parametrize("m,k", [(1, 1), (37, 31), (5, 784), (8, 4096)])
def test_bitpack_fake(m, k):
    x = _pm1(_gen("bp", m, k), m, k)
    _same(_fake_out("bitpack", x), ref.bitpack_ref(x))


@pytest.mark.parametrize("m,c", [(1, 40), (37, 10), (9, 128)])
def test_bn_sign_pack_fake(m, c):
    gen = _gen("k2", m, c)
    x = torch.randint(-50, 50, (m, c), generator=gen, dtype=torch.int32)
    tau, flip = _bn(gen, c)
    _same(_fake_out("bn_sign_pack", x, tau, flip),
          ref.bn_sign_pack_ref(x, tau, flip))


@pytest.mark.parametrize("m,n,k", [(1, 10, 70), (9, 40, 300), (64, 33, 32)])
def test_xnor_gemm_fakes(m, n, k):
    gen = _gen("k4", m, n, k)
    a, b = _words(gen, m, k), _words(gen, n, k)
    tau, flip = _bn(gen, n)
    _same(_fake_out("xnor_gemm", a, b, k),
          ref.binary_matmul_packed_ref(a, b, k))
    _same(_fake_out("xnor_gemm_bn_sign", a, b, tau, flip, k),
          ref.binary_matmul_bn_sign_packed_ref(a, b, tau, flip, k))


@pytest.mark.parametrize("m,sizes", [(3, (70, 40, 33)), (17, (64, 96))])
def test_dense_stack_fake(m, sizes):
    gen = _gen("k6", m, sizes)
    stages, k = [], sizes[0]
    for n in sizes[1:]:
        tau, flip = _bn(gen, n)
        stages.append({"w_packed": _words(gen, n, k), "k_true": k,
                       "tau": tau, "flip": flip})
        k = n
    x = _words(gen, m, sizes[0])
    args = (x, [*(s["w_packed"] for s in stages),
                *(s["tau"] for s in stages), *(s["flip"] for s in stages)],
            [s["k_true"] for s in stages])
    _same(_fake_out("dense_stack", *args),
          ref.binary_dense_stack_packed_ref(stages, x))


CONV_CASES = [((9, 9), 33, 40, 2, "VALID"), ((7, 7), 20, 10, 1, "SAME"),
              ((8, 8), 64, 64, 1, "SAME")]


@pytest.mark.parametrize("hw,c_in,c_out,stride,padding", CONV_CASES)
def test_conv_fakes(hw, c_in, c_out, stride, padding):
    gen = _gen("k3", hw, c_in, c_out, stride)
    plan = bconv.make_conv_plan(_pm1(gen, c_out, 3, 3, c_in), input_hw=hw,
                                stride=stride, padding=padding)
    x = _words(gen, 2, *hw, c_in)
    tau, flip = _bn(gen, c_out)
    geom = lib.conv_geom(plan)
    kw = lib.geom_kwargs(geom)
    assert kw["pads"] == plan["pads"] and kw["out_hw"] == plan["out_hw"]
    conv = dict(kh=3, kw=3, stride=stride, pads=plan["pads"], c_out=c_out,
                k_true=plan["k_true"])
    _same(_fake_out("binary_conv", x, plan["w_packed"], plan["correction"],
                    geom),
          ref.binary_conv2d_packed_ref(x, plan["w_packed"],
                                       plan["correction"], **conv))
    _same(_fake_out("conv_bn_sign", x, plan["w_packed"], plan["correction"],
                    tau, flip, geom),
          ref.binary_conv2d_bn_sign_packed_ref(
              x, plan["w_packed"], plan["correction"], tau, flip, **conv))


@pytest.mark.parametrize("hw,c_in,c_out,stride,padding", CONV_CASES[:2])
def test_bitplane_conv_fakes(hw, c_in, c_out, stride, padding):
    gen = _gen("k1", hw, c_in, c_out, stride)
    plan = bconv.make_bitplane_conv_plan(
        _pm1(gen, c_out, 3, 3, c_in), input_hw=hw, stride=stride,
        padding=padding, nbits=8)
    x = torch.randint(0, 256, (2, *hw, c_in), generator=gen,
                      dtype=torch.uint8)
    tau, flip = _bn(gen, c_out)
    geom = [*lib.conv_geom(plan), 8]
    conv = dict(kh=3, kw=3, stride=stride, pads=plan["pads"], c_out=c_out,
                k_true=plan["k_true"], nbits=8)
    _same(_fake_out("bitplane_conv", x, plan["w_packed"],
                    plan["rowsum"], geom),
          ref.bitplane_conv2d_packed_ref(x, plan["w_packed"],
                                         plan["rowsum"], **conv))
    _same(_fake_out("bitplane_conv_bn_sign", x, plan["w_packed"],
                    plan["rowsum"], tau, flip, geom),
          ref.bitplane_conv2d_bn_sign_packed_ref(
              x, plan["w_packed"], plan["rowsum"], tau, flip, **conv))


@pytest.mark.parametrize("b,sq,skv,hq,hkv,d,dv", [
    (1, 5, 5, 4, 2, 40, 24), (2, 16, 9, 2, 1, 256, 256),
    (1, 3, 70, 2, 2, 64, 300)])
def test_binary_attention_fake(b, sq, skv, hq, hkv, d, dv):
    gen = _gen("k8", b, sq, skv, d)
    qp = _words(gen, b, sq, hq, d)
    kp = _words(gen, b, skv, hkv, d)
    v = torch.randn((b, skv, hkv, dv), generator=gen)
    _same(_fake_out("binary_attention", qp, kp, v, d, True, 4, 50.0, 0),
          ref.binary_attention_packed_ref(qp, kp, v, d_true=d, window=4,
                                          attn_softcap=50.0))


def test_cuda_dispatchers_launch_through_the_ops():
    """The ``'cuda'`` route of every dispatcher is its kernel's op (here
    on fake card tensors), and a launch counter only moves on the card."""
    gen = _gen("route")
    a, b = _pm1(gen, 9, 70), _pm1(gen, 12, 70)
    before = ops.launch_counts()
    tr = graph.trace(lambda x, y: ops.binary_matmul(x, y, backend="cuda"),
                     a, b)
    assert [op.name for op in tr.ops if op.kernel] == [
        "repro_torch.bitpack.default", "repro_torch.bitpack.default",
        "repro_torch.xnor_gemm.default"]
    assert ops.launch_counts() == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        ops.binary_matmul(a, b, backend="cuda")


def test_launch_calls_the_body_directly_outside_a_trace(monkeypatch):
    """Outside a dispatch mode a ``'cuda'`` launch calls the kernel's CUDA
    body with no boxing (here a stub: the body needs the card); inside a
    trace the same launch is the kernel's op."""
    calls = []
    monkeypatch.setitem(lib.BODIES, "bitpack",
                        lambda x: calls.append(x.shape) or x)
    x = torch.zeros(2, 40)
    assert ops._launch("bitpack", x) is x and calls == [(2, 40)]
    tr = graph.trace(lambda t: ops._launch("bitpack", t), x)
    assert [op.kernel for op in tr.ops] == ["bitpack"] and len(calls) == 1


def test_record_launches_nests_and_restores(monkeypatch):
    """The CUDA implementations name their kernel to the active recorder
    (here with the wrappers stubbed: they need the card)."""
    monkeypatch.setattr(lib._bp, "bitpack", lambda x: x)
    monkeypatch.setattr(lib._bmm, "binary_matmul_packed",
                        lambda a, b, k_true: a)
    x = torch.zeros(2, 3)
    with lib.record_launches() as outer:
        lib._bitpack(x)
        with lib.record_launches() as inner:
            lib._xnor_gemm(x, x, 3)
        lib._bitpack(x)
    lib._xnor_gemm(x, x, 3)              # nothing records it
    assert outer == ["bitpack", "bitpack"] and inner == ["xnor_gemm"]
    assert lib._recording is None


def test_geom_round_trips_the_conv_wrappers_keywords():
    gen = _gen("geom")
    plan = bconv.make_conv_plan(_pm1(gen, 8, 3, 3, 5), input_hw=(7, 6),
                                stride=2, padding="SAME")
    kw = lib.geom_kwargs(lib.conv_geom(plan))
    assert kw == dict(kh=3, kw=3, stride=2, pads=plan["pads"],
                      out_hw=plan["out_hw"], c_out=8,
                      k_true=plan["k_true"])
    assert np.prod(plan["out_hw"]) > 0
