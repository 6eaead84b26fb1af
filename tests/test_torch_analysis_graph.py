"""The fake trace (``repro_torch.analysis.graph``): a ``'cuda'`` forward
of each demo network and of the reduced LM traces to its launch list
with no card, and the counts equal the live reference's
``count_pallas_calls`` but for the port's deliberate differences, each
asserted by name."""
import numpy as np
import pytest
import torch

from repro.analysis import count_pallas_calls
from repro.analysis import report as JREPORT
from repro_torch.analysis import graph
from repro_torch.analysis import report as TREPORT
from repro_torch.kernels import ops
from repro_torch.models import cnn


@pytest.fixture(scope="module")
def demos():
    return {kind: TREPORT.demo_packed(kind)
            for kind in ("bmlp", "bcnn", "transformer")}


def _launches(packed, batch, dense_stack="auto"):
    return graph.kernel_launches(
        lambda p, x: TREPORT.cuda_forward(p, x, dense_stack), packed,
        TREPORT.forward_input(packed, batch))


@pytest.mark.parametrize("kind", ["bmlp", "bcnn", "transformer"])
def test_launch_counts_against_the_live_reference(demos, kind):
    """The reference's bit-plane dense layer runs bitpack + GEMV once per
    plane (8 planes: 16 launches) where the port runs K5 once and K4 once
    on the 8·M stacked rows; its BCNN's first stage is the bit-plane conv
    and the standalone BN-sign pack where the port runs K1-fused.  Every
    other launch is one for one."""
    jpacked = JREPORT.demo_packed(kind)
    for batch in (1, 8):
        fn, x = JREPORT._forward_and_input(jpacked, batch)
        want = count_pallas_calls(fn, x)
        got = [ln.kernel for ln in _launches(demos[kind], batch)]
        if kind == "bmlp":
            assert got == ["bitpack", "xnor_gemm", "bn_sign_pack",
                           "dense_stack", "xnor_gemm"]
            assert want == len(got) - 2 + 2 * 8
        elif kind == "bcnn":
            assert got == ["bitplane_conv_bn_sign", "conv_bn_sign",
                           "dense_stack", "xnor_gemm"]
            assert want == len(got) + 1
        else:
            assert want == len(got) == 50


def test_lm_launches_by_layer(demos):
    """Per layer bitpack, K4 ×3 (q, k, v), bitpack ×2 and K8 (the
    attention), bitpack and K4 (wo), bitpack, K4-fused and K4 (the FFN);
    then the head's bitpack and K4: the reference's order."""
    got = [ln.kernel for ln in _launches(demos["transformer"], 8)]
    layer = ["bitpack", "xnor_gemm", "xnor_gemm", "xnor_gemm", "bitpack",
             "bitpack", "binary_attention", "bitpack", "xnor_gemm",
             "bitpack", "xnor_gemm_bn_sign", "xnor_gemm"]
    assert got == layer * 4 + ["bitpack", "xnor_gemm"]


def test_dense_stack_modes_trace_their_own_launches(demos):
    auto = [ln.kernel for ln in _launches(demos["bmlp"], 8)]
    per_layer = [ln.kernel for ln in _launches(demos["bmlp"], 8,
                                               "per_layer")]
    assert auto.count("dense_stack") == 1
    assert "dense_stack" not in per_layer
    assert per_layer.count("xnor_gemm_bn_sign") == 1   # one hidden layer


def test_trace_records_values_and_touches_no_counter(demos):
    before = ops.launch_counts()
    packed = demos["bcnn"]
    x = TREPORT.forward_input(packed, 2)
    tr = graph.trace(TREPORT.cuda_forward, packed, x)
    assert ops.launch_counts() == before
    leaves = [tr.values[i] for i in tr.inputs]
    assert leaves[-1].shape == tuple(x.shape) and \
        leaves[-1].dtype == torch.uint8
    assert any(v.path[-1] == "w_packed" for v in leaves if v.path)
    (out,) = tr.outputs
    assert tr.values[out].shape == (2, 10)
    assert tr.values[out].dtype == torch.float32
    kernels = [op for op in tr.ops if op.kernel]
    assert all(op.estimate.kernel == op.kernel for op in kernels)


def test_max_intermediate_is_the_bit_planes(demos):
    """No bit-plane stack is the largest intermediate, since none is
    built: K1 reads the raw image, so no (nbits, B, H, W, 32) plane
    tensor exists (537 MB at full width and batch 256, in int64), and
    the largest tensor outside a kernel of the BCNN is a packed pool's
    words, (B, H/2, W/2, Cw) int32 (the bit-domain max of two rows)."""
    packed = demos["bcnn"]
    x = TREPORT.forward_input(packed, 8)
    tr = graph.trace(TREPORT.cuda_forward, packed, x)
    nbits, h, w = packed["spec"].nbits_input, *packed["spec"].input_hw
    assert not [v for v in tr.values if v.shape[:4] == (nbits, 8, h, w)]
    nbytes, shape = graph.max_intermediate_bytes(TREPORT.cuda_forward,
                                                 packed, x)
    cw = packed["spec"].stages[-1].c_out // 32
    assert shape == (8, h // 2, w // 2, cw) and nbytes == np.prod(shape) * 4


def test_bcnn_first_kernel_takes_the_raw_input(demos):
    """The BCNN's ``'cuda'`` forward hands its uint8 input to K1-fused
    as it is: the first op of the trace is ``bitplane_conv_bn_sign`` on
    the input leaf, and no aten op reads the input before or beside it."""
    packed = demos["bcnn"]
    x = TREPORT.forward_input(packed, 8)
    tr = graph.trace(TREPORT.cuda_forward, packed, x)
    leaf = tr.inputs[-1]
    assert tr.values[leaf].dtype == torch.uint8
    assert tr.values[leaf].shape == tuple(x.shape)
    first = tr.ops[0]
    assert first.kernel == "bitplane_conv_bn_sign"
    assert first.inputs[0] == leaf
    assert [op.name for op in tr.ops if leaf in op.inputs] == [first.name]


def test_indexing_on_fake_tensors_matches_pytorch():
    """The bindings routed to aten ops index as PyTorch does."""
    x = torch.arange(2 * 3 * 4 * 5).reshape(2, 3, 4, 5)
    idx = torch.tensor([2, 0, 1])
    cases = [lambda t: t[1], lambda t: t[:, None, 1:3:2], lambda t: t[..., -1],
             lambda t: t[:, idx], lambda t: t[0, :, idx, None],
             lambda t: t[[1, 0]], lambda t: ~t, lambda t: t.permute(
                 3, 2, 1, 0).contiguous(), lambda t: t.to("cuda")[..., 0]]
    for i, case in enumerate(cases):
        tr = graph.trace(lambda t: case(t), x)
        (out,) = tr.outputs
        want = case(x) if i < len(cases) - 1 else x[..., 0]
        assert tr.values[out].shape == tuple(want.shape), i


def test_host_sync_stops_the_trace():
    def syncs(x):
        return x * x.sum().item()
    with pytest.raises(graph.HostSyncError, match="host"):
        graph.trace(syncs, torch.ones(3))


def test_packed_forwards_have_no_host_sync(demos):
    """The forwards the probes trace read nothing back to the host (a
    ``.item()`` would raise ``HostSyncError``), also through
    ``make_packed_forward``'s input check."""
    for kind, packed in demos.items():
        x = TREPORT.forward_input(packed, 3)
        graph.trace(lambda p, a: cnn.make_packed_forward(
            p, backend="cuda")(a), packed, x)
