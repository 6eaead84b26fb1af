"""The port's CUDA kernels against their plain versions, on the card.

    python -m pytest -m cuda tests/test_torch_cuda.py     # on the card

Every test here needs a CUDA card and skips without one; the check runs
inside the fixture, never at import time.
"""
import pytest
import torch

from repro_torch import configs
from repro_torch.core import binarize as B
from repro_torch.kernels import binary_attention as batt
from repro_torch.kernels import binary_conv as bconv
from repro_torch.kernels import binary_matmul as bmm
from repro_torch.kernels import bitpack as bp
from repro_torch.kernels import fused_epilogue as fe
from repro_torch.kernels import ops
from repro_torch.kernels import ref
from repro_torch.models import cnn
from repro_torch.models import transformer as tf

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _pm1(gen, *shape):
    return torch.rand(shape, generator=gen) * 2 - 1


def _bn(gen, c, k, dev):
    tau = torch.randint(-k, k + 1, (c,), generator=gen).float()
    tau += 0.5 * (torch.rand(c, generator=gen) < 0.5)
    flip = torch.where(torch.rand(c, generator=gen) < 0.3, -1.0, 1.0)
    return tau.to(dev), flip.to(dev)


@pytest.mark.parametrize("m,c", [(1, 40), (37, 10), (2048, 128)])
def test_bn_sign_pack_kernel(dev, m, c):
    gen = torch.Generator().manual_seed(m + c)
    x = torch.randint(-99, 99, (m, c), generator=gen,
                      dtype=torch.int32).to(dev)
    tau, flip = _bn(gen, c, 99, dev)
    assert torch.equal(fe.bn_sign_pack(x, tau, flip),
                       ref.bn_sign_pack_ref(x, tau, flip))


# K2's two paths on the same rows: the aligned path (C % 4 == 0, x on 16
# bytes) and, 4 bytes off 16-byte alignment, the warp-per-word path.  M
# below and past a tile of 8 rows; a word tail (C 40, 100); two slabs of
# 128 channels, the second one lane wide (C 132); the BMLP's (256, 4096);
# grids that walk several tiles a warp (M 40000).  Channel 0's tau equals
# row 0's value.
@pytest.mark.parametrize("m,c", [(1, 4), (37, 40), (3, 132), (9, 100),
                                 (256, 4096), (40000, 128), (40000, 132)])
def test_bn_sign_pack_both_paths(dev, m, c):
    gen = torch.Generator().manual_seed(3 * m + c)
    x = torch.randint(-99, 99, (m, c), generator=gen,
                      dtype=torch.int32).to(dev)
    tau, flip = _bn(gen, c, 99, dev)
    tau[0] = x[0, 0].float()
    want = ref.bn_sign_pack_ref(x, tau, flip)
    assert fe.bn_sign_aligned(c, x.data_ptr())
    assert torch.equal(fe.bn_sign_pack(x, tau, flip), want)
    xm = _misaligned(x)
    assert not fe.bn_sign_aligned(c, xm.data_ptr())
    assert torch.equal(fe.bn_sign_pack(xm, tau, flip), want)


@pytest.mark.parametrize("m,n,k", [(1, 10, 1024), (3, 40, 70),
                                   (256, 1024, 8192)])
def test_xnor_gemm_kernels(dev, m, n, k):
    gen = torch.Generator().manual_seed(m + n + k)
    a = B.pack_bits(_pm1(gen, m, k)).to(dev)
    w = B.pack_bits(_pm1(gen, n, k)).to(dev)
    tau, flip = _bn(gen, n, k, dev)
    assert torch.equal(bmm.binary_matmul_packed(a, w, k_true=k),
                       ref.binary_matmul_packed_ref(a, w, k))
    assert torch.equal(
        bmm.binary_matmul_bn_sign_packed(a, w, tau, flip, k_true=k),
        ref.binary_matmul_bn_sign_packed_ref(a, w, tau, flip, k))


def _misaligned(t, by=4):
    """A contiguous copy of ``t`` starting ``by`` bytes past 16-byte
    alignment (a multiple of its element size)."""
    size = t.element_size()
    flat = torch.empty(t.numel() + 16 // size, dtype=t.dtype,
                       device=t.device)
    start = next(i for i in range(16 // size)
                 if (flat.data_ptr() + size * i) % 16 == by)
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


# The edges of K4's tiles: the small-M route's limit (8) and past it, rows
# that end inside an m16 fragment, one and two 64- and 128-row tiles,
# ragged N and K, the LM's widths, and rows that do not start on 16 bytes.
@pytest.mark.parametrize("m,n,k,shift", [
    (8, 136, 31, False), (9, 136, 3584, False), (15, 136, 31, False), (16, 40, 3584, False), (17, 10, 33, False),
    (128, 136, 1, False), (129, 40, 14336, False), (1, 14336, 3584, False),
    (4608, 14336, 3584, False), (129, 136, 3584, True),
    (15, 40, 3584, True), (4608, 136, 33, True), (2048, 4096, 100, True)])
def test_xnor_gemm_tile_edges(dev, m, n, k, shift):
    gen = torch.Generator().manual_seed(m * n + k)
    a = B.pack_bits(_pm1(gen, m, k)).to(dev)
    w = B.pack_bits(_pm1(gen, n, k)).to(dev)
    if shift:
        a, w = _misaligned(a), _misaligned(w)
        assert a.data_ptr() % 16 == 4 and a.is_contiguous()
    tau, flip = _bn(gen, n, k, dev)
    assert torch.equal(bmm.binary_matmul_packed(a, w, k_true=k),
                       ref.binary_matmul_packed_ref(a, w, k))
    assert torch.equal(
        bmm.binary_matmul_bn_sign_packed(a, w, tau, flip, k_true=k),
        ref.binary_matmul_bn_sign_packed_ref(a, w, tau, flip, k))


def _image(gen, dev, bsz, hw, c_in, nbits, high=False):
    """A random uint8 image below 2^nbits, or with ``high`` over all 256
    values (bits above nbits set, which K1 must ignore)."""
    top = 256 if high else 2 ** nbits
    return torch.randint(0, top, (bsz, *hw, c_in), generator=gen,
                         dtype=torch.uint8).to(dev)


def _k1_operands(x, bplan, dev):
    """K1's operands on the raw image and the plain version's on its bit
    planes (``binarize.pack_bitplanes_uint8``, the low nbits bits)."""
    w, r = bplan["w_packed"].to(dev), bplan["rowsum"].to(dev)
    return (x, w, r), (B.pack_bitplanes_uint8(x, bplan["nbits"]), w, r)


# K1's edges, and inputs whose full band and 64 channels' weights exceed a
# block's shared memory: C_in 288 (chunks of 32 channels), C_in 768 (8
# channels, a 2-row band) and a 448-wide row at C_in 128 (16 channels, a
# 1-row band).
K1_EDGES = [
    ((9, 9), 33, 40, 2, "SAME", 1), ((11, 7), 33, 10, 2, "VALID", 8),
    ((9, 9), 3, 40, 2, "SAME", 1), ((13, 5), 3, 136, 2, "VALID", 8),
    ((32, 32), 3, 128, 1, "SAME", 8), ((7, 7), 33, 72, 1, "SAME", 4),
    ((32, 32), 288, 64, 1, "SAME", 8), ((32, 32), 768, 40, 1, "SAME", 8),
    ((4, 448), 128, 72, 1, "SAME", 8)]


@pytest.mark.parametrize("hw,c_in,c_out,stride,padding,nbits", K1_EDGES)
def test_bitplane_conv_kernel_edges(dev, hw, c_in, c_out, stride, padding,
                                    nbits):
    gen = torch.Generator().manual_seed(c_in * c_out + nbits)
    bplan = bconv.make_bitplane_conv_plan(
        _pm1(gen, c_out, 3, 3, c_in), input_hw=hw, stride=stride,
        padding=padding, nbits=nbits)
    kargs, pargs = _k1_operands(_image(gen, dev, 3, hw, c_in, nbits), bplan,
                                dev)
    geom = dict(kh=3, kw=3, stride=stride, pads=bplan["pads"], c_out=c_out,
                k_true=bplan["k_true"])
    assert torch.equal(
        bconv.bitplane_conv2d_packed(*kargs, out_hw=bplan["out_hw"],
                                     nbits=nbits, **geom),
        ref.bitplane_conv2d_planes_ref(*pargs, nbits=nbits, **geom))


# K1's copy of the band from the image, a byte a thread: rows whose bytes
# are not whole 16-byte units (C_in 3 at W 9 and 13, C_in 33 at W 7);
# rows of whole 16-byte units with and without a left halo (C_in 16 SAME,
# C_in 32 VALID at stride 2), also 1 byte off 16-byte alignment; and
# nbits 1 and 4 on images with the bits above nbits set, which must read
# as their low bits.
@pytest.mark.parametrize("hw,c_in,c_out,stride,padding,nbits,high,shift", [
    ((9, 9), 3, 40, 1, "SAME", 8, False, False),
    ((13, 13), 3, 72, 2, "SAME", 8, False, False),
    ((7, 7), 33, 40, 1, "SAME", 8, False, False),
    ((8, 8), 16, 40, 1, "SAME", 8, False, False),
    ((9, 9), 32, 40, 2, "VALID", 8, False, False),
    ((8, 8), 16, 40, 1, "SAME", 8, False, True),
    ((9, 9), 32, 40, 2, "VALID", 8, False, True),
    ((9, 9), 3, 40, 1, "SAME", 1, True, False),
    ((7, 7), 33, 72, 1, "SAME", 4, True, False),
    ((8, 8), 16, 40, 1, "SAME", 4, True, False),
    ((9, 9), 32, 40, 2, "VALID", 1, True, False)])
def test_bitplane_conv_reads_the_raw_image(dev, hw, c_in, c_out, stride,
                                           padding, nbits, high, shift):
    gen = torch.Generator().manual_seed(c_in * c_out + nbits + 7 * stride)
    bplan = bconv.make_bitplane_conv_plan(
        _pm1(gen, c_out, 3, 3, c_in), input_hw=hw, stride=stride,
        padding=padding, nbits=nbits)
    x = _image(gen, dev, 3, hw, c_in, nbits, high)
    if shift:
        x = _misaligned(x, by=1)
        assert x.data_ptr() % 16 == 1
    kargs, pargs = _k1_operands(x, bplan, dev)
    geom = dict(kh=3, kw=3, stride=stride, pads=bplan["pads"], c_out=c_out,
                k_true=bplan["k_true"], nbits=nbits)
    y = bconv.bitplane_conv2d_packed(*kargs, out_hw=bplan["out_hw"], **geom)
    want = ref.bitplane_conv2d_planes_ref(*pargs, **geom)
    assert torch.equal(y, want)
    tau, flip = _bn(gen, c_out, 2 ** nbits * int(bplan["k_true"] ** 0.5),
                    dev)
    tau[:4] = y[0, 0, 0, :4].float()
    assert torch.equal(
        bconv.bitplane_conv2d_bn_sign_packed(*kargs, tau, flip,
                                             out_hw=bplan["out_hw"], **geom),
        ref.bn_sign_pack_ref(want, tau, flip))


# K1's fused instance (K2's epilogue inside K1) against its plain version
# and against K2 on K1's int32 output: chunks of 64 channels (the BCNN's
# first stage; C_out 40, 10, 136, 72 and 33 with tail words; stride 2;
# VALID; 1 and 4 planes) and of 32 (C_in 288), and a band halved to keep
# chunks of 32 (C_in 448: the int32 instance takes 8 rows of 16 channels,
# the fused one 4 rows of 32).  Four channels' tau equal one output.
K1_FUSED_EDGES = [
    ((32, 32), 3, 128, 1, "SAME", 8), ((9, 9), 33, 40, 2, "SAME", 1),
    ((11, 7), 33, 10, 2, "VALID", 8), ((13, 5), 3, 136, 2, "VALID", 8),
    ((7, 7), 33, 72, 1, "SAME", 4), ((9, 9), 3, 33, 1, "SAME", 8),
    ((32, 32), 288, 64, 1, "SAME", 8), ((16, 16), 448, 40, 1, "SAME", 8)]


@pytest.mark.parametrize("hw,c_in,c_out,stride,padding,nbits",
                         K1_FUSED_EDGES)
def test_bitplane_conv_bn_sign_kernel(dev, hw, c_in, c_out, stride, padding,
                                      nbits):
    gen = torch.Generator().manual_seed(c_in * c_out + nbits + stride)
    bplan = bconv.make_bitplane_conv_plan(
        _pm1(gen, c_out, 3, 3, c_in), input_hw=hw, stride=stride,
        padding=padding, nbits=nbits)
    kargs, pargs = _k1_operands(_image(gen, dev, 3, hw, c_in, nbits), bplan,
                                dev)
    geom = dict(kh=3, kw=3, stride=stride, pads=bplan["pads"], c_out=c_out,
                k_true=bplan["k_true"], nbits=nbits)
    y = bconv.bitplane_conv2d_packed(*kargs, out_hw=bplan["out_hw"], **geom)
    tau, flip = _bn(gen, c_out, 2 ** nbits * int(bplan["k_true"] ** 0.5),
                    dev)
    tau[:4] = y[0, 0, 0, :4].float()
    got = bconv.bitplane_conv2d_bn_sign_packed(
        *kargs, tau, flip, out_hw=bplan["out_hw"], **geom)
    assert torch.equal(got, ref.bn_sign_pack_ref(
        ref.bitplane_conv2d_planes_ref(*pargs, **geom), tau, flip))
    assert torch.equal(got, fe.bn_sign_pack(y.reshape(-1, c_out), tau, flip)
                       .reshape(got.shape))


def test_bitplane_conv_bn_sign_refuses_chunks_below_32(dev):
    """Where 32 channels' weights fit no band, the fused instance raises
    (the int32 instance serves the shape with chunks of 16)."""
    hw, c_in, c_out = (32, 32), 512, 40
    gen = torch.Generator().manual_seed(5)
    bplan = bconv.make_bitplane_conv_plan(_pm1(gen, c_out, 3, 3, c_in),
                                          input_hw=hw, nbits=8)
    x = torch.zeros((1, *hw, c_in), dtype=torch.uint8, device=dev)
    tau, flip = _bn(gen, c_out, 100, dev)
    with pytest.raises(ValueError, match="32 channels' weights"):
        bconv.bitplane_conv2d_bn_sign_packed(
            x, bplan["w_packed"].to(dev), bplan["rowsum"].to(dev), tau,
            flip, kh=3, kw=3, stride=1, pads=bplan["pads"],
            out_hw=bplan["out_hw"], c_out=c_out, k_true=bplan["k_true"],
            nbits=8)


def test_bitplane_conv_refuses_what_shared_memory_cannot_hold(dev):
    hw, c_in = (3, 2048), 1024
    bplan = bconv.make_bitplane_conv_plan(
        torch.ones(8, 3, 3, c_in), input_hw=hw, padding="VALID", nbits=8)
    x = torch.zeros((1, *hw, c_in), dtype=torch.uint8, device=dev)
    with pytest.raises(ValueError, match="shared memory"):
        bconv.bitplane_conv2d_packed(
            x, bplan["w_packed"].to(dev), bplan["rowsum"].to(dev),
            kh=3, kw=3, stride=1, pads=bplan["pads"],
            out_hw=bplan["out_hw"], c_out=8, k_true=bplan["k_true"],
            nbits=8)


# K3/K7's tensor-core tiles: the BCNN's five packed-conv stages (Cw 4, 8
# and 16: 4.5, 9 and 18 k256 steps), then ragged channels (C_out 10, 40,
# 136) and inputs of 1 and 2 words (rows not 16-byte aligned: 4-byte
# copies), stride 2 VALID and pixel counts that end inside a tile.
CONV_STAGES_AND_RAGGED = [
    ((16, 16), 128, 256, 1, "SAME"), ((16, 16), 256, 256, 1, "SAME"),
    ((8, 8), 256, 512, 1, "SAME"), ((8, 8), 512, 512, 1, "SAME"),
    ((9, 9), 3, 136, 1, "SAME"), ((11, 7), 33, 136, 2, "VALID"),
    ((9, 9), 64, 40, 2, "VALID"), ((5, 5), 128, 10, 1, "SAME")]


@pytest.mark.parametrize("hw,c_in,c_out,stride,padding", [
    ((32, 32), 128, 128, 1, "SAME"), ((9, 9), 33, 40, 2, "VALID"),
    ((7, 7), 20, 10, 2, "SAME")] + CONV_STAGES_AND_RAGGED)
def test_conv_kernels(dev, hw, c_in, c_out, stride, padding):
    gen = torch.Generator().manual_seed(c_in + c_out + stride)
    plan = bconv.make_conv_plan(_pm1(gen, c_out, 3, 3, c_in), input_hw=hw,
                                stride=stride, padding=padding)
    geom = dict(kh=3, kw=3, stride=stride, pads=plan["pads"], c_out=c_out,
                k_true=plan["k_true"])
    x = B.pack_bits(_pm1(gen, 2, *hw, c_in)).to(dev)
    tau, flip = _bn(gen, c_out, plan["k_true"], dev)
    args = (x, plan["w_packed"].to(dev), plan["correction"].to(dev), tau,
            flip)
    assert torch.equal(
        bconv.binary_conv2d_bn_sign_packed(*args, out_hw=plan["out_hw"],
                                           **geom),
        ref.binary_conv2d_bn_sign_packed_ref(*args, **geom))
    bplan = bconv.make_bitplane_conv_plan(_pm1(gen, c_out, 3, 3, 3),
                                          input_hw=hw, stride=stride,
                                          padding=padding)
    kargs, pargs = _k1_operands(_image(gen, dev, 2, hw, 3, 8), bplan, dev)
    geom["k_true"] = bplan["k_true"]
    assert torch.equal(
        bconv.bitplane_conv2d_packed(*kargs, out_hw=bplan["out_hw"],
                                     nbits=8, **geom),
        ref.bitplane_conv2d_planes_ref(*pargs, nbits=8, **geom))


@pytest.mark.parametrize("m,k", [(1, 1), (37, 31), (1, 33), (37, 784),
                                 (1, 1000), (8192, 8192)])
def test_bitpack_kernel(dev, m, k):
    gen = torch.Generator().manual_seed(m + k)
    x = torch.randn((m, k), generator=gen)
    x[0, : min(k, 3)] = torch.tensor([-0.0, float("nan"), 0.0])[: min(k, 3)]
    x = x.to(dev)
    assert torch.equal(bp.bitpack(x), ref.bitpack_ref(x))


@pytest.mark.parametrize("m", [1, 3, 9, 37, 300])
def test_dense_stack_kernel(dev, m):
    gen = torch.Generator().manual_seed(m)
    k = 100
    x = B.pack_bits(_pm1(gen, m, k)).to(dev)
    stages = []
    for n in (40, 96, 10):
        tau, flip = _bn(gen, n, k, dev)
        stages.append({"w_packed": B.pack_bits(_pm1(gen, n, k)).to(dev),
                       "k_true": k, "tau": tau, "flip": flip})
        k = n
    got = bmm.binary_dense_stack_packed(
        x, [s["w_packed"] for s in stages], [s["tau"] for s in stages],
        [s["flip"] for s in stages], k_trues=[s["k_true"] for s in stages])
    assert torch.equal(got, ref.binary_dense_stack_packed_ref(stages, x))
    with pytest.raises(ValueError, match="words wide"):
        bmm.binary_dense_stack_packed(x, [stages[1]["w_packed"]],
                                      [stages[1]["tau"]],
                                      [stages[1]["flip"]], k_trues=[40])


@pytest.mark.parametrize("hw,c_in,c_out,stride,padding", [
    ((16, 16), 128, 256, 1, "SAME"), ((9, 9), 33, 40, 2, "VALID"),
    ((7, 7), 20, 40, 1, "SAME"), ((9, 9), 64, 10, 2, "SAME"),
    ((32, 32), 128, 128, 1, "SAME")] + CONV_STAGES_AND_RAGGED[1:])
def test_binary_conv_kernel(dev, hw, c_in, c_out, stride, padding):
    gen = torch.Generator().manual_seed(c_in * c_out + stride)
    plan = bconv.make_conv_plan(_pm1(gen, c_out, 3, 3, c_in), input_hw=hw,
                                stride=stride, padding=padding)
    geom = dict(kh=3, kw=3, stride=stride, pads=plan["pads"], c_out=c_out,
                k_true=plan["k_true"])
    x = B.pack_bits(_pm1(gen, 2, *hw, c_in)).to(dev)
    args = (x, plan["w_packed"].to(dev), plan["correction"].to(dev))
    assert torch.equal(
        bconv.binary_conv2d_packed(*args, out_hw=plan["out_hw"], **geom),
        ref.binary_conv2d_packed_ref(*args, **geom))


@pytest.mark.parametrize("bsz,hw,c_in,c_out,shift", [
    (80, (15, 15), 64, 40, False),     # 64 x 128 tiles, M ends inside one
    (256, (8, 8), 512, 512, False),    # the BCNN's last stage at batch 256
    (3, (9, 9), 128, 40, True),        # x 4 bytes off 16: 4-byte copies
    (1, (2, 2), 256, 136, False)])     # M = 4, one tile mostly empty
def test_conv_kernel_tiles(dev, bsz, hw, c_in, c_out, shift):
    gen = torch.Generator().manual_seed(bsz + c_in + c_out)
    plan = bconv.make_conv_plan(_pm1(gen, c_out, 3, 3, c_in), input_hw=hw)
    geom = dict(kh=3, kw=3, stride=1, pads=plan["pads"], c_out=c_out,
                k_true=plan["k_true"])
    x = B.pack_bits(_pm1(gen, bsz, *hw, c_in)).to(dev)
    if shift:
        x = _misaligned(x)
    tau, flip = _bn(gen, c_out, plan["k_true"], dev)
    args = (x, plan["w_packed"].to(dev), plan["correction"].to(dev))
    assert torch.equal(
        bconv.binary_conv2d_packed(*args, out_hw=plan["out_hw"], **geom),
        ref.binary_conv2d_packed_ref(*args, **geom))
    assert torch.equal(
        bconv.binary_conv2d_bn_sign_packed(*args, tau, flip,
                                           out_hw=plan["out_hw"], **geom),
        ref.binary_conv2d_bn_sign_packed_ref(*args, tau, flip, **geom))


def test_wrappers_reject_what_they_do_not_take(dev):
    a = torch.zeros((4, 8), dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="dtype"):
        bmm.binary_matmul_packed(a.float(), a, k_true=256)
    with pytest.raises(ValueError, match="shape"):
        bmm.binary_matmul_packed(a, a[:, :4], k_true=256)
    with pytest.raises(ValueError, match="contiguous"):
        bmm.binary_matmul_packed(a[:, ::2], a[:, :4].contiguous(),
                                 k_true=128)
    with pytest.raises(ValueError, match="on cpu"):
        bmm.binary_matmul_packed(a, a.cpu(), k_true=256)


def test_forward_launch_counts_and_parity(dev):
    spec = cnn.BCNNSpec(input_hw=(16, 16),
                        stages=(cnn.ConvStage(64), cnn.ConvStage(64, True),
                                cnn.ConvStage(96, True)),
                        dense=(128, 40, 10))
    gen = torch.Generator().manual_seed(0)
    packed = cnn.pack_bcnn(cnn.init_bcnn(gen, spec), spec)
    fwd = cnn.make_packed_forward(packed)
    x = torch.randint(0, 256, (5, 16, 16, 3), generator=gen,
                      dtype=torch.uint8)
    ops.reset_launch_counts()
    got = fwd(x)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "bitplane_conv_bn_sign": 1, "conv_bn_sign": 2, "xnor_gemm": 1,
        "dense_stack": 1}
    want = cnn.bcnn_forward_packed(packed, x.to(dev), backend="torch")
    assert torch.equal(got, want)


def test_forward_pooled_stage0_launch_counts_and_parity(dev):
    """A first stage that pools keeps K1, the int32 pool and K2."""
    spec = cnn.BCNNSpec(input_hw=(16, 16),
                        stages=(cnn.ConvStage(40, True),
                                cnn.ConvStage(64, True)),
                        dense=(128, 10))
    gen = torch.Generator().manual_seed(1)
    packed = cnn.pack_bcnn(cnn.init_bcnn(gen, spec), spec)
    x = torch.randint(0, 256, (5, 16, 16, 3), generator=gen,
                      dtype=torch.uint8).to(dev)
    ops.reset_launch_counts()
    got = cnn.bcnn_forward_packed_int(packed, x)
    torch.cuda.synchronize()
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "bitplane_conv": 1, "bn_sign_pack": 1, "conv_bn_sign": 1,
        "xnor_gemm": 1, "dense_stack": 1}
    assert torch.equal(got, cnn.bcnn_forward_packed_int(packed, x,
                                                        backend="torch"))


def test_bmlp_launch_counts_and_parity(dev):
    spec = cnn.BMLPSpec(sizes=(100, 256, 96, 40, 10))
    gen = torch.Generator().manual_seed(0)
    packed = cnn.pack_bmlp(cnn.init_bmlp(gen, spec), spec)
    x = torch.randint(0, 256, (5, 100), generator=gen, dtype=torch.uint8)
    want = cnn.bmlp_forward_packed(packed, x.to(dev), backend="torch")
    for mode, stack in (("auto", {"dense_stack": 1}),
                        ("per_layer", {"xnor_gemm_bn_sign": 2})):
        fwd = cnn.make_packed_forward(packed, dense_stack=mode)
        ops.reset_launch_counts()
        got = fwd(x)
        torch.cuda.synchronize()
        counts = {k: v for k, v in ops.launch_counts().items() if v}
        assert counts == {"bitpack": 1, "xnor_gemm": 2, "bn_sign_pack": 1,
                          **stack}
        assert torch.equal(got, want)


# (B, Sq, Skv, Hq, Hkv, D, Dv), keyword arguments; the attention kernel is
# held within rtol = atol = 2e-5 of its plain version (a float softmax in
# another order; the reference's own tolerance).
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("shape,kw", [
    ((2, 8, 8, 4, 2, 16, 16), {}),
    ((1, 37, 37, 6, 2, 40, 24), dict(window=5, attn_softcap=50.0)),
    ((2, 3, 19, 4, 4, 64, 32), dict(q_offset=16)),
    ((2, 37, 130, 6, 2, 40, 40), dict(window=5, q_offset=93,
                                      attn_softcap=50.0)),
    ((1, 12, 20, 4, 2, 40, 40), dict(window=3, q_offset=15)),
    ((1, 9, 70, 2, 1, 33, 33), dict(causal=False, window=7)),
    ((1, 20, 50, 2, 2, 64, 300), dict(attn_softcap=30.0)),
    ((1, 300, 300, 16, 8, 256, 256), dict(window=100, attn_softcap=50.0)),
    # The tensor-core kernel's edges: 64-row q tiles and 32-key KV tiles
    # (Sq 65, Skv 129: a last tile of one key), Dv 8/24/264/512 (two
    # 256-dim blocks past 256), Dw 1/9/16/35 (D 17, 280, 512, 1100: the
    # fragments from global memory past 32 words), GQA groups 1 and 8, no
    # mask at all, a q tile with rows that see no key beside rows that do,
    # decode-like Sq 3, and V 4 bytes off 16-byte alignment.
    ((2, 65, 129, 3, 3, 64, 64), dict(window=40, attn_softcap=50.0)),
    ((1, 70, 70, 8, 1, 17, 8), {}),
    ((1, 33, 97, 4, 2, 280, 24), dict(causal=False)),
    ((1, 65, 65, 2, 1, 512, 264), dict(attn_softcap=50.0)),
    ((1, 40, 33, 2, 1, 1100, 512), dict(window=9)),
    ((2, 16, 16, 16, 8, 256, 256), dict(causal=False)),
    ((1, 70, 100, 2, 2, 40, 40), dict(window=5, q_offset=60)),
    ((2, 3, 129, 16, 8, 256, 256), dict(q_offset=126, window=64,
                                        attn_softcap=50.0)),
    ((1, 65, 100, 4, 2, 256, 256), dict(window=50, misaligned_v=True)),
    # 16-row blocks (Sq <= 16) over two 256-dim blocks, the second of 8
    # dims: one warp of four has dims there.
    ((1, 16, 40, 4, 2, 40, 264), dict(window=9, attn_softcap=50.0))])
def test_attention_kernel(dev, shape, kw):
    b, sq, skv, hq, hkv, d, dv = shape
    kw = dict(kw)
    gen = torch.Generator().manual_seed(sq * skv + d)
    qp = B.pack_bits(torch.randn((b, sq, hq, d), generator=gen)).to(dev)
    kp = B.pack_bits(torch.randn((b, skv, hkv, d), generator=gen)).to(dev)
    v = torch.randn((b, skv, hkv, dv), generator=gen).to(dev)
    if kw.pop("misaligned_v", False):
        v = _misaligned(v)
        assert v.data_ptr() % 16 == 4 and v.is_contiguous()
    got = batt.binary_attention_packed(qp, kp, v, d_true=d, **kw)
    want = ref.binary_attention_packed_ref(qp, kp, v, d_true=d, **kw)
    torch.cuda.synchronize()
    assert torch.isfinite(got).all()
    torch.testing.assert_close(got, want, **ATTN_TOL)


@pytest.mark.parametrize("shape,kw", [
    ((1, 16, 40, 4, 2, 40, 24), dict(window=9, attn_softcap=50.0)),
    ((1, 65, 70, 2, 1, 17, 40), dict(causal=False))])
def test_attention_kernel_counts_bits_past_d(dev, shape, kw):
    """K words with random bits past D in their last word.  The kernel
    counts each as a mismatch, as the reference's Pallas kernel does: the
    score is D - 2 popc(q ^ k) over the whole words.  The plain version
    gives that score on the whole words unpacked to +-1, with one more
    column, +1 in Q and -1 in K, for each of the 32 Dw - D bits past D."""
    b, sq, skv, hq, hkv, d, dv = shape
    kw = dict(kw)
    gen = torch.Generator().manual_seed(sq * skv + d)
    qp = B.pack_bits(torch.randn((b, sq, hq, d), generator=gen))
    kp = B.pack_bits(torch.randn((b, skv, hkv, d), generator=gen))
    full = 32 * kp.shape[-1]
    tail = torch.randint(0, 2 ** 31, kp.shape[:-1], generator=gen,
                         dtype=torch.int64) << (d % 32) & (2 ** 32 - 1)
    kp[..., -1] = B.to_words(B.from_words(kp[..., -1]) | tail)
    v = torch.randn((b, skv, hkv, dv), generator=gen)
    assert (B.from_words(kp[..., -1]) >> (d % 32)).any()
    got = batt.binary_attention_packed(qp.to(dev), kp.to(dev), v.to(dev),
                                       d_true=d, **kw)
    extra = full - d
    qb = torch.cat([B.unpack_bits(qp, full),
                    torch.ones((b, sq, hq, extra))], -1)
    kb = torch.cat([B.unpack_bits(kp, full),
                    -torch.ones((b, skv, hkv, extra))], -1)
    want = ref._attention_pm1(
        qb, kb, v, scale=batt.attention_scale(d),
        causal=kw.pop("causal", True), window=kw.pop("window", None),
        attn_softcap=kw.pop("attn_softcap", None), q_offset=0)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.cpu(), want, **ATTN_TOL)


def test_attention_cuda_backend_refuses_cpu_tensors(dev):
    q = torch.randn((1, 4, 2, 16))
    k = torch.randn((1, 4, 1, 16))
    with pytest.raises(ValueError, match="CUDA"):
        ops.binary_attention(q, k, k, backend="cuda")
    with pytest.raises(ValueError, match="CUDA tensors only"):
        batt.binary_attention_packed(B.pack_bits(q), B.pack_bits(k), k,
                                     d_true=16)


def test_lm_launch_counts_and_parity(dev):
    """Reduced gemma2-9b (4 layers, local and global, softcap) at S = 20,
    longer than its window of 8: launches per forward, then each half of
    each layer against the plain path's stage, and the logits."""
    spec = configs.GEMMA2_9B.reduced()
    gen = torch.Generator(device=dev).manual_seed(0)
    packed = tf.pack_transformer(tf.init_binary_lm(gen, spec), spec,
                                 max_len=20)
    tokens = torch.randint(0, spec.vocab_size, (2, 20), dtype=torch.int64)
    fwd = cnn.make_packed_forward(packed)
    ops.reset_launch_counts()
    got = fwd(tokens)
    torch.cuda.synchronize()
    n = spec.num_layers
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "bitpack": 5 * n + 1, "xnor_gemm": 5 * n + 1,
        "xnor_gemm_bn_sign": n, "binary_attention": n}
    meta = packed["meta"]
    x = tf.embed(packed, tokens)
    flips = 0
    for blk, kind in zip(packed["blocks"], meta["kinds"]):
        w = tf.layer_window(meta, kind)
        want = tf.attention_half(blk, meta, x, window=w, backend="torch")
        have = tf.attention_half(blk, meta, x, window=w, backend="cuda")
        for a, b in zip(have[:3], want[:3]):
            assert torch.equal(a, b)
        torch.testing.assert_close(have[3], want[3], **ATTN_TOL)
        differ = (have[3] >= 0) != (want[3] >= 0)
        assert (want[3][differ].abs() <= 4e-5).all()
        flips += int(differ.sum())
        x_next = tf.update_half(blk, meta, x, want[3], backend="torch")
        assert torch.equal(
            tf.update_half(blk, meta, x, want[3], backend="cuda"), x_next)
        x = x_next
    logits = tf.head_logits(packed, x, backend="torch")
    assert got.shape == logits.shape and torch.isfinite(got).all()
    if flips == 0:
        assert torch.equal(got, logits)


# K6 (csrc/dense_stack.cu) as thread-block clusters: M below, at and past a
# 16- and a 32-row tile, in every tile (R, C) the rule can pick, on stage
# widths that leave some blocks of a cluster fewer words or none.
def _stack(gen, sizes, k, dev):
    stages = []
    for n in sizes:
        tau, flip = _bn(gen, n, k, dev)
        stages.append({"w_packed": B.pack_bits(_pm1(gen, n, k)).to(dev),
                       "k_true": k, "tau": tau, "flip": flip})
        k = n
    return stages


def _stack_launch(x, stages):
    return bmm.binary_dense_stack_packed(
        x, [s["w_packed"] for s in stages], [s["tau"] for s in stages],
        [s["flip"] for s in stages], k_trues=[s["k_true"] for s in stages])


@pytest.mark.parametrize("m", [1, 15, 16, 17, 33, 65])
@pytest.mark.parametrize("tile", bmm.STACK_TILES,
                         ids=[f"R{r}-C{c}" for r, c in bmm.STACK_TILES])
def test_dense_stack_cluster_edges(dev, monkeypatch, tile, m):
    gen = torch.Generator().manual_seed(m)
    stages = _stack(gen, (40, 96, 10), 100, dev)
    x = B.pack_bits(_pm1(gen, m, 100)).to(dev)
    monkeypatch.setattr(bmm, "stack_tile", lambda rows, sms: tile)
    assert torch.equal(_stack_launch(x, stages),
                       ref.binary_dense_stack_packed_ref(stages, x))


def test_dense_stack_sixteen_stages(dev):
    gen = torch.Generator().manual_seed(16)
    sizes = (64, 33, 100, 32, 7, 64, 200, 31, 96, 40, 128, 9, 64, 64, 250,
             10)
    stages = _stack(gen, sizes, 70, dev)
    x = B.pack_bits(_pm1(gen, 37, 70)).to(dev)
    assert torch.equal(_stack_launch(x, stages),
                       ref.binary_dense_stack_packed_ref(stages, x))


@pytest.mark.parametrize("m", [1, 17, 256])
def test_dense_stack_bcnn_first_stage(dev, m):
    """The BCNN's stack: a 256-word first stage, 8192 -> 1024 -> 1024."""
    gen = torch.Generator().manual_seed(8192 + m)
    stages = _stack(gen, (1024, 1024), 8192, dev)
    x = B.pack_bits(_pm1(gen, m, 8192)).to(dev)
    assert torch.equal(_stack_launch(x, stages),
                       ref.binary_dense_stack_packed_ref(stages, x))


def test_dense_stack_refuses_buffers_that_do_not_fit(dev):
    gen = torch.Generator().manual_seed(577)
    stages = _stack(gen, (577 * 32,), 32, dev)      # 577-word rows
    x = B.pack_bits(_pm1(gen, 4, 32)).to(dev)
    with pytest.raises(ValueError, match="do not fit"):
        _stack_launch(x, stages)


def _edgy(gen, m, k):
    """Normal floats with -0.0, NaN, +-0 and the tiniest normals sprinkled
    in, at the first element too."""
    x = torch.randn((m, k), generator=gen)
    specials = torch.tensor([-0.0, float("nan"), 0.0, 1.17549435e-38,
                             -1.17549435e-38, 1e-30, -1e-30])
    idx = torch.randint(0, m * k, (max(1, m * k // 5),), generator=gen)
    x.view(-1)[idx] = specials[torch.randint(0, len(specials), idx.shape,
                                             generator=gen)]
    x[0, 0] = -0.0
    return x


# K5's aligned path at the LM prefill's four shapes (narrow M) and Table 1's
# width; a row view 4 bytes off 16 and K = 784 take the general path.
@pytest.mark.parametrize("m,k", [(9, 3584), (144, 256), (72, 256),
                                 (9, 4096), (3, 8192)])
def test_bitpack_aligned_path(dev, m, k):
    x = _edgy(torch.Generator().manual_seed(m * k), m, k).to(dev)
    assert bp.packs_aligned(k, x.data_ptr())
    assert torch.equal(bp.bitpack(x), ref.bitpack_ref(x))


@pytest.mark.parametrize("k", [3584, 784])
def test_bitpack_general_path(dev, k):
    x = _edgy(torch.Generator().manual_seed(k), 37, k).to(dev)
    view = _misaligned(x) if k % 32 == 0 else x
    assert not bp.packs_aligned(k, view.data_ptr())
    assert torch.equal(bp.bitpack(view), ref.bitpack_ref(view))


# The kernels at the shapes a C_out shard gives them on BCNNSpec() and
# BMLPSpec() at |model| 2 and 4 (distributed/sharding.py): K1-fused at
# local C_out 64 and 32 (one packed word a pixel), K3 at local C_out 32 to
# 256 on the BCNN's stages, K4-fused at N 256 and 512 (the BCNN's hidden
# dense) and 1024 and 2048 (the BMLP's), K2 at C 1024 and 2048.
@pytest.mark.parametrize("c_out", [64, 32])
def test_bitplane_conv_bn_sign_at_shard_widths(dev, c_out):
    gen = torch.Generator().manual_seed(c_out)
    bplan = bconv.make_bitplane_conv_plan(_pm1(gen, c_out, 3, 3, 3),
                                          input_hw=(32, 32))
    kargs, pargs = _k1_operands(_image(gen, dev, 2, (32, 32), 3, 8), bplan,
                                dev)
    geom = dict(kh=3, kw=3, stride=1, pads=bplan["pads"], c_out=c_out,
                k_true=bplan["k_true"], nbits=8)
    tau, flip = _bn(gen, c_out, 256 * 9, dev)
    assert torch.equal(
        bconv.bitplane_conv2d_bn_sign_packed(*kargs, tau, flip,
                                             out_hw=bplan["out_hw"], **geom),
        ref.bn_sign_pack_ref(ref.bitplane_conv2d_planes_ref(*pargs, **geom),
                             tau, flip))


@pytest.mark.parametrize("bsz,hw,c_in,c_out", [
    (2, (32, 32), 128, 64), (2, (32, 32), 128, 32), (64, (16, 16), 128, 64),
    (2, (16, 16), 256, 128), (2, (8, 8), 256, 256), (64, (8, 8), 512, 128)])
def test_conv_bn_sign_at_shard_widths(dev, bsz, hw, c_in, c_out):
    gen = torch.Generator().manual_seed(bsz + c_in + c_out)
    plan = bconv.make_conv_plan(_pm1(gen, c_out, 3, 3, c_in), input_hw=hw)
    geom = dict(kh=3, kw=3, stride=1, pads=plan["pads"], c_out=c_out,
                k_true=plan["k_true"])
    x = B.pack_bits(_pm1(gen, bsz, *hw, c_in)).to(dev)
    tau, flip = _bn(gen, c_out, plan["k_true"], dev)
    args = (x, plan["w_packed"].to(dev), plan["correction"].to(dev), tau,
            flip)
    assert torch.equal(
        bconv.binary_conv2d_bn_sign_packed(*args, out_hw=plan["out_hw"],
                                           **geom),
        ref.binary_conv2d_bn_sign_packed_ref(*args, **geom))


@pytest.mark.parametrize("m,n,k", [(2, 512, 8192), (128, 256, 8192),
                                   (4, 256, 1024), (2, 2048, 4096),
                                   (128, 1024, 4096)])
def test_xnor_gemm_bn_sign_at_shard_widths(dev, m, n, k):
    gen = torch.Generator().manual_seed(m + n + k)
    a = B.pack_bits(_pm1(gen, m, k)).to(dev)
    w = B.pack_bits(_pm1(gen, n, k)).to(dev)
    tau, flip = _bn(gen, n, k, dev)
    assert torch.equal(
        bmm.binary_matmul_bn_sign_packed(a, w, tau, flip, k_true=k),
        ref.binary_matmul_bn_sign_packed_ref(a, w, tau, flip, k))


@pytest.mark.parametrize("m,c", [(2, 2048), (128, 1024)])
def test_bn_sign_pack_at_shard_widths(dev, m, c):
    gen = torch.Generator().manual_seed(m + c)
    x = torch.randint(-99, 99, (m, c), generator=gen,
                      dtype=torch.int32).to(dev)
    tau, flip = _bn(gen, c, 99, dev)
    assert fe.bn_sign_aligned(c, x.data_ptr())
    assert torch.equal(fe.bn_sign_pack(x, tau, flip),
                       ref.bn_sign_pack_ref(x, tau, flip))


@pytest.mark.parametrize("shape", [(2, 2), (1, 4), (4, 1)])
def test_sharded_forward_on_one_card(dev, shape):
    """Every position of the mesh on the one card: the sharded BCNN's
    launches are each position's, its outputs the unsharded forward's."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    spec = cnn.BCNNSpec(input_hw=(16, 16),
                        stages=(cnn.ConvStage(128), cnn.ConvStage(64, True)),
                        dense=(256, 10))
    gen = torch.Generator().manual_seed(0)
    packed = cnn.pack_bcnn(cnn.init_bcnn(gen, spec), spec)
    x = torch.randint(0, 256, (8, 16, 16, 3), generator=gen,
                      dtype=torch.uint8)
    fwd = sh.make_sharded_forward(packed, make_host_mesh(*shape))
    ops.reset_launch_counts()
    got = fwd.forward_int(x)
    torch.cuda.synchronize()
    n = shape[0] * shape[1]
    stack = ({"dense_stack": n} if shape[1] == 1
             else {"xnor_gemm_bn_sign": n})
    assert {k: v for k, v in ops.launch_counts().items() if v} == {
        "bitplane_conv_bn_sign": n, "conv_bn_sign": n, "xnor_gemm": n,
        **stack}
    assert torch.equal(got, cnn.bcnn_forward_packed_int(packed, x.to(dev)))


# ---------------------------------------------------------------------------
# The model zoo: the packed linear's routes and one reduced config per
# family, the kernel route (K5 + K4) against the plain route on the card
# ---------------------------------------------------------------------------

def _zoo_route(cfg, backend):
    import dataclasses
    return dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, backend=backend))


@pytest.mark.parametrize("rows", [1, 4, 128, 256, 300])
def test_zoo_packed_linear_routes(dev, rows):
    """``apply_linear`` in binary mode on packed weights: the XNOR route
    launches K5 and K4 once each up to 256 rows (none above, the unpack
    route), and every route and backend gives the same values."""
    from repro_torch.core.quantize import GemmStrategy
    from repro_torch.models import linear as LN
    cfg = configs.get_config("gemma2-9b", quant="binary", reduced=True)
    gen = torch.Generator().manual_seed(rows)
    p = LN.pack_linear({"w": torch.randn((200, 96), generator=gen)})
    p = {k: v.to(dev) for k, v in p.items()}
    x = torch.randn((rows, 200), generator=gen).to(dev)
    ops.reset_launch_counts()
    got = LN.apply_linear(p, x, cfg.quant, dtype=torch.float32)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == ({"bitpack": 1, "xnor_gemm": 1} if rows <= 256 else {})
    plain = _zoo_route(cfg, "torch").quant
    assert torch.equal(got, LN.apply_linear(p, x, plain,
                                            dtype=torch.float32))
    for s in ("vpu_xnor", "mxu_unpack"):
        import dataclasses
        q = dataclasses.replace(cfg.quant, strategy=GemmStrategy(s))
        assert torch.equal(got, LN.apply_linear(p, x, q,
                                                dtype=torch.float32))


@pytest.mark.parametrize("name", ["gemma2-9b", "mamba2-1.3b",
                                  "qwen3-moe-30b-a3b", "qwen2-vl-72b",
                                  "whisper-base", "recurrentgemma-9b"])
def test_zoo_reduced_family_kernel_route(dev, name):
    """One reduced config per family in binary mode, packed on the card:
    ``logits_fn``, ``prefill`` and two decode steps equal on the kernel
    and the plain route, with K5 and K4 launched."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import linear as LN
    from repro_torch.models import model as M
    from repro_torch.tree import leaves_with_path, tree_map
    cfg = configs.get_config(name, quant="binary", reduced=True)
    plain = _zoo_route(cfg, "torch")
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    packed = LN.maybe_pack_tree(params, cfg.quant)
    gen = torch.Generator().manual_seed(1)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (2, 12),
                                     generator=gen).to(dev)}
    if cfg.encoder_layers:
        batch["enc_embeds"] = torch.randn((2, 10, cfg.d_model),
                                          generator=gen).to(dev)

    def equal(a, b):
        la, lb = list(leaves_with_path(a)), list(leaves_with_path(b))
        assert [p for p, _ in la] == [p for p, _ in lb]
        for (path, x), (_, y) in zip(la, lb):
            assert torch.equal(x, y), path

    ops.reset_launch_counts()
    equal(M.logits_fn(packed, cfg, batch), M.logits_fn(packed, plain, batch))
    assert ops.launch_counts()["xnor_gemm"] > 0
    logits, cache = M.prefill(packed, cfg, batch, 16)
    equal((logits, cache), M.prefill(packed, plain, batch, 16))
    if cfg.encoder_layers:
        enc = ED.encode(packed["encdec"], cfg, batch["enc_embeds"])
        cache = M.init_cache(packed, cfg, 2, 16, enc_len=10)
        cache["cross"] = ED.precompute_cross_kv(packed["encdec"], cfg, enc)
    for i in range(2):
        tok = logits[:, -1].float().argmax(-1, keepdim=True)
        # a step writes into the cache it is given: one copy for each route
        got = M.decode_step(packed, cfg, tok, tree_map(torch.clone, cache),
                            12 + i)
        equal(got, M.decode_step(packed, plain, tok, cache, 12 + i))
        logits, cache = got


# ---------------------------------------------------------------------------
# Training: a reduced step on the card against the CPU, and the deploy of
# a binary-trained tree through K5 + K4
# ---------------------------------------------------------------------------

def _leaves_of(tree):
    from repro_torch.tree import sorted_leaves
    return list(sorted_leaves(tree))


@pytest.mark.parametrize("mode", ["float", "binary"])
def test_train_step_on_the_card_matches_the_cpu(dev, mode):
    """One reduced starcoder2-3b step in float32 from the same state and
    batch on the card and on the CPU: loss and gradient norm within rtol
    1e-5, moments within 1e-4 of each value plus 1e-5 of the tree's
    largest, params within 1e-6 where the gradient is above 1e-5 of the
    largest (elsewhere it is float noise, which Adam's first step turns
    into a bounded step of either sign: 2 lr (1 + 0.1 |p|) apart at
    most)."""
    import dataclasses
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.train import trainer as TR
    from repro_torch.tree import tree_map
    cfg = dataclasses.replace(configs.get_config(
        "starcoder2-3b", quant=mode, reduced=True), dtype="float32")
    tc = TR.TrainConfig(lr=1e-3, warmup=2, total_steps=10)
    cpu = TR.init_train_state(torch.Generator().manual_seed(0), cfg, tc,
                              device="cpu")
    card = tree_map(lambda t: t.to(dev, copy=True), cpu)
    batch = token_batch(TokenStreamConfig(cfg.vocab_size, 32, 4), 0, "cpu")
    step = TR.make_train_step(cfg, tc)
    card, mc = step(card, {k: v.to(dev) for k, v in batch.items()})
    cpu, mh = step(cpu, batch)
    for k in ("loss", "grad_norm", "lr"):
        assert float(mc[k]) == pytest.approx(float(mh[k]), rel=1e-5), k
    for k in ("mu", "nu"):
        want = _leaves_of(cpu["opt"][k])
        top = max(float(t.abs().max()) for t in want)
        for g, w in zip(_leaves_of(card["opt"][k]), want):
            torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                       atol=1e-5 * top)
    mu = _leaves_of(cpu["opt"]["mu"])
    top = max(float(t.abs().max()) for t in mu)
    for g, w, m in zip(_leaves_of(card["params"]), _leaves_of(cpu["params"]),
                       mu):
        d = (g.cpu() - w).abs()
        held = m.abs() > 1e-5 * top
        assert not bool(held.any()) or float(d[held].max()) <= 1e-6
        assert bool((d <= 2 * tc.lr * (1 + 0.1 * w.abs()) + 1e-6).all())
        if mode == "binary":
            assert float(g.abs().max()) <= 1.0


def test_binary_trained_deploy_launches_k5_k4_per_linear(dev):
    """Reduced starcoder2-3b trained two steps in binary mode on the card,
    packed there: prefill at (8, 16) and one decode step launch K5 and K4
    once per packed linear (6 a layer and the head) and equal the plain
    route."""
    import dataclasses
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.models import linear as LN
    from repro_torch.train import serve as SV
    from repro_torch.train import trainer as TR
    from repro_torch.tree import leaves_with_path, tree_map
    cfg = configs.get_config("starcoder2-3b", quant="binary", reduced=True)
    tc = TR.TrainConfig(lr=1e-2, warmup=1, total_steps=10)
    state = TR.init_train_state(torch.Generator(device=dev).manual_seed(0),
                                cfg, tc)
    step = TR.make_train_step(cfg, tc)
    dcfg = TokenStreamConfig(cfg.vocab_size, 16, 8)
    for i in range(2):
        state, m = step(state, token_batch(dcfg, i))
        assert bool(torch.isfinite(m["loss"]))
    packed = LN.maybe_pack_tree(state["params"], cfg.quant)
    del state
    n = sum(t.shape[:-2].numel() for p, t in leaves_with_path(packed)
            if p.endswith("w_packed"))
    assert n == 6 * cfg.num_layers + 1
    plain = dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, backend="torch"))
    toks = token_batch(dcfg, 5)["tokens"]
    ops.reset_launch_counts()
    logits, cache = SV.make_prefill_step(cfg, 32)(packed, {"tokens": toks})
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"bitpack": n, "xnor_gemm": n}
    want = SV.make_prefill_step(plain, 32)(packed, {"tokens": toks})
    for (p, a), (_, b) in zip(leaves_with_path((logits, cache)),
                              leaves_with_path(want)):
        assert torch.equal(a, b), p
    tok = logits[:, -1].float().argmax(-1, keepdim=True)
    kcache = tree_map(torch.clone, cache)
    ops.reset_launch_counts()
    got = SV.make_decode_step(cfg)(packed, kcache, tok, 16)
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {"bitpack": n, "xnor_gemm": n}
    want = SV.make_decode_step(plain)(packed, cache, tok, 16)
    for (p, a), (_, b) in zip(leaves_with_path(got), leaves_with_path(want)):
        assert torch.equal(a, b), p


# ---------------------------------------------------------------------------
# The kernels as torch ops, the fake trace and the shared-memory preflight
# ---------------------------------------------------------------------------

def _op_cases(dev):
    """Each kernel's op arguments at small ragged shapes on the card, and
    the direct wrapper call they stand for."""
    from repro_torch.kernels import library as lib
    gen = torch.Generator().manual_seed(27)

    def words(*shape):
        return B.pack_bits(_pm1(gen, *shape)).to(dev)

    tau, flip = _bn(gen, 40, 50, dev)
    a, b = words(9, 300), words(40, 300)
    a1 = words(3, 300)
    cases = {
        "bitpack": ((_pm1(gen, 37, 70).to(dev),),
                    lambda x: bp.bitpack(x)),
        "bn_sign_pack": ((torch.randint(-60, 60, (9, 40), generator=gen,
                                        dtype=torch.int32).to(dev), tau,
                          flip), lambda *t: fe.bn_sign_pack(*t)),
        "xnor_gemm": ((a1, b, 300), lambda x, y, k: bmm.binary_matmul_packed(
            x, y, k_true=k)),
        "xnor_gemm_bn_sign": ((a, b, tau, flip, 300),
                              lambda x, y, t, f, k:
                              bmm.binary_matmul_bn_sign_packed(
                                  x, y, t, f, k_true=k)),
    }
    w2 = words(40, 40)
    cases["dense_stack"] = (
        (a, [b, w2, tau, tau, flip, flip], [300, 40]),
        lambda x, st, k: bmm.binary_dense_stack_packed(
            x, st[:2], st[2:4], st[4:], k_trues=k))
    plan = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in bconv.make_conv_plan(
                _pm1(gen, 40, 3, 3, 33), input_hw=(9, 9), stride=2,
                padding="VALID").items()}
    x = words(2, 9, 9, 33)
    geom = lib.conv_geom(plan)
    kw = lib.geom_kwargs(geom)
    cases["binary_conv"] = ((x, plan["w_packed"], plan["correction"], geom),
                            lambda x_, w_, c_, g_: bconv.binary_conv2d_packed(
                                x_, w_, c_, **kw))
    cases["conv_bn_sign"] = (
        (x, plan["w_packed"], plan["correction"], tau, flip, geom),
        lambda x_, w_, c_, t_, f_, g_: bconv.binary_conv2d_bn_sign_packed(
            x_, w_, c_, t_, f_, **kw))
    bplan = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
             for k, v in bconv.make_bitplane_conv_plan(
                 _pm1(gen, 40, 3, 3, 3), input_hw=(12, 10),
                 nbits=8).items()}
    image = _image(gen, dev, 2, (12, 10), 3, 8)
    bgeom = [*lib.conv_geom(bplan), 8]
    bkw = lib.geom_kwargs(bgeom)
    cases["bitplane_conv"] = (
        (image, bplan["w_packed"], bplan["rowsum"], bgeom),
        lambda x_, w_, r_, g_: bconv.bitplane_conv2d_packed(
            x_, w_, r_, nbits=8, **bkw))
    cases["bitplane_conv_bn_sign"] = (
        (image, bplan["w_packed"], bplan["rowsum"], tau, flip, bgeom),
        lambda x_, w_, r_, t_, f_, g_: bconv.bitplane_conv2d_bn_sign_packed(
            x_, w_, r_, t_, f_, nbits=8, **bkw))
    qp, kp = words(1, 20, 4, 256), words(1, 20, 2, 256)
    v = torch.randn((1, 20, 2, 256), generator=gen).to(dev)
    cases["binary_attention"] = (
        (qp, kp, v, 256, True, 8, 50.0, 0),
        lambda q, k, v_, d, c, w, s, o: batt.binary_attention_packed(
            q, k, v_, d_true=d, causal=c, window=w, attn_softcap=s,
            q_offset=o))
    return cases


def test_each_op_equals_the_direct_wrapper_call(dev):
    """Registering a kernel as an op changes no value: the op on real card
    tensors equals the wrapper called directly, bit for bit; it records
    its launch while a recorder is active, and its estimate is what its
    launcher's query answers."""
    from repro_torch.analysis import smem
    from repro_torch.kernels import library as lib
    cases = _op_cases(dev)
    assert set(cases) == set(lib.OPS)
    for name, (args, direct) in cases.items():
        ops.reset_launch_counts()
        with lib.record_launches() as order:
            got = lib.OPS[name](*args)
        want = direct(*args)
        torch.cuda.synchronize()
        assert order == [name]
        assert ops.launch_counts()[name] == 2
        assert torch.equal(got, want), name
        est = smem.check_against_card(smem.estimate_call(name, args))
        assert est.registers > 0 and est.fits(), est.breakdown()


# K1's shared-memory mirror (``binary_conv.bitplane_estimate``) against
# its launcher's search (``bitplane_conv_query``), both instances: the
# BCNN's stage 0 at batch 512, the edge shapes above and the two shapes
# the launchers refuse, where the query answers kTooLarge.
K1_QUERY_SHAPES = [(512, (32, 32), 3, 128, 1, "SAME")] + [
    (3, hw, c_in, c_out, stride, padding)
    for hw, c_in, c_out, stride, padding, _ in K1_EDGES + K1_FUSED_EDGES] + [
    (1, (32, 32), 512, 40, 1, "SAME"), (1, (3, 2048), 1024, 8, 1, "VALID")]


@pytest.mark.parametrize("fused", [False, True])
def test_k1_estimate_equals_the_launchers_query(dev, fused):
    import ctypes
    from repro_torch.analysis import smem
    from repro_torch.kernels import _build
    lib = _build.load("bitplane_conv", bconv.BITPLANE_ENTRIES)
    for bsz, hw, c_in, c_out, stride, padding in K1_QUERY_SHAPES:
        plan = bconv.make_bitplane_conv_plan(
            torch.ones(c_out, 3, 3, c_in), input_hw=hw, stride=stride,
            padding=padding)
        (pt, _), (pl, _) = plan["pads"]
        est = bconv.bitplane_estimate(bsz, *hw, plan["cw"], c_in, c_out, 3,
                                      3, stride, pt, pl, *plan["out_hw"], 8,
                                      fused)
        if est.fits():
            smem.check_against_card(est)
            continue
        out, name = (ctypes.c_int * 9)(), ctypes.c_char_p()
        assert lib.bitplane_conv_query(
            *est.query[2], ctypes.addressof(out),
            ctypes.addressof(name)) == bconv.BITPLANE_TOO_LARGE, est.route


def test_preflight_raises_before_a_launch_on_the_card(dev):
    from repro_torch.analysis import smem
    gen = torch.Generator().manual_seed(577)
    stages = [{"w_packed": B.pack_bits(_pm1(gen, 577 * 32, 32)).to(dev),
               "k_true": 32, "tau": torch.zeros(577 * 32, device=dev),
               "flip": torch.ones(577 * 32, device=dev)}]
    x = B.pack_bits(_pm1(gen, 4, 32)).to(dev)
    plan = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in bconv.make_bitplane_conv_plan(
                torch.ones(8, 3, 3, 1024), input_hw=(3, 2048),
                padding="VALID", nbits=8).items()}
    raw = torch.zeros((1, 3, 2048, 1024), dtype=torch.uint8, device=dev)
    ops.reset_launch_counts()
    with pytest.raises(smem.SmemBudgetError):
        ops.binary_dense_stack_packed(stages, x, resident=True)
    with pytest.raises(smem.SmemBudgetError):
        ops.bitplane_conv2d_packed(plan, raw)
    torch.cuda.synchronize()
    assert not any(ops.launch_counts().values())


@pytest.mark.parametrize("kind", ["bcnn", "bmlp", "transformer"])
def test_fake_trace_equals_the_real_launches(dev, kind):
    """The demo forwards' fake trace against a real run on the card:
    the same kernels in the same order, the same estimates (each held to
    its launcher's query), the same packedness report."""
    from repro_torch.analysis import graph, packedness, smem
    from repro_torch.analysis import report as rep
    from repro_torch.kernels import library as lib
    packed = rep.demo_packed(kind)
    x = rep.forward_input(packed, 8)
    fake = graph.trace(rep.cuda_forward, packed, x)
    real_packed = cnn.to_device(packed, dev)
    ops.reset_launch_counts()
    with lib.record_launches() as order:
        real = graph.trace(rep.cuda_forward, real_packed, x.to(dev),
                           fake=False)
    torch.cuda.synchronize()
    assert order == [ln.kernel for ln in fake.launches()]
    assert real.launches() == fake.launches()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    assert counts == {k: order.count(k) for k in set(order)}
    for op in fake.ops:
        if op.kernel:
            smem.check_against_card(op.estimate)
    policy = packedness.model_policy(kind)
    assert packedness.analyze_trace(real, policy).to_json() == \
        packedness.analyze_trace(fake, policy).to_json()
