"""The shared-memory estimates (``repro_torch.analysis.smem``, the cost
model of ``kernels/smem.py`` and the kernel modules): each estimate
mirrors its launcher's arithmetic in ``csrc/``, K6's residency rule
takes its numbers from it, a trace and K1's launcher refuse an
over-budget launch before anything launches, and the merged report's CLI passes
against its committed baseline.  Holding each estimate to the launcher's
own query needs the card (``chip_smoke.py`` phase 11,
``tests/test_torch_cuda.py``)."""
import os
import subprocess
import sys
from dataclasses import replace as dataclass_replace

import pytest
import torch

from repro_torch.analysis import graph
from repro_torch.analysis import report as TREPORT
from repro_torch.analysis import smem as S
from repro_torch.core import binarize as B
from repro_torch.kernels import binary_conv as bconv
from repro_torch.kernels import binary_matmul as bmm
from repro_torch.kernels import ops

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_mma_estimates_mirror_the_launchers():
    """csrc/b1_mma.cuh: a ring of kStages (K4: 3) or 2 (K3/K7) stages of
    (kBM + kBN) rows of 36 words; K3/K7 add a 16-byte row table a row."""
    small = S.gemm_estimate(8, 4096, 128, False, True, 132)
    assert (small.route, small.grid, small.threads, small.dynamic) == (
        "small8", (128, 1, 1), 256, 0)
    one_warp = S.gemm_estimate(1, 100, 5, True, False, 132)
    assert (one_warp.route, one_warp.threads) == ("small1", 32)
    m64 = S.gemm_estimate(64, 256, 8, False, True, 132)
    assert (m64.route, m64.grid, m64.dynamic) == ("mma64", (4, 1, 1),
                                                 3 * 128 * 36 * 4)
    m128 = S.gemm_estimate(2048, 4096, 32, True, True, 132)
    assert (m128.route, m128.grid, m128.dynamic) == ("mma128", (32, 16, 1),
                                                   3 * 256 * 36 * 4)
    conv = S.conv_estimate(256, 16, 16, 256, True, True, 132)
    assert (conv.route, conv.grid, conv.dynamic) == (
        "64x128", (1024, 2, 1), 2 * 192 * 36 * 4 + 64 * 16)
    small_conv = S.conv_estimate(1, 4, 4, 512, False, True, 132)
    assert (small_conv.route, small_conv.dynamic) == (
        "64x64", 2 * 128 * 36 * 4 + 64 * 16)


def test_warp_per_word_estimates():
    assert S.bitpack_estimate(8 * 256, 784, False).grid == (6400, 1, 1)
    assert S.bitpack_estimate(8, 4096, True).grid == (4, 1, 1)
    k2 = S.bn_sign_pack_estimate(262144, 128, True, 132)
    assert k2.grid == (528, 1, 1) and k2.dynamic == 0      # 132·32 warps
    assert S.bn_sign_pack_estimate(9, 100, False, 132).grid == (5, 1, 1)


def test_attention_estimates_take_the_launchers_branches():
    staged16 = S.attention_estimate(8, 16, 16, 8, 256)
    assert staged16.route == "16rows_nv32_staged"
    assert staged16.grid == (16, 1, 8)
    assert staged16.dynamic == 4 * (2 * 32 * 260 + 80 * 36 + 32 * 32 + 4)
    narrow = S.attention_estimate(1, 1024, 24, 4, 128)
    assert narrow.route == "64rows_nv16_staged"
    assert narrow.grid == (24, 16, 1)
    wide = S.attention_estimate(1, 100, 2, 40, 300)
    assert wide.route == "64rows_nv32_global"
    assert wide.grid == (2, 2, 2) and wide.dynamic == 4 * 2 * 32 * 260


def test_stack_rule_takes_the_preflight_numbers():
    """``binary_matmul.stack_smem_bytes`` and ``dense_stack_fits``
    delegate here: the ring plus two activation buffers at the row
    stride, the same bytes the rule always took."""
    for rows in (16, 32):
        for buf in (1, 32, 128, 576, 577):
            want = bmm.STACK_RING_BYTES + 2 * rows * \
                bmm.stack_row_stride(buf) * 4
            assert bmm.stack_smem_bytes(rows, buf) == want
            assert S.dense_stack_estimate(40, rows, 8, buf, True).dynamic \
                == want
    meta = [torch.empty((4096, 128), dtype=torch.int32, device="meta")] * 2
    assert bmm.dense_stack_fits(meta)
    wide = [torch.empty((577 * 32, 1), dtype=torch.int32, device="meta")]
    assert not bmm.dense_stack_fits(wide)
    assert not S.dense_stack_estimate(4, 32, 8, 577, True).fits()


def test_k1_search_matches_the_launchers():
    """The largest chunk of 64, 32 (16, 8 for the int32 instance), then
    the largest band, that fits a block; where the fused instance's
    chunks of 32 fit no band, the int32 instance still fits."""
    stage0 = S.bitplane_estimate(256, 32, 32, 1, 3, 128, 3, 3, 1, 1, 1, 32,
                                 32, 8, True)
    assert stage0.route == "band4_chunk64" and stage0.grid == (8, 256, 1)
    assert stage0.fits()
    big = dict(bsz=1, h=32, w=32, cw=16, c_in=512, c_out=40, kh=3, kw=3,
               stride=1, pad_top=1, pad_left=1, oh=32, ow=32, nbits=8)
    assert not S.bitplane_estimate(**big, fused=True).fits()
    assert S.bitplane_estimate(**big, fused=False).route == "band4_chunk16"
    halved = dict(big, h=16, w=16, cw=14, c_in=448, oh=16, ow=16)
    assert S.bitplane_estimate(**halved, fused=False).route == \
        "band8_chunk16"
    assert S.bitplane_estimate(**halved, fused=True).route == "band4_chunk32"
    hopeless = S.bitplane_estimate(1, 3, 2048, 32, 1024, 8, 3, 3, 1, 0, 0, 1,
                                   2046, 8, False)
    assert hopeless.route == "band1_chunk8" and not hopeless.fits()


def test_k1_holds_the_image_band_and_no_planes():
    """K1 reads the raw uint8 image: its band is rows x columns x C_in
    bytes, whatever nbits, and no term holds bit planes."""
    for nbits in (1, 8):
        est = S.bitplane_estimate(512, 32, 32, 1, 3, 128, 3, 3, 1, 1, 1, 32,
                                  32, nbits, True)
        terms = {t.name: t.bytes for t in est.terms}
        assert set(terms) == {"output_stage", "chunk_weights",
                              "depth_offsets", "input_band", "tau_flip"}
        assert terms["input_band"] == 624    # 6 rows x 34 columns x 3 bytes
        assert est.route == "band4_chunk64" and est.grid == (8, 512, 1)
    int32 = S.bitplane_estimate(512, 32, 32, 1, 3, 128, 3, 3, 1, 1, 1, 32,
                                32, 8, False)
    assert "planes_band" not in {t.name for t in int32.terms}
    assert "tau_flip" not in {t.name for t in int32.terms}

def test_preflight_raises_with_the_breakdown():
    est = S.dense_stack_estimate(4, 32, 8, 577, True)
    with pytest.raises(S.SmemBudgetError) as err:
        S.preflight(est)
    msg = str(err.value)
    assert "activations" in msg and "weight_ring" in msg and "232448" in msg
    assert isinstance(err.value, ValueError) and err.value.estimate is est
    assert S.preflight(S.gemm_estimate(8, 64, 4, False, True, 132)).fits()


def _stages(n, k):
    return [{"w_packed": torch.zeros((n, B.packed_width(k)),
                                     dtype=torch.int32), "k_true": k,
             "tau": torch.zeros(n), "flip": torch.ones(n)}]


def test_dispatchers_refuse_over_budget_launches_before_launching():
    """A K6 stack whose 577-word activation rows overflow a block, and a
    K1 band no chunk fits: ``SmemBudgetError`` from the trace before the
    op runs, as the launchers raise it on the card; no launch is
    counted."""
    before = ops.launch_counts()
    stages = _stages(577 * 32, 32)
    x = torch.zeros((4, 1), dtype=torch.int32)
    with pytest.raises(S.SmemBudgetError, match="activations"):
        graph.trace(lambda h, st: ops.binary_dense_stack_packed(
            st, h, backend="cuda", resident=True), x, stages)
    plan = bconv.make_bitplane_conv_plan(torch.ones(8, 3, 3, 1024),
                                         input_hw=(3, 2048),
                                         padding="VALID", nbits=8)
    raw = torch.zeros((1, 3, 2048, 1024), dtype=torch.uint8)
    with pytest.raises(S.SmemBudgetError, match="input_band"):
        graph.trace(lambda p, a: ops.bitplane_conv2d_packed(
            p, a, backend="cuda"), plan, raw)
    assert ops.launch_counts() == before
    # the same dispatcher routes a stack that fits to the op
    ok = graph.trace(lambda h, st: ops.binary_dense_stack_packed(
        st, h, backend="cuda", resident=True), torch.zeros(
            (4, 1), dtype=torch.int32), _stages(64, 32))
    assert [op.kernel for op in ok.ops if op.kernel] == ["dense_stack"]


def test_k1_launcher_refusal_carries_the_estimate():
    """K1's launcher answers kTooLarge where no band and chunk fit: the
    wrapper raises ``SmemBudgetError`` (a ``ValueError``) with the
    launcher's account and the estimate's breakdown, before its launch
    is counted."""
    sizes = (1, 3, 2048, 32, 1024, 8, 3, 3, 1, 0, 0, 1, 2046, 8, 0)
    before = bconv.bitplane_conv2d_packed.launches
    with pytest.raises(S.SmemBudgetError, match="input_band") as err:
        bconv._bitplane_check(bconv.BITPLANE_TOO_LARGE, "bitplane_conv",
                              sizes, False)
    assert "8 channels' weights of depth 9216" in str(err.value)
    assert err.value.estimate == S.bitplane_estimate(*sizes[:14], False)
    assert isinstance(err.value, ValueError)
    assert bconv.bitplane_conv2d_packed.launches == before


def test_estimate_forward_is_one_estimate_per_launch():
    packed = TREPORT.demo_packed("bmlp")
    x = TREPORT.forward_input(packed, 8)
    ests = S.estimate_forward(TREPORT.cuda_forward, packed, x)
    launches = graph.kernel_launches(TREPORT.cuda_forward, packed, x)
    assert [(e.kernel, e.grid, e.route) for e in ests] == \
        [(ln.kernel, ln.grid, ln.route) for ln in launches]
    assert all(e.fits() for e in ests)


PTXAS = """\
ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z13bitpack_kernelPKfPjiii' for 'sm_90a'
ptxas info    : Function properties for _Z13bitpack_kernelPKfPjiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 12 registers, used 0 barriers, 380 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_117xnor_small_kernelILi8ELb1EEEvPKjS2_PKfS4_Pviiii' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_117xnor_small_kernelILi8ELb1EEEvPKjS2_PKfS4_Pviiii
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 40 registers, used 1 barriers, 25600 bytes smem, 408 bytes cmem[0]
"""


def test_ptxas_report_parses_registers_and_static_shared_memory(
        monkeypatch):
    got = S.parse_ptxas(PTXAS)
    small = ("_ZN12_GLOBAL__N_117xnor_small_kernelILi8ELb1EEEvPKjS2_PKfS4_"
             "Pviiii")
    assert got == {"_Z13bitpack_kernelPKfPjiii": (12, 0), small: (40, 25600)}
    monkeypatch.setattr(S, "ptxas_resources", lambda: got)
    est = S.gemm_estimate(8, 64, 128, True, True, 132)     # 256 threads
    rich = S.with_ptxas(est, S.CardLaunch((2, 1, 1), (256, 1, 1), 0, 40,
                                          25600, small))
    assert (rich.registers, rich.static_smem) == (40, 25600)
    assert rich.total == 25600 and rich.fits()
    assert not dataclass_replace(rich, registers=300).fits()   # 300 · 256
    with pytest.raises(AssertionError, match=r"ptxas reports \(12, 0\)"):
        S.with_ptxas(est, S.CardLaunch((2, 1, 1), (256, 1, 1), 0, 40, 25600,
                                       "_Z13bitpack_kernelPKfPjiii"))
    with pytest.raises(LookupError):
        S.with_ptxas(est, S.CardLaunch((2, 1, 1), (256, 1, 1), 0, 40, 25600,
                                       "missing"))


def test_analysis_cli_check_passes_against_its_baseline():
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--check"],
        capture_output=True, text=True, env=env, cwd=REPO, timeout=600)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "analysis clean, matches baseline (9 cells)" in out.stdout
