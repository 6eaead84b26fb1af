#!/usr/bin/env python3
"""Drive the port's packed forwards on one CUDA card and check them.

    python3 chip_smoke.py            # from the repository root

Phases, each printing its lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of ``src/repro_torch/csrc``, one ``nvcc``
   per source in parallel, with the ptxas register/shared-memory report
   (a spill in K1, K2, K3/K7, K4, K5, K6 or K8 fails the run), then the
   tensor cores' 1-bit, int8 and TF32 ``mma.sync`` peaks
   (``csrc/mma_probe.cu``), which the bounds use;
3. kernels: each kernel against its plain PyTorch version on the card,
   bit-exact, at the full-width shapes of every path (batch 8), at the
   layer entry points' shapes and on ragged cases;
4. main paths, each driven with the launch counts set to 0 just before
   it and read just after:
   - the paper's ``BCNNSpec()`` and ``BMLPSpec()`` with random weights
     and BN from seed 0, packed on the card and served through
     ``make_packed_forward`` at batches 1, 8, 64 and 256, with
     ``dense_stack`` 'auto' (the single-launch stack) and 'per_layer';
     int32 pre-BN outputs and logits against the plain path, logits
     against the float reference at batch 8;
   - the layer entry points at the paper's shapes: ``ops.binary_matmul``
     on 8192x8192 operands (Table 1) and ``ops.binary_conv2d`` on the
     Table-3 layer (16x16, 128 -> 256 channels, 3x3 SAME) at batch 1
     and 256, against ``torch.matmul`` / ``F.conv2d`` on the ±1 tensors;
     ``ops.bitplane_conv2d_packed`` then ``ops.bn_sign_pack`` at the
     BCNN's first stage at batch 1 and 256 (K1's int32 instance and K2,
     the route of a first stage that pools), against the plain path and
     against K1's fused instance, which the forward runs there;
   - the packed binary LM at gemma2-9b's full width and depth (42
     layers), weights from seed 0 made and packed on the card: served
     through ``make_packed_forward`` at (B, S) = (1, 16) and (8, 16) and
     run as a (1, 4608) prefill, where the local layers' window masks;
     stage by stage against the plain versions (every layer at (1, 16)
     and (8, 16), layers 0 and 1 at (1, 4608));
5. times (CUDA events): every kernel of each path at batches 1 and 256
   beside its plain version, its bound and a library call; the attention
   kernel at each of its shapes and one local and one global LM layer;
   each forward per batch and mode, fed from host memory as a request
   arrives and from the card, and at batches 1 and 256 as a CUDA graph
   (the card's own time); the hidden stack at every batch, K6 in every
   tile beside K4-fused per layer; and K4 on both sides of
   ``binary_matmul.SMALL_M_MAX`` at the LM's widths;
6. serving: ``train.serve.PackedInferenceServer`` on the card (wall
   clock), each run with the launch counts set to 0 just before it and
   read just after.  ``BCNNSpec()`` and ``BMLPSpec()`` in both
   ``dense_stack`` modes, registered from params and spec (packed on the
   card once; a second ``register`` is a cache hit): a burst of 300
   requests at ``max_batch`` 256, a ragged tail of 13 that flushes on its
   deadline, and 20 requests one at a time, three times over (cold
   buckets, warm, and traced: each flush split by the server's spans);
   gemma2-9b (the packed tree of phase 4): 8 prompts of 16 tokens, ids up to 255999.  Every served row
   equal to the direct ``make_packed_forward`` on the flush's rows, each
   flush's launches equal to the direct forward's at its bucket; per
   flush batch, bucket, route, launches and wall time beside the direct
   forward's at that batch; request latency p50/p99 and requests/s;
7. sharding and recovery, every mesh position on the one card
   (``launch.mesh.make_host_mesh``): ``make_sharded_forward`` of
   ``BCNNSpec()`` and ``BMLPSpec()`` on the meshes (1, 1), (4, 1),
   (2, 2), (1, 4) and (2, 4) at batches 8 and 256 in both modes, each
   run's launches held to the shard plan (positions x the unsharded
   forward's, K4-fused per layer where a hidden layer shards), its
   gathers and gathered bytes to the packed words of the sharded seams,
   its int32 pre-BN outputs and logits to ``make_packed_forward``'s;
   their times beside the unsharded forward's, and the gathers' alone; a
   server with a (2, 2) mesh behind its queue (a burst of 300 and 20
   singles, every row held to the unsharded forward, each flush's
   launches to the sharded forward's at its bucket); the chaos drill
   (``launch.serve.run_chaos``) on ``BCNNSpec()``, a (4, 2) mesh
   degrading 8 -> 4 -> 2 from a packed checkpoint, every invariant held;
   packed-checkpoint save and restore of both networks (ms, MB);
8. the model zoo (``models/model.py``, ``train/serve.py``'s
   ``BatchedServer``), each run with the launch counts set to 0 just
   before it and read just after, and held to the same run on the plain
   route (``quant.backend = 'torch'``: K5's and K4's plain versions on the
   same card; only the packed dots differ between the routes, and they
   are integers, so everything is held equal): gemma2-9b at its published
   width and depth in ``binary`` mode (42 layers, float32 weights made on
   the card from seed 0, packed by ``maybe_pack_tree``, the float tree
   freed), ``make_prefill_step`` at (8, 16) (128 rows: K5 + K4) and
   (1, 512) (the unpack route), each also timed on the strategy AUTO
   does not take there, one decode step (K5 = K4 = 294, nothing else),
   one at the end of a 4096-position cache, ``BatchedServer`` on 8
   requests over 4 slots, K5 and K4 at layer 0's decode and prefill
   shapes beside their library calls (CUDA-graph replays);
   mamba2-1.3b (prefill (2, 512), 8 decode steps) and whisper-base
   (encode 1500 frames, 8 decode steps) at their published widths; every
   reduced registry config in each mode (``logits_fn``, ``prefill``, 3
   decode steps); the packed binary LM on every reduced config, stage by
   stage;
9. training (``train/trainer.py``): starcoder2-3b at its published width
   and depth (30 layers, d_model 3072, 24/2 heads of 128, gelu d_ff
   12288, vocab 49152, untied head, bfloat16 activations; float32 masters
   made on the card from seed 0), 3 steps in ``float`` and 3 in
   ``binary`` at (B, S) = (4, 512) on the port's stream, each step's ms
   (CUDA events), tokens/s, and each run's peak memory beside the
   reckoning from the parameter count; one step each of
   ``microbatches=4`` (held to ``microbatches=1`` from the same state),
   ``compress_grads`` and ``grads_bf16`` on the full-width binary state;
   a reduced float32 step on the card held to the same step on the CPU;
   the binary-trained tree, its optimizer state freed, packed by
   ``maybe_pack_tree`` and served: a (8, 16) prefill and a decode step,
   each launching K5 = K4 = the tree's packed linears (181) and equal to
   the plain route; the STE gradients of ``BCNNSpec()`` and
   ``BMLPSpec()`` at batch 8, card against CPU;
10. sharded training (``make_train_step(..., mesh=)``,
   ``distributed/fsdp.py``), every mesh position on the one card:
   starcoder2-3b at its published widths and depth, (4, 512), seed 0,
   one step each in ``float`` on (2, 2), (4, 1) and (1, 4) and in
   ``binary`` on (2, 2), FSDP over ``data`` and tensor parallelism over
   ``model`` where a block splits on whole units (attention and FFN on
   (2, 2), the FFN alone on (1, 4)), each from the same state and batch
   as an unsharded step and held to it (a data split is a microbatch
   split: phase 9's bounds; a float mesh that splits a block holds
   grad_norm at bfloat16 within ``TP_BF16_NORM_RTOL``, since the card's
   bfloat16 products round apart from the split ones, and within phase
   9's bound at float32 activations, where it runs again), (4, 1) also
   to ``microbatches=4``, which takes the same row slices; every
   position's resident bytes against
   the specs' reckoning, the counted gathers, reductions and partial
   sums of the weights and the tensor-parallel activations against
   ``fsdp.step_traffic``, ms a step, tokens/s and the peak beside the
   reckoning and beside the readings of the FSDP-only step and of the
   step that gathered the embedding and the head whole (PERF.md §5); the embedding and the loss's logits vocabulary-parallel
   wherever |model| divides the vocabulary (49,152 over 2 and 4), the
   bytes ``embed/table`` and ``head/w`` gather and reduce a step beside
   those of gathering them whole; the (2, 2)-trained binary tree made
   whole, packed and served (K5 = K4 = 181, equal to the plain route);
   mamba2-1.3b's split form (``fused_proj=False``) at its published
   widths, ``MAMBA_TRAIN_LAYERS`` layers, on (1, 2) (its 64 heads and its
   50,280-id vocabulary split over 2), held to the unsharded step at
   bfloat16 and again at float32 activations within phase 9's bounds;
   gemma2-9b's per-position bytes on (2, 2), (4, 1) and 16 x 16 from the
   dry run;
11. static analysis and launch probes (``repro_torch.analysis``,
   ``telemetry/probes.py``): ``BCNNSpec()`` and ``BMLPSpec()`` (made
   again from seed 0) at batches 1, 8, 32 and 256 in both modes and
   gemma2-9b at full width (made again from seed 0) at (1, 16) and
   (8, 16), each traced on fake tensors (``analysis.graph``), then run
   for real with the launch counts set to 0 just before it and read just
   after, inside the ops' launch recorder: the real launches' order,
   counts, grids and routes and the packedness report of the real run
   equal the fake trace's, with no escape; every distinct launch's
   shared-memory estimate (``analysis.smem``) equal to its launcher's
   query entry, with the instance's registers and static shared memory
   from the ptxas report (equal to the runtime's attributes) inside the
   budget; a seeded over-budget K6 and K1 launch refused by its launcher
   (``SmemBudgetError``) before anything launches; phase 7's sharded
   forwards at batch 8 through the collective rules on every mesh; both
   ``--check`` CLIs; the host cost the ``ops`` dispatcher adds to a
   launch beside the wrapper called directly (µs, median; at most
   HOST_ADDED_MAX_US), and what the op adds where a trace goes through
   it;
12. the examples (``repro_torch.examples``), each ``main`` on the card
   with its reference's default flags, with the launch counts set to 0
   just before it and read just after: the quickstart (K5 x2, K4), the
   bit-plane first layer (K5, K4, K1), the BMLP trained with the STE and
   served packed (K5, K4 x2, K2, K6), the binary-weight LM through
   ``BatchedServer`` (its unpack route launches no kernel); each returns
   0, its checks held.

Every kernel is held to its plain version exactly, but for the attention
kernel (K8), whose float softmax is held within rtol = atol = 2e-5 (the
reference's own tolerance between its kernel and its oracle).

The line before the last is the JSON list of kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without that line.
"""
from __future__ import annotations

import contextlib
import functools
import json
import os
import subprocess
import sys
import time


ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
FP32_FLOPS_PER_S = 67e12       # H100 SXM fp32 outside the tensor cores
# CUDA C++ Programming Guide, arithmetic instruction throughput table:
# 32-bit population count, 16 results per clock per SM at compute
# capability 9.0.  XOR and ADD (64 per clock) never bind before it.
POPC_PER_CLOCK_PER_SM = 16
# H100 SXM int8 tensor cores, dense (NVIDIA's data sheet, at 700 W).  An
# XNOR contraction can also run as a +-1 int8 product at its true depth,
# 2 ops per MAC, so its operations bound is the lesser of the two routes.
INT8_OPS_PER_S = 1979e12
TF32_OPS_PER_S = 495e12        # the same data sheet (dense, wgmma)
# NVIDIA publishes no H100 rate for the 1-bit MMA K4 runs on; the script
# measures its mma.sync peak (csrc/mma_probe.cu) and bounds with that.
BIT_MACS_PER_B1_MMA = 16 * 8 * 256
MACS_PER_S8_MMA = 16 * 8 * 32
# K8's P.V holds 2e-5 on the CUDA cores' fp32 FMA or as three TF32
# products (hi.hi + hi.lo + lo.hi) on the tensor cores.  The card's TF32
# peak is the published one; the mma.sync m16n8k8 rate K8 issues at is
# measured and printed beside it, and the bound takes the higher of the two.
MACS_PER_TF32_MMA = 16 * 8 * 8
TF32_PASSES = 3
# ptxas must report 0 spills
SPILL_FREE = ("bitplane_conv", "bn_sign_pack", "conv_bn_sign", "xnor_gemm",
              "binary_attention", "bitpack", "dense_stack")

LM_SERVE = ((1, 16), (8, 16))            # the reference serves max_len 16
LM_PREFILL = (1, 4608)                   # longer than the 4096 window

# kernel -> (source, the Pallas body it replaces, the path whose batch-256
# numbers, or batch-1 for the attention kernel, go into the kernels line)
SOURCES = {
    "bitplane_conv_bn_sign": ("src/repro_torch/csrc/bitplane_conv.cu",
                              "src/repro/kernels/binary_conv.py:277",
                              "bcnn auto"),
    "bitplane_conv": ("src/repro_torch/csrc/bitplane_conv.cu",
                      "src/repro/kernels/binary_conv.py:277",
                      "bitplane_conv2d"),
    "bn_sign_pack": ("src/repro_torch/csrc/bn_sign_pack.cu",
                     "src/repro/kernels/fused_epilogue.py:96", "bmlp auto"),
    "conv_bn_sign": ("src/repro_torch/csrc/conv_bn_sign.cu",
                     "src/repro/kernels/binary_conv.py:257", "bcnn auto"),
    "xnor_gemm": ("src/repro_torch/csrc/xnor_gemm.cu",
                  "src/repro/kernels/binary_matmul.py:120", "bcnn auto"),
    "xnor_gemm_bn_sign": ("src/repro_torch/csrc/xnor_gemm.cu",
                          "src/repro/kernels/binary_matmul.py:137",
                          "bcnn per_layer"),
    "bitpack": ("src/repro_torch/csrc/bitpack.cu",
                "src/repro/kernels/bitpack.py:26", "bmlp auto"),
    "dense_stack": ("src/repro_torch/csrc/dense_stack.cu",
                    "src/repro/kernels/binary_matmul.py:169", "bmlp auto"),
    "binary_conv": ("src/repro_torch/csrc/conv_bn_sign.cu",
                    "src/repro/kernels/binary_conv.py:249", "binary_conv2d"),
    "binary_attention": ("src/repro_torch/csrc/binary_attention.cu",
                         "src/repro/kernels/binary_attention.py:60",
                         f"attention gemma2-9b local {LM_PREFILL}"),
}
MODES = ("auto", "per_layer")
BATCHES = (1, 8, 64, 256)
MATMUL_SIZE = 8192                       # Table 1: 8192x8192 operands
TABLE3_LAYER = dict(hw=(16, 16), c_in=128, c_out=256)
ATTN_TOL = dict(rtol=2e-5, atol=2e-5)
ATTN_BIT_SLACK = 4e-5    # |ref| within which a packed attention bit may flip


def log(*parts) -> None:
    print(*parts, flush=True)


class Call:
    """One kernel call of a path: the kernel, its plain version on the
    same inputs, the work it must do (bytes, XOR + POPC word-ops, the
    MACs of the same contraction at its true depth, as int8 and as 1-bit
    MACs, fp32 operations) and an optional library call.

    ``library_as`` maps the library call's output onto the kernel's, where
    the library computes the kernel's whole function; it is None where
    the library computes only the contraction (no fused epilogue).
    ``also`` is a second yardstick, timed and printed only (the +-1
    float32 ``torch.matmul`` beside ``torch._int_mm``, or ``F.conv2d``
    beside the im2col ``torch._int_mm``), ``also_name`` what it is.
    ``tol`` is None for a kernel held to its plain version exactly, else
    the ``torch.allclose`` tolerance."""

    def __init__(self, name, kernel, plain, nbytes, word_ops, library=None,
                 library_as=None, flops=0, tol=None, macs=0, also=None,
                 bit_macs=None, also_name="the ±1 float32 torch.matmul"):
        self.name, self.kernel, self.plain = name, kernel, plain
        self.nbytes, self.word_ops, self.library = nbytes, word_ops, library
        self.library_as, self.flops, self.tol = library_as, flops, tol
        self.macs, self.also, self.also_name = macs, also, also_name
        self.bit_macs = macs if bit_macs is None else bit_macs


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def bitpack_call(x):
    """K5 on float32 (M, K); no single library call packs bits."""
    from repro_torch.core import binarize as B
    from repro_torch.kernels import bitpack as bp
    from repro_torch.kernels import ref
    m, k = x.shape
    return Call("bitpack", functools.partial(bp.bitpack, x),
                functools.partial(ref.bitpack_ref, x),
                _nbytes(x) + m * B.packed_width(k) * 4, 0)


def int_mm_allowed(m, n, k) -> bool:
    """``torch._int_mm``'s shape rule: M > 16, N and K multiples of 8."""
    return m > 16 and n % 8 == 0 and k % 8 == 0


def gemm_call(h, w, k):
    """K4 with the int32 epilogue.  Library: ``torch._int_mm`` on the ±1
    int8 operands where its shape rule allows (exact int32, the kernel's
    function), else the ±1 float32 GEMM (TF32 off; every dot is an
    integer below 2^24, so it is exact too).  The float32 GEMM is timed
    beside ``_int_mm`` as well."""
    import torch
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_matmul as bmm
    from repro_torch.kernels import ref
    m, n = h.shape[0], w.shape[0]
    f32 = functools.partial(torch.matmul, B.unpack_bits(h, k),
                            B.unpack_bits(w, k).T)
    f32_as = lambda y: y.round().to(torch.int32)   # noqa: E731
    if int_mm_allowed(m, n, k):
        library, library_as, also = functools.partial(
            torch._int_mm, B.unpack_bits(h, k, torch.int8),
            B.unpack_bits(w, k, torch.int8).T), (lambda y: y), f32
    else:
        library, library_as, also = f32, f32_as, None
    return Call("xnor_gemm",
                functools.partial(bmm.binary_matmul_packed, h, w, k_true=k),
                functools.partial(ref.binary_matmul_packed_ref, h, w, k),
                _nbytes(h, w) + m * n * 4, m * n * w.shape[1], library,
                library_as, macs=m * n * k, also=also)


def hidden_stack_calls(h, layers, foldeds, dense_stack):
    """The hidden dense stack as the forward runs it: one K6 launch
    ('auto', which the residency rule resolves to it here) or one fused K4
    per layer ('per_layer').  Returns the calls and the stack's output."""
    import torch
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_matmul as bmm
    from repro_torch.kernels import ref
    bsz = h.shape[0]
    stages = [{"w_packed": p["w_packed"], "k_true": p["k_true"],
               "tau": f["tau"], "flip": f["flip"]}
              for p, f in zip(layers, foldeds)]
    weights = [s["w_packed"] for s in stages]
    if dense_stack == "auto":
        if not bmm.dense_stack_fits(weights):
            raise AssertionError("the residency rule no longer takes this "
                                 "stack: 'auto' would not run K6")
        taus = [s["tau"] for s in stages]
        flips = [s["flip"] for s in stages]
        n_last = weights[-1].shape[0]
        call = Call(
            "dense_stack",
            functools.partial(bmm.binary_dense_stack_packed, h, weights,
                              taus, flips,
                              k_trues=[s["k_true"] for s in stages]),
            functools.partial(ref.binary_dense_stack_packed_ref, stages, h),
            _nbytes(h, *weights, *taus, *flips)
            + bsz * B.packed_width(n_last) * 4,
            sum(bsz * w.shape[0] * w.shape[1] for w in weights),
            macs=sum(bsz * w.shape[0] * s["k_true"]
                     for w, s in zip(weights, stages)))
        return [call], call.plain()
    calls = []
    for s in stages:
        calls.append(gemm_bn_sign_call(h, s["w_packed"], s["tau"],
                                       s["flip"], s["k_true"]))
        h = calls[-1].plain()
    return calls, h


def gemm_bn_sign_call(h, w, tau, flip, k):
    """K4 with the fused BN-sign epilogue.  Library (M > 16 and N, K
    multiples of 8): the ±1 int8 tensor-core GEMM, contraction only."""
    import torch
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_matmul as bmm
    from repro_torch.kernels import ref
    bsz = h.shape[0]
    library = None
    if int_mm_allowed(bsz, w.shape[0], k):
        library = functools.partial(
            torch._int_mm, B.unpack_bits(h, k, torch.int8),
            B.unpack_bits(w, k, torch.int8).T)
    args = (h, w, tau, flip)
    return Call(
        "xnor_gemm_bn_sign",
        functools.partial(bmm.binary_matmul_bn_sign_packed, *args, k_true=k),
        functools.partial(ref.binary_matmul_bn_sign_packed_ref, *args, k),
        _nbytes(*args) + bsz * B.packed_width(w.shape[0]) * 4,
        bsz * w.shape[0] * w.shape[1], library, macs=bsz * w.shape[0] * k)


def bcnn_calls(packed, x, dense_stack):
    """Walk the packed BCNN forward stage by stage with the plain versions
    and return every kernel call it makes, in order, on the inputs the
    path gives it."""
    from repro_torch.core import binarize as B
    from repro_torch.core import binary_layers as L
    from repro_torch.kernels import binary_conv as bconv
    from repro_torch.kernels import ref

    spec = packed["spec"]
    bsz = x.shape[0]
    calls = []

    pc, fc = packed["convs"][0], packed["folded_conv"][0]
    if spec.stages[0].pool:
        calls.append(bitplane_call(pc, x))
        z = L.maxpool2d(calls[-1].plain())
        calls.append(bn_sign_pack_call(z.reshape(-1, z.shape[-1])
                                       .contiguous(), fc))
        hp = calls[-1].plain().reshape(*z.shape[:-1], -1)
    else:
        calls.append(bitplane_call(pc, x, fc))
        hp = calls[-1].plain()

    for i in range(1, len(packed["convs"])):
        pc, fc = packed["convs"][i], packed["folded_conv"][i]
        geom = dict(kh=pc["kh"], kw=pc["kw"], stride=pc["stride"],
                    pads=pc["pads"], c_out=pc["c_out"], k_true=pc["k_true"])
        oh, ow = pc["out_hw"]
        args = (hp, pc["w_packed"], pc["correction"], fc["tau"], fc["flip"])
        library, _, also = conv_library(B.unpack_bits(hp, pc["c_in"]), pc)
        calls.append(Call(
            "conv_bn_sign",
            functools.partial(bconv.binary_conv2d_bn_sign_packed, *args,
                              out_hw=pc["out_hw"], **geom),
            functools.partial(ref.binary_conv2d_bn_sign_packed_ref, *args,
                              **geom),
            _nbytes(*args) + bsz * oh * ow * B.packed_width(pc["c_out"]) * 4,
            bsz * oh * ow * pc["c_out"] * pc["kh"] * pc["kw"] * pc["cw"],
            library, macs=bsz * oh * ow * pc["c_out"] * pc["k_true"],
            also=also, also_name="F.conv2d on the ±1 tensors"))
        hp = calls[-1].plain()
        if spec.stages[i].pool:
            hp = L.maxpool2d_packed(hp, packed["pool_masks"][i])

    h = hp.reshape(bsz, -1).contiguous()
    n = len(packed["denses"])
    stack, h = hidden_stack_calls(h, packed["denses"][:n - 1],
                                  packed["folded_dense"], dense_stack)
    out = packed["denses"][n - 1]
    return calls + stack + [gemm_call(h, out["w_packed"], out["k_true"])]


def bitplane_call(pc, x, folded=None):
    """K1 on the raw image ``x`` (B, H, W, C_in) uint8 of the plan ``pc``,
    as the path hands it over: the int32 instance, or with ``folded`` the
    fused instance (K2's epilogue inside, packed words out).  The plain
    version convolves the image's bit planes.  Library: ``F.conv2d`` on
    the zero-padded raw image against the
    ±1 weights (float32, TF32 off; every sum is an integer below 2^24, so
    exact); it computes the int32 instance's function and the fused one's
    contraction only."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_conv as bconv
    from repro_torch.kernels import ref
    bsz = x.shape[0]
    geom = dict(kh=pc["kh"], kw=pc["kw"], stride=pc["stride"],
                pads=pc["pads"], c_out=pc["c_out"], k_true=pc["k_true"],
                nbits=pc["nbits"])
    args = (x, pc["w_packed"], pc["rowsum"])
    pargs = (B.pack_bitplanes_uint8(x, pc["nbits"]), *args[1:])
    oh, ow = pc["out_hw"]
    xf = x.permute(0, 3, 1, 2).float()
    (pt, pb), (pl, pr) = pc["pads"]
    library = functools.partial(F.conv2d, F.pad(xf, (pl, pr, pt, pb)),
                                unpacked_conv_weights(pc),
                                stride=pc["stride"])
    work = dict(
        word_ops=bsz * oh * ow * pc["c_out"] * pc["kh"] * pc["kw"]
        * pc["cw"] * pc["nbits"],
        macs=bsz * oh * ow * pc["c_out"] * pc["k_true"],
        bit_macs=bsz * oh * ow * pc["c_out"] * pc["k_true"] * pc["nbits"])
    if folded is None:
        return Call(
            "bitplane_conv",
            functools.partial(bconv.bitplane_conv2d_packed, *args,
                              out_hw=pc["out_hw"], **geom),
            functools.partial(ref.bitplane_conv2d_planes_ref, *pargs, **geom),
            _nbytes(*args) + bsz * oh * ow * pc["c_out"] * 4,
            work["word_ops"], library,
            lambda y: y.permute(0, 2, 3, 1).round().to(torch.int32),
            macs=work["macs"], bit_macs=work["bit_macs"])
    bn = (folded["tau"], folded["flip"])
    return Call(
        "bitplane_conv_bn_sign",
        functools.partial(bconv.bitplane_conv2d_bn_sign_packed, *args, *bn,
                          out_hw=pc["out_hw"], **geom),
        lambda: ref.bn_sign_pack_ref(
            ref.bitplane_conv2d_planes_ref(*pargs, **geom), *bn),
        _nbytes(*args, *bn) + bsz * oh * ow * B.packed_width(pc["c_out"]) * 4,
        work["word_ops"], library, macs=work["macs"],
        bit_macs=work["bit_macs"])


def stage0_calls(packed, x):
    """The BCNN's first stage on the route of a stage that pools, without
    the pool: K1's int32 instance, then K2 on its output, at the shapes
    the fused instance takes on the forward."""
    pc = packed["convs"][0]
    calls = [bitplane_call(pc, x)]
    z = calls[0].plain()
    return calls + [bn_sign_pack_call(z.reshape(-1, z.shape[-1]),
                                      packed["folded_conv"][0])]


def conv_library(x_pm1, plan):
    """The yardsticks of a packed conv on its ±1 input ``x_pm1`` (B, H, W,
    C_in): ``torch._int_mm`` on the ±1 int8 im2col (B*OH*OW, KH*KW*C_in)
    with zero padding, tap-major as the packed weights, against the ±1
    int8 weights, and ``F.conv2d`` on the ±1 float32 tensors (TF32 off).
    Both compute the true zero-pad conv, the kernel's int32 result.
    Returns the ``_int_mm`` call (None where its shape rule fails), the
    map of its (M, C_out) output onto (B, OH, OW, C_out), and the
    ``F.conv2d`` call."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import binarize as B
    kh, kw, s, c_out = plan["kh"], plan["kw"], plan["stride"], plan["c_out"]
    (pt, pb), (pl, pr) = plan["pads"]
    oh, ow = plan["out_hw"]
    xp = F.pad(x_pm1, (0, 0, pl, pr, pt, pb))
    cols = torch.cat([xp[:, di:di + (oh - 1) * s + 1:s,
                         dj:dj + (ow - 1) * s + 1:s]
                      for di in range(kh) for dj in range(kw)], dim=-1)
    m, k = cols.shape[0] * oh * ow, cols.shape[-1]
    a = cols.reshape(m, k).to(torch.int8)
    w = B.unpack_bits(plan["w_packed"].reshape(c_out, kh * kw, plan["cw"]),
                      plan["c_in"], torch.int8).reshape(c_out, k)
    library = (functools.partial(torch._int_mm, a, w.T)
               if int_mm_allowed(m, c_out, k) else None)
    also = functools.partial(
        F.conv2d, F.pad(x_pm1.permute(0, 3, 1, 2), (pl, pr, pt, pb)),
        unpacked_conv_weights(plan), stride=s)
    return library, (lambda y: y.reshape(-1, oh, ow, c_out)), also


def unpacked_conv_weights(plan):
    """The ±1 float32 (C_out, C_in, KH, KW) weights of a conv plan."""
    from repro_torch.core import binarize as B
    c_out, kh, kw = plan["c_out"], plan["kh"], plan["kw"]
    wf = B.unpack_bits(plan["w_packed"].reshape(c_out, kh * kw, plan["cw"]),
                       plan["c_in"])
    return wf.reshape(c_out, kh, kw, plan["c_in"]).permute(
        0, 3, 1, 2).contiguous()


def bn_sign_pack_call(z2, folded):
    from repro_torch.core import binarize as B
    from repro_torch.kernels import fused_epilogue as fe
    from repro_torch.kernels import ref
    args = (z2, folded["tau"], folded["flip"])
    return Call("bn_sign_pack", functools.partial(fe.bn_sign_pack, *args),
                functools.partial(ref.bn_sign_pack_ref, *args),
                _nbytes(*args) + z2.shape[0] * B.packed_width(z2.shape[1])
                * 4, 0)


def bmlp_calls(packed, x, dense_stack):
    """The BMLP forward's kernel calls, in order: the stacked bit planes
    (one bitpack, one K4), K2, the hidden stack, the output K4."""
    import torch
    from repro_torch.core import binarize as B
    from repro_torch.core import binary_layers as L

    l0 = packed["layers"][0]
    nbits, bsz = l0["nbits"], x.shape[0]
    planes = (2 * B.bitplanes_uint8(x, nbits) - 1).to(torch.float32)
    planes = planes.reshape(nbits * bsz, -1)
    calls = [bitpack_call(planes)]
    calls.append(gemm_call(calls[-1].plain(), l0["w_packed"], l0["k_true"]))
    z = L.apply_bitplane_dense_packed(l0, x, backend="torch")
    calls.append(bn_sign_pack_call(z, packed["folded"][0]))
    layers = packed["layers"]
    stack, h = hidden_stack_calls(calls[-1].plain(), layers[1:-1],
                                  packed["folded"][1:], dense_stack)
    return calls + stack + [gemm_call(h, layers[-1]["w_packed"],
                                      layers[-1]["k_true"])]


def matmul_calls(a, b):
    """``ops.binary_matmul`` (Table 1): bitpack both operands, then K4."""
    calls = [bitpack_call(a), bitpack_call(b)]
    return calls + [gemm_call(calls[0].plain(), calls[1].plain(),
                              a.shape[1])]


def conv_calls(x, w):
    """``ops.binary_conv2d`` (the Table-3 layer): bitpack the channels,
    then K7.  Library: ``torch._int_mm`` on the zero-padded ±1 int8
    im2col, and beside it ``F.conv2d`` on the ±1 tensors (float32, TF32
    off, zero padding); both compute the same function."""
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_conv as bconv
    from repro_torch.kernels import ref
    from repro_torch.models import cnn
    bsz, h, wd, c_in = x.shape
    plan = cnn.to_device(bconv.make_conv_plan(w, input_hw=(h, wd)),
                         x.device)
    calls = [bitpack_call(x.reshape(-1, c_in))]
    xp = calls[0].plain().reshape(bsz, h, wd, -1)
    geom = dict(kh=plan["kh"], kw=plan["kw"], stride=plan["stride"],
                pads=plan["pads"], c_out=plan["c_out"],
                k_true=plan["k_true"])
    args = (xp, plan["w_packed"], plan["correction"])
    oh, ow = plan["out_hw"]
    library, library_as, also = conv_library(B.sign_pm1(x), plan)
    calls.append(Call(
        "binary_conv",
        functools.partial(bconv.binary_conv2d_packed, *args,
                          out_hw=plan["out_hw"], **geom),
        functools.partial(ref.binary_conv2d_packed_ref, *args, **geom),
        _nbytes(*args) + bsz * oh * ow * plan["c_out"] * 4,
        bsz * oh * ow * plan["c_out"] * plan["kh"] * plan["kw"] * plan["cw"],
        library, library_as if library else None,
        macs=bsz * oh * ow * plan["c_out"] * plan["k_true"], also=also,
        also_name="F.conv2d on the ±1 tensors"))
    return calls


def attention_pairs(b, sq, skv, hq, *, causal=True, window=None,
                    q_offset=0) -> int:
    """The (q, k) pairs one attention call must compute: the unmasked ones,
    and all Skv keys of a row that has none (it averages every key)."""
    import torch
    qpos = q_offset + torch.arange(sq, dtype=torch.int64)
    hi = qpos.clamp(max=skv - 1) if causal else torch.full_like(qpos, skv - 1)
    lo = ((qpos - window + 1).clamp(min=0) if window
          else torch.zeros_like(qpos))
    n = hi - lo + 1
    return int(torch.where(n > 0, n, skv).sum()) * b * hq


def sdpa_library(qp, kp, v, d, *, causal=True, window=None, q_offset=0):
    """``F.scaled_dot_product_attention`` on the ±1 float32 Q and K with the
    same boolean mask and scale (GQA by ``enable_gqa``): the same function
    where there is no softcap.  Returns the call and the map of its (B, H,
    S, Dv) output onto the kernel's layout."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_attention as ba
    sq, skv, dev = qp.shape[1], kp.shape[1], qp.device
    qpos = q_offset + torch.arange(sq, device=dev)[:, None]
    kpos = torch.arange(skv, device=dev)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=dev)
    if causal:
        mask &= qpos >= kpos
    if window:
        mask &= qpos - kpos < window
    call = functools.partial(
        F.scaled_dot_product_attention,
        B.unpack_bits(qp, d).transpose(1, 2).contiguous(),
        B.unpack_bits(kp, d).transpose(1, 2).contiguous(),
        v.transpose(1, 2).contiguous(), attn_mask=mask,
        scale=ba.attention_scale(d), enable_gqa=qp.shape[2] != kp.shape[2])
    return call, lambda y: y.transpose(1, 2)


def attention_call(qp, kp, v, d, *, library=False, **kw):
    """K8 on packed Q/K and float32 V, held to its plain version within
    ATTN_TOL.  Its work: per computed (q, k) pair, the score's XNOR
    contraction (Dw word-ops, D 1-bit MACs) and 2*Dv operations for P.V
    (fp32, or three times as many TF32 ones on the tensor cores)."""
    from repro_torch.kernels import binary_attention as ba
    from repro_torch.kernels import ref
    b, sq, hq, dw = qp.shape
    pairs = attention_pairs(b, sq, kp.shape[1], hq,
                            causal=kw.get("causal", True),
                            window=kw.get("window"),
                            q_offset=kw.get("q_offset", 0))
    lib, lib_as = (sdpa_library(qp, kp, v, d, **kw) if library
                   else (None, None))
    dv = v.shape[-1]
    return Call("binary_attention",
                functools.partial(ba.binary_attention_packed, qp, kp, v,
                                  d_true=d, **kw),
                functools.partial(ref.binary_attention_packed_ref, qp, kp,
                                  v, d_true=d, **kw),
                _nbytes(qp, kp, v) + b * sq * hq * dv * 4, pairs * dw, lib,
                lib_as, flops=2 * pairs * dv, tol=ATTN_TOL, macs=pairs * d)


def attention_cases(gen, dev) -> dict:
    """K8 at the LM's shapes (gemma2-9b's local and global layers at (1,
    4608) and at a served (8, 16); a starcoder2-3b layer at (1, 1024),
    timed against SDPA) and on ragged cases, on random inputs: the
    edges of its 64-row q tiles and 32-key KV tiles (Sq 65, Skv 129, a
    last tile of one key), Dv 8 to 512 (two 256-dim blocks past 256), Dw
    1 to 35 (D 17 to 1100: 1-4 k256 steps, the fragments from global
    memory past 32 words), GQA groups 1 and 8, decode-like Sq 3 and the
    16-row blocks of Sq <= 16, and V 4 bytes off 16-byte alignment
    (4-byte copies)."""
    import torch
    from repro_torch import configs
    from repro_torch.core import binarize as B
    g, sc = configs.GEMMA2_9B, configs.STARCODER2_3B
    gem = (g.num_heads, g.num_kv_heads, g.head_dim, g.head_dim)
    cap = dict(attn_softcap=g.attn_softcap)
    (bl, sl), (bs, ss) = LM_PREFILL, LM_SERVE[-1]
    cases = {
        f"gemma2-9b local {LM_PREFILL}": ((bl, sl, sl, *gem),
                                          dict(window=g.window_size, **cap)),
        f"gemma2-9b global {LM_PREFILL}": ((bl, sl, sl, *gem), cap),
        f"gemma2-9b local {LM_SERVE[-1]}": ((bs, ss, ss, *gem),
                                            dict(window=g.window_size,
                                                 **cap)),
        "starcoder2-3b (1, 1024)": ((1, 1024, 1024, sc.num_heads,
                                     sc.num_kv_heads, sc.head_dim,
                                     sc.head_dim), dict(library=True)),
        "D 40, Skv 130, q_offset 93": ((2, 37, 130, 6, 2, 40, 40),
                                       dict(window=5, q_offset=93, **cap)),
        "rows with no unmasked key": ((1, 12, 20, 4, 2, 40, 40),
                                      dict(window=3, q_offset=15)),
        "not causal, window 7": ((1, 9, 70, 2, 1, 33, 33),
                                 dict(causal=False, window=7)),
        "Dv 300, dynamic shared memory": ((1, 20, 50, 2, 2, 64, 300),
                                           dict(attn_softcap=30.0)),
        "Sq 65, Skv 129, group 1": ((2, 65, 129, 3, 3, 64, 64),
                                    dict(window=40, attn_softcap=50.0)),
        "Dv 8, D 17, group 8": ((1, 70, 70, 8, 1, 17, 8), {}),
        "Dv 24, D 280, not causal": ((1, 33, 97, 4, 2, 280, 24),
                                     dict(causal=False)),
        "Dv 264, D 512": ((1, 65, 65, 2, 1, 512, 264),
                          dict(attn_softcap=50.0)),
        "Dv 512, D 1100, fragments from global memory": (
            (1, 40, 33, 2, 1, 1100, 512), dict(window=9)),
        "Sq 3, q_offset 126, Skv 129": ((2, 3, 129, 16, 8, 256, 256),
                                        dict(q_offset=126, window=64,
                                             attn_softcap=50.0)),
        "a q tile with rows that see no key beside rows that do": (
            (1, 70, 100, 2, 2, 40, 40), dict(window=5, q_offset=60)),
        "V 4 bytes off 16-byte alignment": ((1, 65, 100, 4, 2, 256, 256),
                                            dict(window=50,
                                                 misaligned_v=True)),
        "Sq 16, Dv 264: 16-row blocks, one warp with dims in the second": (
            (1, 16, 40, 4, 2, 40, 264), dict(window=9, attn_softcap=50.0)),
    }
    out = {}
    for name, ((b, sq, skv, hq, hkv, d, dv), kw) in cases.items():
        kw = dict(kw)
        qp = B.pack_bits(torch.randn((b, sq, hq, d), generator=gen).to(dev))
        kp = B.pack_bits(torch.randn((b, skv, hkv, d), generator=gen).to(dev))
        v = torch.randn((b, skv, hkv, dv), generator=gen).to(dev)
        if kw.pop("misaligned_v", False):
            v = misaligned(v)
        out[name] = attention_call(qp, kp, v, d, **kw)
    return out


def lm_model(dev, gen):
    """gemma2-9b at full width and depth: float weights from seed 0 made on
    the card, the FFN's BN randomized, packed on the card; the float tree
    is freed before anything is timed."""
    import torch
    from repro_torch import configs
    from repro_torch.models import transformer as tf
    spec = configs.GEMMA2_9B
    t0 = time.perf_counter()
    params = tf.init_binary_lm(torch.Generator(device=dev).manual_seed(0),
                               spec)
    randomize_bn([blk["bn1"] for blk in params["blocks"]], gen)
    n_float = sum(t.numel() for blk in params["blocks"]
                  for k, t in blk.items() if k != "bn1")
    n_float += params["embed"].numel() + params["head"].numel()
    packed = tf.pack_transformer(params, spec, max_len=LM_SERVE[0][1],
                                 device=dev)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    words = sum(blk[w]["w_packed"].numel() for blk in packed["blocks"]
                for w in ("wq", "wk", "wv", "wo", "w1", "w2"))
    log(f"lm: {spec.name}, {spec.num_layers} layers, d_model "
        f"{spec.d_model}, {spec.num_heads}/{spec.num_kv_heads} heads of "
        f"{spec.head_dim}, d_ff {spec.d_ff}, vocab {spec.vocab_size}: "
        f"{n_float} float parameters made and packed on the card in "
        f"{time.perf_counter() - t0:.1f} s; packed layers {words * 4} bytes, "
        f"packed head {packed['head']['w_packed'].numel() * 4}, float32 "
        f"embedding {packed['embed'].numel() * 4}")
    return spec, packed


def attention_bit_flips(what, got, want) -> int:
    """Packed attention bits of the kernel path against the plain path's:
    the number that differ, each only where the plain value lies within
    ATTN_BIT_SLACK of 0."""
    rows = got.shape[0] * got.shape[1]
    w = want.reshape(rows, -1)
    differ = (got.reshape(rows, -1) >= 0) != (w >= 0)
    n = int(differ.sum())
    if n and not bool((w[differ].abs() <= ATTN_BIT_SLACK).all()):
        raise AssertionError(f"{what}: a packed attention bit differs where "
                             f"the plain value is farther than "
                             f"{ATTN_BIT_SLACK} from 0")
    return n


def lm_stage_check(what, packed, tokens, n_layers=None):
    """The forward stage by stage against the plain versions on the card:
    each layer's first half on the plain path's residual (q, k, v equal,
    the attention output within ATTN_TOL, packed bits by the slack rule),
    its second half on the plain path's residual and attention output (the
    next residual equal), then the head.  Returns the number of differing
    attention bits and the plain logits (None when ``n_layers`` cuts the
    walk short)."""
    from repro_torch.models import transformer as tf
    meta = packed["meta"]
    x = tf.embed(packed, tokens)
    flips = 0
    worst = 0.0
    blocks = packed["blocks"][:n_layers]
    for i, (blk, kind) in enumerate(zip(blocks, meta["kinds"])):
        window = tf.layer_window(meta, kind)
        want = tf.attention_half(blk, meta, x, window=window,
                                 backend="torch")
        got = tf.attention_half(blk, meta, x, window=window, backend="cuda")
        for name, a, b in zip("qkv", got[:3], want[:3]):
            check_equal(f"{what} layer {i} {name}", a, b)
        worst = max(worst, check_close(f"{what} layer {i} attention",
                                       got[3], want[3], ATTN_TOL))
        flips += attention_bit_flips(f"{what} layer {i}", got[3], want[3])
        x_next = tf.update_half(blk, meta, x, want[3], backend="torch")
        check_equal(f"{what} layer {i} residual",
                    tf.update_half(blk, meta, x, want[3], backend="cuda"),
                    x_next)
        x = x_next
    want = None
    if n_layers is None:
        want = tf.head_logits(packed, x, backend="torch")
        check_equal(f"{what} head", tf.head_logits(packed, x, backend="cuda"),
                    want)
    log(f"  {what}: q, k, v and residuals equal; attention outputs within "
        f"{ATTN_TOL} (max |diff| {worst:.3g}); {flips} packed attention "
        f"bits differ, each within {ATTN_BIT_SLACK} of 0")
    return flips, want


def lm_path(drv, spec, packed, gen, dev) -> dict:
    """Serve the packed LM through ``make_packed_forward`` at LM_SERVE and
    run the LM_PREFILL forward, with the launch counts of each; then the
    stage-by-stage check and the logits.  Returns the ids used."""
    import torch
    from repro_torch.models import cnn
    from repro_torch.models import transformer as tf
    n = spec.num_layers
    expect = {"bitpack": 5 * n + 1, "xnor_gemm": 5 * n + 1,
              "xnor_gemm_bn_sign": n, "binary_attention": n}
    fwd = cnn.make_packed_forward(packed)
    tokens, logits = {}, {}
    for b, s in LM_SERVE:
        tokens[b, s] = torch.randint(0, spec.vocab_size, (b, s),
                                     generator=gen)    # int64, host memory
        logits[b, s] = drv.run(f"lm serve ({b}, {s})",
                               lambda: fwd(tokens[b, s]), expect)
    b, s = LM_PREFILL
    tokens[b, s] = torch.randint(0, spec.vocab_size, (b, s),
                                 generator=gen).to(dev)
    logits[b, s] = drv.run(
        f"lm prefill ({b}, {s})",
        lambda: tf.transformer_forward_packed(packed, tokens[b, s]), expect)
    for (b, s), out in logits.items():
        if out.shape != (b, spec.vocab_size) or \
                not bool(torch.isfinite(out).all()):
            raise AssertionError(f"lm ({b}, {s}): logits not finite or of "
                                 f"the wrong shape {tuple(out.shape)}")
    log(f"main path lm {spec.name}: served at {LM_SERVE} and run at "
        f"{LM_PREFILL}, launches per forward {expect}; logits finite, "
        f"(B, {spec.vocab_size})")
    for b, s in LM_SERVE:
        flips, want = lm_stage_check(f"lm ({b}, {s})", packed,
                                     tokens[b, s].to(dev))
        if flips == 0:
            check_equal(f"lm ({b}, {s}) logits", logits[b, s], want)
            log(f"main path lm ({b}, {s}): every layer's stages and the "
                f"logits equal the plain path's")
        else:
            log(f"main path lm ({b}, {s}): every layer's stages hold; "
                f"{flips} attention bits flip near 0, so the logits are "
                f"not compared whole")
    b, s = LM_PREFILL
    lm_stage_check(f"lm ({b}, {s}) layers 0 (local) and 1 (global)", packed,
                   tokens[b, s], n_layers=2)
    return tokens


def lm_layer_calls(packed, x, i):
    """Layer ``i``'s kernel calls in the forward's order, on the inputs the
    forward gives them (walked with the plain versions): bitpack, K4 x3
    (Q, K, V), bitpack x2 (q, k), K8, bitpack, K4 (O), bitpack, K4-fused
    (FFN up), K4 (FFN down).  Returns the calls and the next residual."""
    from repro_torch.models import transformer as tf
    meta, blk = packed["meta"], packed["blocks"][i]
    d, hq, hkv, hd, f = (meta["d_model"], meta["num_heads"],
                         meta["num_kv_heads"], meta["head_dim"], meta["d_ff"])
    b, s = x.shape[:2]
    calls = [bitpack_call(x.reshape(b * s, d))]
    xp = calls[-1].plain()
    q, k, v = [], [], []
    for w, out in (("wq", q), ("wk", k), ("wv", v)):
        calls.append(gemm_call(xp, blk[w]["w_packed"], d))
        out.append(calls[-1].plain())
    calls.append(bitpack_call(q[0].reshape(-1, hd).float()))
    qp = calls[-1].plain().reshape(b, s, hq, -1)
    calls.append(bitpack_call(k[0].reshape(-1, hd).float()))
    kp = calls[-1].plain().reshape(b, s, hkv, -1)
    calls.append(attention_call(
        qp, kp, v[0].reshape(b, s, hkv, hd).float() * (1.0 / d), hd,
        window=tf.layer_window(meta, meta["kinds"][i]),
        attn_softcap=meta["attn_softcap"]))
    attn = calls[-1].plain()
    calls.append(bitpack_call(attn.reshape(b * s, hq * hd)))
    calls.append(gemm_call(calls[-1].plain(), blk["wo"]["w_packed"],
                           hq * hd))
    x = x + calls[-1].plain().reshape(b, s, d).float() * (1.0 / (hq * hd))
    calls.append(bitpack_call(x.reshape(b * s, d)))
    calls.append(gemm_bn_sign_call(calls[-1].plain(), blk["w1"]["w_packed"],
                                   blk["fold1"]["tau"], blk["fold1"]["flip"],
                                   d))
    calls.append(gemm_call(calls[-1].plain(), blk["w2"]["w_packed"], f))
    x = x + calls[-1].plain().reshape(b, s, d).float() * (1.0 / f)
    return calls, x


def lm_head_calls(packed, x):
    """The head's calls: bitpack of the last token, K4 over the vocab."""
    calls = [bitpack_call(x[:, -1].contiguous())]
    return calls + [gemm_call(calls[0].plain(), packed["head"]["w_packed"],
                              packed["meta"]["d_model"])]


def time_lm(packed, tokens, rates, dev) -> dict:
    """Per kernel, one local and one global layer and the head at a served
    (8, 16) and at the (1, 4608) prefill; then the forwards."""
    from repro_torch.models import cnn
    from repro_torch.models import transformer as tf
    rows = {}
    n = len(packed["blocks"])
    for bs in (LM_SERVE[-1], LM_PREFILL):
        x = tf.embed(packed, tokens[bs].to(dev))
        big = bs == LM_PREFILL
        for i, kind in enumerate(packed["meta"]["kinds"][:2]):
            calls, x = lm_layer_calls(packed, x, i)
            rows[bs, kind] = kernel_table(calls, rates,
                                          kernel_reps=5 if big else 20,
                                          plain_reps=1 if big else 3)
            log_table(f"lm {bs} layer {i} ({kind}, x{n // 2} per forward)",
                      rows[bs, kind])
        rows[bs, "head"] = kernel_table(lm_head_calls(packed, x), rates,
                                        kernel_reps=20, plain_reps=3)
        log_table(f"lm {bs} head", rows[bs, "head"])
    fwd = cnn.make_packed_forward(packed)
    for b, s in LM_SERVE + (LM_PREFILL,):
        host = tokens[b, s].cpu()
        card = host.to(dev)
        if (b, s) == LM_PREFILL:
            ms_host = time_ms(lambda: tf.transformer_forward_packed(
                packed, host), reps=1, warmup=0)
            ms = time_ms(lambda: tf.transformer_forward_packed(packed, card),
                         reps=2, warmup=0)
        else:
            ms_host = time_ms(lambda: fwd(host), reps=10)
            ms = time_ms(lambda: fwd(card), reps=10)
        log(f"forward lm ({b}, {s}): {ms_host:.5g} ms from host memory "
            f"({b * s / ms_host * 1e3:.6g} tokens/s), {ms:.5g} ms with the "
            f"ids already on the card ({b * s / ms * 1e3:.6g} tokens/s)")
    return rows


def mma_peaks(dev, sms) -> dict:
    """The mma.sync issue rates of the 1-bit (m16n8k256 .and.popc), the
    int8 (m16n8k32) and the TF32 (m16n8k8) steps on register operands,
    every SM busy (csrc/mma_probe.cu): ops/s at 2 ops per MAC, best of 3
    runs."""
    import torch
    from repro_torch.kernels import _build
    lib = _build.load("mma_probe", {"mma_peak": "iiipp"})
    blocks, iters = 8 * sms, 4096
    out = torch.empty(blocks * 256, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    mmas = blocks * 8 * iters * 8          # warps x iterations x chains
    peaks = {}
    for key, kind, macs in (("b1_ops", 0, BIT_MACS_PER_B1_MMA),
                            ("s8_mma_sync_ops", 1, MACS_PER_S8_MMA),
                            ("tf32_ops", 2, MACS_PER_TF32_MMA)):
        def run():
            _build.check(lib.mma_peak(kind, blocks, iters, out.data_ptr(),
                                      stream), "mma_peak")
        ms = min(time_ms(run, 1) for _ in range(3))
        peaks[key] = 2 * macs * mmas / (ms * 1e-3)
    log(f"tensor-core peaks measured (mma.sync on registers): 1-bit "
        f"m16n8k256 {peaks['b1_ops']:.5g} ops/s, int8 m16n8k32 "
        f"{peaks['s8_mma_sync_ops']:.5g} ops/s (published int8 dense "
        f"{INT8_OPS_PER_S:.5g}), TF32 m16n8k8 {peaks['tf32_ops']:.5g} "
        f"ops/s (published TF32 dense {TF32_OPS_PER_S:.5g})")
    return peaks


def time_route_edge(gen, dev) -> None:
    """K4 through its wrapper on both sides of ``SMALL_M_MAX`` at the LM's
    widths: the XOR + POPC kernel at M = SMALL_M_MAX, the 1-bit
    tensor-core one at M = SMALL_M_MAX + 1 and 16, each held to the plain
    version, then timed."""
    import torch
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_matmul as bmm
    from repro_torch.kernels import ref
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for n, k in ((3584, 3584), (14336, 3584), (3584, 14336)):
        w = B.pack_bits(torch.rand((n, k), generator=gen).to(dev) * 2 - 1)
        times = []
        for m in (bmm.SMALL_M_MAX, bmm.SMALL_M_MAX + 1, 16):
            a = B.pack_bits(torch.rand((m, k), generator=gen).to(dev) * 2 - 1)
            check_equal(f"xnor_gemm M={m} N={n} K={k}",
                        bmm.binary_matmul_packed(a, w, k_true=k),
                        ref.binary_matmul_packed_ref(a, w, k))
            ms = time_ms(lambda: bmm.binary_matmul_packed(a, w, k_true=k), 20)
            times.append(f"M={m} (route {bmm.gemm_route(m, n, sms)}) "
                         f"{ms:.5g} ms")
        log(f"time xnor_gemm at the route edge N={n} K={k}: "
            + ", ".join(times))


def time_ms(fn, reps: int, warmup: int = 1) -> float:
    """Mean ms per call over ``reps`` calls, CUDA events, after warm-up."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps: int = 20) -> float:
    """Per-call ms of ``reps`` calls captured in one CUDA graph and
    replayed: the card's own time, without the host's launch cost (best of
    5 replays)."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(reps):
            fn()
    g.replay()
    torch.cuda.synchronize()
    best = float("inf")
    for _ in range(5):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        g.replay()
        end.record()
        torch.cuda.synchronize()
        best = min(best, start.elapsed_time(end) / reps)
    return best


def time_dense_stack(what, calls_of, inputs, rates, dev) -> None:
    """The hidden stack at every batch: K6 ('auto', in the tile its rule
    picks and in every other) beside the route it must beat, K4-fused once
    per layer ('per_layer'), each on the stack's input as the forward
    gives it.  Eager (CUDA events over back-to-back calls) at every batch,
    and as a CUDA graph (the card's own time) at batches 1 and 8, where
    the host's launch cost is the eager time.  Prints K6's bound."""
    from repro_torch.kernels import binary_matmul as bmm
    for b in BATCHES:
        x = inputs[b].to(dev)
        stack = [c for c in calls_of(x, "auto") if c.name == "dense_stack"]
        fused = [c for c in calls_of(x, "per_layer")
                 if c.name == "xnor_gemm_bn_sign"]
        rows = kernel_table(stack + fused, rates, kernel_reps=20,
                            plain_reps=1)
        k6, k4 = rows["dense_stack"], rows["xnor_gemm_bn_sign"]
        weights = stack[0].kernel.args[1]
        fit = bmm.stack_clusters(dev, bmm.stack_buffer_words(weights))
        line = (f"time dense_stack {what} B={b}: K6 {k6['ms']:.5g} ms in "
                f"tile {bmm.stack_tile(b, fit)} (clusters that fit at once "
                f"{fit}), K4-fused x"
                f"{k4['launches_per_forward']} {k4['ms']:.5g} ms, K6 / "
                f"K4-fused {k6['ms'] / k4['ms']:.4g}; K6 bound "
                f"{k6['bound_ms']:.5g} ms ({k6['bound_by']}), K4-fused "
                f"bound {k4['bound_ms']:.5g} ms")
        if b <= 8:
            g6 = graph_ms(stack[0].kernel)
            g4 = graph_ms(lambda: [c.kernel() for c in fused])
            line += (f"; as a CUDA graph K6 {g6:.5g} ms, K4-fused "
                     f"{g4:.5g} ms")
        tiles = []
        for tile in bmm.STACK_TILES:
            with forced_stack_tile(tile):
                t = f"{tile} {time_ms(stack[0].kernel, 20):.5g}"
                if b <= 8:
                    t += f" (graph {graph_ms(stack[0].kernel):.5g})"
            tiles.append(t)
        log(line + "; K6 in each tile: " + ", ".join(tiles) + " ms")


def check_equal(what: str, got, want) -> None:
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else -1
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version ({bad} elements differ, shapes "
                             f"{tuple(got.shape)} vs {tuple(want.shape)})")


def check_close(what: str, got, want, tol) -> float:
    """``got`` within ``tol`` of ``want`` (finite, same shape); returns the
    largest absolute difference."""
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.isfinite(got).all() or \
            not torch.allclose(got, want, **tol):
        err = ((got - want).abs().max().item() if got.shape == want.shape
               else float("nan"))
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version beyond {tol} (max |diff| {err}, "
                             f"shapes {tuple(got.shape)} vs "
                             f"{tuple(want.shape)})")
    return (got - want).abs().max().item()


def check_call(what: str, c, got, want) -> float:
    """One call's kernel output against its plain version's: exact, or
    within the call's tolerance; returns the largest absolute error."""
    import torch
    if c.tol is None:
        check_equal(what, got, want)
        return float((got.to(torch.int64) - want.to(torch.int64))
                     .abs().max()) if got.numel() else 0.0
    return check_close(what, got, want, c.tol)


def check_library(what: str, c, want) -> None:
    """The library call's output against the plain version's, where the
    library computes the kernel's function."""
    if c.library_as is None:
        return
    got = c.library_as(c.library())
    if c.tol is None:
        check_equal(f"{what}: {c.name} library call", got, want)
    else:  # a float softmax in another order: layout faults show as O(1)
        check_close(f"{what}: {c.name} library call", got, want,
                    dict(rtol=1e-4, atol=1e-4))


def check_calls(what: str, calls) -> None:
    """Each call's kernel against its plain version (and the library call,
    where it computes the kernel's function)."""
    for c in calls:
        want = c.plain()
        check_call(f"{what}: {c.name}", c, c.kernel(), want)
        check_library(what, c, want)


def ragged_checks(gen, dev) -> list[str]:
    """Ragged shapes: channel and K tails, N 10 and 40, M 1, stride 2, both
    of K5's paths, and the edges of K4's, K6's (every tile), K3/K7's and
    K1's tiles (GEMM_RAGGED, STACK_RAGGED, CONV_RAGGED, BITPLANE_RAGGED)."""
    import torch
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_conv as bconv
    from repro_torch.kernels import binary_matmul as bmm
    from repro_torch.kernels import bitpack as bp
    from repro_torch.kernels import fused_epilogue as fe
    from repro_torch.kernels import ref

    def pm1(*shape):
        return torch.rand(shape, generator=gen) * 2 - 1

    def bn(c, k):
        tau = torch.randint(-k, k + 1, (c,), generator=gen).float()
        tau = tau + 0.5 * (torch.rand(c, generator=gen) < 0.5)
        flip = torch.where(torch.rand(c, generator=gen) < 0.3, -1.0, 1.0)
        return tau.to(dev), flip.to(dev)

    done = []
    for m, c in BN_SIGN_RAGGED + SHARD_BN_SIGN:
        x = torch.randint(-60, 60, (m, c), generator=gen,
                          dtype=torch.int32).to(dev)
        tau, flip = bn(c, 60)
        tau[0] = x[0, 0].float()          # y == tau exactly
        want = ref.bn_sign_pack_ref(x, tau, flip)
        for xx in (x, misaligned(x)):     # 4 bytes off: the general path
            aligned = fe.bn_sign_aligned(c, xx.data_ptr())
            if aligned != (c % 4 == 0 and xx is x):
                raise AssertionError(f"bn_sign_pack M={m} C={c}: path rule")
            check_equal(f"bn_sign_pack M={m} C={c} aligned path {aligned}",
                        fe.bn_sign_pack(xx, tau, flip), want)
    done.append(f"bn_sign_pack (M, C) in {BN_SIGN_RAGGED + SHARD_BN_SIGN} on "
                f"the general path, and where C % 4 == 0 on the aligned one, "
                f"tau[0] == x[0, 0]")
    for m in (1, 37):
        for k in (1, 31, 33, 784, 1000) + BITPACK_ALIGNED:
            x = torch.randn((m, k), generator=gen)
            x.view(-1)[torch.randint(0, m * k, (max(1, m * k // 7),),
                                     generator=gen)] = -0.0
            x.view(-1)[torch.randint(0, m * k, (max(1, m * k // 11),),
                                     generator=gen)] = float("nan")
            x.view(-1)[torch.randint(0, m * k, (max(1, m * k // 13),),
                                     generator=gen)] = 1.17549435e-38
            x.view(-1)[torch.randint(0, m * k, (max(1, m * k // 13),),
                                     generator=gen)] = -1.17549435e-38
            x[0, 0] = -0.0
            x = x.to(dev)
            for xx in (x, misaligned(x)):   # 4 bytes off: the general path
                aligned = bp.packs_aligned(k, xx.data_ptr())
                if aligned != (k in BITPACK_ALIGNED and xx is x):
                    raise AssertionError(f"bitpack M={m} K={k}: path rule")
                check_equal(f"bitpack M={m} K={k} aligned path {aligned}",
                            bp.bitpack(xx), ref.bitpack_ref(xx))
    done.append(f"bitpack M in (1, 37) x K in (1, 31, 33, 784, 1000) on the "
                f"general path and K in {BITPACK_ALIGNED} on both, with -0.0,"
                f" NaN and the tiniest normals")
    for m, n, k, shift in GEMM_RAGGED + SHARD_GEMM:
        a = B.pack_bits(pm1(m, k)).to(dev)
        w = B.pack_bits(pm1(n, k)).to(dev)
        if shift:           # rows that do not start on 16 bytes
            a, w = misaligned(a), misaligned(w)
        route = bmm.gemm_route(m, n, torch.cuda.get_device_properties(
            dev).multi_processor_count)
        what = (f"M={m} N={n} K={k}, route {route}"
                + (", operands 4 bytes off 16-byte alignment" if shift
                   else ""))
        check_equal(f"xnor_gemm {what}",
                    bmm.binary_matmul_packed(a, w, k_true=k),
                    ref.binary_matmul_packed_ref(a, w, k))
        tau, flip = bn(n, k)
        check_equal(f"xnor_gemm_bn_sign {what}",
                    bmm.binary_matmul_bn_sign_packed(a, w, tau, flip,
                                                     k_true=k),
                    ref.binary_matmul_bn_sign_packed_ref(a, w, tau, flip, k))
        done.append(f"xnor_gemm(+bn_sign) {what}")
    for what, (sizes, k, ms) in STACK_RAGGED.items():
        stages = []
        for n in sizes:
            tau, flip = bn(n, k)
            stages.append({"w_packed": B.pack_bits(pm1(n, k)).to(dev),
                           "k_true": k, "tau": tau, "flip": flip})
            k = n
        for m in ms:
            x = B.pack_bits(pm1(m, stages[0]["k_true"])).to(dev)
            want = ref.binary_dense_stack_packed_ref(stages, x)
            for tile in bmm.STACK_TILES:
                with forced_stack_tile(tile):
                    check_equal(f"dense_stack {what} M={m} tile {tile}",
                                stack_launch(x, stages), want)
        done.append(f"dense_stack {what}, M in {ms}, every tile "
                    f"{bmm.STACK_TILES}")
    def conv_case(bsz, hw, c_in, c_out, stride, padding, shift=False):
        plan = bconv.make_conv_plan(pm1(c_out, 3, 3, c_in), input_hw=hw,
                                    stride=stride, padding=padding)
        x = B.pack_bits(pm1(bsz, *hw, c_in)).to(dev)
        if shift:           # rows that do not start on 16 bytes
            x = misaligned(x)
        geom = dict(kh=3, kw=3, stride=stride, pads=plan["pads"],
                    c_out=c_out, k_true=plan["k_true"])
        tau, flip = bn(c_out, plan["k_true"])
        args = (x, plan["w_packed"].to(dev), plan["correction"].to(dev))
        tile = bconv.conv_tile(bsz * plan["out_hw"][0] * plan["out_hw"][1],
                               c_out, torch.cuda.get_device_properties(
                                   dev).multi_processor_count)
        what = (f"B={bsz} {hw} C_in={c_in} C_out={c_out} s{stride} "
                f"{padding}, tile {tile}"
                + (", input 4 bytes off 16-byte alignment" if shift else ""))
        check_equal(f"conv_bn_sign {what}", bconv.binary_conv2d_bn_sign_packed(
            *args, tau, flip, out_hw=plan["out_hw"], **geom),
            ref.binary_conv2d_bn_sign_packed_ref(*args, tau, flip, **geom))
        check_equal(f"binary_conv {what}", bconv.binary_conv2d_packed(
            *args, out_hw=plan["out_hw"], **geom),
            ref.binary_conv2d_packed_ref(*args, **geom))
        return f"conv_bn_sign and binary_conv {what}"

    for (hw, c_in, c_out, stride, padding) in (((9, 9), 33, 40, 2, "VALID"),
                                                ((7, 7), 20, 40, 1, "SAME"),
                                                ((9, 9), 64, 10, 2, "SAME")):
        done.append(conv_case(2, hw, c_in, c_out, stride, padding))
        done.append(bitplane_check(gen, dev, hw, 3, c_out, stride, padding,
                                   8))
    for case in CONV_RAGGED + SHARD_CONV:
        done.append(conv_case(*case))
    for hw, c_in, c_out, stride, padding, nbits in \
            BITPLANE_RAGGED + SHARD_BITPLANE:
        done.append(bitplane_check(gen, dev, hw, c_in, c_out, stride,
                                   padding, nbits))
    return done


# K4 and K4-fused edges of the redesign's tiling, (M, N, K, misaligned):
# the small-M route's limit (8) and past it, rows that end inside an m16
# fragment (15, 17), one and two 64- and 128-row tiles, ragged N (10, 40,
# 136) and K (1, 31, 33: 1-2 words, not a whole stage), the LM's widths
# (3584, 14336), and operands whose rows do not start on 16 bytes (the
# 4-byte cp.async path).
GEMM_RAGGED = ((1, 10, 1000, False), (3, 10, 33, False),
               (1, 40, 8192, False), (9, 40, 70, False),
               (8, 136, 31, False), (9, 136, 3584, False),
               (15, 136, 31, False), (16, 40, 3584, False),
               (17, 10, 33, False), (128, 136, 1, False),
               (129, 40, 14336, False), (129, 10, 31, False),
               (1, 14336, 14336, False), (16, 14336, 1, False),
               (4608, 14336, 3584, False), (129, 136, 3584, True),
               (15, 40, 3584, True), (4608, 136, 33, True),
               (2048, 4096, 100, True))
# K6 stacks, (sizes, K_0, the M edges): stage widths that do not split into
# whole words per block (the last blocks take fewer words or none), the
# kernel's 16 stages, the BCNN's 256-word first stage and the BMLP's stack;
# M below, at and past one 16- and 32-row tile.
STACK_RAGGED = {
    "100 -> 40 -> 96 -> 10": ((40, 96, 10), 100, (1, 15, 16, 17, 33, 37)),
    "16 stages": ((64, 33, 100, 32, 7, 64, 200, 31, 96, 40, 128, 9, 64, 64,
                   250, 10), 70, (1, 37)),
    "8192 -> 1024 -> 1024": ((1024, 1024), 8192, (1, 17, 65)),
    "4096 -> 4096 -> 4096": ((4096, 4096), 4096, (1, 17, 65, 300)),
}
# K5's aligned path: the LM's and Table 1's widths.
BITPACK_ALIGNED = (256, 3584, 4096, 8192)
# K3/K7 edges of the tensor-core tiling, (B, hw, C_in, C_out, stride,
# padding, misaligned): the BCNN's five packed-conv stages at batch 2
# (Cw 4, 8, 16: 4.5, 9 and 18 k256 steps), C_out 10, 40 and 136, inputs of
# 1 and 2 words (rows not 16-byte aligned: 4-byte copies), stride 2 VALID,
# 64 x 128 tiles with M ending inside one, M below one m16 fragment, and
# an input 4 bytes off 16-byte alignment.
CONV_RAGGED = ((2, (32, 32), 128, 128, 1, "SAME", False),
               (2, (16, 16), 128, 256, 1, "SAME", False),
               (2, (16, 16), 256, 256, 1, "SAME", False),
               (2, (8, 8), 256, 512, 1, "SAME", False),
               (2, (8, 8), 512, 512, 1, "SAME", False),
               (2, (9, 9), 3, 136, 1, "SAME", False),
               (3, (11, 7), 33, 136, 2, "VALID", False),
               (2, (9, 9), 64, 40, 2, "VALID", False),
               (2, (5, 5), 128, 10, 1, "SAME", False),
               (80, (15, 15), 64, 40, 1, "SAME", False),
               (1, (2, 2), 256, 136, 1, "SAME", False),
               (3, (9, 9), 128, 40, 1, "SAME", True))
# K1 edges: (hw, C_in, C_out, stride, padding, nbits); the last four
# exceed a block's shared memory with the full band and 64 channels'
# weights, and take smaller channel chunks or bands: C_in 288 chunks of
# 32 in both instances; C_in 448 16 channels in 8 rows in the int32
# instance, 32 in 4 rows in the fused one; the last two fit 32 channels
# in no band, so the fused instance refuses them.
BITPLANE_RAGGED = (((9, 9), 33, 40, 2, "SAME", 1),
                   ((11, 7), 33, 10, 2, "VALID", 8),
                   ((9, 9), 3, 40, 2, "SAME", 1),
                   ((13, 5), 3, 136, 2, "VALID", 8),
                   ((7, 7), 33, 72, 1, "SAME", 8),
                   ((8, 8), 16, 40, 1, "SAME", 4),
                   ((9, 9), 32, 40, 2, "VALID", 8),
                   ((32, 32), 288, 64, 1, "SAME", 8),
                   ((16, 16), 448, 40, 1, "SAME", 8),
                   ((32, 32), 768, 40, 1, "SAME", 8),
                   ((4, 448), 128, 72, 1, "SAME", 8))
BITPLANE_FUSED_REFUSED = (((32, 32), 768, 40), ((4, 448), 128, 72))
# K2 edges, (M, C): M 1 and past a tile of 8 rows, word tails (40, 100),
# two slabs of 128 channels, the second one lane wide (132), C % 4 != 0
# (10, 33: the general path only), and grids that walk several tiles a
# warp (M 40000).
BN_SIGN_RAGGED = ((1, 40), (37, 40), (5, 10), (9, 100), (3, 33),
                  (37, 132), (40000, 128), (40000, 132))
# The shapes a C_out shard gives the kernels on BCNNSpec() and BMLPSpec()
# at |model| 2 and 4 (phase 7), at the rows of a data shard of batch 8 or
# 256: K1-fused at local C_out 64 and 32 (one packed word a pixel); K3 at
# local C_out 32-256 on each of the BCNN's five stages; K4-fused at N 512
# and 256 (the BCNN's hidden dense, K 8192 and 1024) and 2048 and 1024
# (the BMLP's, K 4096), on both of K4's routes; K2 at C 2048 and 1024 (the
# BMLP's first layer, on its aligned path).
SHARD_BITPLANE = (((32, 32), 3, 64, 1, "SAME", 8),
                  ((32, 32), 3, 32, 1, "SAME", 8))
SHARD_CONV = ((2, (32, 32), 128, 64, 1, "SAME", False),
              (2, (32, 32), 128, 32, 1, "SAME", False),
              (2, (16, 16), 128, 128, 1, "SAME", False),
              (64, (16, 16), 128, 64, 1, "SAME", False),
              (2, (16, 16), 256, 64, 1, "SAME", False),
              (2, (8, 8), 256, 256, 1, "SAME", False),
              (64, (8, 8), 256, 128, 1, "SAME", False),
              (2, (8, 8), 512, 128, 1, "SAME", False))
SHARD_GEMM = ((2, 512, 8192, False), (128, 256, 8192, False),
              (4, 256, 1024, False), (64, 512, 1024, False),
              (2, 2048, 4096, False), (128, 1024, 4096, False))
SHARD_BN_SIGN = ((2, 2048), (128, 1024), (64, 2048))


@contextlib.contextmanager
def forced_stack_tile(tile):
    """K6 launched in ``tile`` (R, C) whatever its tile rule says."""
    from repro_torch.kernels import binary_matmul as bmm
    rule = bmm.stack_tile
    bmm.stack_tile = lambda m, sms: tile
    try:
        yield
    finally:
        bmm.stack_tile = rule


def stack_launch(x, stages):
    """K6 on ``stages`` ({"w_packed", "k_true", "tau", "flip"} each)."""
    from repro_torch.kernels import binary_matmul as bmm
    return bmm.binary_dense_stack_packed(
        x, [s["w_packed"] for s in stages], [s["tau"] for s in stages],
        [s["flip"] for s in stages], k_trues=[s["k_true"] for s in stages])


def misaligned(t):
    """A contiguous copy of ``t`` whose data starts 4 bytes past a 16-byte
    boundary."""
    import torch
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    start = next(i for i in range(4)
                 if (flat.data_ptr() + 4 * i) % 16 == 4)
    out = flat[start:start + t.numel()].view(t.shape)
    out.copy_(t)
    return out


def bitplane_check(gen, dev, hw, c_in, c_out, stride, padding, nbits) -> str:
    """K1's two instances on the raw image against their plain versions on
    its bit planes, random uint8 input over all 256 values (the bits above
    nbits set, which K1 ignores), the fused one also against K2 on the
    int32 one's output; where 32 channels' weights fit no band, the fused
    one must refuse the shape (BITPLANE_FUSED_REFUSED)."""
    import torch
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_conv as bconv
    from repro_torch.kernels import fused_epilogue as fe
    from repro_torch.kernels import ref
    w = torch.rand((c_out, 3, 3, c_in), generator=gen) * 2 - 1
    bplan = bconv.make_bitplane_conv_plan(w, input_hw=hw, stride=stride,
                                          padding=padding, nbits=nbits)
    x8 = torch.randint(0, 256, (2, *hw, c_in), generator=gen,
                       dtype=torch.uint8).to(dev)
    bargs = (x8, bplan["w_packed"].to(dev), bplan["rowsum"].to(dev))
    pargs = (B.pack_bitplanes_uint8(x8, nbits), *bargs[1:])
    geom = dict(kh=3, kw=3, stride=stride, pads=bplan["pads"], c_out=c_out,
                k_true=bplan["k_true"], nbits=nbits)
    what = (f"bitplane_conv {hw} C_in={c_in} C_out={c_out} s{stride} "
            f"{padding} nbits={nbits}")
    y = bconv.bitplane_conv2d_packed(*bargs, out_hw=bplan["out_hw"], **geom)
    check_equal(what, y, ref.bitplane_conv2d_planes_ref(*pargs, **geom))
    k = 2 ** nbits * int(bplan["k_true"] ** 0.5) // 2
    tau = torch.randint(-k, k + 1, (c_out,), generator=gen).float()
    tau[:2] = y[0, 0, 0, :2].float().cpu()       # y == tau exactly
    flip = torch.where(torch.rand(c_out, generator=gen) < 0.3, -1.0, 1.0)
    tau, flip = tau.to(dev), flip.to(dev)
    fused = functools.partial(bconv.bitplane_conv2d_bn_sign_packed, *bargs,
                              tau, flip, out_hw=bplan["out_hw"], **geom)
    if (hw, c_in, c_out) in BITPLANE_FUSED_REFUSED:
        try:
            fused()
        except ValueError:
            return what + "; the fused instance refuses it"
        raise AssertionError(f"{what}: the fused instance took a shape "
                             f"whose 32 channels' weights fit no band")
    got = fused()
    check_equal(f"{what} fused", got, ref.bn_sign_pack_ref(
        ref.bitplane_conv2d_planes_ref(*pargs, **geom), tau, flip))
    check_equal(f"{what} fused against K2 on the int32 instance", got,
                fe.bn_sign_pack(y.reshape(-1, c_out), tau, flip)
                .reshape(got.shape))
    return what + ", and the fused instance"


def randomize_bn(bns, gen) -> None:
    """Random BN statistics with both signs of gamma."""
    import torch
    for bn in bns:
        c = bn["gamma"].numel()
        sign = torch.where(torch.rand(c, generator=gen) < 0.3, -1.0, 1.0)
        bn["gamma"] = (0.3 + 1.2 * torch.rand(c, generator=gen)) * sign
        bn["beta"] = torch.randn(c, generator=gen)
        bn["mean"] = torch.randn(c, generator=gen) * 3
        bn["var"] = 0.5 + 1.5 * torch.rand(c, generator=gen)


def kernel_table(calls, rates, kernel_reps, plain_reps, timer=None):
    """Per kernel: summed time, plain time, bound and library time over its
    launches in one run of a path (each call checked bit-exact on the
    way; that plain call is the warm-up of its timing).  ``timer`` times
    the kernel and the library calls: :func:`time_ms` by default,
    :func:`graph_ms` where launches too small for the host to keep up
    with would time the host."""
    import torch
    timer = timer or time_ms
    rows = {}
    for c in calls:
        got, want = c.kernel(), c.plain()
        r = rows.setdefault(c.name, {"launches_per_forward": 0, "ms": 0.0,
                                     "plain_ms": 0.0, "bytes": 0,
                                     "word_ops": 0, "flops": 0, "macs": 0,
                                     "bit_macs": 0,
                                     "library_ms": 0.0, "also_ms": 0.0,
                                     "also_name": c.also_name,
                                     "max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"],
                               check_call(c.name, c, got, want))
        del got
        r["launches_per_forward"] += 1
        r["ms"] += timer(c.kernel, kernel_reps)
        r["plain_ms"] += time_ms(c.plain, plain_reps, warmup=0)
        r["bytes"] += c.nbytes
        r["word_ops"] += c.word_ops
        r["flops"] += c.flops
        r["macs"] += c.macs
        r["bit_macs"] += c.bit_macs
        check_library("", c, want)
        del want
        if c.library is None or r["library_ms"] is None:
            r["library_ms"] = None
        else:
            r["library_ms"] += timer(c.library, kernel_reps)
        if c.also is None or r["also_ms"] is None:
            r["also_ms"] = None
        else:
            r["also_ms"] += timer(c.also, kernel_reps)
    for r in rows.values():
        bound_of(r, rates)
    return rows


def bound_of(r, rates) -> None:
    """The least time the card could take for a row's work: the larger of
    its bytes over the memory rate and its operations over their peak.
    An XNOR contraction's operations take the fastest route: XOR + POPC
    word-ops on the POPC pipe, or 2 ops per MAC at the true depth on the
    int8 tensor cores (published peak) or the 1-bit ones (peak measured
    by this run); ``ops_route`` says which.  P.V's operations (K8) take
    the faster route that holds 2e-5: fp32 on the CUDA cores, or three
    TF32 products at the card's TF32 peak (the published one, or the
    measured ``mma.sync`` rate if that is higher); on the tensor cores
    they add to the scores' tensor-core time, on the CUDA cores they
    overlap it.  ``fp32_bound_ms`` and ``tf32_bound_ms`` keep the
    bound by each P.V route, ``tf32_mma_sync_ms`` the TF32 one at the
    measured ``mma.sync`` rate.  ``int8_bound_ms`` and ``popc_bound_ms``
    keep the bounds without the 1-bit route and with the POPC route
    alone."""
    t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
    t_popc = r["word_ops"] / rates["popc"] * 1e3
    routes = {"int8 tensor cores": 2 * r["macs"] / INT8_OPS_PER_S * 1e3,
              "b1 tensor cores (measured peak)":
                  2 * r["bit_macs"] / rates["b1_ops"] * 1e3}
    t_xnor, r["ops_route"] = t_popc, "popc"
    for name, t in routes.items():
        if r["macs"] and t < t_xnor:
            t_xnor, r["ops_route"] = t, name
    t_fp32 = r["flops"] / FP32_FLOPS_PER_S * 1e3
    on_tc = r["ops_route"] != "popc"

    def tf32_route(peak):
        t_tf32 = TF32_PASSES * r["flops"] / peak * 1e3
        return t_tf32 + t_xnor if on_tc else max(t_tf32, t_xnor)

    pv = {"fp32 (P.V)": max(t_xnor, t_fp32),
          "3xTF32 tensor cores (P.V)":
              tf32_route(max(TF32_OPS_PER_S, rates["tf32_ops"]))}
    r["fp32_bound_ms"] = max(t_bytes, pv["fp32 (P.V)"])
    r["tf32_bound_ms"] = max(t_bytes, pv["3xTF32 tensor cores (P.V)"])
    # The same at the mma.sync rate K8 issues at: a diagnostic, not a bound.
    r["tf32_mma_sync_ms"] = max(t_bytes, tf32_route(rates["tf32_ops"]))
    r["int8_bound_ms"] = max(t_bytes, min(t_popc, routes["int8 tensor cores"]),
                             t_fp32)
    if not r["word_ops"]:
        r["ops_route"] = "none"
    t_ops = t_xnor
    if r["flops"]:
        name = min(pv, key=pv.get)
        t_ops = pv[name]
        r["ops_route"] = f"{name} + scores by {r['ops_route']}"
    r["bound_ms"] = max(t_bytes, t_ops)
    r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    r["popc_bound_ms"] = max(t_bytes, t_popc, t_fp32)


def log_table(what, rows) -> None:
    for k, r in rows.items():
        lib = ("null" if r["library_ms"] is None
               else f"{r['library_ms']:.5g}")
        also = ("" if not r["also_ms"] else
                f"; {r['also_name']} {r['also_ms']:.5g} ms")
        pv = ("" if not r["flops"] else
              f"; P.V by fp32 {r['fp32_bound_ms']:.5g} ms, by 3xTF32 "
              f"{r['tf32_bound_ms']:.5g} ms, by 3xTF32 at the measured "
              f"mma.sync rate {r['tf32_mma_sync_ms']:.5g} ms")
        log(f"time {what} {k}: x{r['launches_per_forward']} per run, "
            f"kernel {r['ms']:.5g} ms ({r['bytes'] / r['ms'] * 1e3:.5g} "
            f"bytes/s, {r['bound_ms'] / r['ms']:.4g} of its bound), plain "
            f"{r['plain_ms']:.5g} ms, "
            f"bound {r['bound_ms']:.5g} ms ({r['bound_by']}; operations by "
            f"{r['ops_route']}{pv}; without the 1-bit route "
            f"{r['int8_bound_ms']:.5g} ms, the POPC route alone "
            f"{r['popc_bound_ms']:.5g} ms), library {lib} ms{also}")


class Driver:
    """Runs each path with the launch counts set to 0 just before it and
    read just after, checks them and keeps their sum per kernel."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.totals = dict.fromkeys(ops.KERNELS, 0)

    def run(self, what, fn, expect):
        import torch
        self.ops.reset_launch_counts()
        out = fn()
        torch.cuda.synchronize()
        counts = self.ops.launch_counts()
        launched = {k: v for k, v in counts.items() if v}
        if launched != expect:
            raise AssertionError(f"{what}: launches {launched}, expected "
                                 f"{expect}")
        for k, v in counts.items():
            self.totals[k] += v
        return out


def network_path(drv, what, packed, inputs, forward_int, expect):
    """Serve a packed network through ``make_packed_forward`` in both
    dense-stack modes at every batch; check the launches, and the int32
    pre-BN outputs and logits against the plain path."""
    import torch
    from repro_torch.core import binary_layers as L
    from repro_torch.models import cnn
    dev = torch.device("cuda", 0)
    logits = {}
    for mode in MODES:
        fwd = cnn.make_packed_forward(packed, dense_stack=mode)
        for b in BATCHES:
            logits[mode, b] = drv.run(f"{what} {mode} B={b}",
                                      lambda: fwd(inputs[b]), expect[mode])
    for b in BATCHES:
        xd = inputs[b].to(dev)
        want_int = forward_int(packed, xd, backend="torch")
        want = L.apply_batchnorm(packed["bn_out"], want_int)
        for mode in MODES:
            check_equal(f"{what} {mode} int32 B={b}",
                        forward_int(packed, xd, backend="cuda",
                                    dense_stack=mode), want_int)
            check_equal(f"{what} {mode} logits B={b}", logits[mode, b], want)
            if logits[mode, b].shape != want.shape or \
                    not torch.isfinite(logits[mode, b]).all():
                raise AssertionError(f"{what} B={b}: logits not finite or "
                                     f"of the wrong shape")
    log(f"main path {what}: batches {BATCHES}, launches per forward "
        f"{expect}; int32 pre-BN outputs and logits equal the plain path at "
        f"every batch in both modes")
    return logits


def stage0_path(drv, packed, inputs, dev) -> None:
    """The BCNN's first stage through the layer entry points on the route
    of a stage that pools (without the pool): ``ops.bitplane_conv2d_packed``
    (K1's int32 instance), then ``ops.bn_sign_pack`` (K2), at batch 1 and
    256.  The int32 output against the plain path; the words against the
    plain path and against ``ops.bitplane_conv2d_bn_sign_packed`` (K1's
    fused instance, outside the counted run)."""
    from repro_torch.kernels import ops
    pc, fc = packed["convs"][0], packed["folded_conv"][0]
    for b in (1, 256):
        x = inputs[b].to(dev)

        def run():
            y = ops.bitplane_conv2d_packed(pc, x)
            return y, ops.bn_sign_pack(y, fc["tau"], fc["flip"])

        y, words = drv.run(f"bitplane_conv2d + bn_sign_pack B={b}", run,
                           {"bitplane_conv": 1, "bn_sign_pack": 1})
        check_equal(f"bitplane_conv2d B={b}", y,
                    ops.bitplane_conv2d_packed(pc, x, backend="torch"))
        want = ops.bitplane_conv2d_bn_sign_packed(pc, fc, x, backend="torch")
        check_equal(f"bn_sign_pack after bitplane_conv2d B={b}", words, want)
        check_equal(f"bitplane_conv2d_bn_sign_packed B={b} against K2(K1)",
                    ops.bitplane_conv2d_bn_sign_packed(pc, fc, x), words)


def check_float_reference(what, logits, ref_logits) -> None:
    import torch
    for mode in MODES:
        if not torch.allclose(logits[mode, 8], ref_logits, rtol=1e-4,
                              atol=1e-3):
            raise AssertionError(f"{what} {mode} batch 8: packed logits "
                                 f"differ from the float reference beyond "
                                 f"rtol 1e-4, atol 1e-3")
    diff = (logits["auto", 8] - ref_logits).abs().max().item()
    log(f"main path {what}: batch-8 logits match the float reference "
        f"(max |diff| {diff:.3g})")


def time_forwards(what, packed, inputs) -> None:
    import torch
    from repro_torch.models import cnn
    dev = torch.device("cuda", 0)
    for mode in MODES:
        fwd = cnn.make_packed_forward(packed, dense_stack=mode)
        for b in BATCHES:
            x = inputs[b].to(dev)
            reps = 20 if b < 256 else 10
            ms_host = time_ms(lambda: fwd(inputs[b]), reps)
            ms = time_ms(lambda: fwd(x), reps)
            line = (f"forward {what} {mode} B={b}: {ms_host:.5g} ms per batch "
                    f"from host memory ({b / ms_host * 1e3:.6g} per s), "
                    f"{ms:.5g} ms with the batch already on the card "
                    f"({b / ms * 1e3:.6g} per s)")
            if b in (1, 256):   # the card's own time, without the host's
                line += (f"; as a CUDA graph "
                         f"{graph_ms(lambda: fwd(x), reps=5):.5g} ms")
            log(line)


SERVE_MAX_BATCH = 256
SERVE_DEADLINE_S = 0.005
# (traffic, requests): a burst past max_batch, a ragged tail that flushes
# on its deadline, then requests one at a time (deadline 0)
SERVE_TRAFFIC = (("burst", 300), ("tail", 13), ("singles", 20))
# the same traffic three times: the first meets cold buckets, the second
# gives the end-to-end numbers, the third runs traced (the flush split by
# the server's spans; its difference from the second is the tracing cost)
SERVE_PASSES = ("cold", "warm", "traced")


class FlushLaunches:
    """A server ``flush_hook`` that keeps the launch counts of each
    dispatch: the ``ops.launch_counts()`` delta across its forward."""

    def __init__(self):
        from repro_torch.kernels import ops
        self.ops = ops
        self.deltas = []

    def __call__(self, eng, buf, reqs, default):
        before = self.ops.launch_counts()
        out = default()
        self.deltas.append({k: v - before[k]
                            for k, v in self.ops.launch_counts().items()
                            if v != before[k]})
        return out


def serve_traffic(srv, xs, traffic_mix=SERVE_TRAFFIC) -> dict:
    """Drive ``traffic_mix`` through ``srv`` on the wall clock: {traffic:
    (completed requests in flush order, wall s from the first submit to
    the last completion)}."""
    out, i = {}, 0
    for traffic, n in traffic_mix:
        t0 = time.perf_counter()
        done = []
        if traffic == "singles":
            for x in xs[i:i + n]:
                srv.submit(x, deadline=0.0)
                done += srv.step()
        else:
            for x in xs[i:i + n]:
                srv.submit(x)
            done += srv.step()
            while srv.pending():
                time.sleep(SERVE_DEADLINE_S / 20)
                done += srv.step()
        out[traffic] = (done, time.perf_counter() - t0)
        i += n
    return out


def host_forward_ms(fwd, x, reps: int = 5, idle_s: float = 0.0) -> float:
    """Median wall ms of the direct forward from host memory to a host
    result, the work a flush does without the server's own; back to back,
    or each call after ``idle_s`` of host sleep, as a flush that waited
    for its deadline comes."""
    fwd(x).cpu()
    times = []
    for _ in range(reps):
        time.sleep(idle_s)
        t0 = time.perf_counter()
        fwd(x).cpu()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[reps // 2]


def check_served(what, srv, hook, results, direct, at_bucket_fwd=None):
    """Every flush of the run against the direct forward: its rows equal
    (the forward on the flush's unpadded rows), its launches equal the
    direct forward's (or ``at_bucket_fwd``'s) at its bucket, and on the
    card not empty.  Returns the run's flush records and {bucket: launch
    set}."""
    import torch
    from repro_torch.kernels import ops
    done = [r for reqs, _ in results.values() for r in reqs]
    flushes = srv.flushes[-len(hook.deltas):]
    if len(flushes) != len(hook.deltas) or \
            sum(f.batch for f in flushes) != len(done) or \
            any(r.status != "ok" for r in done):
        raise AssertionError(f"{what}: {len(done)} requests in "
                             f"{len(flushes)} flushes, {len(hook.deltas)} "
                             f"dispatches, not every one served ok")
    at_bucket, i = {}, 0
    for f, delta in zip(flushes, hook.deltas):
        cohort = done[i:i + f.batch]
        i += f.batch
        x = torch.stack([r.x for r in cohort])
        check_equal(f"{what} flush of {f.batch} (bucket {f.bucket}) rows",
                    torch.stack([r.result for r in cohort]),
                    direct(x).cpu())
        if f.bucket not in at_bucket:
            ops.reset_launch_counts()
            (at_bucket_fwd or direct)(torch.zeros((f.bucket, *x.shape[1:]),
                                                  dtype=x.dtype))
            at_bucket[f.bucket] = {k: v for k, v in
                                   ops.launch_counts().items() if v}
        if delta != at_bucket[f.bucket] or \
                (srv.device.type == "cuda" and not delta):
            raise AssertionError(f"{what} flush of {f.batch} (bucket "
                                 f"{f.bucket}): launches {delta}, the "
                                 f"direct forward's {at_bucket[f.bucket]}")
        if not bool(torch.isfinite(torch.stack(
                [r.result for r in cohort])).all()):
            raise AssertionError(f"{what}: served logits not finite")
    return flushes, at_bucket


def log_served(what, flushes, tracer, results, at_bucket, direct) -> None:
    """Per traffic: requests/s and latency p50/p99; per kind of flush:
    batch, bucket, route, launches and median wall, split by the server's
    spans, beside the direct forward's at that batch and bucket."""
    from repro_torch.train import serve as sv
    for traffic, (done, wall) in results.items():
        lats = sorted(r.latency for r in done)
        log(f"serve {what} {traffic}: {len(done)} requests in "
            f"{wall * 1e3:.5g} ms ({len(done) / wall:.6g} requests/s); "
            f"latency p50 {sv.latency_percentile(lats, 0.5) * 1e3:.5g} ms, "
            f"p99 {sv.latency_percentile(lats, 0.99) * 1e3:.5g} ms")
    # the server's spans, one of each per flush in flush order, where the
    # pass ran traced
    spans = {name: [e["dur"] / 1e3 for e in tracer.events
                    if e["name"] == name]
             for name in ("serve.pack", "serve.dispatch", "serve.compute")}
    groups = {}
    for i, f in enumerate(flushes):
        groups.setdefault((f.batch, f.bucket, f.route), []).append(
            (f.wall_s * 1e3, *(v[i] if v else 0.0 for v in spans.values())))

    def median(vals):
        return sorted(vals)[len(vals) // 2]

    example = results["burst"][0][0].x
    per_bucket = {}
    for (batch, bucket, route), rows in groups.items():
        per_bucket[bucket] = per_bucket.get(bucket, 0) + len(rows)
        wall, pack, dispatch, compute = (median(c) for c in zip(*rows))
        line = (f"serve {what} flush batch={batch} bucket={bucket} "
                f"route={route} launches {at_bucket[bucket]}: {len(rows)} "
                f"flush(es), wall median {wall:.5g} ms")
        if spans["serve.pack"]:
            line += (f" (staging {pack:.5g}, dispatch {dispatch:.5g}, host "
                     f"copy {compute:.5g})")
        line += "; direct forward from host memory"
        for b in sorted({batch, bucket}):
            x = example.expand(b, *example.shape).contiguous()
            line += (f" at batch {b} {host_forward_ms(direct, x):.5g} ms "
                     f"back to back, "
                     f"{host_forward_ms(direct, x, idle_s=SERVE_DEADLINE_S):.5g}"
                     f" ms after {SERVE_DEADLINE_S * 1e3:g} ms idle")
        log(line)
    log(f"serve {what}: flushes per bucket {per_bucket}")


def serve_network(kind, params, spec, gen, dev) -> None:
    """Phase 6 for one network: one server on the card with both
    dense_stack modes registered from params and spec, SERVE_TRAFFIC
    through each, every flush checked (``check_served``)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    from repro_torch.train import serve as sv
    srv = sv.PackedInferenceServer(max_batch=SERVE_MAX_BATCH,
                                   default_deadline=SERVE_DEADLINE_S,
                                   device=dev)
    t0 = time.perf_counter()
    for mode in MODES:
        srv.register(mode, params, spec, kind=kind, dense_stack=mode)
    pack_s = time.perf_counter() - t0
    srv.register(MODES[0], params, spec, kind=kind, dense_stack=MODES[0])
    if (srv.cache.misses, srv.cache.hits) != (len(MODES), 1):
        raise AssertionError(f"serve {kind}: cache misses/hits "
                             f"{srv.cache.misses}/{srv.cache.hits}")
    eng = srv.engine()
    n = sum(k for _, k in SERVE_TRAFFIC)
    xs = torch.randint(0, 256, (len(SERVE_PASSES), n, *eng.example_shape),
                       generator=gen, dtype=torch.uint8)
    log(f"serve {kind}: {len(MODES)} modes packed on {srv.device} in "
        f"{pack_s:.2f} s, a re-register hit the cache; buckets "
        f"{eng.buckets}")
    for mode in MODES:
        srv.use(mode)
        direct = cnn.make_packed_forward(srv.engine().packed,
                                         dense_stack=mode)
        for p, label in enumerate(SERVE_PASSES):
            what = f"{kind} {mode} {label}"
            hook = FlushLaunches()
            srv.flush_hook = hook
            srv.telemetry.tracer.clear()
            if label == "traced":
                srv.telemetry.enable_tracing()
            ops.reset_launch_counts()
            results = serve_traffic(srv, xs[p])
            srv.telemetry.tracer.disable()
            torch.cuda.synchronize()
            total = ops.launch_counts()
            srv.flush_hook = None
            summed = {}
            for d in hook.deltas:
                for k, v in d.items():
                    summed[k] = summed.get(k, 0) + v
            if {k: v for k, v in total.items() if v} != summed:
                raise AssertionError(f"serve {what}: launches {total} "
                                     f"beyond the flushes' {summed}")
            flushes, at_bucket = check_served(f"serve {what}", srv, hook,
                                              results, direct)
            log(f"serve {what}: {n} requests in {len(hook.deltas)} "
                f"flushes, launches in all {summed}; every served row "
                f"equals the direct forward on its flush's rows, every "
                f"flush's launches the direct forward's at its bucket")
            log_served(what, flushes, srv.telemetry.tracer, results,
                       at_bucket, direct)
    log(f"serve {kind}: staging pool {srv.pool.allocations} buffers")


def serve_lm(spec, packed, gen, dev) -> None:
    """Phase 6 for the LM: the packed tree of phase 4 registered as it
    is, 8 prompts of LM_SERVE's 16 tokens, ids up to the vocab's last,
    in one flush; rows equal to the direct forward, launches its set."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    from repro_torch.train import serve as sv
    b, s = LM_SERVE[1]
    srv = sv.PackedInferenceServer(max_batch=b, device=dev)
    srv.register("lm", packed=packed)
    eng = srv.engine()
    tokens = torch.randint(0, spec.vocab_size, (b, s), generator=gen)
    if eng.input_dtype != torch.int32 or int(tokens.max()) < 256:
        raise AssertionError(f"serve lm: input dtype {eng.input_dtype}, "
                             f"largest id {int(tokens.max())}")
    direct = cnn.make_packed_forward(packed)
    hook = FlushLaunches()
    srv.flush_hook = hook
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    rids = [srv.submit(t) for t in tokens]
    done = srv.flush()
    wall = time.perf_counter() - t0
    torch.cuda.synchronize()
    srv.flush_hook = None
    results = {"burst": (done, wall)}
    check_served(f"serve lm {spec.name}", srv, hook, results, direct)
    if [r.rid for r in done] != rids:
        raise AssertionError("serve lm: requests out of order")
    f = srv.flushes[-1]
    lats = sorted(r.latency for r in done)
    log(f"serve lm {spec.name}: {b} prompts of {s} tokens (ids up to "
        f"{int(tokens.max())}, staged as {eng.input_dtype}) in 1 flush, "
        f"batch={f.batch} bucket={f.bucket} route={f.route} launches "
        f"{hook.deltas[0]}; rows equal the direct forward's; {wall * 1e3:.5g}"
        f" ms ({b / wall:.6g} prompts/s); latency p50 "
        f"{sv.latency_percentile(lats, 0.5) * 1e3:.5g} ms, p99 "
        f"{sv.latency_percentile(lats, 0.99) * 1e3:.5g} ms; direct forward "
        f"at batch {b} from host memory "
        f"{host_forward_ms(direct, tokens, reps=3):.5g} ms")


# Phase 7: the meshes, every position on the one card (make_host_mesh
# puts the positions round-robin over the visible cards), and the batches
# of the sharded forwards
SHARD_MESHES = ((1, 1), (4, 1), (2, 2), (1, 4), (2, 4))
SHARD_BATCHES = (8, 256)
MESH_SERVE = (2, 2)
# the mesh server's traffic: phase 6's burst past max_batch and its singles
MESH_TRAFFIC = (("burst", 300), ("singles", 20))


def sharded_expect(expect, plan, n_hidden, positions):
    """Launches per sharded forward as the shard plan predicts them: each
    position runs the unsharded forward's kernels on its slice, so every
    count is multiplied by the positions, but a hidden dense stack with a
    C_out-sharded layer runs K4-fused per layer in every mode."""
    out = {k: v * positions for k, v in expect.items()}
    hidden = plan["dense"][:-1] if "dense" in plan else plan["layer"][1:-1]
    if any(s > 1 for s in hidden):
        out.pop("dense_stack", None)
        out["xnor_gemm_bn_sign"] = n_hidden * positions
    return out


def gather_ms(packed, plan, mesh, batch, dev) -> float:
    """CUDA-event ms of one forward's gathers alone: each sharded seam's
    packed words, on every position, concatenated as the forward does."""
    import torch
    from repro_torch.distributed import verify_sharded as vs
    from repro_torch.models import cnn
    model = mesh.shape["model"]
    rows = batch // (mesh.size // model)
    peers = [[i - i % model + j for j in range(model)]
             for i in range(mesh.size)]
    seams = []
    for shape in vs.seam_shapes(packed, plan):
        local = (*shape[:-1], shape[-1] // model)
        seams.append([torch.zeros((rows, *local), dtype=torch.int32,
                                  device=dev) for _ in range(mesh.size)])
    if not seams:
        return 0.0
    return time_ms(lambda: [cnn._gather_packed(hs, peers) for hs in seams],
                   reps=20)


def sharded_path(drv, what, packed, inputs, forward_int, expect, n_hidden,
                 logits, dev) -> None:
    """Phase 7's sharded forwards of one network: every mesh of
    SHARD_MESHES, both dense-stack modes, batches SHARD_BATCHES, each run
    held to its plan's launches and gathers and to the unsharded forward
    (``torch.equal``); then the times beside the unsharded forward's."""
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import verify_sharded as vs
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import cnn
    for shape in SHARD_MESHES:
        mesh = make_host_mesh(*shape)
        for mode in MODES:
            fwd = sh.make_sharded_forward(packed, mesh, dense_stack=mode)
            want_launches = sharded_expect(expect[mode], fwd.shard_plan,
                                           n_hidden, mesh.size)
            planned = {}
            for b in SHARD_BATCHES:
                label = f"{what} sharded {shape} {mode} B={b}"
                g0 = vs.gather_counts()
                got_int = drv.run(label, lambda: fwd.forward_int(inputs[b]),
                                  want_launches)
                g1 = vs.gather_counts()
                gathered = (g1[0] - g0[0], g1[1] - g0[1])
                planned[b] = vs.expected_gathers(packed, fwd.shard_plan,
                                                 mesh, b)
                if gathered != planned[b] or \
                        (shape[1] == 1 and any(gathered)):
                    raise AssertionError(f"{label}: gathers {gathered}, the "
                                         f"plan's {planned[b]}")
                check_equal(f"{label} int32", got_int, forward_int(
                    packed, inputs[b].to(dev), dense_stack=mode))
                check_equal(f"{label} logits", fwd(inputs[b]),
                            logits[mode, b])
            log(f"sharded {what} {shape} {mode}: plan {fwd.shard_plan}, "
                f"launches per forward {want_launches}, (gathers, bytes) "
                f"per forward by batch {planned}; int32 pre-BN outputs and "
                f"logits equal make_packed_forward's at every batch")
    for mode in MODES:
        direct = cnn.make_packed_forward(packed, dense_stack=mode)
        for b in SHARD_BATCHES:
            xd = inputs[b].to(dev)
            base = time_ms(lambda: direct(xd), reps=20)
            line = (f"sharded {what} {mode} B={b}: unsharded forward "
                    f"{base:.5g} ms (batch on the card)")
            for shape in SHARD_MESHES:
                mesh = make_host_mesh(*shape)
                fwd = sh.make_sharded_forward(packed, mesh, dense_stack=mode)
                ms = time_ms(lambda: fwd(xd), reps=20)
                gms = gather_ms(packed, fwd.shard_plan, mesh, b, dev)
                nbytes = vs.expected_gathers(packed, fwd.shard_plan, mesh,
                                             b)[1]
                line += (f"; {shape} {ms:.5g} ms ({ms / base:.4g}x), "
                         f"gathers {gms:.5g} ms for {nbytes} bytes")
            log(line)


def serve_mesh(kind, params, spec, gen, dev) -> None:
    """Phase 7's server: ``PackedInferenceServer`` on the card with a
    MESH_SERVE mesh behind its queue, MESH_TRAFFIC through it; every row
    held to the unsharded forward, each flush's launches to the sharded
    forward's at its bucket."""
    import torch
    from repro_torch.distributed import sharding as sh
    from repro_torch.kernels import ops
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import cnn
    from repro_torch.train import serve as sv
    mesh = make_host_mesh(*MESH_SERVE)
    srv = sv.PackedInferenceServer(max_batch=SERVE_MAX_BATCH,
                                   default_deadline=SERVE_DEADLINE_S,
                                   device=dev)
    srv.register(kind, params, spec, kind=kind, mesh=mesh)
    eng = srv.engine()
    direct = cnn.make_packed_forward(eng.packed)
    sharded = sh.make_sharded_forward(eng.packed, mesh)
    n = sum(k for _, k in MESH_TRAFFIC)
    xs = torch.randint(0, 256, (2, n, *eng.example_shape), generator=gen,
                       dtype=torch.uint8)
    for p, label in enumerate(("cold", "warm")):
        what = f"serve {kind} mesh {MESH_SERVE} {label}"
        hook = FlushLaunches()
        srv.flush_hook = hook
        ops.reset_launch_counts()
        results = serve_traffic(srv, xs[p], MESH_TRAFFIC)
        torch.cuda.synchronize()
        srv.flush_hook = None
        flushes, at_bucket = check_served(what, srv, hook, results, direct,
                                          at_bucket_fwd=sharded)
        log(f"{what}: {n} requests in {len(flushes)} flushes, buckets "
            f"{eng.buckets} (batch_multiple {eng.batch_multiple}); every "
            f"row equals the unsharded forward, every flush's launches the "
            f"sharded forward's at its bucket {at_bucket}")
    for traffic, (done, wall) in results.items():
        lats = sorted(r.latency for r in done)
        log(f"{what} {traffic}: {len(done)} requests in {wall * 1e3:.5g} ms "
            f"({len(done) / wall:.6g} requests/s); latency p50 "
            f"{sv.latency_percentile(lats, 0.5) * 1e3:.5g} ms, p99 "
            f"{sv.latency_percentile(lats, 0.99) * 1e3:.5g} ms")
    groups = {}
    for f in flushes:
        groups.setdefault((f.batch, f.bucket), []).append(f.wall_s * 1e3)
    example = results["burst"][0][0].x
    for (batch, bucket), walls in sorted(groups.items()):
        x = example.expand(bucket, *example.shape).contiguous()
        log(f"{what} flush batch={batch} bucket={bucket}: {len(walls)} "
            f"flush(es), wall median {sorted(walls)[len(walls) // 2]:.5g} "
            f"ms; the sharded forward from host memory at batch {bucket} "
            f"{host_forward_ms(sharded, x):.5g} ms, the unsharded "
            f"{host_forward_ms(direct, x):.5g} ms")


def chaos_drill(params, spec, dev) -> None:
    """Phase 7's chaos drill (``launch.serve.run_chaos``) on the full-width
    network: a (4, 2) mesh of eight positions on the card degrades 8 -> 4
    -> 2, restoring from a packed checkpoint; every invariant must hold."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.launch import serve as cli
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    out = cli.run_chaos(params, spec, "bcnn", device=dev)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {k: v for k, v in ops.launch_counts().items() if v}
    bad = [name for name, ok in out["invariants"].items() if not ok]
    if bad or not launched:
        raise AssertionError(f"chaos drill: invariants failed {bad}, "
                             f"launches {launched}")
    for p in out["phases"]:
        log(f"chaos {p['phase']}: {p['statuses']}")
    log(f"chaos drill bcnn: every invariant held "
        f"({sorted(out['invariants'])}); tally {out['tally']} of "
        f"{out['submitted']} submitted, {out['lost']} lost; launches "
        f"{launched}; {wall:.3f} s on the host clock")
    for e in out["events"]:
        log(f"chaos degrade to {e['survivors']} positions: mesh "
            f"{tuple(e['mesh_shape'])}, restored from {e['restored_from']}, "
            f"{e['requeued']} requeued; remesh + restore + rebuild "
            f"{e['wall_s'] * 1e3:.5g} ms")


def checkpoint_times(what, packed, dev) -> None:
    """Packed-checkpoint save (card -> disk) and restore (disk -> card, and
    onto a MESH_SERVE mesh) of one network, in ms and MB, in a temporary
    directory; the restored tree equal to the saved one."""
    import tempfile
    import torch
    from repro_torch import checkpoint as ck
    from repro_torch.distributed import sharding as sh
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.tree import leaves_with_path
    mesh = make_host_mesh(*MESH_SERVE)
    with tempfile.TemporaryDirectory(prefix="chip_ckpt_") as d:
        times = {"save": [], "restore": [], "restore onto a mesh": []}
        for step in range(3):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            path = ck.save_packed_checkpoint(d, step, packed)
            times["save"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            back, _ = ck.load_packed_checkpoint(d, step, packed)
            torch.cuda.synchronize()
            times["restore"].append(time.perf_counter() - t0)
            t0 = time.perf_counter()
            placed, _ = ck.load_packed_checkpoint(d, step, packed, mesh=mesh)
            torch.cuda.synchronize()
            times["restore onto a mesh"].append(time.perf_counter() - t0)
        for (pa, a), (_, b) in zip(leaves_with_path(back),
                                   leaves_with_path(packed)):
            if isinstance(b, torch.Tensor):
                check_equal(f"checkpoint {what} {pa}", a, b)
        if not isinstance(placed["bn_out"]["gamma"], sh.Placed):
            raise AssertionError(f"checkpoint {what}: not placed")
        mb = os.path.getsize(os.path.join(path, "arrays.npz")) / 1e6
    log(f"checkpoint {what}: {mb:.4g} MB; " + "; ".join(
        f"{k} {sorted(v)[1] * 1e3:.5g} ms (median of 3)"
        for k, v in times.items()) + "; restored words equal the saved ones")


# Phase 8: the model zoo (``models/model.py``) on the card.  gemma2-9b at
# its published width and depth in binary mode, served through
# ``BatchedServer`` (``examples/serve_binary_lm.py``'s mix: prompts of
# 8-10 ids, 8-9 new tokens each, 4 slots) and prefilled through
# ``make_prefill_step`` on both sides of the AUTO rule's 256 rows;
# mamba2-1.3b and whisper-base at their published widths; every reduced
# registry config in each mode; the packed LM on every reduced config.
# Each run is held to the same run on the plain route (``backend
# 'torch'``: the plain versions of K5 and K4 on the same card).
ZOO_LM = "gemma2-9b"
ZOO_SLOTS, ZOO_MAX_LEN, ZOO_REQUESTS = 4, 64, 8
ZOO_PROMPT_LEN, ZOO_MAX_NEW = 8, 8
ZOO_PREFILL = ((8, 16), (1, 512))
ZOO_LONG = 4096            # gemma2-9b's window: one decode step at its end
ZOO_SSM = ("mamba2-1.3b", (2, 512), 8)         # prefill (B, S), decode steps
ZOO_AUDIO = ("whisper-base", 2, 1500, 8)       # batch, frames, decode steps
ZOO_REDUCED = dict(batch=2, seq=12, max_len=16, steps=3)


def zoo_plain(cfg):
    """The same config on the plain route: the packed linears' K5 and K4
    run their plain PyTorch versions (``quant.backend = 'torch'``)."""
    import dataclasses
    return dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, backend="torch"))


def zoo_strategy(cfg, strategy):
    """The same config with every packed linear on one ``GemmStrategy``
    whatever its rows (``AUTO`` picks by the rows)."""
    import dataclasses
    return dataclasses.replace(cfg, quant=dataclasses.replace(
        cfg.quant, strategy=strategy))


def zoo_decode_pair(drv, what, packed, cfg, tok, cache, idx, expect):
    """One decode step on the kernel route and on the plain route, each on
    its own copy of ``cache`` (a step writes into the cache it is given);
    logits and caches held equal.  Returns the plain route's (logits,
    cache); ``cache`` itself is that route's."""
    import torch
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map
    kc = tree_map(torch.clone, cache)
    got = drv.run(what, lambda: M.decode_step(packed, cfg, tok, kc, idx),
                  expect)
    want = M.decode_step(packed, zoo_plain(cfg), tok, cache, idx)
    check_tree_equal(what, got, want)
    return want


def check_tree_equal(what, got, want) -> None:
    """Every leaf of two trees of tensors (or None) equal."""
    from repro_torch.tree import leaves_with_path
    gl, wl = list(leaves_with_path(got)), list(leaves_with_path(want))
    if [p for p, _ in gl] != [p for p, _ in wl]:
        raise AssertionError(f"{what}: trees differ in layout")
    for (path, g), (_, w) in zip(gl, wl):
        check_equal(f"{what} {path}", g, w)


def zoo_step_launches(n):
    """The launches of a call through ``n`` packed linears on the XNOR
    route: K5 and K4 once each per linear, nothing else."""
    return {"bitpack": n, "xnor_gemm": n} if n else {}


def _ffn_linears(cfg) -> int:
    """Packed linears of the FFN (or MoE) sub-block after a layer: the
    dense FFN's (gate,) up and down; the MoE's router and its shared
    expert's FFN (the experts' weights stay unpacked, as the reference's
    ``maybe_pack_tree`` leaves them)."""
    from repro_torch.models import ffn
    n_ffn = 3 if ffn.is_gated(cfg.ffn_type) else 2
    if cfg.moe is not None:
        return 1 + (n_ffn if cfg.moe.shared_experts else 0)
    return n_ffn if cfg.d_ff > 0 else 0


def packed_linears(cfg) -> int:
    """Packed linears one call of the decoder goes through in ``binary``
    mode, each called once whatever the rows: per attention layer q, k, v
    and o, per RG-LRU block its five, per Mamba-2 block in_proj and
    out_proj, the FFN sub-block's (:func:`_ffn_linears`); the whisper
    decoder's self-attention, cross q and o (its cross K/V come from
    ``precompute_cross_kv``); the untied head."""
    per_kind = {"global": 4, "local": 4, "rec": 5, "ssm": 2}
    n = 0
    for i in range(cfg.num_layers):
        kind = cfg.layer_kind(i)
        n += per_kind[kind] + (0 if kind == "ssm" else _ffn_linears(cfg))
        if cfg.encoder_layers:
            n += 2
    return n + (0 if cfg.tie_embeddings else 1)


def zoo_linear_inputs(fn):
    """Run ``fn`` recording (x, w_packed) of every packed linear call."""
    from repro_torch.models import linear as LN
    seen = []
    orig = LN._apply_packed

    def record(params, x, quant, dtype):
        seen.append((x, params["w_packed"]))
        return orig(params, x, quant, dtype)

    LN._apply_packed = record
    try:
        fn()
    finally:
        LN._apply_packed = orig
    return seen


def zoo_kernel_rows(what, seen, rates):
    """K5 and K4 at the shapes the path gave the first layer's packed
    linears (the inputs recorded), beside K4's library calls, each timed
    as 20 calls replayed from one CUDA graph: the card's time, not the
    host's launch time."""
    from repro_torch.core import binarize as B
    calls = []
    for x, w in seen:
        k = x.shape[-1]
        x2 = x.reshape(-1, k).float().contiguous()
        calls.append(bitpack_call(x2))
        calls.append(gemm_call(B.pack_bits(x2), w, k))
    rows = kernel_table(calls, rates, kernel_reps=20, plain_reps=2,
                        timer=graph_ms)
    log_table(what, rows)
    return rows


def zoo_full_lm(drv, dev, rates) -> dict:
    """Phase 8a: gemma2-9b at full width and depth in binary mode."""
    import torch
    from repro_torch import configs
    from repro_torch.core import quantize as Q
    from repro_torch.models import linear as LN
    from repro_torch.models import model as M
    from repro_torch.train import serve as SV
    from repro_torch.tree import leaves_with_path, tree_bytes, tree_map
    cfg = configs.get_config(ZOO_LM, quant="binary")
    plain = zoo_plain(cfg)
    t0 = time.perf_counter()
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    n_float = sum(t.numel() for _, t in leaves_with_path(params))
    float_bytes = tree_bytes(params["stack"])
    packed = LN.maybe_pack_tree(params, cfg.quant)
    del params
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    log(f"zoo {ZOO_LM} binary: {cfg.num_layers} layers, d_model "
        f"{cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
        f"{cfg.head_dim}, {cfg.ffn_type} d_ff {cfg.d_ff}, vocab "
        f"{cfg.vocab_size}, {cfg.dtype}: {n_float} float32 parameters made "
        f"on the card from seed 0 and packed by maybe_pack_tree in "
        f"{time.perf_counter() - t0:.1f} s; the stack {float_bytes} bytes "
        f"float32 -> {tree_bytes(packed['stack'])} bytes packed "
        f"({float_bytes / tree_bytes(packed['stack']):.4g}x); embedding "
        f"{tree_bytes(packed['embed'])} bytes float32 (tied head)")
    per_step = packed_linears(cfg)
    if per_step != 7 * cfg.num_layers:
        raise AssertionError(f"{per_step} packed linears a step")
    expect = zoo_step_launches(per_step)
    out = {"cfg": cfg}
    gen = torch.Generator().manual_seed(1)
    for b, s in ZOO_PREFILL:
        toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen
                             ).to(dev)
        max_len = max(ZOO_MAX_LEN, s)
        step = SV.make_prefill_step(cfg, max_len)
        pstep = SV.make_prefill_step(plain, max_len)
        xnor = b * s <= Q.XNOR_MAX_ROWS
        got, gcache = drv.run(f"zoo {ZOO_LM} prefill ({b}, {s})",
                              lambda: step(packed, {"tokens": toks}),
                              expect if xnor else {})
        want, wcache = pstep(packed, {"tokens": toks})
        check_equal(f"zoo {ZOO_LM} prefill ({b}, {s}) logits", got, want)
        check_tree_equal(f"zoo {ZOO_LM} prefill ({b}, {s}) cache", gcache,
                         wcache)
        if got.shape != (b, 1, cfg.vocab_size) or \
                not bool(torch.isfinite(got.float()).all()):
            raise AssertionError(f"zoo prefill ({b}, {s}): logits")
        del gcache, wcache
        ms = time_ms(lambda: step(packed, {"tokens": toks}), reps=3)
        plain_ms = time_ms(lambda: pstep(packed, {"tokens": toks}), reps=1)
        # the strategy AUTO does not take at these rows, on the same input
        other = Q.GemmStrategy.MXU_UNPACK if xnor else Q.GemmStrategy.VPU_XNOR
        ostep = SV.make_prefill_step(zoo_strategy(cfg, other), max_len)
        ogot, ocache = drv.run(
            f"zoo {ZOO_LM} prefill ({b}, {s}) on {other.value}",
            lambda: ostep(packed, {"tokens": toks}), {} if xnor else expect)
        check_equal(f"zoo {ZOO_LM} prefill ({b}, {s}) logits, {other.value} "
                    f"against AUTO", ogot, got)
        del ocache
        other_ms = time_ms(lambda: ostep(packed, {"tokens": toks}), reps=3)
        routes = ("XNOR route (K5 + K4)", "unpack route")
        log(f"zoo {ZOO_LM} prefill ({b}, {s}), {b * s} rows, AUTO takes the "
            f"{routes[0] if xnor else routes[1]}: logits and every cache "
            f"leaf equal the plain route's; {ms:.5g} ms "
            f"({b * s / ms * 1e3:.6g} tokens/s), plain route {plain_ms:.5g} "
            f"ms; the "
            f"{routes[1] if xnor else routes[0]} ({other.value}) on the same "
            f"tokens {other_ms:.5g} ms, logits equal")
        out[b, s] = (ms, plain_ms, other_ms)
        if xnor:
            seen = zoo_linear_inputs(lambda: pstep(packed, {"tokens": toks}))
            out["rows_prefill"] = zoo_kernel_rows(
                f"zoo {ZOO_LM} prefill ({b}, {s}) layer 0, x{cfg.num_layers}"
                f" per prefill", seen[:7], rates)

    # one decode step: launches, equality, time
    toks = torch.randint(0, cfg.vocab_size, (ZOO_SLOTS, 8), generator=gen
                         ).to(dev)
    _, cache = SV.make_prefill_step(cfg, ZOO_MAX_LEN)(packed,
                                                      {"tokens": toks})
    tok = toks[:, :1]
    dstep, pdstep = SV.make_decode_step(cfg), SV.make_decode_step(plain)
    zoo_decode_pair(drv, f"zoo {ZOO_LM} decode step", packed, cfg, tok,
                    cache, 8, expect)
    step_ms = time_ms(lambda: dstep(packed, cache, tok, 8), reps=5)
    plain_step_ms = time_ms(lambda: pdstep(packed, cache, tok, 8), reps=1)
    log(f"zoo {ZOO_LM} decode step ({ZOO_SLOTS} slots): launches {expect} "
        f"(K5 = K4 = 7 x {cfg.num_layers}), logits and cache equal the "
        f"plain route's; {step_ms:.5g} ms a step, plain route "
        f"{plain_step_ms:.5g} ms")
    seen = zoo_linear_inputs(lambda: pdstep(packed, cache, tok, 8))
    out["rows_decode"] = zoo_kernel_rows(
        f"zoo {ZOO_LM} decode M={ZOO_SLOTS} layer 0, x{cfg.num_layers} per "
        f"step", seen[:7], rates)
    out["step_ms"], out["plain_step_ms"] = step_ms, plain_step_ms
    del cache

    # one decode step at the end of the model's own window: a cache of
    # ZOO_LONG positions, random K/V, the step at the last one reads all
    idx = ZOO_LONG - 1
    cache = M.init_cache(packed, cfg, ZOO_SLOTS, ZOO_LONG)
    g = torch.Generator(device=dev).manual_seed(8)
    for _, t in leaves_with_path(cache):
        t.copy_(torch.randn(t.shape, generator=g, device=dev))
    zoo_decode_pair(drv, f"zoo {ZOO_LM} decode step at {idx} of {ZOO_LONG}",
                    packed, cfg, tok, cache, idx, expect)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    long_ms = time_ms(lambda: dstep(packed, cache, tok, idx), reps=3)
    extra = torch.cuda.max_memory_allocated() - base
    copy_ms = time_ms(lambda: dstep(packed, tree_map(torch.clone, cache),
                                    tok, idx), reps=3)
    log(f"zoo {ZOO_LM} decode step at position {idx} of a {ZOO_LONG}-"
        f"position cache ({ZOO_SLOTS} slots, {tree_bytes(cache)} bytes, "
        f"written in place): launches {expect}, logits and cache equal the "
        f"plain route's; {long_ms:.5g} ms a step, {extra} bytes allocated "
        f"beside the cache at the step's peak; on a copy of the cache "
        f"(what keeping the old one costs) {copy_ms:.5g} ms")
    out["long"] = (long_ms, extra, tree_bytes(cache), copy_ms)
    del cache

    # BatchedServer, both routes, the example's mix
    served = {}
    for route, c in (("kernel", cfg), ("plain", plain)):
        srv = SV.BatchedServer(c, packed, batch_slots=ZOO_SLOTS,
                               max_len=ZOO_MAX_LEN)
        if route == "kernel":
            inner = srv.decode
            srv.decode = lambda *a, inner=inner: drv.run(
                f"zoo {ZOO_LM} served step", lambda: inner(*a), expect)
        rgen = torch.Generator().manual_seed(2)
        reqs = [SV.Request(rid=i, prompt=torch.randint(
            0, cfg.vocab_size, (ZOO_PROMPT_LEN + i % 3,), generator=rgen),
            max_new=ZOO_MAX_NEW + i % 2) for i in range(ZOO_REQUESTS)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        done = srv.submit_and_run(reqs)
        torch.cuda.synchronize()
        served[route] = (done, time.perf_counter() - t, srv.idx)
    (kdone, kwall, ksteps), (pdone, pwall, _) = served["kernel"], \
        served["plain"]
    if [(r.rid, r.out, r.truncated) for r in kdone] != \
            [(r.rid, r.out, r.truncated) for r in pdone]:
        raise AssertionError("zoo served tokens differ between the routes")
    if any(r.truncated for r in kdone) or len(kdone) != ZOO_REQUESTS:
        raise AssertionError("zoo served: a request was truncated or lost")
    tokens = sum(len(r.out) for r in kdone)
    log(f"zoo {ZOO_LM} served through BatchedServer: {ZOO_REQUESTS} "
        f"requests (prompts {ZOO_PROMPT_LEN}-{ZOO_PROMPT_LEN + 2} ids, "
        f"max_new {ZOO_MAX_NEW}-{ZOO_MAX_NEW + 1}), {ZOO_SLOTS} slots, "
        f"max_len {ZOO_MAX_LEN}: {ksteps} decode steps, {tokens} tokens "
        f"in {kwall * 1e3:.5g} ms ({tokens / kwall:.5g} tokens/s, "
        f"{kwall / ksteps * 1e3:.5g} ms a step), each step's launches "
        f"{expect}; plain route {pwall * 1e3:.5g} ms; every request's "
        f"tokens equal on both routes: "
        + "; ".join(f"req{r.rid} {r.out}" for r in kdone[:3]))
    out["served"] = (tokens, kwall, ksteps, pwall)
    del packed
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return out


def zoo_pair(drv, what, fn_kernel, fn_plain, expect):
    """Run a zoo function on both routes; the kernel route's launches held
    to ``expect``; the outputs (trees) equal."""
    got = drv.run(what, fn_kernel, expect)
    want = fn_plain()
    check_tree_equal(what, got, want)
    return got


def zoo_published(drv, dev) -> None:
    """Phase 8b: mamba2-1.3b and whisper-base at their published widths in
    binary mode, kernel route against plain route."""
    import torch
    from repro_torch import configs
    from repro_torch.core import quantize as Q
    from repro_torch.models import encdec as ED
    from repro_torch.models import linear as LN
    from repro_torch.models import model as M
    from repro_torch.tree import tree_bytes
    name, (b, s), steps = ZOO_SSM
    cfg = configs.get_config(name, quant="binary")
    plain = zoo_plain(cfg)
    t0 = time.perf_counter()
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    fbytes = tree_bytes(params["stack"])
    packed = LN.maybe_pack_tree(params, cfg.quant)
    del params
    gen = torch.Generator().manual_seed(3)
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=gen).to(dev)
    n = packed_linears(cfg)
    xnor = b * s <= Q.XNOR_MAX_ROWS
    t1 = time.perf_counter()
    logits, cache = zoo_pair(
        drv, f"zoo {name} prefill ({b}, {s})",
        lambda: M.prefill(packed, cfg, {"tokens": toks}, s + steps),
        lambda: M.prefill(packed, plain, {"tokens": toks}, s + steps),
        zoo_step_launches(n if xnor else 0))
    t_prefill = time.perf_counter() - t1
    t_made = t1 - t0
    t1 = time.perf_counter()
    for i in range(steps):
        tok = logits[:, -1].float().argmax(-1, keepdim=True)
        logits, cache = zoo_decode_pair(drv, f"zoo {name} decode {i}",
                                        packed, cfg, tok, cache, s + i,
                                        zoo_step_launches(n))
    torch.cuda.synchronize()
    t_decode = (time.perf_counter() - t1) / steps
    log(f"zoo {name} binary at its published widths ({cfg.num_layers} "
        f"layers, d_model {cfg.d_model}, d_state {cfg.ssm.d_state}, "
        f"stack {fbytes} -> {tree_bytes(packed['stack'])} bytes, made in "
        f"{t_made:.1f} s): prefill ({b}, {s}) on the "
        f"{'XNOR' if xnor else 'unpack'} route, {steps} decode steps with "
        f"K5 = K4 = {n} a step; logits and caches equal the plain route's; "
        f"prefill {t_prefill * 1e3:.5g} ms, a decode step (both routes, "
        f"host clock) {t_decode * 1e3:.5g} ms")
    del packed, cache
    name, b, frames, steps = ZOO_AUDIO
    cfg = configs.get_config(name, quant="binary")
    plain = zoo_plain(cfg)
    params = M.init_model(torch.Generator(device=dev).manual_seed(0), cfg)
    packed = LN.maybe_pack_tree(params, cfg.quant)
    del params
    emb = torch.randn((b, frames, cfg.d_model), generator=gen).to(dev)
    t1 = time.perf_counter()
    enc = zoo_pair(drv, f"zoo {name} encode ({b}, {frames})",
                   lambda: ED.encode(packed["encdec"], cfg, emb),
                   lambda: ED.encode(packed["encdec"], plain, emb), {})
    cache = M.init_cache(packed, cfg, b, steps, enc_len=frames)
    cache["cross"] = zoo_pair(
        drv, f"zoo {name} cross K/V",
        lambda: ED.precompute_cross_kv(packed["encdec"], cfg, enc),
        lambda: ED.precompute_cross_kv(packed["encdec"], plain, enc), {})
    t_enc = time.perf_counter() - t1
    n = packed_linears(cfg)
    tok = torch.zeros((b, 1), dtype=torch.int64, device=dev)
    t1 = time.perf_counter()
    for i in range(steps):
        logits, cache = zoo_decode_pair(drv, f"zoo {name} decode {i}",
                                        packed, cfg, tok, cache, i,
                                        zoo_step_launches(n))
        tok = logits[:, -1].float().argmax(-1, keepdim=True)
    torch.cuda.synchronize()
    log(f"zoo {name} binary at its published widths ({cfg.encoder_layers} "
        f"+ {cfg.num_layers} layers, d_model {cfg.d_model}): encode {frames}"
        f" frame embeddings x{b} on the unpack route and the cross K/V "
        f"({t_enc * 1e3:.5g} ms), {steps} decode steps with K5 = K4 = {n} a "
        f"step ({(time.perf_counter() - t1) / steps * 1e3:.5g} ms a step, "
        f"both routes); equal to the plain route")
    del packed, cache, enc
    torch.cuda.empty_cache()


def zoo_reduced(drv, dev) -> None:
    """Phase 8c: every reduced registry config in each mode, forward,
    prefill and decode, kernel route against plain route; then the packed
    LM on every reduced config against its plain path, stage by stage."""
    import torch
    from repro_torch import configs
    from repro_torch.models import encdec as ED
    from repro_torch.models import linear as LN
    from repro_torch.models import model as M
    from repro_torch.models import transformer as tf
    r = ZOO_REDUCED
    b, s = r["batch"], r["seq"]
    held = []
    for name in configs.list_configs():
        for mode in ("float", "binary_weight", "binary"):
            cfg = configs.get_config(name, quant=mode, reduced=True)
            plain = zoo_plain(cfg)
            gen = torch.Generator(device=dev).manual_seed(4)
            params = M.init_model(gen, cfg)
            packed = LN.maybe_pack_tree(params, cfg.quant)
            cpu = torch.Generator().manual_seed(5)
            batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s),
                                             generator=cpu).to(dev)}
            if cfg.encoder_layers:
                batch["enc_embeds"] = torch.randn(
                    (b, 10, cfg.d_model), generator=cpu).to(dev)
            n = packed_linears(cfg) if mode == "binary" else 0
            what = f"zoo {name} {mode}"
            zoo_pair(drv, f"{what} logits_fn",
                     lambda: M.logits_fn(packed, cfg, batch),
                     lambda: M.logits_fn(packed, plain, batch),
                     zoo_forward_launches(cfg, mode))
            logits, cache = zoo_pair(
                drv, f"{what} prefill",
                lambda: M.prefill(packed, cfg, batch, r["max_len"]),
                lambda: M.prefill(packed, plain, batch, r["max_len"]),
                zoo_forward_launches(cfg, mode))
            if cfg.encoder_layers:
                enc = ED.encode(packed["encdec"], cfg, batch["enc_embeds"])
                cache = M.init_cache(packed, cfg, b, r["max_len"],
                                     enc_len=10)
                cache["cross"] = ED.precompute_cross_kv(packed["encdec"],
                                                        cfg, enc)
            for i in range(r["steps"]):
                tok = logits[:, -1].float().argmax(-1, keepdim=True)
                logits, cache = zoo_decode_pair(
                    drv, f"{what} decode {i}", packed, cfg, tok, cache,
                    s + i, zoo_step_launches(n))
            if not bool(torch.isfinite(logits.float()).all()):
                raise AssertionError(f"{what}: logits not finite")
            held.append(f"{name}/{mode}")
    log(f"zoo reduced: logits_fn, prefill and {r['steps']} decode steps at "
        f"(B, S) = ({b}, {s}) equal on the kernel and the plain route for "
        f"{len(held)} config/mode pairs (binary: K5 = K4 = one a packed "
        f"linear a call; float and binary_weight: no kernel)")
    flips = {}
    for name in configs.list_configs():
        cfg = configs.get_config(name, reduced=True)
        spec = configs.LMSpec.from_arch(cfg)
        params = tf.init_binary_lm(torch.Generator(device=dev).manual_seed(6),
                                   spec)
        packed = tf.pack_transformer(params, spec, max_len=s, device=dev)
        toks = torch.randint(0, spec.vocab_size, (b, s),
                             generator=torch.Generator().manual_seed(7)
                             ).to(dev)
        L = spec.num_layers
        got = drv.run(f"zoo packed lm {name}",
                      lambda: tf.transformer_forward_packed(packed, toks),
                      {"bitpack": 5 * L + 1, "xnor_gemm": 5 * L + 1,
                       "xnor_gemm_bn_sign": L, "binary_attention": L})
        flips[name], want = lm_stage_check(f"zoo packed lm {name}", packed,
                                           toks)
        if flips[name] == 0:
            check_equal(f"zoo packed lm {name} logits", got, want)
    log(f"zoo packed lm on every reduced registry config, stage by stage "
        f"against the plain path (attention bits flipped near 0: {flips})")


def zoo_forward_launches(cfg, mode):
    """Launches of one full-sequence call (``logits_fn`` or ``prefill``) at
    the reduced (B, S), on the XNOR route (B*S <= 256): K5 and K4 once per
    packed linear; the encoder-decoder adds its encoder's layers and its
    decoder's cross K and V."""
    if mode != "binary":
        return {}
    n = packed_linears(cfg)
    if cfg.encoder_layers:
        n += cfg.encoder_layers * (4 + _ffn_linears(cfg))
        n += 2 * cfg.num_layers
    return zoo_step_launches(n)



# Phase 9: training (``train/trainer.py``).  starcoder2-3b at its published
# width and depth (``configs/starcoder2_3b.py``, arXiv:2402.19173): 30
# layers, d_model 3072, 24 query heads over 2 KV heads of 128, gelu d_ff
# 12288, vocab 49152, untied head, bfloat16 activations, float32 masters
# made on the card from seed 0; nothing cut.  Three steps in 'float' and
# three in 'binary' on the port's stream at (B, S) = TRAIN_BATCH; one step
# each of compress_grads and grads_bf16 on a full-width binary state, and
# of microbatches=4 against microbatches=1 from the same binary state, at
# bfloat16 and at float32 activations; a reduced
# step on the card against the CPU; the binary-trained tree packed and
# served through K5 + K4; the paper's nets' STE gradients, card against
# CPU.
TRAIN_LM = "starcoder2-3b"
TRAIN_BATCH = (4, 512)
TRAIN_STEPS = 3
TRAIN_LR = 3e-4            # the trainer's default, 100 warm-up steps
TRAIN_MICRO = 4
# microbatches=4 against 1, one step each at the full learning rate
# (warm-up 1) from the same fresh state, at the config's own bfloat16
# activations and again at float32: the loss within the reference's rtol
# 1e-3 (tests/test_trainer_optim.py), the gradients' global norm within
# rtol 1e-4, and the gradients themselves (mu = 0.1 x the clipped
# gradient) within MICRO_MU[dtype] of each leaf's largest value; the
# elements past MICRO_NEAR of their value plus MICRO_NEAR of the largest
# are counted.  A wrong microbatch scale moves mu and the norm by 100 % or
# more.  The params are not compared: Adam's first step moves each by
# lr (sign(g) + weight_decay p) whatever the gradient's size, so the
# reference's param bounds cannot tell a fault from a right step.  The
# bfloat16 runs' forwards round apart (a 512-row and a 2048-row product
# need not sum in one order), and binary activations near 0 and STE masks
# near +-1 flip with them: mu read 0.015 of a leaf's largest there, and
# 2.6e-06 in the same pair at float32, where the rounding, and so the
# flips, are 2^16 times rarer (H100 readings, PERF.md).
MICRO_TOL = dict(loss_rtol=1e-3, norm_rtol=1e-4)
MICRO_MU = {"bfloat16": 0.05, "float32": 1e-4}
MICRO_NEAR = 1e-3
DEPLOY_PREFILL = (8, 16)
STE_BATCH = 8
STE_TOL = dict(rtol=1e-4, top=1e-6)
SAMPLE = 1 << 16           # elements of each leaf kept to see it change


def train_config(**kw):
    from repro_torch.train import trainer as TR
    return TR.TrainConfig(lr=TRAIN_LR, **kw)


def train_reckoning(n: int, tc) -> dict:
    """The bytes a step holds, from the parameter count: float32 params,
    mu and nu; float32 gradients, or bfloat16 casts of the params and
    bfloat16 gradients with ``grads_bf16``; the float32 error buffer with
    ``compress_grads``."""
    r = {"params+mu+nu": 12 * n}
    if tc.grads_bf16:
        r["bf16 leaves"] = 2 * n
        r["bf16 grads"] = 2 * n
    else:
        r["grads"] = 4 * n
    if tc.compress_grads:
        r["ef_error"] = 4 * n
    r["total"] = sum(r.values())
    return r


def free_card() -> None:
    import gc
    import torch
    gc.collect()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()


def fresh_state(cfg, tc, dev):
    """The full-width train state made on the card from seed 0."""
    import torch
    from repro_torch.train import trainer as TR
    return TR.init_train_state(torch.Generator(device=dev).manual_seed(0),
                               cfg, tc, device=dev)


class StepSplit:
    """The trainer's ``mark`` hook: a CUDA event at the start of a step
    and after each of its parts; ``parts()`` gives the last step's
    milliseconds by part."""

    def __init__(self):
        self.events = []

    def __call__(self, name) -> None:
        import torch
        if name == "begin":
            self.events = []
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        self.events.append((name, ev))

    def parts(self) -> dict:
        out = {}
        for (_, a), (name, b) in zip(self.events, self.events[1:]):
            out[name] = out.get(name, 0.0) + a.elapsed_time(b)
        return out


def leaf_samples(tree) -> list:
    from repro_torch.tree import sorted_leaves
    return [t.view(-1)[:SAMPLE].clone() for t in sorted_leaves(tree)]


def timed_steps(what, cfg, tc, state, dev, steps, start=0,
                split=None) -> list:
    """``steps`` train steps on the port's stream, each timed with CUDA
    events; every loss finite.  ``split``: a :class:`StepSplit` given to
    the trainer as its ``mark``.  Returns one dict a step."""
    import math
    import torch
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.train import trainer as TR
    b, s = TRAIN_BATCH
    dcfg = TokenStreamConfig(vocab_size=cfg.vocab_size, seq_len=s,
                             global_batch=b)
    step = TR.make_train_step(cfg, tc, mark=split)
    out = []
    for i in range(start, start + steps):
        batch = token_batch(dcfg, i, dev)
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        state, m = step(state, batch)
        e1.record()
        torch.cuda.synchronize()
        ms = e0.elapsed_time(e1)
        row = {"step": i, "ms": ms, "tokens_per_s": b * s / ms * 1e3,
               "loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
               "lr": float(m["lr"])}
        if not (math.isfinite(row["loss"]) and
                math.isfinite(row["grad_norm"])):
            raise AssertionError(f"{what} step {i}: {row}")
        log(f"train {what} step {i}: loss {row['loss']:.6g} grad_norm "
            f"{row['grad_norm']:.6g} lr {row['lr']:.4g}; {ms:.6g} ms "
            f"({row['tokens_per_s']:.6g} tokens/s)")
        out.append(row)
    return out


def check_trained(what, state, samples, binary) -> None:
    """Every leaf moved (in its first SAMPLE elements); in the binary
    modes every leaf within [-1, 1]."""
    import torch
    from repro_torch.tree import sorted_leaves
    leaves = list(sorted_leaves(state["params"]))
    still = [i for i, (t, s) in enumerate(zip(leaves, samples))
             if torch.equal(t.view(-1)[:SAMPLE], s)]
    if still:
        raise AssertionError(f"train {what}: leaves {still} never moved")
    if binary:
        top = max(float(t.abs().max()) for t in leaves)
        if top > 1.0:
            raise AssertionError(f"train {what}: a latent at {top}")


def run_training(what, cfg, tc, dev, steps, *, split=False, keep=False):
    """A fresh full-width state, ``steps`` timed steps, the peak memory
    beside the reckoning; with ``split`` the last step split into its
    parts by the trainer's marks.  Returns (rows, peak bytes, parameter
    count, the parts, the state if ``keep``, else None: it is freed)."""
    import torch
    from repro_torch.tree import sorted_leaves
    free_card()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state = fresh_state(cfg, tc, dev)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    n = sum(t.numel() for t in sorted_leaves(state["params"]))
    samples = leaf_samples(state["params"])
    marks = StepSplit() if split else None
    rows = timed_steps(what, cfg, tc, state, dev, steps, split=marks)
    check_trained(what, state, samples, cfg.quant.mode.value != "float")
    peak = torch.cuda.max_memory_allocated() - base
    parts = None
    if split:
        parts = marks.parts()
        total = sum(parts.values())
        log(f"train {what} step {rows[-1]['step']} split (CUDA events at "
            f"the trainer's marks): " + ", ".join(
                f"{k} {ms:.5g} ms ({ms / total:.1%})"
                for k, ms in parts.items()) + f"; {total:.5g} ms in all")
    reck = train_reckoning(n, tc)
    log(f"train {what}: {n} parameters, state made on the card in "
        f"{init_s:.3g} s; peak {peak} bytes allocated (max_memory_allocated "
        f"above the {base} bytes held before) against the reckoning "
        f"{reck['total']} bytes {reck} (+{peak - reck['total']} bytes: "
        f"activations, the loss chunk, temporaries)")
    if keep:
        return rows, peak, n, parts, state
    del state
    free_card()
    return rows, peak, n, parts, None


def micro_check(cfg, dev, dtype) -> dict:
    """microbatches=4 against microbatches=1, one step each at the full
    learning rate from the same fresh full-width state (seed 0, made
    twice) with activations in ``dtype``: the loss, the gradients' norm
    and ``mu`` as the comment on MICRO_TOL says.  The first run's ``mu``
    waits on the host.  Logs every figure and returns the failures."""
    import dataclasses
    import torch
    from repro_torch.optim import adamw as OPT
    from repro_torch.tree import sorted_leaves
    cfg = dataclasses.replace(cfg, dtype=dtype)
    tc = dict(warmup=1)
    what = f"binary {dtype}"
    free_card()
    st4 = fresh_state(cfg, train_config(microbatches=TRAIN_MICRO, **tc), dev)
    r4 = timed_steps(f"{what} microbatches={TRAIN_MICRO}, warm-up 1", cfg,
                     train_config(microbatches=TRAIN_MICRO, **tc), st4, dev,
                     1)
    host = [m.cpu() for m in sorted_leaves(st4["opt"]["mu"])]
    del st4
    free_card()
    st1 = fresh_state(cfg, train_config(**tc), dev)
    r1 = timed_steps(f"{what} microbatches=1, warm-up 1", cfg,
                     train_config(**tc), st1, dev, 1)
    (l4, n4), (l1, n1) = [(r[0]["loss"], r[0]["grad_norm"]) for r in (r4, r1)]
    mu_worst, mu_far = 0.0, 0
    for m1_full, hm_full in zip(sorted_leaves(st1["opt"]["mu"]), host):
        top = float(m1_full.abs().max())
        mu_leaf = 0.0
        # a slice at a time: the temporaries of a 1.1e9-element leaf
        # would take 4.5 GB each
        for m1, hm in OPT.slices(m1_full, hm_full):
            dm = (hm.to(dev) - m1).abs()
            mu_far += int((dm > MICRO_NEAR * (m1.abs() + top)).sum())
            mu_leaf = max(mu_leaf, float(dm.max()))
        mu_worst = max(mu_worst, mu_leaf / max(top, 1e-30))
    log(f"train {what} microbatches={TRAIN_MICRO} against 1, same state, "
        f"lr {r1[0]['lr']:.4g}: loss {l4:.7g} / {l1:.7g} (rtol "
        f"{abs(l4 - l1) / abs(l1):.3g}, bound {MICRO_TOL['loss_rtol']}); "
        f"grad_norm {n4:.7g} / {n1:.7g} (rtol {abs(n4 - n1) / abs(n1):.3g}, "
        f"bound {MICRO_TOL['norm_rtol']}); mu max abs diff {mu_worst:.3g} "
        f"of its leaf's largest (bound {MICRO_MU[dtype]}), {mu_far} "
        f"elements past {MICRO_NEAR} of the value plus {MICRO_NEAR} of the "
        f"largest")
    failed = [f"microbatches {dtype}"] if \
        abs(l4 - l1) > MICRO_TOL["loss_rtol"] * abs(l1) or \
        abs(n4 - n1) > MICRO_TOL["norm_rtol"] * abs(n1) or \
        mu_worst > MICRO_MU[dtype] else []
    del st1
    free_card()
    return {"rows4": r4, "rows1": r1, "mu_worst": mu_worst,
            "mu_far": mu_far, "failed": failed}


def train_card_vs_cpu(dev) -> dict:
    """One reduced starcoder2-3b step with dtype float32 from the same
    state and batch on the card and on the CPU, in float and binary:
    loss and gradient norm within rtol 1e-5; moments within 1e-4 of each
    value plus 1e-5 of the tree's largest; params within 1e-6 where the
    gradient is above 1e-5 of the largest, and elsewhere (float noise,
    which Adam's first step turns into a unit step of either sign)
    within the step's bound, 2 lr (1 + 0.1 |p|)."""
    import dataclasses
    import torch
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.train import trainer as TR
    from repro_torch.tree import sorted_leaves, tree_map
    out = {}
    for mode in ("float", "binary"):
        cfg = dataclasses.replace(configs.get_config(
            TRAIN_LM, quant=mode, reduced=True), dtype="float32")
        tc = TR.TrainConfig(lr=1e-3, warmup=2, total_steps=10)
        cpu = TR.init_train_state(torch.Generator().manual_seed(0), cfg, tc,
                                  device="cpu")
        card = tree_map(lambda t: t.to(dev, copy=True), cpu)
        batch = token_batch(TokenStreamConfig(cfg.vocab_size, 32, 4), 0,
                            "cpu")
        step = TR.make_train_step(cfg, tc)
        card, mc = step(card, {k: v.to(dev) for k, v in batch.items()})
        cpu, mh = step(cpu, batch)
        for k in ("loss", "grad_norm", "lr"):
            if abs(float(mc[k]) - float(mh[k])) > 1e-5 * abs(float(mh[k])):
                raise AssertionError(f"card vs cpu {mode} {k}: "
                                     f"{float(mc[k])} / {float(mh[k])}")
        for k in ("mu", "nu"):
            want = list(sorted_leaves(cpu["opt"][k]))
            top = max(float(t.abs().max()) for t in want)
            for g, w in zip(sorted_leaves(card["opt"][k]), want):
                torch.testing.assert_close(g.cpu(), w, rtol=1e-4,
                                           atol=1e-5 * top)
        mu = list(sorted_leaves(cpu["opt"]["mu"]))
        top = max(float(t.abs().max()) for t in mu)
        held_max = 0.0
        for g, w, m in zip(sorted_leaves(card["params"]),
                           sorted_leaves(cpu["params"]), mu):
            d = (g.cpu() - w).abs()
            held = m.abs() > 1e-5 * top
            if bool(held.any()):
                held_max = max(held_max, float(d[held].max()))
            if not bool((d <= 2 * tc.lr * (1 + 0.1 * w.abs()) + 1e-6).all()):
                raise AssertionError(f"card vs cpu {mode}: a step past its "
                                     f"bound")
        if held_max > 1e-6:
            raise AssertionError(f"card vs cpu {mode}: params {held_max}")
        out[mode] = (float(mc["loss"]), float(mh["loss"]),
                     float(mc["grad_norm"]), float(mh["grad_norm"]),
                     held_max)
        log(f"train card vs cpu, reduced {TRAIN_LM} {mode} float32: loss "
            f"{out[mode][0]:.8g} / {out[mode][1]:.8g}, grad_norm "
            f"{out[mode][2]:.8g} / {out[mode][3]:.8g}, params max abs diff "
            f"{held_max:.3g} where the gradient is not noise")
    return out


def deploy_trained(drv, cfg, params, dev) -> dict:
    """The binary-trained full-width tree packed on the card and served:
    prefill at DEPLOY_PREFILL and one decode step, K5 = K4 = the packed
    linears of the tree, logits and cache equal to the plain route."""
    import torch
    from repro_torch.models import linear as LN
    from repro_torch.train import serve as SV
    from repro_torch.tree import leaves_with_path
    t0 = time.perf_counter()
    packed = LN.maybe_pack_tree(params, cfg.quant, device=dev)
    torch.cuda.synchronize()
    pack_s = time.perf_counter() - t0
    n = sum(t.shape[:-2].numel() for p, t in leaves_with_path(packed)
            if p.endswith("w_packed"))
    if n != packed_linears(cfg):
        raise AssertionError(f"{n} packed linears in the tree, "
                             f"{packed_linears(cfg)} by the config")
    expect = zoo_step_launches(n)
    b, s = DEPLOY_PREFILL
    toks = torch.randint(0, cfg.vocab_size, (b, s), generator=torch.Generator(
        ).manual_seed(3)).to(dev)
    step = SV.make_prefill_step(cfg, ZOO_MAX_LEN)
    got, gcache = drv.run(f"train deploy prefill ({b}, {s})",
                          lambda: step(packed, {"tokens": toks}), expect)
    want, wcache = SV.make_prefill_step(zoo_plain(cfg), ZOO_MAX_LEN)(
        packed, {"tokens": toks})
    check_equal("train deploy prefill logits", got, want)
    check_tree_equal("train deploy prefill cache", gcache, wcache)
    if not bool(torch.isfinite(got.float()).all()):
        raise AssertionError("train deploy: logits not finite")
    del gcache
    tok = got[:, -1].float().argmax(-1, keepdim=True)
    zoo_decode_pair(drv, "train deploy decode step", packed, cfg, tok,
                    wcache, s, expect)
    ms = time_ms(lambda: step(packed, {"tokens": toks}), reps=3)
    log(f"train deploy: the binary-trained {TRAIN_LM} packed on the card in "
        f"{pack_s:.3g} s ({n} packed linears: 6 a layer x {cfg.num_layers} "
        f"and the head); prefill ({b}, {s}) and a decode step each launch "
        f"{expect}, logits and cache equal the plain route's; prefill "
        f"{ms:.5g} ms")
    del packed, wcache
    return {"linears": n, "pack_s": pack_s, "prefill_ms": ms}


def unit_bn_var(bns) -> None:
    """Set each BN variance to 1 - eps in float32, so that var + eps is 1
    and its rsqrt exactly 1 on any device.  CUDA's float32 rsqrt and the
    CPU's round differently, and one ulp in a BN scale can flip a sign or
    a straight-through mask (a discrete decision) between the devices;
    with the scale exact both forwards are the same IEEE operations on
    the same integers and agree bit for bit."""
    import torch
    eps = torch.tensor(1e-5, dtype=torch.float32)
    for bn in bns:
        bn["var"] = torch.full_like(bn["var"], 1.0) - eps
        if not bool(((bn["var"] + eps) == 1.0).all()):
            raise AssertionError("1 - eps + eps is not 1 in float32")


def ste_card_vs_cpu(dev) -> dict:
    """The STE gradient of a cross-entropy through ``BCNNSpec()`` and
    ``BMLPSpec()`` at batch STE_BATCH (``*_forward_float(..., ste=True)``),
    random weights and BN (gamma of both signs, beta, mean; the variances
    as ``unit_bn_var`` says) from seed 0, on the card and on the CPU: the
    logits equal, loss within rtol 1e-5, every gradient within rtol 1e-4
    plus 1e-6 of its leaf's largest (the ±1 dots and convs run in float64
    on both; the gradients' sums run in another order).  Logs every
    figure, then returns the failures."""
    import torch
    import torch.nn.functional as F
    from repro_torch.models import cnn
    from repro_torch.tree import leaves_with_path, tree_map
    gen = torch.Generator().manual_seed(0)
    out, failed = {}, []
    for kind, spec in (("bcnn", cnn.BCNNSpec()), ("bmlp", cnn.BMLPSpec())):
        if kind == "bcnn":
            params = cnn.init_bcnn(gen, spec)
            bns = params["conv_bns"] + params["dense_bns"]
            x = torch.randint(0, 256, (STE_BATCH, *spec.input_hw,
                                       spec.c_in), generator=gen,
                              dtype=torch.uint8)
            fwd = lambda p, x: cnn.bcnn_forward_float(p, x, spec, ste=True)
        else:
            params = cnn.init_bmlp(gen, spec)
            bns = params["bns"]
            x = torch.randint(0, 256, (STE_BATCH, spec.sizes[0]),
                              generator=gen, dtype=torch.uint8)
            fwd = lambda p, x: cnn.bmlp_forward_float(p, x, ste=True)
        randomize_bn(bns, gen)
        unit_bn_var(bns)
        y = torch.randint(0, 10, (STE_BATCH,), generator=gen)
        res = {}
        for where in ("cpu", dev):
            p = tree_map(lambda t: t.detach().to(where, copy=True)
                         .requires_grad_(True), params)
            t0 = time.perf_counter()
            logits = fwd(p, x.to(where))
            loss = F.cross_entropy(logits, y.to(where))
            loss.backward()
            if where != "cpu":
                torch.cuda.synchronize()
            res[str(where)] = (float(loss.detach()), logits.detach().cpu(), [
                (path, t.grad.cpu() if t.grad is not None
                 else torch.zeros_like(t).cpu())
                for path, t in leaves_with_path(p)],
                time.perf_counter() - t0)
        (lc, zc, gc, _), (ld, zd, gd, sd) = res["cpu"], res[str(dev)]
        worst, bad = 0.0, []
        for (path, a), (_, b) in zip(gd, gc):
            top = float(b.abs().max())
            d = (a - b).abs()
            if bool((d > STE_TOL["rtol"] * b.abs()
                     + STE_TOL["top"] * top).any()):
                bad.append(path)
            worst = max(worst, float(d.max()) / max(top, 1e-30))
        moving = sum(float(g.abs().max()) > 0 for path, g in gd
                     if path.endswith("/w"))
        logits_equal = bool(torch.equal(zd, zc))
        log(f"train ste {kind} batch {STE_BATCH}: logits "
            f"{'equal' if logits_equal else 'differ'} on the card and the "
            f"CPU (max abs diff {float((zd - zc).abs().max()):.3g}), loss "
            f"{ld:.8g} / {lc:.8g}; gradients within rtol {STE_TOL['rtol']} "
            f"+ {STE_TOL['top']} of their leaf's largest but {bad} (worst "
            f"{worst:.3g} of it), {moving} latent weight leaves with a "
            f"gradient; forward + backward on the card {sd * 1e3:.5g} ms")
        if not logits_equal or abs(ld - lc) > 1e-5 * abs(lc) or bad:
            failed.append(f"ste {kind}")
        out[kind] = (ld, lc, worst)
    out["failed"] = failed
    return out


def phase9_training(drv, dev) -> dict:
    """Phase 9: training starcoder2-3b at full width and depth, then its
    deploy; the reduced step card against CPU; the paper's nets."""
    from repro_torch import configs
    cfg = configs.get_config(TRAIN_LM)
    bcfg = configs.get_config(TRAIN_LM, quant="binary")
    log(f"train {TRAIN_LM}: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads}/{cfg.num_kv_heads} heads of {cfg.head_dim}, "
        f"{cfg.ffn_type} d_ff {cfg.d_ff}, vocab {cfg.vocab_size}, untied "
        f"head {not cfg.tie_embeddings}, {cfg.dtype} activations, (B, S) = "
        f"{TRAIN_BATCH}, lr {TRAIN_LR} after {train_config().warmup} "
        f"warm-up steps, AdamW (clip_latent in binary)")
    out = {"float": run_training("float", cfg, train_config(), dev,
                                 TRAIN_STEPS, split=True)}
    for what, tc in (("binary compress_grads",
                      train_config(compress_grads=True)),
                     ("binary grads_bf16", train_config(grads_bf16=True))):
        out[what] = run_training(what, bcfg, tc, dev, 1)
    *out["binary"], state = run_training("binary", bcfg, train_config(), dev,
                                         TRAIN_STEPS, split=True, keep=True)
    params = state.pop("params")
    del state
    free_card()
    out["deploy"] = deploy_trained(drv, bcfg, params, dev)
    del params
    free_card()
    out["card_vs_cpu"] = train_card_vs_cpu(dev)
    out["ste"] = ste_card_vs_cpu(dev)
    out["micro"] = {dt: micro_check(bcfg, dev, dt)
                    for dt in ("bfloat16", "float32")}
    failed = out["ste"]["failed"] + [
        f for m in out["micro"].values() for f in m["failed"]]
    if failed:
        raise AssertionError(f"train: {failed} failed (logged above)")
    return out

# Phase 10: sharded training (``trainer.make_train_step(..., mesh=)``),
# every position of each mesh on the one card.  starcoder2-3b at phase
# 9's published widths and depth, (B, S) = TRAIN_BATCH, seed 0: FSDP over
# the data axis (``param_specs`` with fsdp=True, the reference's
# launcher's specs) and tensor parallelism over ``model`` wherever a
# block splits on whole units (``fsdp.split_blocks``): its 24 query heads
# over 2 KV heads split over 2 positions, not 4; its d_ff 12288 over
# both.  So (2, 2) runs attention and FFN tensor-parallel, (1, 4) its FFN
# only (attention falls back to the whole-weight gather), (4, 1) none.
# Each sharded step is held to the unsharded step from the same state and
# batch: the data slices are microbatches of it, so phase 9's microbatch
# bounds hold (loss rtol 1e-3, grad_norm rtol 1e-4, mu within
# MICRO_MU[bfloat16] of each leaf's largest).  (4, 1) takes the same row
# slices as microbatches=4 and the same weights, gathered: held to it
# within SAME_ROWS.  The first chip reading (H100, PERF.md): loss equal,
# grad_norm rtol 1.0e-07 (partial sums of four slices in another order),
# mu 2.3e-07 of a leaf's largest (the clip scale 1 / grad_norm moves
# with the norm); the bounds leave 4-10x of it.  Each run's second step
# is timed warm: the first carries the new shapes' first launches.
# A tensor-parallel step sums its row-parallel partial outputs and its
# column-parallel partial input gradients in float32 and rounds each sum
# once, as the unsplit bfloat16 product rounds its float32 sum once.  On
# the CPU that makes the bfloat16 steps agree (grad_norm 1.9e-5); on the
# card cuBLAS's bfloat16 product is not the exact product rounded once
# (off it in 0.67 % of w_down's outputs, where the split's float32 sum is
# off in 0.19 %: chip_tp_parity.py), so the split steps round apart:
# grad_norm 5.6e-4 on (2, 2) and 7.0e-4 on (1, 4) from the unsharded
# step (H100 readings, PERF.md §6; the unsharded bfloat16 step reads
# 6.9e-4 from its float32 twin).  With the embedding and the head
# vocabulary-parallel (1, 4) reads 8.9e-4: the unsharded bfloat16 step
# sits 6.9e-4 from the float32 one, the split step 2.1e-4 on the other
# side, 1.9e-4 of it the vocabulary split's rounding (chip_tp_parity.py
# vocab).  So a float mesh whose step splits a
# block over 'model' holds grad_norm at bfloat16 within TP_BF16_NORM_RTOL,
# set from those readings, loss and mu within phase 9's bounds; and it
# runs again at float32 activations (state, batch and seed alike), held
# within phase 9's float32 bounds (loss 1e-3, grad_norm 1e-4, mu 1e-4 of
# a leaf's largest), where it read loss and grad_norm equal and mu
# 3.7e-06.  The binary (2, 2) step holds all of phase 9's bfloat16 bounds
# (grad_norm 6.8e-06): its products are integers.
# FSDP_ONLY holds the readings of the step before it split blocks over
# 'model' (every weight gathered whole; H100 80GB HBM3 at 700 W, PERF.md
# §5): warm ms and peak bytes, printed beside this run's.
TRAIN_MESHES = (("float", (2, 2)), ("float", (4, 1)), ("float", (1, 4)),
                ("binary", (2, 2)))
SAME_ROWS = dict(loss_rtol=1e-6, norm_rtol=1e-6, mu=1e-6)
TP_BF16_NORM_RTOL = 2e-3    # over twice the larger reading
FSDP_ONLY = {("float", (2, 2)): (1153.6, 53.65e9),
             ("float", (4, 1)): (2177.6, 53.13e9),
             ("binary", (2, 2)): (2115.1, 54.30e9)}
# WHOLE_VOCAB holds the readings of the same meshes before the embedding
# and the head ran vocabulary-parallel (every block split where it could,
# those two gathered whole; H100 80GB HBM3 at 700 W, PERF.md §5): warm
# ms, peak bytes, weight bytes gathered a step; printed beside this run's.
WHOLE_VOCAB = {("float", (2, 2)): (2046.2, 53.65e9, 24.839e9),
               ("float", (4, 1)): (1770.3, 53.13e9, 72.704e9),
               ("float", (1, 4)): (710.52, 54.89e9, 4.586e9),
               ("binary", (2, 2)): (2857.8, 55.06e9, 24.839e9)}
# WHOLE_VOCAB_LEAVES: the bytes starcoder2-3b's embed/table and head/w
# gathered, and reduced, a (4, 512) step when both were gathered whole at
# each data slice's first position (fsdp.step_traffic of those two leaves
# before they ran vocabulary-parallel), by (data, model).
WHOLE_VOCAB_LEAVES = {(2, 2): 1_811_939_328, (4, 1): 3_623_878_656,
                      (1, 4): 905_969_664}
TRAIN_SIZES = {"gemma2-9b": ((2, 2), (4, 1))}
# Mamba-2's split form over 'model': mamba2-1.3b at its published widths
# (d_model 2048, 64 heads of 64, d_state 128, vocabulary 50,280), 16 of
# its 48 layers, on (1, 2) at (4, 512).  Loss and grad_norm are held
# within phase 9's bounds; mu within MAMBA_MU of each leaf's largest, set
# from readings against a float64 step from the same state and batch
# (chip_tp_parity.py ssm; H100 80GB HBM3, 700.00 W, PERF.md §6): A_log's
# gradient cancels (its terms' magnitudes sum to 10-19 times a layer's
# largest head), so the unsharded float32 step itself sits 1.33e-4 of
# the leaf's largest from float64 and the split one 1.55e-4; the two
# read 9.96e-5 apart, and the unsharded step in two microbatches (the
# same sums in another order) 1.31e-4 from it.  At bfloat16 the two sit
# 0.041 and 0.048 from float64 (dt_bias) and 0.038 apart.  Each bound is
# above the sum of the two steps' distances from float64 (2.9e-4, 0.090).
MAMBA_TRAIN = "mamba2-1.3b"
MAMBA_TRAIN_LAYERS = 16
MAMBA_TRAIN_MESH = (1, 2)
MAMBA_MU = {"bfloat16": 0.1, "float32": 5e-4}


def host_leaves(tree) -> dict:
    from repro_torch.tree import leaves_with_path
    return {p: t.cpu() for p, t in leaves_with_path(tree)}


def unsharded_step(cfg, tc, dev, batch) -> dict:
    """One unsharded step from a fresh state: loss, grad_norm, mu on the
    host (the sharded runs rebuild the state: two do not fit)."""
    import torch
    from repro_torch.train import trainer as TR
    free_card()
    state = fresh_state(cfg, tc, dev)
    e0, e1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    e0.record()
    state, m = TR.make_train_step(cfg, tc)(state, batch)
    e1.record()
    torch.cuda.synchronize()
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "ms": e0.elapsed_time(e1), "mu": host_leaves(state["opt"]["mu"])}
    del state
    free_card()
    return out


def mu_gap(placed_mu, host_mu, dev) -> tuple[float, int, str]:
    """(largest |mu - reference mu| over each leaf's largest reference
    value, elements past MICRO_NEAR of the value plus MICRO_NEAR of the
    largest, the leaf of the largest), copy by copy of every placed leaf
    against the reference's slice."""
    from repro_torch.tree import leaves_with_path
    worst, far, at = 0.0, 0, ""
    for path, pl in leaves_with_path(placed_mu):
        copies = pl.copies()
        top = max(float(host_mu[path][idx].to(dev).abs().max())
                  for _, idx, _ in copies)
        leaf = 0.0
        for t, idx, _ in copies:
            ref = host_mu[path][idx].to(dev)
            d = (t - ref).abs()
            far += int((d > MICRO_NEAR * (ref.abs() + top)).sum())
            leaf = max(leaf, float(d.max()))
            del ref, d
        if leaf / max(top, 1e-30) > worst:
            worst, at = leaf / max(top, 1e-30), path
    return worst, far, at


def sharded_run(what, cfg, tc, shape, dev, batch, check, what_key=None
                ) -> tuple[dict, list, dict]:
    """A fresh full-width state placed on a ``shape`` mesh of the one card
    by ``trainer.state_specs``, one step: the resident bytes of every
    position against the specs' reckoning, the card's allocation against
    the distinct copies, the counted traffic against ``step_traffic``, ms,
    tokens/s, the peak; ``check(readings, state)`` after it (its
    failures are returned); then a second step on the stream's next
    batch, timed warm.  Returns (the readings, the failures, the state
    after both steps)."""
    import torch
    from repro_torch import telemetry
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.distributed import fsdp as FS
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common as C
    from repro_torch.models import model as M
    from repro_torch.train import trainer as TR
    from repro_torch.tree import leaves_with_path
    free_card()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mesh = make_host_mesh(*shape, device=dev.type)
    state = fresh_state(cfg, tc, dev)
    specs = TR.state_specs(state, mesh)
    state = SH.Shardings(mesh, specs).place(state, donate=True)
    torch.cuda.synchronize()
    placed_bytes = torch.cuda.memory_allocated() - base
    # the reckoning from shapes alone: a meta state, its specs
    meta = M.init_model(C.MetaGenerator(), cfg, device="meta")
    mstate = {"params": meta, "opt": {"mu": meta, "nu": meta,
                                      "step": torch.empty((), dtype=torch.int32,
                                                          device="meta")}}
    mspecs = TR.state_specs(mstate, mesh)
    reckon = SH.position_bytes(mstate, mspecs, mesh)
    held = [sum(leaf.nbytes(i) for _, leaf in leaves_with_path(state))
            for i in range(mesh.size)]
    if held != reckon:
        raise AssertionError(f"train {what}: positions hold {held} bytes, "
                             f"the specs reckon {reckon}")
    sizes = [t.numel() * t.element_size()
             for _, leaf in leaves_with_path(state)
             for t, _, _ in leaf.copies()]
    distinct = sum(sizes)
    # the caching allocator rounds every block up to 512 bytes
    blocks = sum(-(-n // 512) * 512 for n in sizes)
    if abs(placed_bytes - blocks) > (1 << 20):
        raise AssertionError(f"train {what}: {placed_bytes} bytes allocated "
                             f"for the placed state, {blocks} in the blocks "
                             f"of its distinct copies")
    want = FS.step_traffic(meta, SH.param_specs(meta, mesh), mesh,
                           microbatches=tc.microbatches,
                           compress=tc.compress_grads,
                           grads_bf16=tc.grads_bf16, cfg=cfg, batch=batch)
    split = sorted(FS.split_blocks(cfg, mesh.shape["model"]))
    metrics = telemetry.default().metrics
    before = {k: metrics.value(k) for k in FS.COUNTERS}
    step = TR.make_train_step(cfg, tc, mesh=mesh)
    e0, e1 = torch.cuda.Event(enable_timing=True), \
        torch.cuda.Event(enable_timing=True)
    e0.record()
    state, m = step(state, batch)
    e1.record()
    torch.cuda.synchronize()
    got = {k: metrics.value(k) - before[k] for k in FS.COUNTERS}
    if got != want:
        raise AssertionError(f"train {what}: counted {got}, reckoned {want}")
    ms = e0.elapsed_time(e1)
    peak = torch.cuda.max_memory_allocated() - base
    n = sum(t.numel() for _, t in leaves_with_path(meta))
    reck = train_reckoning(n, tc)
    b, s = TRAIN_BATCH
    out = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
           "lr": float(m["lr"]), "ms": ms, "tokens_per_s": b * s / ms * 1e3,
           "peak": peak, "reckon": reck["total"], "held": held[0],
           "traffic": got}
    log(f"train {what}: tensor-parallel blocks {split}; loss "
        f"{out['loss']:.7g} grad_norm "
        f"{out['grad_norm']:.7g}; {ms:.6g} ms a step ({out['tokens_per_s']:.6g}"
        f" tokens/s); every position holds {held[0]} bytes = the specs' "
        f"reckoning; {distinct} bytes of distinct copies on the card "
        f"({placed_bytes} allocated, {blocks} in 512-byte blocks); "
        f"peak {peak} bytes (max_memory_allocated above the {base} held "
        f"before) against the reckoning {reck['total']} {reck} "
        f"({peak - reck['total']:+d} bytes: gathered layers, activations, "
        f"the loss chunk, temporaries); traffic {got} = step_traffic")
    failed = check(out, state)
    batch2 = token_batch(TokenStreamConfig(cfg.vocab_size, s, b), 1, dev)
    e0.record()
    state, m = step(state, batch2)
    e1.record()
    torch.cuda.synchronize()
    out["ms_warm"] = e0.elapsed_time(e1)
    out["peak"] = max(out["peak"], torch.cuda.max_memory_allocated() - base)
    fsdp_only = FSDP_ONLY.get(what_key)
    whole = WHOLE_VOCAB.get(what_key)
    log(f"train {what}: step 1, warm: loss {float(m['loss']):.7g}, "
        f"{out['ms_warm']:.6g} ms ({b * s / out['ms_warm'] * 1e3:.6g} "
        f"tokens/s); peak over both steps {out['peak']} bytes against the "
        f"reckoning {reck['total']}; weights gathered "
        f"{got['sharding.gathered_bytes']} bytes a step" + (
            f"; the FSDP-only step read {fsdp_only[0]} ms warm and a peak "
            f"of {fsdp_only[1]:.4g} bytes" if fsdp_only else "") + (
            f"; with the vocabulary gathered whole the step read "
            f"{whole[0]} ms warm, a peak of {whole[1]:.4g} bytes and "
            f"{whole[2]:.5g} bytes gathered" if whole else ""))
    vocab_traffic(what, meta, mesh, cfg, batch)
    return out, failed, state


def vocab_traffic(what, meta, mesh, cfg, batch) -> None:
    """Logs the weight bytes ``embed/table`` and ``head/w`` gather and
    reduce a step on ``mesh`` (``fsdp.step_traffic`` of those leaves:
    vocabulary-parallel where ``fsdp.vocab_split``), their activation
    traffic, and the bytes of gathering them whole (WHOLE_VOCAB_LEAVES)."""
    from repro_torch.distributed import fsdp as FS
    from repro_torch.distributed import sharding as SH
    sub = {k: meta[k] for k in ("embed", "head") if k in meta}
    specs = SH.param_specs(sub, mesh)
    t = FS.step_traffic(sub, specs, mesh, cfg=cfg, batch=batch)
    split = sorted(p for p in specs if FS.vocab_split(p, specs[p]))
    whole = WHOLE_VOCAB_LEAVES.get((mesh.shape["data"], mesh.shape[
        "model"])) if cfg.name == TRAIN_LM else None
    log(f"train {what}: vocabulary-parallel leaves {split}; embed/table "
        f"and head/w gather {t['sharding.gathered_bytes']} and reduce "
        f"{t['sharding.reduced_bytes']} bytes a step" + (
            f" (gathered whole: {whole} of each)" if whole else "")
        + "; their activations: "
        + ", ".join(f"{k.split('.', 1)[1]} {t[k]}" for k in FS.TP_COUNTERS))


def hold_to(what, got, ref, bounds, dev, placed_mu) -> list[str]:
    """``got`` (a sharded run) against ``ref`` (an unsharded step): loss,
    grad_norm and mu within ``bounds``; logs every figure, returns the
    failures."""
    worst, far, at = mu_gap(placed_mu, ref["mu"], dev)
    l_r = abs(got["loss"] - ref["loss"]) / abs(ref["loss"])
    n_r = abs(got["grad_norm"] - ref["grad_norm"]) / abs(ref["grad_norm"])
    log(f"train {what}: loss {got['loss']:.8g} / {ref['loss']:.8g} (rtol "
        f"{l_r:.3g}, bound {bounds['loss_rtol']}); grad_norm "
        f"{got['grad_norm']:.8g} / {ref['grad_norm']:.8g} (rtol {n_r:.3g}, "
        f"bound {bounds['norm_rtol']}); mu max abs diff {worst:.3g} of its "
        f"leaf's largest ({at}; bound {bounds['mu']}), {far} elements past "
        f"{MICRO_NEAR} of the value plus {MICRO_NEAR} of the largest")
    if l_r > bounds["loss_rtol"] or worst > bounds["mu"] or \
            n_r > bounds["norm_rtol"]:
        return [what]
    return []


def dryrun_sizes() -> None:
    """gemma2-9b's per-position bytes of its train state on (2, 2), (4, 1)
    and the production mesh, from the specs (the dry run's reckoning):
    148 GB of state cannot run on one card."""
    from repro_torch import configs
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch import dryrun as DR
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import common as C
    from repro_torch.models import model as M
    for name, shapes in TRAIN_SIZES.items():
        cfg = configs.get_config(name)
        meta = M.init_model(C.MetaGenerator(), cfg, device="meta")
        for shape in shapes:
            mesh = make_host_mesh(*shape)
            p = max(SH.position_bytes(meta, SH.param_specs(meta, mesh),
                                      mesh))
            log(f"train {name} on {shape} (FSDP), from the specs: float32 "
                f"params {p} bytes a position, mu + nu {2 * p}, gradient "
                f"accumulators {p}: {4 * p} bytes a position in all")
            if shape == (2, 2) and abs(p - 9.242e9) > 0.001e9:
                raise AssertionError(f"{name} (2, 2): {p} bytes, not 9.242e9")
        rec = DR.run_cell(name, "train_4k")
        log(f"train {name} train_4k on {rec['mesh']} (dry run): "
            f"{rec['bytes_per_position']} bytes a position, "
            f"{rec['bytes_per_position_total']} in all, fits 80 GB "
            f"{rec['fits_hbm']}; step traffic {rec['step_traffic']}")


def phase10_sharded(drv, dev) -> dict:
    """Phase 10: sharded training on meshes of the one card, its deploy,
    the sizes that do not fit."""
    import dataclasses
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.distributed import fsdp as FS
    from repro_torch.distributed import sharding as SH
    b, s = TRAIN_BATCH
    out, failed = {}, []
    micro = {**MICRO_TOL, "mu": MICRO_MU["bfloat16"]}
    for mode in ("float", "binary"):
        cfg = configs.get_config(TRAIN_LM, quant=None if mode == "float"
                                 else mode)
        batch = token_batch(TokenStreamConfig(cfg.vocab_size, s, b), 0, dev)
        tc = train_config(warmup=1)
        shapes = [sh for m, sh in TRAIN_MESHES if m == mode]
        # the float meshes whose step splits a block over 'model': their
        # grad_norm bound at bfloat16, and a second run at float32 (the
        # comment above TRAIN_MESHES)
        tp32 = [sh for sh in shapes if mode == "float"
                and FS.split_blocks(cfg, sh[1])]
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        # the references first, their mu on the host: a second state does
        # not fit beside a sharded one
        refs = {1: unsharded_step(cfg, tc, dev, batch)}
        if (4, 1) in shapes:
            refs[4] = unsharded_step(
                cfg, dataclasses.replace(tc, microbatches=4), dev, batch)
        if tp32:
            refs["float32"] = unsharded_step(cfg32, tc, dev, batch)
        for n, r in refs.items():
            log(f"train sharded {mode}: the unsharded step, "
                + (f"microbatches={n}" if n != "float32"
                   else "float32 activations")
                + f", loss {r['loss']:.8g} grad_norm {r['grad_norm']:.8g}, "
                f"{r['ms']:.6g} ms")
        for shape in shapes:
            what = f"sharded {mode} {shape}"

            def check(got, state, what=what, shape=shape):
                mu = state["opt"]["mu"]
                bounds = dict(micro, norm_rtol=TP_BF16_NORM_RTOL) \
                    if shape in tp32 else micro
                bad = hold_to(f"{what} against the unsharded step", got,
                              refs[1], bounds, dev, mu)
                if shape == (4, 1):
                    bad += hold_to(f"{what} against microbatches=4", got,
                                   refs[4], SAME_ROWS, dev, mu)
                return bad

            got, bad, state = sharded_run(what, cfg, tc, shape, dev, batch,
                                          check, (mode, shape))
            failed += bad
            out[what] = got
            if mode == "binary" and shape == (2, 2):
                state.pop("opt")
                params = SH.unshard(state.pop("params"), dev)
                del state
                free_card()
                out["deploy"] = deploy_trained(drv, cfg, params, dev)
                del params
            else:
                del state
            free_card()
            if shape in tp32:
                what32 = f"{what} float32"

                def check32(got, state, what=what32):
                    return hold_to(f"{what} against the unsharded step",
                                   got, refs["float32"],
                                   {**MICRO_TOL, "mu": MICRO_MU["float32"]},
                                   dev, state["opt"]["mu"])

                got, bad, state = sharded_run(what32, cfg32, tc, shape, dev,
                                              batch, check32)
                failed += bad
                out[what32] = got
                del state
                free_card()
        del refs
    failed += mamba_split_step(dev, out)
    dryrun_sizes()
    if failed:
        raise AssertionError(f"train sharded: {failed} failed (logged above)")
    return out


def mamba_split_step(dev, out) -> list[str]:
    """Mamba-2's split form tensor-parallel on ``MAMBA_TRAIN_MESH``, at
    bfloat16 and again at float32 activations, each held to the
    unsharded step from the same state and batch: loss and grad_norm
    within phase 9's bounds (its bfloat16 ``grad_norm`` read 6.28e-5,
    within 1e-4: the unsharded bfloat16 step sits 6.4e-5 from a float64
    step, the split one 1.4e-6), mu within MAMBA_MU (the comment above
    it).  Returns the failures."""
    import dataclasses
    import time
    from repro_torch import configs
    from repro_torch.data.synthetic import TokenStreamConfig, token_batch
    from repro_torch.distributed import fsdp as FS
    t0 = time.monotonic()
    base = configs.get_config(MAMBA_TRAIN)
    cfg = dataclasses.replace(base, num_layers=MAMBA_TRAIN_LAYERS,
                              ssm=dataclasses.replace(base.ssm,
                                                      fused_proj=False))
    m = MAMBA_TRAIN_MESH[1]
    if FS.split_blocks(cfg, m) != {"ssm"}:
        raise AssertionError(f"{MAMBA_TRAIN}: split blocks "
                             f"{FS.split_blocks(cfg, m)} on {m} positions")
    b, s = TRAIN_BATCH
    batch = token_batch(TokenStreamConfig(cfg.vocab_size, s, b), 0, dev)
    tc = train_config(warmup=1)
    failed = []
    for dtype in ("bfloat16", "float32"):
        bounds = {**MICRO_TOL, "mu": MAMBA_MU[dtype]}
        c = dataclasses.replace(cfg, dtype=dtype)
        ref = unsharded_step(c, tc, dev, batch)
        what = (f"sharded {MAMBA_TRAIN} split form, {MAMBA_TRAIN_LAYERS} "
                f"layers, {dtype} {MAMBA_TRAIN_MESH}")
        log(f"train {what}: the unsharded step, loss {ref['loss']:.8g} "
            f"grad_norm {ref['grad_norm']:.8g}, {ref['ms']:.6g} ms")

        def check(got, state, what=what, ref=ref, bounds=bounds):
            return hold_to(f"{what} against the unsharded step", got, ref,
                           bounds, dev, state["opt"]["mu"])

        got, bad, state = sharded_run(what, c, tc, MAMBA_TRAIN_MESH, dev,
                                      batch, check)
        failed += bad
        out[what] = got
        del state, ref
        free_card()
    log(f"train sharded {MAMBA_TRAIN} split form: "
        f"{time.monotonic() - t0:.1f} s")
    return failed


# ---------------------------------------------------------------------------
# 11. static analysis and launch probes on the card
# ---------------------------------------------------------------------------

ANALYSIS_BATCHES = (1, 8, 32, 256)
HOST_ROUNDS, HOST_CALLS = 61, 50       # the host cost's median and chunk
HOST_ADDED_MAX_US = 5.0    # the most the dispatcher may add to a launch


def analysis_networks(dev) -> dict:
    """``BCNNSpec()`` and ``BMLPSpec()`` from seed 0 as phase 4 makes them
    (random BN, packed on the card), and their inputs at
    ANALYSIS_BATCHES."""
    import torch
    from repro_torch.models import cnn
    gen = torch.Generator().manual_seed(0)
    bspec, mspec = cnn.BCNNSpec(), cnn.BMLPSpec()
    bparams = cnn.init_bcnn(gen, bspec)
    randomize_bn(bparams["conv_bns"] + bparams["dense_bns"], gen)
    mparams = cnn.init_bmlp(gen, mspec)
    randomize_bn(mparams["bns"], gen)
    nets = {"bcnn": cnn.pack_bcnn(bparams, bspec, device=dev),
            "bmlp": cnn.pack_bmlp(mparams, mspec, device=dev)}
    inputs = {kind: {b: torch.randint(
        0, 256, (b, *cnn.packed_input_shape(p)), generator=gen,
        dtype=torch.uint8).to(dev) for b in ANALYSIS_BATCHES}
        for kind, p in nets.items()}
    return nets, inputs


def traced_pair(drv, what, fn, args, policy):
    """``fn(*args)`` traced on fake twins, then run for real on the card
    with the launch counts set to 0 just before and read just after,
    inside a launch recorder: the real launches' order, counts, grids and
    routes, and the packedness report of the real run, must equal the
    fake trace's.  Returns (fake trace, packedness report)."""
    import collections
    import torch
    from repro_torch.analysis import graph, packedness
    from repro_torch.kernels import library as lib
    from repro_torch.kernels import ops
    fake = graph.trace(fn, *args)
    ops.reset_launch_counts()
    with lib.record_launches() as order:
        real = graph.trace(fn, *args, fake=False)
    torch.cuda.synchronize()
    counts = {k: v for k, v in ops.launch_counts().items() if v}
    for k, v in counts.items():
        drv.totals[k] += v
    want = [ln.kernel for ln in fake.launches()]
    if order != want or counts != dict(collections.Counter(want)):
        raise AssertionError(f"{what}: real launches {order} ({counts}), "
                             f"the fake trace's {want}")
    if real.launches() != fake.launches():
        raise AssertionError(f"{what}: real grids and routes "
                             f"{real.launches()}, fake {fake.launches()}")
    rep = packedness.analyze_trace(fake, policy)
    if packedness.analyze_trace(real, policy).to_json() != rep.to_json() \
            or not rep.ok:
        raise AssertionError(f"{what}: packedness of the real run "
                             f"{packedness.analyze_trace(real, policy)}, "
                             f"of the fake trace {rep}")
    return fake, rep


def launch_summary(tr) -> str:
    """``kernel(route) grid`` of each launch, runs of one collapsed."""
    out, prev, n = [], None, 0
    for ln in tr.launches() + [None]:
        key = None if ln is None else f"{ln.kernel}({ln.route}){list(ln.grid)}"
        if key == prev:
            n += 1
            continue
        if prev is not None:
            out.append(prev + (f" x{n}" if n > 1 else ""))
        prev, n = key, 1
    return ", ".join(out)


def smem_rows(traces) -> dict:
    """Every distinct launch of ``traces`` held to its launcher's query
    (grid, threads, dynamic shared memory) and given its instance's
    registers and static shared memory from the ptxas report; by kernel,
    the instances seen."""
    from repro_torch.analysis import smem
    seen, rows = set(), {}
    for tr in traces:
        for op in tr.ops:
            est = op.estimate
            if est is None or (est.kernel, est.query) in seen:
                continue
            seen.add((est.kernel, est.query))
            full = smem.check_against_card(est)
            if not full.fits():
                raise AssertionError(f"over a block's budget on the card:\n"
                                     f"{full.breakdown()}")
            key = (full.route, full.threads, full.dynamic,
                   full.static_smem, full.registers)
            rows.setdefault(full.kernel, {})[key] = \
                rows.get(full.kernel, {}).get(key, 0) + 1
    return rows


def host_cases(nets, lm, dev) -> dict:
    """One launch of each kernel at a batch-1 shape of its path: the op's
    arguments, and the wrapper's direct call on the same tensors with its
    keywords bound beforehand."""
    import functools
    import torch
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_attention as batt
    from repro_torch.kernels import binary_conv as bconv
    from repro_torch.kernels import binary_matmul as bmm
    from repro_torch.kernels import bitpack as bp
    from repro_torch.kernels import fused_epilogue as fe
    from repro_torch.kernels import library as lib
    from repro_torch.kernels import ops
    P = functools.partial
    gen = torch.Generator().manual_seed(11)
    bmlp, bcnn = nets["bmlp"], nets["bcnn"]
    l0, l1, l2 = bmlp["layers"][:3]
    f0, f1, f2 = bmlp["folded"][:3]
    planes = torch.where(torch.rand((8, 784), generator=gen) < 0.5, 1.0,
                         -1.0).to(dev)
    a0 = ops.bitpack(planes)
    h = B.pack_bits(torch.rand((1, 4096), generator=gen) * 2 - 1).to(dev)
    z = torch.randint(-900, 900, (1, 4096), generator=gen,
                      dtype=torch.int32).to(dev)
    ws = [l1["w_packed"], l2["w_packed"]]
    taus, flips = [f1["tau"], f2["tau"]], [f1["flip"], f2["flip"]]
    cases = {
        "bitpack": ((planes,), P(bp.bitpack, planes)),
        "xnor_gemm": ((a0, l0["w_packed"], 784), P(
            bmm.binary_matmul_packed, a0, l0["w_packed"], k_true=784)),
        "bn_sign_pack": ((z, f0["tau"], f0["flip"]),
                         P(fe.bn_sign_pack, z, f0["tau"], f0["flip"])),
        "xnor_gemm_bn_sign": (
            (h, l1["w_packed"], f1["tau"], f1["flip"], 4096),
            P(bmm.binary_matmul_bn_sign_packed, h, l1["w_packed"],
              f1["tau"], f1["flip"], k_true=4096)),
        "dense_stack": ((h, [*ws, *taus, *flips], [4096, 4096]),
                        P(bmm.binary_dense_stack_packed, h, ws, taus, flips,
                          k_trues=[4096, 4096])),
    }
    p1, fold1 = bcnn["convs"][1], bcnn["folded_conv"][1]
    x1 = B.pack_bits(torch.rand((1, 32, 32, 128), generator=gen) * 2 - 1
                     ).to(dev)
    g1 = lib.conv_geom(p1)
    cases["conv_bn_sign"] = (
        (x1, p1["w_packed"], p1["correction"], fold1["tau"], fold1["flip"],
         g1), P(bconv.binary_conv2d_bn_sign_packed, x1, p1["w_packed"],
                p1["correction"], fold1["tau"], fold1["flip"],
                **lib.geom_kwargs(g1)))
    cases["binary_conv"] = (
        (x1, p1["w_packed"], p1["correction"], g1),
        P(bconv.binary_conv2d_packed, x1, p1["w_packed"], p1["correction"],
          **lib.geom_kwargs(g1)))
    p0, fold0 = bcnn["convs"][0], bcnn["folded_conv"][0]
    x0 = torch.randint(0, 256, (1, 32, 32, 3), generator=gen,
                       dtype=torch.uint8).to(dev)
    g0 = [*lib.conv_geom(p0), 8]
    cases["bitplane_conv_bn_sign"] = (
        (x0, p0["w_packed"], p0["rowsum"], fold0["tau"], fold0["flip"], g0),
        P(bconv.bitplane_conv2d_bn_sign_packed, x0, p0["w_packed"],
          p0["rowsum"], fold0["tau"], fold0["flip"], nbits=8,
          **lib.geom_kwargs(g0)))
    cases["bitplane_conv"] = (
        (x0, p0["w_packed"], p0["rowsum"], g0),
        P(bconv.bitplane_conv2d_packed, x0, p0["w_packed"], p0["rowsum"],
          nbits=8, **lib.geom_kwargs(g0)))
    meta = lm["meta"]
    hq, hkv, hd = meta["num_heads"], meta["num_kv_heads"], meta["head_dim"]
    q = B.pack_bits(torch.rand((1, 16, hq, hd), generator=gen) * 2 - 1
                    ).to(dev)
    k = B.pack_bits(torch.rand((1, 16, hkv, hd), generator=gen) * 2 - 1
                    ).to(dev)
    v = torch.randn((1, 16, hkv, hd), generator=gen).to(dev)
    window, cap = meta["window_size"], meta["attn_softcap"]
    cases["binary_attention"] = (
        (q, k, v, hd, True, window, cap, 0),
        P(batt.binary_attention_packed, q, k, v, d_true=hd, causal=True,
          window=window, attn_softcap=cap, q_offset=0))
    return cases


def host_cost(cases) -> dict:
    """Per kernel, µs a call on the host, each the median over HOST_ROUNDS
    chunks of HOST_CALLS calls with the garbage collector off (as
    ``timeit``), the card synchronized between chunks, the variants in
    turns within a round: the ``ops`` dispatcher's launch
    (``ops._launch``, the kernel's CUDA body outside a trace), the wrapper
    called directly on the same inputs, and the kernel's op (the path a
    trace takes); what the dispatcher and the op add is the median of
    each round's difference to the direct call.  The dispatcher's output
    equals the direct call's bit for bit (every kernel, K8 too, computes
    in a fixed order)."""
    import functools
    import gc
    import statistics
    import torch
    from repro_torch.kernels import library as lib
    from repro_torch.kernels import ops
    out = {}
    for name, (args, direct) in cases.items():
        runs = {"dispatcher": functools.partial(ops._launch, name, *args),
                "direct": direct,
                "op": functools.partial(lib.OPS[name], *args)}
        check_equal(f"host cost {name}: the op against the direct call",
                    runs["dispatcher"](), direct())
        per = {k: [] for k in runs}
        gc.disable()
        try:
            for r in range(HOST_ROUNDS):
                order = list(runs) if r % 2 else list(runs)[::-1]
                for which in order:
                    fn = runs[which]
                    torch.cuda.synchronize()
                    t0 = time.perf_counter()
                    for _ in range(HOST_CALLS):
                        fn()
                    per[which].append((time.perf_counter() - t0) * 1e6 /
                                      HOST_CALLS)
                    torch.cuda.synchronize()
        finally:
            gc.enable()
        med = {k: statistics.median(v) for k, v in per.items()}
        out[name] = {**{f"{k}_us": v for k, v in med.items()},
                     "added_us": statistics.median(
                         d - b for d, b in zip(per["dispatcher"],
                                               per["direct"])),
                     "op_added_us": statistics.median(
                         o - b for o, b in zip(per["op"], per["direct"]))}
    return out


def check_collectives(nets, inputs, dev) -> list:
    """Phase 7's sharded forwards at batch 8 on every mesh of
    SHARD_MESHES in both modes through the collective rules
    (``analysis.collectives.check_mesh``), the gathers also held to the
    plan's (``verify_sharded.expected_gathers``)."""
    from repro_torch.analysis import collectives as col
    from repro_torch.distributed import sharding as sh
    from repro_torch.distributed import verify_sharded as vs
    from repro_torch.launch.mesh import make_host_mesh
    seen = []
    for kind, packed in nets.items():
        for shape in SHARD_MESHES:
            mesh = make_host_mesh(*shape)
            for mode in MODES:
                fwd = sh.make_sharded_forward(packed, mesh, dense_stack=mode)
                _, got = col.count_collectives(
                    fwd.forward_int, inputs[kind][8], positions=mesh.size)
                rep = col.check_mesh(got, shape)
                n, nbytes = vs.expected_gathers(packed, fwd.shard_plan,
                                                mesh, 8)
                if not rep.ok or got.kinds.get("all-gather", 0) != n or \
                        got.bytes_by_kind.get("all-gather", 0) * mesh.size \
                        != nbytes:
                    raise AssertionError(f"collectives {kind} {shape} "
                                         f"{mode}: {rep} against {n}, "
                                         f"{nbytes}")
                seen.append((kind, shape, mode, rep.kinds, rep.total_bytes))
    return seen


def run_cli(module) -> str:
    """``python -m <module> --check`` from the root; raises unless it
    exits 0; returns its last line."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run([sys.executable, "-m", module, "--check"],
                          capture_output=True, text=True, env=env, cwd=ROOT,
                          timeout=300)
    if proc.returncode != 0:
        raise AssertionError(f"python -m {module} --check exited "
                             f"{proc.returncode}:\n{proc.stdout}\n"
                             f"{proc.stderr}")
    return proc.stdout.strip().splitlines()[-1]


def phase11_analysis(drv, dev) -> dict:
    """Phase 11: the fake trace of every forward against its real launches
    (order, counts, grids, routes, packedness), every launch's
    shared-memory estimate against its launcher's query with registers and
    static shared memory from ptxas, a seeded over-budget launch refused
    before anything launches, the collective rules on phase 7's meshes,
    both ``--check`` CLIs, and the host cost the dispatcher adds to a
    launch (at most HOST_ADDED_MAX_US)."""
    import torch
    from repro_torch import configs
    from repro_torch.analysis import graph, smem
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_conv as bconv
    from repro_torch.kernels import ops
    from repro_torch.models import cnn
    t0 = time.perf_counter()
    nets, inputs = analysis_networks(dev)
    traces, summary = [], {}
    for kind, packed in nets.items():
        for mode in MODES:
            for b in ANALYSIS_BATCHES:
                what = f"{kind} {mode} B={b}"
                tr, rep = traced_pair(
                    drv, what, lambda p, x: cnn.make_packed_forward(
                        p, dense_stack=mode)(x), (packed, inputs[kind][b]),
                    "strict")
                traces.append(tr)
                big = max(graph.intermediates(tr),
                          key=lambda vi: vi[0].nbytes)[0]
                summary[what] = {
                    "launches": len(tr.launches()),
                    "max_intermediate": [big.nbytes, list(big.shape)],
                    "max_live_unpacked": rep.max_live_unpacked_bytes}
                log(f"analysis {what}: {launch_summary(tr)}; largest "
                    f"intermediate {big.nbytes} B {list(big.shape)}; "
                    f"unpacked live at most {rep.max_live_unpacked_bytes} B "
                    f"{list(rep.max_unpacked_shape)}; no escape")
    spec, lm = lm_model(dev, torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    for b, s in LM_SERVE:
        what = f"lm {spec.name} {(b, s)}"
        tokens = torch.randint(0, spec.vocab_size, (b, s), generator=gen,
                               dtype=torch.int32).to(dev)
        tr, rep = traced_pair(drv, what, lambda p, x: cnn.make_packed_forward(
            p)(x), (lm, tokens), "float-residual")
        traces.append(tr)
        big = max(graph.intermediates(tr), key=lambda vi: vi[0].nbytes)[0]
        summary[what] = {"launches": len(tr.launches()),
                         "max_intermediate": [big.nbytes, list(big.shape)],
                         "max_live_unpacked": rep.max_live_unpacked_bytes}
        counts = {}
        for ln in tr.launches():
            counts[ln.kernel] = counts.get(ln.kernel, 0) + 1
        log(f"analysis {what}: {len(tr.launches())} launches {counts}, "
            f"real order equal; largest intermediate {big.nbytes} B "
            f"{list(big.shape)}; unpacked live at most "
            f"{rep.max_live_unpacked_bytes} B; no escape")
    rows = smem_rows(traces)
    for kernel, seen in sorted(rows.items()):
        log(f"smem {kernel}: " + "; ".join(
            f"{route} {threads} threads, {dyn} B dynamic + {static} B "
            f"static of {smem.SMEM_BUDGET}, {regs} registers "
            f"({regs * threads} of {smem.REGS_PER_SM}) x{n}"
            for (route, threads, dyn, static, regs), n in sorted(
                seen.items())))
    log(f"smem: {sum(len(v) for v in rows.values())} distinct launches, "
        f"each estimate equal to its launcher's query; registers and "
        f"static shared memory from ptxas, equal to the runtime's")

    # a seeded over-budget launch of K6 and of K1: refused by its
    # launcher, nothing counted
    g = torch.Generator().manual_seed(577)
    wide = [{"w_packed": B.pack_bits(torch.rand((577 * 32, 32),
                                                generator=g) - 0.5).to(dev),
             "k_true": 32, "tau": torch.zeros(577 * 32, device=dev),
             "flip": torch.ones(577 * 32, device=dev)}]
    plan = {k: v.to(dev) if isinstance(v, torch.Tensor) else v
            for k, v in bconv.make_bitplane_conv_plan(
                torch.ones(8, 3, 3, 1024), input_hw=(3, 2048),
                padding="VALID", nbits=8).items()}
    ops.reset_launch_counts()
    refused = []
    for what, run in (
            ("K6, 577-word rows", lambda: ops.binary_dense_stack_packed(
                wide, B.pack_bits(torch.rand((4, 32), generator=g) - 0.5
                                  ).to(dev), resident=True)),
            ("K1, a (3, 2048) band of 1024 channels",
             lambda: ops.bitplane_conv2d_packed(plan, torch.zeros(
                 (1, 3, 2048, 1024), dtype=torch.uint8, device=dev)))):
        try:
            run()
        except smem.SmemBudgetError as e:
            refused.append(f"{what}: {e.estimate.total} B")
        else:
            raise AssertionError(f"seeded over-budget launch ran: {what}")
    torch.cuda.synchronize()
    if any(ops.launch_counts().values()):
        raise AssertionError(f"a refused launch was counted: "
                             f"{ops.launch_counts()}")
    log(f"over budget: refused by the launchers before launching, no "
        f"launch counted: {refused}")

    sharded = check_collectives(nets, inputs, dev)
    log(f"collectives: {len(sharded)} sharded forwards pass check_mesh "
        f"(data meshes silent, model meshes all-gathers only), gathers "
        f"and bytes as planned: " + "; ".join(
            f"{k} {s} {m} {kinds} {b:.0f} B/device"
            for k, s, m, kinds, b in sharded if m == "auto"))
    for module in ("repro_torch.analysis", "repro_torch.telemetry.probes"):
        log(f"cli python -m {module} --check: {run_cli(module)}")
    cost = host_cost(host_cases(nets, lm, dev))
    log("host cost a launch, µs (medians, GC off): the ops dispatcher "
        "against the wrapper called directly, added; the op (a trace's "
        "path) added: " + "; ".join(
            f"{k} {v['dispatcher_us']:.4g} vs {v['direct_us']:.4g} "
            f"(+{v['added_us']:.3g}); op +{v['op_added_us']:.3g}"
            for k, v in cost.items()))
    over = {k: v["added_us"] for k, v in cost.items()
            if v["added_us"] > HOST_ADDED_MAX_US}
    if over:
        raise AssertionError(f"the ops dispatcher adds more than "
                             f"{HOST_ADDED_MAX_US} µs a launch: {over}")
    del lm
    log(f"analysis: {time.perf_counter() - t0:.1f} s")
    return {"cells": summary, "host_cost_us": cost}


# ---------------------------------------------------------------------------
# 12. the examples on the card
# ---------------------------------------------------------------------------

# (module, argv, launches): the reference's default flags; the launches
# of one run on the card (the STE training runs plain tensor ops, the
# binary-weight LM the unpack route)
EXAMPLES = (
    ("quickstart", [], {"bitpack": 2, "xnor_gemm": 1}),
    ("bitplane_first_layer", [],
     {"bitpack": 1, "xnor_gemm": 1, "bitplane_conv": 1}),
    ("train_binary_mlp", [],
     {"bitpack": 1, "xnor_gemm": 2, "bn_sign_pack": 1, "dense_stack": 1}),
    ("serve_binary_lm", [], {}))


def phase12_examples(drv) -> dict:
    """Phase 12: each example's ``main`` on the card through
    ``Driver.run`` (its launches checked and counted), its output logged; every one
    must return 0."""
    import importlib
    import io
    out = {}
    for name, argv, expect in EXAMPLES:
        mod = importlib.import_module(f"repro_torch.examples.{name}")
        buf = io.StringIO()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(buf):
            rc = drv.run(f"example {name}", lambda: mod.main(argv), expect)
        out[name] = time.perf_counter() - t0
        for line in buf.getvalue().splitlines():
            log(f"example {name}: {line}")
        if rc != 0:
            raise AssertionError(f"example {name} returned {rc}")
        log(f"example {name}: returned 0 in {out[name]:.2f} s, launches "
            f"{expect or 'none'}")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import binary_matmul as bmm
    from repro_torch.kernels import ops
    from repro_torch.models import cnn

    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    dev = torch.device("cuda", 0)
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    clock_mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm",
         "--format=csv,noheader,nounits"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    rates = {"popc": POPC_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6}
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}"
        f"; {sms} SMs at max {clock_mhz:.0f} MHz -> POPC peak "
        f"{rates['popc']:.4g}/s")
    log(f"nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in _build.ptxas_report().items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line or \
                    "spill" in line:
                log(f"  ptxas {src}: {line.split('ptxas info    :')[-1].strip()}")
            if src in SPILL_FREE and "spill" in line and \
                    "0 bytes spill stores, 0 bytes spill loads" not in line:
                raise AssertionError(f"ptxas reports spills in {src}: "
                                     f"{line.strip()}")

    rates.update(mma_peaks(dev, sms))

    # the networks, the layer operands and every path's inputs
    gen = torch.Generator().manual_seed(0)
    bspec = cnn.BCNNSpec()
    bparams = cnn.init_bcnn(gen, bspec)
    randomize_bn(bparams["conv_bns"] + bparams["dense_bns"], gen)
    bcnn = cnn.pack_bcnn(bparams, bspec)          # on the card
    mspec = cnn.BMLPSpec()
    mparams = cnn.init_bmlp(gen, mspec)
    randomize_bn(mparams["bns"], gen)
    bmlp = cnn.pack_bmlp(mparams, mspec)          # on the card
    bcnn_in = {b: torch.randint(0, 256, (b, *bspec.input_hw, bspec.c_in),
                                generator=gen, dtype=torch.uint8)
               for b in BATCHES}
    bmlp_in = {b: torch.randint(0, 256, (b, mspec.sizes[0]), generator=gen,
                                dtype=torch.uint8) for b in BATCHES}
    mm_a = torch.randn((MATMUL_SIZE, MATMUL_SIZE), generator=gen).to(dev)
    mm_b = torch.randn((MATMUL_SIZE, MATMUL_SIZE), generator=gen).to(dev)
    t3 = TABLE3_LAYER
    conv_w = (torch.rand((t3["c_out"], 3, 3, t3["c_in"]), generator=gen)
              * 2 - 1)
    conv_x = {b: torch.randn((b, *t3["hw"], t3["c_in"]), generator=gen
                             ).to(dev) for b in (1, 256)}

    # 3. kernels against their plain versions
    for mode in MODES:
        check_calls(f"bcnn {mode} B=8",
                    bcnn_calls(bcnn, bcnn_in[8].to(dev), mode))
        check_calls(f"bmlp {mode} B=8",
                    bmlp_calls(bmlp, bmlp_in[8].to(dev), mode))
    check_calls("bcnn first stage unfused B=8",
                stage0_calls(bcnn, bcnn_in[8].to(dev)))
    log("kernels: full-width BCNN and BMLP shapes at batch 8 bit-exact in "
        "both dense-stack modes (BCNN: K1-fused, K3 x5, dense_stack or "
        "K4-fused x2, K4; BMLP: bitpack, K4, K2, dense_stack or K4-fused "
        "x2, K4), and the BCNN's first stage as K1 and K2")
    check_calls(f"binary_matmul {MATMUL_SIZE}^2", matmul_calls(mm_a, mm_b))
    log(f"kernels: ops.binary_matmul at {MATMUL_SIZE}x{MATMUL_SIZE} "
        f"bit-exact (bitpack on both operands; K4 against the plain version "
        f"and against the ±1 float32 torch.matmul, TF32 off)")
    for b, x in conv_x.items():
        check_calls(f"binary_conv2d B={b}", conv_calls(x, conv_w))
    log("kernels: ops.binary_conv2d on the Table-3 layer at batch 1 and 256 "
        "bit-exact (bitpack; K7 against the plain version and against "
        "torch._int_mm on the zero-padded ±1 int8 im2col)")
    for what in ragged_checks(gen, dev):
        log(f"kernels: {what} bit-exact")
    attention = attention_cases(gen, dev)
    for what, call in attention.items():
        check_calls(f"attention {what}", [call])
        log(f"kernels: binary_attention {what} within {ATTN_TOL} of its "
            f"plain version" + (" (and SDPA within 1e-4)"
                                if call.library else ""))
    stack_bytes = {
        "bcnn": bmm.dense_stack_bytes(
            [p["w_packed"] for p in bcnn["denses"][:-1]]),
        "bmlp": bmm.dense_stack_bytes(
            [p["w_packed"] for p in bmlp["layers"][1:-1]])}
    log(f"dense_stack rule: hidden stacks of {stack_bytes} bytes against "
        f"the {bmm.STACK_L2_BUDGET_BYTES}-byte L2 budget: 'auto' runs "
        f"the single launch for both")

    # 4. the main paths
    drv = Driver()
    n_conv = len(bspec.stages) - 1
    stage0 = ({"bitplane_conv": 1, "bn_sign_pack": 1}
              if bspec.stages[0].pool else {"bitplane_conv_bn_sign": 1})
    bcnn_expect = {
        "auto": {**stage0, "conv_bn_sign": n_conv, "dense_stack": 1,
                 "xnor_gemm": 1},
        "per_layer": {**stage0, "conv_bn_sign": n_conv,
                      "xnor_gemm_bn_sign": len(bspec.dense) - 1,
                      "xnor_gemm": 1}}
    bmlp_expect = {
        "auto": {"bitpack": 1, "xnor_gemm": 2, "bn_sign_pack": 1,
                 "dense_stack": 1},
        "per_layer": {"bitpack": 1, "xnor_gemm": 2, "bn_sign_pack": 1,
                      "xnor_gemm_bn_sign": len(mspec.sizes) - 3}}
    bcnn_logits = network_path(drv, "bcnn", bcnn, bcnn_in,
                               cnn.bcnn_forward_packed_int, bcnn_expect)
    check_float_reference("bcnn", bcnn_logits, cnn.bcnn_forward_float(
        cnn.to_device(bparams, dev), bcnn_in[8].to(dev), bspec))
    bmlp_logits = network_path(drv, "bmlp", bmlp, bmlp_in,
                               cnn.bmlp_forward_packed_int, bmlp_expect)
    check_float_reference("bmlp", bmlp_logits, cnn.bmlp_forward_float(
        cnn.to_device(mparams, dev), bmlp_in[8].to(dev)))
    mm = drv.run("binary_matmul", lambda: ops.binary_matmul(mm_a, mm_b),
                 {"bitpack": 2, "xnor_gemm": 1})
    check_equal("binary_matmul against the ±1 float32 torch.matmul", mm,
                torch.matmul(torch.where(mm_a >= 0, 1.0, -1.0),
                             torch.where(mm_b >= 0, 1.0, -1.0).T)
                .round().to(torch.int32))
    for b, x in conv_x.items():
        y = drv.run(f"binary_conv2d B={b}",
                    lambda: ops.binary_conv2d(x, conv_w.to(dev)),
                    {"bitpack": 1, "binary_conv": 1})
        check_equal(f"binary_conv2d B={b}", y, ops.binary_conv2d(
            x, conv_w.to(dev), backend="torch"))
    stage0_path(drv, bcnn, bcnn_in, dev)
    log(f"main path layer entry points: ops.binary_matmul {MATMUL_SIZE}^2 "
        f"(bitpack x2, K4 x1), ops.binary_conv2d Table-3 layer at batch 1 "
        f"and 256 (bitpack x1, K7 x1), ops.bitplane_conv2d_packed + "
        f"ops.bn_sign_pack at the BCNN's first stage at batch 1 and 256 "
        f"(K1 x1, K2 x1), equal to the plain path and to K1-fused")
    lm_spec, lm = lm_model(dev, gen)
    lm_tokens = lm_path(drv, lm_spec, lm, gen, dev)
    launches = drv.totals
    log(f"main paths: launches in all {launches}")
    missing = [k for k in SOURCES if launches[k] == 0]
    if missing:
        raise AssertionError(f"kernels never launched on the main paths: "
                             f"{missing}")

    # 5. times
    rows = {}
    for b in (1, 256):
        plain_reps = 2 if b > 1 else 5
        for what, calls in (
                ("bcnn auto", bcnn_calls(bcnn, bcnn_in[b].to(dev), "auto")),
                ("bcnn per_layer", [c for c in bcnn_calls(
                    bcnn, bcnn_in[b].to(dev), "per_layer")
                    if c.name == "xnor_gemm_bn_sign"]),
                ("bmlp auto", bmlp_calls(bmlp, bmlp_in[b].to(dev), "auto")),
                ("bmlp per_layer", [c for c in bmlp_calls(
                    bmlp, bmlp_in[b].to(dev), "per_layer")
                    if c.name == "xnor_gemm_bn_sign"]),
                ("binary_conv2d", conv_calls(conv_x[b], conv_w)),
                ("bitplane_conv2d", stage0_calls(bcnn,
                                                 bcnn_in[b].to(dev)))):
            rows[what, b] = kernel_table(calls, rates, kernel_reps=20,
                                         plain_reps=plain_reps)
            log_table(f"{what} B={b}", rows[what, b])
    mm_rows = kernel_table(matmul_calls(mm_a, mm_b), rates,
                           kernel_reps=3, plain_reps=1)
    log_table(f"binary_matmul {MATMUL_SIZE}^2", mm_rows)
    time_forwards("bcnn", bcnn, bcnn_in)
    time_forwards("bmlp", bmlp, bmlp_in)
    time_dense_stack("bcnn", functools.partial(bcnn_calls, bcnn), bcnn_in,
                     rates, dev)
    time_dense_stack("bmlp", functools.partial(bmlp_calls, bmlp), bmlp_in,
                     rates, dev)
    for what, packed, x, fwd in (
            ("bcnn", bcnn, bcnn_in[256], cnn.bcnn_forward_packed),
            ("bmlp", bmlp, bmlp_in[256], cnn.bmlp_forward_packed)):
        xd = x.to(dev)
        plain_fwd_ms = time_ms(lambda: fwd(packed, xd, backend="torch"),
                               reps=1)
        log(f"forward {what} B=256 on the plain versions: {plain_fwd_ms:.5g} "
            f"ms")
    for what, call in attention.items():
        if "(" not in what:         # the ragged cases are not timed
            continue
        big = str(LM_PREFILL) in what
        rows["attention " + what, 1] = kernel_table(
            [call], rates, kernel_reps=5 if big else 20,
            plain_reps=1 if big else 3)
        log_table(f"attention {what}", rows["attention " + what, 1])
    time_lm(lm, lm_tokens, rates, dev)
    time_route_edge(gen, dev)

    # 6. serving
    for kind, params, spec in (("bcnn", bparams, bspec),
                               ("bmlp", mparams, mspec)):
        serve_network(kind, params, spec, gen, dev)
    serve_lm(lm_spec, lm, gen, dev)

    # 7. the sharded forwards, the mesh server, the chaos drill, checkpoints
    n_hidden = {"bcnn": len(bspec.dense) - 1, "bmlp": len(mspec.sizes) - 3}
    for what, packed, inputs, forward_int, expect, logits in (
            ("bcnn", bcnn, bcnn_in, cnn.bcnn_forward_packed_int,
             bcnn_expect, bcnn_logits),
            ("bmlp", bmlp, bmlp_in, cnn.bmlp_forward_packed_int,
             bmlp_expect, bmlp_logits)):
        sharded_path(drv, what, packed, inputs, forward_int, expect,
                     n_hidden[what], logits, dev)
    for kind, params, spec in (("bcnn", bparams, bspec),
                               ("bmlp", mparams, mspec)):
        serve_mesh(kind, params, spec, gen, dev)
    chaos_drill(bparams, bspec, dev)
    checkpoint_times("bcnn", bcnn, dev)
    checkpoint_times("bmlp", bmlp, dev)

    # 8. the model zoo: gemma2-9b served at full width, two published
    # widths, every reduced config and mode, the packed LM on each
    del lm, lm_tokens
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    zoo_full_lm(drv, dev, rates)
    zoo_published(drv, dev)
    zoo_reduced(drv, dev)
    log(f"zoo: {time.perf_counter() - t0:.1f} s; launches in all, phases "
        f"4-8 {launches}")

    # 9. training: starcoder2-3b at full width and depth, its deploy
    free_card()
    log(f"train: {torch.cuda.memory_allocated()} bytes held on the card "
        f"from phases 1-8")
    t0 = time.perf_counter()
    phase9_training(drv, dev)
    log(f"train: {time.perf_counter() - t0:.1f} s; launches in all, phases "
        f"4-9 {launches}")

    # 10. sharded training: starcoder2-3b on (2, 2), (4, 1) and (1, 4)
    # meshes of the one card, tensor-parallel over 'model', its deploy
    free_card()
    t0 = time.perf_counter()
    phase10_sharded(drv, dev)
    log(f"train sharded: {time.perf_counter() - t0:.1f} s; launches in "
        f"all, phases 4-10 {launches}")

    # 11. static analysis and launch probes: fake traces against the real
    # launches, shared memory against the launchers, the host cost
    free_card()
    phase11_analysis(drv, dev)
    log(f"analysis: launches in all, phases 4-11 {launches}")

    # 12. the examples
    phase12_examples(drv)
    log(f"examples: launches in all, phases 4-12 {launches}")
    log(f"chip_smoke: {time.perf_counter() - t_start:.1f} s in all")

    kernels = []
    for k, (source, replaces, home) in SOURCES.items():
        batch = 256 if (home, 256) in rows else 1
        r = rows[home, batch][k]
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
            "bound_by": r["bound_by"], "library_ms": r["library_ms"],
            "ops_route": r["ops_route"],
            "path": home, "batch": batch,
            "launches_per_forward": r["launches_per_forward"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
