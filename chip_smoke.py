#!/usr/bin/env python3
"""Drive the port's packed BCNN forward on one CUDA card and check it.

    python3 chip_smoke.py            # from the repository root

Phases, each printing its lines:

1. device: the card's name and power limit (``nvidia-smi``);
2. build: every CUDA kernel of ``src/repro_torch/csrc``, one ``nvcc``
   per source in parallel, with the ptxas register/shared-memory report;
3. kernels: each kernel against its plain PyTorch version on the card,
   bit-exact, at the full-width BCNN shapes (batch 8) and on ragged cases;
4. main path: the paper's ``BCNNSpec()`` with random weights and BN from
   seed 0, packed on the card and served through ``make_packed_forward``
   at batches 1, 8, 64 and 256; launch counts per forward; int32 pre-BN
   outputs and logits against the plain path; logits against the float
   reference at batch 8;
5. times (CUDA events): every kernel at batches 1 and 256 beside its
   plain version, its bound and a library call, and the forward per
   batch, fed from host memory as a request arrives and from the card.

The line before the last is the JSON list of kernels; the last line is
``{"ok": true, "device": {...}}``.  Any failed check raises, and the
script exits non-zero without that line.
"""
from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time


ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(ROOT, "src"))

HBM_BYTES_PER_S = 3.35e12      # H100 SXM memory rate
# CUDA C++ Programming Guide, arithmetic instruction throughput table:
# 32-bit population count, 16 results per clock per SM at compute
# capability 9.0.  XOR and ADD (64 per clock) never bind before it.
POPC_PER_CLOCK_PER_SM = 16

SOURCES = {
    "bitplane_conv": ("src/repro_torch/csrc/bitplane_conv.cu",
                      "src/repro/kernels/binary_conv.py:277"),
    "bn_sign_pack": ("src/repro_torch/csrc/bn_sign_pack.cu",
                     "src/repro/kernels/fused_epilogue.py:96"),
    "conv_bn_sign": ("src/repro_torch/csrc/conv_bn_sign.cu",
                     "src/repro/kernels/binary_conv.py:257"),
    "xnor_gemm": ("src/repro_torch/csrc/xnor_gemm.cu",
                  "src/repro/kernels/binary_matmul.py:120"),
    "xnor_gemm_bn_sign": ("src/repro_torch/csrc/xnor_gemm.cu",
                          "src/repro/kernels/binary_matmul.py:137"),
}


def log(*parts) -> None:
    print(*parts, flush=True)


class Call:
    """One kernel call of the main path: the kernel, its plain version on
    the same inputs, the work it must do and an optional library call.

    ``library_as`` maps the library call's output onto the kernel's, where
    the library computes the kernel's whole function; it is None where
    the library computes only the contraction (no fused epilogue)."""

    def __init__(self, name, kernel, plain, nbytes, word_ops, library=None,
                 library_as=None):
        self.name, self.kernel, self.plain = name, kernel, plain
        self.nbytes, self.word_ops, self.library = nbytes, word_ops, library
        self.library_as = library_as


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def main_path_calls(packed, x):
    """Walk the packed forward stage by stage with the plain versions and
    return every kernel call it makes, in order, on the inputs the main
    path gives it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import binarize as B
    from repro_torch.core import binary_layers as L
    from repro_torch.kernels import binary_conv as bconv
    from repro_torch.kernels import binary_matmul as bmm
    from repro_torch.kernels import fused_epilogue as fe
    from repro_torch.kernels import ref

    spec = packed["spec"]
    bsz = x.shape[0]
    calls = []

    pc = packed["convs"][0]
    geom = dict(kh=pc["kh"], kw=pc["kw"], stride=pc["stride"],
                pads=pc["pads"], c_out=pc["c_out"], k_true=pc["k_true"])
    planes = B.pack_bitplanes_uint8(x, pc["nbits"])
    oh, ow = pc["out_hw"]
    out_bytes = bsz * oh * ow * pc["c_out"] * 4
    xf = x.permute(0, 3, 1, 2).float()
    wf = B.unpack_bits(pc["w_packed"].reshape(pc["c_out"], pc["kh"] * pc["kw"],
                                              pc["cw"]), pc["c_in"])
    wf = wf.reshape(pc["c_out"], pc["kh"], pc["kw"], pc["c_in"]).permute(
        0, 3, 1, 2).contiguous()
    (pt, pb), (pl, pr) = pc["pads"]
    calls.append(Call(
        "bitplane_conv",
        functools.partial(bconv.bitplane_conv2d_packed, planes,
                          pc["w_packed"], pc["rowsum"], out_hw=pc["out_hw"],
                          nbits=pc["nbits"], **geom),
        functools.partial(ref.bitplane_conv2d_planes_ref, planes,
                          pc["w_packed"], pc["rowsum"], nbits=pc["nbits"],
                          **geom),
        _nbytes(planes, pc["w_packed"], pc["rowsum"]) + out_bytes,
        bsz * oh * ow * pc["c_out"] * pc["kh"] * pc["kw"] * pc["cw"]
        * pc["nbits"],
        functools.partial(F.conv2d, F.pad(xf, (pl, pr, pt, pb)), wf,
                          stride=pc["stride"]),
        lambda y: y.permute(0, 2, 3, 1).round().to(torch.int32)))
    z = calls[-1].plain()
    if spec.stages[0].pool:
        z = L.maxpool2d(z)
    z2 = z.reshape(-1, z.shape[-1]).contiguous()
    fc = packed["folded_conv"][0]
    calls.append(Call(
        "bn_sign_pack",
        functools.partial(fe.bn_sign_pack, z2, fc["tau"], fc["flip"]),
        functools.partial(ref.bn_sign_pack_ref, z2, fc["tau"], fc["flip"]),
        _nbytes(z2, fc["tau"], fc["flip"])
        + z2.shape[0] * B.packed_width(z2.shape[1]) * 4, 0))
    hp = calls[-1].plain().reshape(*z.shape[:-1], -1)

    for i in range(1, len(packed["convs"])):
        pc, fc = packed["convs"][i], packed["folded_conv"][i]
        geom = dict(kh=pc["kh"], kw=pc["kw"], stride=pc["stride"],
                    pads=pc["pads"], c_out=pc["c_out"], k_true=pc["k_true"])
        oh, ow = pc["out_hw"]
        args = (hp, pc["w_packed"], pc["correction"], fc["tau"], fc["flip"])
        calls.append(Call(
            "conv_bn_sign",
            functools.partial(bconv.binary_conv2d_bn_sign_packed, *args,
                              out_hw=pc["out_hw"], **geom),
            functools.partial(ref.binary_conv2d_bn_sign_packed_ref, *args,
                              **geom),
            _nbytes(*args) + bsz * oh * ow * B.packed_width(pc["c_out"]) * 4,
            bsz * oh * ow * pc["c_out"] * pc["kh"] * pc["kw"] * pc["cw"]))
        hp = calls[-1].plain()
        if spec.stages[i].pool:
            hp = L.maxpool2d_packed(hp, packed["pool_masks"][i])

    h = hp.reshape(bsz, -1).contiguous()
    n = len(packed["denses"])
    for i, layer in enumerate(packed["denses"]):
        w, k = layer["w_packed"], layer["k_true"]
        if i < n - 1:
            library = None
            if bsz > 16 and w.shape[0] % 8 == 0:
                # the +-1 int8 tensor-core route, contraction only
                library = functools.partial(
                    torch._int_mm, B.unpack_bits(h, k, torch.int8),
                    B.unpack_bits(w, k, torch.int8).T)
            fd = packed["folded_dense"][i]
            args = (h, w, fd["tau"], fd["flip"])
            calls.append(Call(
                "xnor_gemm_bn_sign",
                functools.partial(bmm.binary_matmul_bn_sign_packed, *args,
                                  k_true=layer["k_true"]),
                functools.partial(ref.binary_matmul_bn_sign_packed_ref,
                                  *args, layer["k_true"]),
                _nbytes(*args) + bsz * B.packed_width(w.shape[0]) * 4,
                bsz * w.shape[0] * w.shape[1], library))
            h = calls[-1].plain()
        else:
            # +-1 float32 GEMM (TF32 off): every dot is an integer below
            # 2^24, so it is exact and computes the kernel's function
            calls.append(Call(
                "xnor_gemm",
                functools.partial(bmm.binary_matmul_packed, h, w, k_true=k),
                functools.partial(ref.binary_matmul_packed_ref, h, w, k),
                _nbytes(h, w) + bsz * w.shape[0] * 4,
                bsz * w.shape[0] * w.shape[1],
                functools.partial(torch.matmul, B.unpack_bits(h, k),
                                  B.unpack_bits(w, k).T),
                lambda y: y.round().to(torch.int32)))
    return calls


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


def check_equal(what: str, got, want) -> None:
    import torch
    torch.cuda.synchronize()
    if got.shape != want.shape or not torch.equal(got, want):
        bad = (got != want).sum().item() if got.shape == want.shape else -1
        raise AssertionError(f"{what}: kernel disagrees with its plain "
                             f"version ({bad} elements differ, shapes "
                             f"{tuple(got.shape)} vs {tuple(want.shape)})")


def ragged_checks(gen, dev) -> list[str]:
    """Ragged shapes: C_out 40, N 10, M 1, channel tails, stride 2 VALID."""
    import torch
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_conv as bconv
    from repro_torch.kernels import binary_matmul as bmm
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
    for m, c in ((1, 40), (37, 40), (5, 10)):
        x = torch.randint(-60, 60, (m, c), generator=gen,
                          dtype=torch.int32).to(dev)
        tau, flip = bn(c, 60)
        check_equal(f"bn_sign_pack M={m} C={c}", fe.bn_sign_pack(x, tau, flip),
                    ref.bn_sign_pack_ref(x, tau, flip))
        done.append(f"bn_sign_pack M={m} C={c}")
    for m, n, k in ((1, 10, 1000), (3, 10, 33), (1, 40, 8192), (9, 40, 70)):
        a = B.pack_bits(pm1(m, k)).to(dev)
        w = B.pack_bits(pm1(n, k)).to(dev)
        check_equal(f"xnor_gemm M={m} N={n} K={k}",
                    bmm.binary_matmul_packed(a, w, k_true=k),
                    ref.binary_matmul_packed_ref(a, w, k))
        tau, flip = bn(n, k)
        check_equal(f"xnor_gemm_bn_sign M={m} N={n} K={k}",
                    bmm.binary_matmul_bn_sign_packed(a, w, tau, flip,
                                                     k_true=k),
                    ref.binary_matmul_bn_sign_packed_ref(a, w, tau, flip, k))
        done.append(f"xnor_gemm(+bn_sign) M={m} N={n} K={k}")
    for (hw, c_in, c_out, stride, padding) in (((9, 9), 33, 40, 2, "VALID"),
                                                ((7, 7), 20, 40, 1, "SAME"),
                                                ((9, 9), 64, 10, 2, "SAME")):
        plan = bconv.make_conv_plan(pm1(c_out, 3, 3, c_in), input_hw=hw,
                                    stride=stride, padding=padding)
        x = B.pack_bits(pm1(2, *hw, c_in)).to(dev)
        geom = dict(kh=3, kw=3, stride=stride, pads=plan["pads"],
                    c_out=c_out, k_true=plan["k_true"])
        tau, flip = bn(c_out, plan["k_true"])
        args = (x, plan["w_packed"].to(dev), plan["correction"].to(dev), tau,
                flip)
        what = f"conv_bn_sign {hw} C_in={c_in} C_out={c_out} s{stride} {padding}"
        check_equal(what, bconv.binary_conv2d_bn_sign_packed(
            *args, out_hw=plan["out_hw"], **geom),
            ref.binary_conv2d_bn_sign_packed_ref(*args, **geom))
        done.append(what)
        bplan = bconv.make_bitplane_conv_plan(
            pm1(c_out, 3, 3, 3), input_hw=hw, stride=stride, padding=padding)
        x8 = torch.randint(0, 256, (2, *hw, 3), generator=gen,
                           dtype=torch.uint8).to(dev)
        planes = B.pack_bitplanes_uint8(x8)
        bargs = (planes, bplan["w_packed"].to(dev), bplan["rowsum"].to(dev))
        geom["k_true"] = bplan["k_true"]
        what = f"bitplane_conv {hw} C_out={c_out} s{stride} {padding}"
        check_equal(what, bconv.bitplane_conv2d_packed(
            *bargs, out_hw=bplan["out_hw"], nbits=8, **geom),
            ref.bitplane_conv2d_planes_ref(*bargs, nbits=8, **geom))
        done.append(what)
    return done


def randomize_bn(params, gen) -> None:
    """Random BN statistics with both signs of gamma."""
    import torch
    for bn in params["conv_bns"] + params["dense_bns"]:
        c = bn["gamma"].numel()
        sign = torch.where(torch.rand(c, generator=gen) < 0.3, -1.0, 1.0)
        bn["gamma"] = (0.3 + 1.2 * torch.rand(c, generator=gen)) * sign
        bn["beta"] = torch.randn(c, generator=gen)
        bn["mean"] = torch.randn(c, generator=gen) * 3
        bn["var"] = 0.5 + 1.5 * torch.rand(c, generator=gen)


def kernel_table(calls, popc_per_s, kernel_reps, plain_reps):
    """Per kernel: summed time, plain time, bound and library time over its
    launches in one forward (each call checked bit-exact on the way)."""
    import torch
    rows = {}
    for c in calls:
        got, want = c.kernel(), c.plain()
        check_equal(c.name, got, want)
        r = rows.setdefault(c.name, {"launches_per_forward": 0, "ms": 0.0,
                                     "plain_ms": 0.0, "bytes": 0,
                                     "word_ops": 0, "library_ms": 0.0,
                                     "max_abs_err": 0})
        r["max_abs_err"] = max(r["max_abs_err"], int(
            (got.to(torch.int64) - want.to(torch.int64)).abs().max()))
        r["launches_per_forward"] += 1
        r["ms"] += time_ms(c.kernel, kernel_reps)
        r["plain_ms"] += time_ms(c.plain, plain_reps)
        r["bytes"] += c.nbytes
        r["word_ops"] += c.word_ops
        if c.library_as is not None:
            check_equal(f"{c.name} library call", c.library_as(c.library()),
                        want)
        if c.library is None or r["library_ms"] is None:
            r["library_ms"] = None
        else:
            r["library_ms"] += time_ms(c.library, kernel_reps)
    for r in rows.values():
        t_bytes = r["bytes"] / HBM_BYTES_PER_S * 1e3
        t_ops = r["word_ops"] / popc_per_s * 1e3
        r["bound_ms"] = max(t_bytes, t_ops)
        r["bound_by"] = "bytes" if t_bytes >= t_ops else "operations"
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "needs a CUDA card", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build
    from repro_torch.kernels import ops
    from repro_torch.models import cnn

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
    popc_per_s = POPC_PER_CLOCK_PER_SM * sms * clock_mhz * 1e6
    log(f"device: {name}; torch {torch.__version__} cuda {torch.version.cuda}"
        f"; {sms} SMs at max {clock_mhz:.0f} MHz -> POPC peak "
        f"{popc_per_s:.4g}/s")
    log(f"nvidia-smi: {smi}")

    # 2. build
    t0 = time.perf_counter()
    _build.build_all()
    log(f"build: {len(_build.SOURCES)} sources in "
        f"{time.perf_counter() - t0:.1f} s")
    for src, text in _build.ptxas_report().items():
        for line in text.splitlines():
            if "registers" in line or "Compiling entry" in line:
                log(f"  ptxas {src}: {line.split('ptxas info    :')[-1].strip()}")

    # 3. kernels against their plain versions
    gen = torch.Generator().manual_seed(0)
    spec = cnn.BCNNSpec()
    params = cnn.init_bcnn(gen, spec)
    randomize_bn(params, gen)
    packed = cnn.pack_bcnn(params, spec)          # on the card
    x8 = torch.randint(0, 256, (8, *spec.input_hw, spec.c_in), generator=gen,
                       dtype=torch.uint8).to(dev)
    for c in main_path_calls(packed, x8):
        check_equal(f"{c.name} full width B=8", c.kernel(), c.plain())
    log("kernels: full-width BCNN shapes at batch 8 bit-exact "
        "(K1, K2, K3 x5, K4-fused x2, K4)")
    for what in ragged_checks(gen, dev):
        log(f"kernels: {what} bit-exact")

    # 4. the main path
    fwd = cnn.make_packed_forward(packed)
    expect = {"bitplane_conv": 1, "bn_sign_pack": 1,
              "conv_bn_sign": len(spec.stages) - 1,
              "xnor_gemm_bn_sign": len(spec.dense) - 1, "xnor_gemm": 1}
    batches = (1, 8, 64, 256)
    inputs = {b: torch.randint(0, 256, (b, *spec.input_hw, spec.c_in),
                               generator=gen, dtype=torch.uint8)
              for b in batches}
    ops.reset_launch_counts()
    logits = {}
    for b in batches:
        before = ops.launch_counts()
        logits[b] = fwd(inputs[b])
        torch.cuda.synchronize()
        per = {k: v - before[k] for k, v in ops.launch_counts().items()}
        if per != expect:
            raise AssertionError(f"batch {b}: launches {per}, expected "
                                 f"{expect}")
    launches = ops.launch_counts()
    log(f"main path: batches {batches}, launches per forward {expect}, "
        f"in all {launches}")
    for b in batches:
        xd = inputs[b].to(dev)
        got_int = cnn.bcnn_forward_packed_int(packed, xd, backend="cuda")
        want_int = cnn.bcnn_forward_packed_int(packed, xd, backend="torch")
        check_equal(f"forward int32 B={b}", got_int, want_int)
        want = cnn.bcnn_forward_packed(packed, xd, backend="torch")
        check_equal(f"forward logits B={b}", logits[b], want)
        if logits[b].shape != (b, spec.dense[-1]) or \
                not torch.isfinite(logits[b]).all():
            raise AssertionError(f"batch {b}: logits {logits[b].shape} "
                                 f"not finite or of the wrong shape")
    ref_logits = cnn.bcnn_forward_float(
        cnn.to_device(params, dev), inputs[8].to(dev), spec)
    if not torch.allclose(logits[8], ref_logits, rtol=1e-4, atol=1e-3):
        raise AssertionError("batch 8: packed logits differ from the float "
                             "reference beyond rtol 1e-4, atol 1e-3")
    log("main path: int32 pre-BN outputs and logits equal the plain path "
        "at every batch; batch-8 logits match the float reference "
        f"(max |diff| {(logits[8] - ref_logits).abs().max().item():.3g})")

    # 5. times
    kernels_by_batch = {}
    for b in (1, 256):
        calls = main_path_calls(packed, inputs[b].to(dev))
        rows = kernel_table(calls, popc_per_s, kernel_reps=20,
                            plain_reps=2 if b > 1 else 5)
        kernels_by_batch[b] = rows
        for k, r in rows.items():
            lib = ("null" if r["library_ms"] is None
                   else f"{r['library_ms']:.5g}")
            log(f"time B={b} {k}: x{r['launches_per_forward']} per forward, "
                f"kernel {r['ms']:.5g} ms, plain {r['plain_ms']:.5g} ms, "
                f"bound {r['bound_ms']:.5g} ms ({r['bound_by']}), "
                f"library {lib} ms")
    for b in batches:
        x = inputs[b].to(dev)
        reps = 20 if b < 256 else 10
        ms_host = time_ms(lambda: fwd(inputs[b]), reps)
        ms = time_ms(lambda: fwd(x), reps)
        log(f"forward B={b}: {ms_host:.5g} ms per batch from host memory "
            f"({b / ms_host * 1e3:.6g} images/s), {ms:.5g} ms with the "
            f"batch already on the card ({b / ms * 1e3:.6g} images/s)")
    x = inputs[256].to(dev)
    plain_fwd_ms = time_ms(
        lambda: cnn.bcnn_forward_packed(packed, x, backend="torch"), reps=1)
    log(f"forward B=256 on the plain versions: {plain_fwd_ms:.5g} ms")

    kernels = []
    for k, (source, replaces) in SOURCES.items():
        r = kernels_by_batch[256][k]
        kernels.append({
            "name": k, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches[k],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound_ms"], "bound_by": r["bound_by"],
            "library_ms": r["library_ms"], "batch": 256,
            "launches_per_forward": r["launches_per_forward"]})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
