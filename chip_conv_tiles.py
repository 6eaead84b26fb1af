"""Time K3 and K7 (``csrc/conv_bn_sign.cu``) in each of their tiles, and
split their batch-1 time between the card and the host.

Run on a CUDA card from the root of a checkout (``PYTHONPATH=src``)::

    PYTHONPATH=src python3 chip_conv_tiles.py [label]

Cases: K3 at the five packed-conv stages of ``BCNNSpec()`` and K7 on the
Table-3 layer (16 x 16, 128 -> 256 channels, 3 x 3 SAME), at batch 1 and
256, operands random from seed 0.  Each case runs in every variant:
``default``, the wrapper as it is (its own tile rule,
``binary_conv.conv_tile``), then ``64x64`` and ``64x128``, that tile
forced; a checkout without that rule has the default only.  Every variant
is checked equal to the plain version first.  For each it prints one JSON
line with

* ``eager_ms``: CUDA events around 20 back-to-back wrapper calls, per call;
* ``graph_ms``: the same 20 calls captured in a CUDA graph and replayed,
  per call: the card's own time, without the host's launch cost;
* ``host_ms``: host time per wrapper call, enqueued without waiting;
* ``python_ms``: the same with the C launch replaced by a stub, i.e. the
  wrapper's Python cost alone;

each the median of 7 trials, over 2 rounds that run the variants in turn.
"""
from __future__ import annotations

import json
import statistics
import sys
import time

STAGES = [((32, 32), 128, 128), ((16, 16), 128, 256), ((16, 16), 256, 256),
          ((8, 8), 256, 512), ((8, 8), 512, 512)]
REPS, TRIALS, ROUNDS = 20, 7, 2


def make_case(gen, dev, bsz, hw, c_in, c_out, fused):
    """The wrapper call of one case and its plain version's output."""
    import torch
    from repro_torch.core import binarize as B
    from repro_torch.kernels import binary_conv as bconv
    from repro_torch.kernels import ref

    def pm1(*shape):
        return (torch.randint(0, 2, shape, generator=gen) * 2 - 1).float()

    plan = bconv.make_conv_plan(pm1(c_out, 3, 3, c_in), input_hw=hw)
    x = B.pack_bits(pm1(bsz, *hw, c_in)).to(dev)
    k = plan["k_true"]
    tau = (torch.randint(-k, k + 1, (c_out,), generator=gen).float()
           + 0.5).to(dev)
    flip = torch.where(torch.rand(c_out, generator=gen) < 0.3, -1.0,
                       1.0).to(dev)
    geom = dict(kh=3, kw=3, stride=1, pads=plan["pads"], c_out=c_out,
                k_true=k)
    args = (x, plan["w_packed"].to(dev), plan["correction"].to(dev))
    if fused:
        return (lambda: bconv.binary_conv2d_bn_sign_packed(
                    *args, tau, flip, out_hw=plan["out_hw"], **geom),
                ref.binary_conv2d_bn_sign_packed_ref(*args, tau, flip,
                                                     **geom))
    return (lambda: bconv.binary_conv2d_packed(*args, out_hw=plan["out_hw"],
                                               **geom),
            ref.binary_conv2d_packed_ref(*args, **geom))


def eager_ms(fn):
    import torch
    fn()
    torch.cuda.synchronize()
    out = []
    for _ in range(TRIALS):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        for _ in range(REPS):
            fn()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / REPS)
    return statistics.median(out)


def graph_ms(fn):
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(REPS):
            fn()
    g.replay()
    torch.cuda.synchronize()
    out = []
    for _ in range(TRIALS):
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        g.replay()
        e.record()
        e.synchronize()
        out.append(s.elapsed_time(e) / REPS)
    return statistics.median(out)


def host_ms(fn, reps=50):
    import torch
    torch.cuda.synchronize()
    out = []
    for _ in range(TRIALS):
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        out.append((time.perf_counter() - t0) * 1e3 / reps)
        torch.cuda.synchronize()
    return statistics.median(out)


class _StubLib:
    """Stands in for the kernel library: every entry returns 0 at once."""

    def __getattr__(self, name):
        return lambda *args: 0


def python_ms(fn):
    from repro_torch.kernels import binary_conv as bconv
    load = bconv._build.load
    bconv._build.load = lambda name, entries: _StubLib()
    try:
        return host_ms(fn)
    finally:
        bconv._build.load = load


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_conv_tiles: no CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import binary_conv as bconv
    label = sys.argv[1] if len(sys.argv) > 1 else "tree"
    dev = torch.device("cuda", 0)
    gen = torch.Generator().manual_seed(0)
    cases = ([(f"K3 B={b} {hw[0]}x{hw[1]} {ci}->{co}", b, hw, ci, co, True)
              for b in (1, 256) for hw, ci, co in STAGES]
             + [(f"K7 Table-3 B={b}", b, (16, 16), 128, 256, False)
                for b in (1, 256)])
    built = {name: make_case(gen, dev, *rest) for name, *rest in cases}
    rule = getattr(bconv, "conv_tile", None)
    tiles = ({} if rule is None else
             {"64x64": bconv.TILE_64X64, "64x128": bconv.TILE_64X128})
    variants = ["default", *tiles]
    try:
        for rnd in range(ROUNDS):
            for v in variants:
                if rule is not None:
                    bconv.conv_tile = (
                        rule if v == "default"
                        else (lambda m, n, sms, t=tiles[v]: t))
                for name, (fn, want) in built.items():
                    if not torch.equal(fn(), want):
                        print(f"chip_conv_tiles: {name} variant {v} differs "
                              f"from its plain version", file=sys.stderr)
                        return 1
                    print(json.dumps({
                        "label": label, "round": rnd, "variant": v,
                        "case": name, "eager_ms": eager_ms(fn),
                        "graph_ms": graph_ms(fn), "host_ms": host_ms(fn),
                        "python_ms": python_ms(fn)}), flush=True)
    finally:
        if rule is not None:
            bconv.conv_tile = rule
    return 0


if __name__ == "__main__":
    sys.exit(main())
