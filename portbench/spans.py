"""The program's layer spans on the device trace: each kernel, copy and
memset put down to the ``model.*`` span that launched it, and the part of
each idle gap that the host caused.

The program opens its layer spans (``repro_torch/models/cnn.py``) as
``torch.profiler.record_function`` ranges while the profiler records, so
they reach the trace as ``user_annotation`` events on the kernels' clock.
Kineto gives every device interval and the ``cuda_runtime`` or
``cuda_driver`` call that launched it the same ``args.correlation``.  A
device interval belongs to the innermost ``model.*`` span open on the
launching thread when its launch began; one launched outside every such
span, or whose launch the trace does not hold (queued before the trace
began), is left outside the layers.  So the layers and what lies outside
them add up to the sum of the device intervals, which is the busy time
where the intervals do not overlap (one stream).

An idle gap runs between two merged busy intervals.  The host caused
the part from the gap's start to the moment it began the launch of the
op that ends the gap (clamped to the gap); the rest of the gap passed
with that op already queued.

Three readings per traced run (``readings``): ``first_layer_ms`` and
``packed_layers_ms``, device ms a batch launched inside the first
layer's span and inside the packed layers' spans, and
``host_late_idle_pct``, the idle the host caused as a share of the
traced window.  The harness's ``devtrace.Reading`` does not carry the
trace's events, so no per-layer metric of ``BENCHMARK.json`` reads them
yet; run one cell traced with them:

    python3 portbench/spans.py --workload <cell> --seed <n> --seconds <s>

which prints the run's result line with these readings and the split by
span added.  ``traced_run`` and ``main`` are a stopgap beside
``run.py --trace 1``: they catch the events by swapping
``devtrace.reduce`` for the run.  The ``benchmark`` change that gives
``devtrace.Reading`` its ``events`` deletes both, and the metric files
call ``reduce`` and ``readings`` on ``Reading.events``.

Since the layers and the rest are defined to add up to the device time,
their sum closing to busy is an identity on one stream and proves
nothing about the join; what does is the rest: in the cells only the
harness's two copies a batch are launched outside the layer spans, so
the rest's ops and time match the copies' (``copy_ops``, ``copy_s``).
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from collections import defaultdict
from dataclasses import dataclass, field
from pathlib import Path

if __name__ == "__main__":
    # The repository root for ``portbench``, ``src`` for the program; not
    # this folder, whose module names would shadow others (``run.py``).
    _REPO = Path(__file__).resolve().parent.parent
    sys.path[0:1] = [str(_REPO), str(_REPO / "src")]

import torch  # noqa: E402

from portbench import devtrace, harness  # noqa: E402

SPAN_PREFIX = "model."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
FIRST_LAYER = ("model.bcnn.bitplane_conv", "model.bmlp.bitplane_dense")
PACKED_LAYERS = ("model.bcnn.conv_stage", "model.bcnn.dense_stack",
                 "model.bcnn.output", "model.bmlp.dense_stack",
                 "model.bmlp.output")
OUTSIDE = "outside the layer spans"
BEFORE = "launched before the trace"


@dataclass
class LayerSpans:
    """Seconds of device time (``device_s``) and device ops (``ops``) by
    launching span name, or ``OUTSIDE`` / ``BEFORE``; ``n_spans`` counts
    the ``model.*`` spans seen; ``host_late_s`` is the idle the host
    caused, in seconds; ``copy_s`` and ``copy_ops`` are the copies'
    device time and count, wherever they were launched."""
    n_spans: int = 0
    device_s: dict = field(default_factory=dict)
    ops: dict = field(default_factory=dict)
    host_late_s: float = 0.0
    copy_s: float = 0.0
    copy_ops: int = 0

    def sum_s(self, names) -> float:
        return sum(self.device_s.get(n, 0.0) for n in names)

    @property
    def first_s(self) -> float:
        return self.sum_s(FIRST_LAYER)

    @property
    def packed_s(self) -> float:
        return self.sum_s(PACKED_LAYERS)

    @property
    def rest_s(self) -> float:
        """Device time in neither the first nor the packed layers."""
        return sum(self.device_s.values()) - self.first_s - self.packed_s


def _innermost(spans: list, launches: list) -> dict:
    """``{correlation: span name or None}`` for one thread's ``spans``
    (start, end, name) and ``launches`` (start, correlation)."""
    spans = sorted(spans, key=lambda s: (s[0], -s[1]))
    out, stack, i = {}, [], 0
    for ts, corr in sorted(launches):
        while i < len(spans) and spans[i][0] <= ts:
            while stack and stack[-1][1] <= spans[i][0]:
                stack.pop()
            stack.append(spans[i])
            i += 1
        while stack and stack[-1][1] <= ts:
            stack.pop()
        out[corr] = stack[-1][2] if stack else None
    return out


def reduce(events: list) -> LayerSpans:
    """The layer spans of a trace's events (Chrome trace format)."""
    dev, launch_at, thread_of = [], {}, {}
    spans, launches = defaultdict(list), defaultdict(list)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        cat, name = e.get("cat", ""), e.get("name", "")
        corr = (e.get("args") or {}).get("correlation")
        if cat in devtrace.DEVICE_CATS:
            dev.append((a, a + d, corr, cat == "gpu_memcpy"))
        elif cat in LAUNCH_CATS and corr is not None:
            launch_at[corr] = a
            launches[e.get("tid")].append((a, corr))
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans[e.get("tid")].append((a, a + d, name))
    out = LayerSpans(n_spans=sum(len(s) for s in spans.values()))
    if not dev:
        return out
    for tid, ls in launches.items():
        thread_of.update(_innermost(spans.get(tid, []), ls))
    for a, b, corr, copy in dev:
        name = thread_of.get(corr, BEFORE)
        key = OUTSIDE if name is None else name
        out.device_s[key] = out.device_s.get(key, 0.0) + (b - a)
        out.ops[key] = out.ops.get(key, 0) + 1
        if copy:
            out.copy_s += b - a
            out.copy_ops += 1
    busy = devtrace._merge([(a, b) for a, b, _, _ in dev])
    # the launch of the op that ends each gap: the earliest-launched of
    # the ops that start the next busy interval
    ends = defaultdict(list)
    starts = {b0 for b0, _ in busy[1:]}
    for a, _, corr, _ in dev:
        if a in starts and corr in launch_at:
            ends[a].append(launch_at[corr])
    for (_, gap0), (gap1, _) in zip(busy[:-1], busy[1:]):
        if ends[gap1]:
            late = min(ends[gap1]) - gap0
            out.host_late_s += min(max(late, 0.0), gap1 - gap0)
    return out


def readings(s: LayerSpans, batches: int, window_s: float) -> dict:
    """The three readings of ``s`` over ``batches`` traced batches and a
    traced window of ``window_s``; a reading with nothing to read is
    left out (the layer spans of a program that opens none)."""
    out = {}
    if batches and s.n_spans and s.device_s:
        out["first_layer_ms"] = 1e3 * s.first_s / batches
        out["packed_layers_ms"] = 1e3 * s.packed_s / batches
    if window_s > 0:
        out["host_late_idle_pct"] = 100.0 * s.host_late_s / window_s
    return out


def traced_run(cell, seed: int, seconds: float, device) -> tuple:
    """``harness.run_cell`` traced; returns its result line, the trace's
    ``devtrace.Reading`` and the layer spans of its events."""
    kept = []
    reduce_trace = devtrace.reduce

    def keep(events, port_kernels, reading):
        kept.append((reduce_trace(events, port_kernels, reading), events))
        return kept[-1][0]
    devtrace.reduce = keep
    try:
        out = harness.run_cell(cell, seed, seconds, True, device,
                               time.perf_counter())
    finally:
        devtrace.reduce = reduce_trace
    reading, events = kept[0]
    return out, reading, reduce(events)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        print("spans: needs a CUDA card", file=sys.stderr)
        return 2
    torch.set_num_threads(harness.THREADS)
    out, r, s = traced_run(harness.load_cell(args.workload), args.seed,
                           args.seconds, "cuda")
    n = max(r.batches, 1)
    out["layer_spans"] = {
        **readings(s, r.batches, r.window_s),
        "batches": r.batches, "busy_ms": 1e3 * r.busy_s / n,
        "rest_ms": 1e3 * s.rest_s / n,
        "copy_ms": 1e3 * s.copy_s / n, "copy_ops": s.copy_ops / n,
        "closure": (s.first_s + s.packed_s + s.rest_s) / r.busy_s - 1
        if r.busy_s else None,
        "host_late_ms": 1e3 * s.host_late_s / n,
        "idle_ms": 1e3 * (r.window_s - r.busy_s) / n,
        "device_ms": {k: 1e3 * v / n for k, v in sorted(s.device_s.items())},
        "ops": {k: v / n for k, v in sorted(s.ops.items())}}
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
