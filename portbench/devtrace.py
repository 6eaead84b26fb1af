"""The traced run: ``torch.profiler`` over a fixed count of batches, and the
reduction of its trace to device intervals, busy and idle time, plain
PyTorch kernel time and the breakdown.

Device time is the union of every kernel, copy and memset interval in
the trace; the traced window runs from the first of them to the end of
the last, so the profiler's own start and stop fall outside it.  Idle
gaps are named by the harness's host span (``portbench.*``) that
overlaps them most.
"""
from __future__ import annotations

import contextlib
import json
import os
import re
import tempfile
from dataclasses import dataclass, field

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
SPAN_PREFIX = "portbench."
TOP = 10
NAME_CHARS = 160


class Recorder:
    """Starts and stops the profiler; ``span`` marks a host step while it
    records and costs nothing otherwise."""

    def __init__(self, device: torch.device):
        self.device = device
        self.prof = None
        self.active = False

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        self.prof = torch.profiler.profile(activities=acts)
        self.prof.start()
        self.active = True

    def warm_up(self) -> None:
        """One empty start and stop: the profiler's first start takes
        seconds, which belong to set-up and not to the window."""
        self.start()
        torch.ones(1, device=self.device).add_(1)
        self.stop()
        self.prof = None

    def stop(self) -> None:
        """Stops recording; the profiler waits for the device first."""
        self.prof.stop()
        self.active = False

    def span(self, name: str):
        if self.active:
            return torch.profiler.record_function(SPAN_PREFIX + name)
        return contextlib.nullcontext()

    def events(self) -> list:
        """The trace's events (Chrome trace format); none where the
        window closed before the trace began."""
        if self.prof is None:
            return []
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            with open(path) as f:
                return json.load(f)["traceEvents"]
        finally:
            os.unlink(path)


@dataclass
class Reading:
    """What a per-layer metric reads: ``batches`` batches ran in the
    traced window; ``least_s`` is one batch's least time
    (``roofline``); times in seconds."""
    batches: int
    least_s: float
    window_s: float = 0.0
    busy_s: float = 0.0
    plain_s: float = 0.0
    enqueue_s: list = field(default_factory=list)
    device_ops: list = field(default_factory=list)
    idle_gaps: list = field(default_factory=list)


def _merge(intervals: list) -> list:
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def _short(name: str) -> str:
    return name if len(name) <= NAME_CHARS else name[:NAME_CHARS - 3] + "..."


def _top(totals: dict) -> list:
    rows = sorted(totals.items(), key=lambda kv: -kv[1])[:TOP]
    return [[name, seconds] for name, seconds in rows]


def reduce(events: list, port_kernels, reading: Reading) -> Reading:
    """Fill ``reading`` from a trace's events; ``port_kernels`` names the
    program's own kernels, every other kernel is plain PyTorch's."""
    pattern = re.compile(r"\b(?:%s)\b" % "|".join(
        re.escape(n) for n in sorted(port_kernels))) if port_kernels else None
    dev, spans, ops = [], [], {}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        a, d = float(e["ts"]) * 1e-6, float(e["dur"]) * 1e-6
        cat, name = e.get("cat", ""), e.get("name", "")
        if cat in DEVICE_CATS:
            dev.append((a, a + d))
            key = _short(name)
            ops[key] = ops.get(key, 0.0) + d
            if cat == "kernel" and not (pattern and pattern.search(name)):
                reading.plain_s += d
        elif cat == "user_annotation" and name.startswith(SPAN_PREFIX):
            spans.append((a, a + d, name[len(SPAN_PREFIX):]))
    if not dev:
        return reading
    busy = _merge(dev)
    reading.window_s = busy[-1][1] - busy[0][0]
    reading.busy_s = sum(b - a for a, b in busy)
    reading.device_ops = _top(ops)
    gaps = {}
    for (_, a), (b, _) in zip(busy[:-1], busy[1:]):
        label, best = "host outside the harness's spans", 0.0
        for s0, s1, name in spans:
            over = min(b, s1) - max(a, s0)
            if over > best:
                label, best = f"host in {name}", over
        total, count = gaps.get(label, (0.0, 0))
        gaps[label] = (total + b - a, count + 1)
    reading.idle_gaps = _top({f"{label} ({count} gaps)": total
                              for label, (total, count) in gaps.items()})
    return reading
