"""Offline scoring: batches fed from host memory as fast as the card
takes them.

A ring of ``ring`` distinct uint8 batches of ``batch`` inputs, pixels
uniform in 0..255 (the configurations place the first layer's
thresholds for that spread), lies in pinned host memory.
Batch ``k`` uses slot ``k % ring``: a non-blocking copy to the card on
the forward's stream, the forward on the device tensor, a non-blocking
copy of the logits back to pinned memory, and an event.  At most
``inflight`` batches are queued: before enqueuing another, the host
waits on the oldest one's event and keeps its answer.  A batch counts
once its logits are in host memory inside the window.

Traffic parameters (the workload file's ``params``): ``batch``,
``ring``, ``inflight`` and ``trace_batches``.
"""
from __future__ import annotations

import collections
import contextlib
import time
from dataclasses import dataclass, field

import torch

from portbench import judge

TRACE_AT = 0.4      # share of the window before the traced batches start


def make_inputs(params: dict, input_shape: tuple, gen: torch.Generator,
                device: torch.device) -> torch.Tensor:
    """The ring, drawn on ``device`` from ``gen``, in host memory."""
    x = torch.randint(0, 256, (params["ring"], params["batch"],
                               *input_shape),
                      generator=gen, device=device, dtype=torch.uint8)
    host = torch.empty(x.shape, dtype=torch.uint8,
                       pin_memory=device.type == "cuda")
    host.copy_(x)
    return host


@dataclass
class Window:
    seconds: float
    batch: int
    enqueued: int = 0
    completed: int = 0
    malformed: int = 0
    answers: judge.Answers = field(default_factory=judge.Answers)
    traced: int = 0
    traced_enqueue_s: list = field(default_factory=list)

    def end_to_end(self) -> dict:
        return {"inputs_per_s": self.completed * self.batch / self.seconds}


class Driver:
    """Feeds ``fwd`` from ``inputs`` (the ring); ``out_shape`` is one
    batch's logits; ``recorder`` is a ``devtrace.Recorder`` or None."""

    def __init__(self, fwd, inputs: torch.Tensor, params: dict,
                 out_shape: tuple, device: torch.device, recorder=None):
        self.fwd = fwd
        self.inputs = inputs
        self.params = params
        self.out_shape = tuple(out_shape)
        self.device = device
        self.recorder = recorder
        self.inflight = params["inflight"]
        self.ring = params["ring"]
        cuda = device.type == "cuda"
        self.dev_in = [torch.empty(inputs.shape[1:], dtype=inputs.dtype,
                                   device=device)
                       for _ in range(self.inflight)]
        self.host_out = torch.empty((self.inflight, *self.out_shape),
                                    dtype=torch.float32, pin_memory=cuda)
        self.pending = collections.deque()
        self.answers = judge.Answers()

    def _span(self, name: str):
        if self.recorder is None:
            return contextlib.nullcontext()
        return self.recorder.span(name)

    def _enqueue(self, k: int) -> tuple:
        """Queue batch ``k``; returns (host seconds in ``fwd``, well
        formed)."""
        slot, buf = k % self.ring, k % self.inflight
        with self._span("stage"):
            x = self.dev_in[buf]
            x.copy_(self.inputs[slot], non_blocking=True)
        with self._span("enqueue"):
            t0 = time.perf_counter()
            y = self.fwd(x)
            dt = time.perf_counter() - t0
        ok = tuple(y.shape) == self.out_shape
        with self._span("readback"):
            if ok:
                self.host_out[buf].copy_(y, non_blocking=True)
            event = None
            if self.device.type == "cuda":
                event = torch.cuda.Event()
                event.record()
        self.pending.append((slot, buf, event, ok))
        return dt, ok

    def _finish(self) -> tuple:
        """Wait for the oldest batch and keep its answer; returns (host
        time it was seen done, well formed)."""
        slot, buf, event, ok = self.pending.popleft()
        with self._span("wait"):
            if event is not None:
                event.synchronize()
        done = time.perf_counter()
        with self._span("check"):
            if ok:
                self.answers.add(slot, self.host_out[buf].numpy())
        return done, ok

    def warm_up(self) -> None:
        """Every shape of the window: the queue filled twice, then the
        device drained and the answers dropped."""
        for k in range(2 * self.inflight):
            if len(self.pending) >= self.inflight:
                self._finish()
            self._enqueue(k)
        while self.pending:
            self._finish()
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        self.answers = judge.Answers()

    def window(self, seconds: float, t_start: float,
               trace_batches: int = 0) -> Window:
        """Run from ``t_start`` for ``seconds``; with ``trace_batches``
        the recorder covers that many batches from ``TRACE_AT`` of the
        window on.  Batches still queued at the close are waited for and
        judged, not counted."""
        win = Window(seconds=seconds, batch=self.params["batch"])
        t_end = t_start + seconds
        t_trace = t_start + TRACE_AT * seconds
        first_traced = None
        k = 0
        while True:
            if len(self.pending) >= self.inflight:
                done, ok = self._finish()
                win.completed += ok and done <= t_end
            now = time.perf_counter()
            if now >= t_end:
                break
            if trace_batches and first_traced is None and now >= t_trace:
                self.recorder.start()
                first_traced = k
            dt, ok = self._enqueue(k)
            win.malformed += not ok
            k += 1
            if first_traced is not None and self.recorder.active:
                win.traced_enqueue_s.append(dt)
                if k - first_traced == trace_batches:
                    self.recorder.stop()
        while self.pending:
            done, ok = self._finish()
            win.completed += ok and done <= t_end
        if self.recorder is not None and self.recorder.active:
            self.recorder.stop()
        win.enqueued = k
        win.traced = len(win.traced_enqueue_s)
        win.answers = self.answers
        return win
