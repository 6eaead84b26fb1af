"""Fault tolerance: a supervised step loop with checkpoint/restart,
heartbeats, and deadline-based straggler mitigation.

The reference's ``src/repro/runtime/fault_tolerance.py`` on the port's
checkpointer.  Failures are raised by the step function (a
:class:`StepFailure` stands for a lost node); the control flow is:

  Supervisor.run():
    restore the newest checkpoint (if any) -> loop:
      step with deadline -> heartbeat -> periodic async checkpoint
    on StepFailure: restart from the newest checkpoint

Straggler mitigation: a step exceeding ``deadline_factor x`` the rolling
median is recorded and re-dispatched once, from the state before it, so
every step applies exactly once (backup-task semantics).  A step that
writes into the state it is given (the port's trainer does: a 3B-parameter
state has no room for a copy) has no state from before it left to
re-dispatch from; its slow attempt returns tensors of that state, and
then the attempt's result is kept and counted as a kept straggler, so
the step still applies exactly once.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable

import torch

from repro_torch.checkpoint import (AsyncCheckpointer, latest_step,
                                    load_checkpoint)
from repro_torch.telemetry import MetricsRegistry
from repro_torch.tree import leaves_with_path


class StepFailure(RuntimeError):
    """Raised by a step function to signal a node failure."""


@dataclasses.dataclass
class SupervisorConfig:
    ckpt_dir: str
    ckpt_every: int = 50
    max_restarts: int = 10
    deadline_factor: float = 3.0
    min_deadline_s: float = 0.5


@dataclasses.dataclass
class SupervisorReport:
    steps_done: int = 0
    restarts: int = 0
    stragglers_redispatched: int = 0
    stragglers_kept: int = 0
    heartbeats: int = 0


def _storages(tree) -> set:
    """The storage addresses of ``tree``'s non-empty tensor leaves."""
    return {t.untyped_storage().data_ptr() for _, t in leaves_with_path(tree)
            if isinstance(t, torch.Tensor) and t.numel()}


class Supervisor:
    """Runs ``step_fn(state, step_idx) -> state, metrics`` with restart.

    ``state`` is a tree of tensors the checkpointer can write; a restore
    puts its tensors on ``device`` (the CPU if None).  A ``step_fn`` that
    steps its state in place returns that state's tensors, and a slow
    attempt of it is kept rather than re-dispatched (module docstring).
    Restart, straggler and heartbeat counts are mirrored into a telemetry registry
    (``supervisor.*``; pass a shared one via ``metrics=``, else a fresh
    one is made) in lock-step with the :class:`SupervisorReport` that
    ``run()`` returns.
    """

    def __init__(self, cfg: SupervisorConfig, init_state_fn: Callable,
                 step_fn: Callable, device=None,
                 metrics: MetricsRegistry | None = None):
        self.cfg = cfg
        self.init_state_fn = init_state_fn
        self.step_fn = step_fn
        self.device = device
        self.ckpt = AsyncCheckpointer(cfg.ckpt_dir)
        self.report = SupervisorReport()
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        self._m_restarts = self.metrics.counter("supervisor.restarts")
        self._m_stragglers = self.metrics.counter(
            "supervisor.stragglers_redispatched")
        self._m_kept = self.metrics.counter("supervisor.stragglers_kept")
        self._m_heartbeats = self.metrics.counter("supervisor.heartbeats")
        self._m_steps = self.metrics.gauge("supervisor.steps_done")
        self._durations: list[float] = []

    def _restore_or_init(self):
        step = latest_step(self.cfg.ckpt_dir)
        state = self.init_state_fn()
        if step is None:
            return state, 0
        state, meta = load_checkpoint(self.cfg.ckpt_dir, step, state,
                                      self.device)
        return state, int(meta["step"]) + 1

    def _deadline(self) -> float:
        if not self._durations:
            return float("inf")
        med = sorted(self._durations)[len(self._durations) // 2]
        return max(self.cfg.min_deadline_s,
                   self.cfg.deadline_factor * med)

    def run(self, num_steps: int) -> tuple:
        restarts = 0
        while True:
            state, start = self._restore_or_init()
            try:
                for i in range(start, num_steps):
                    t0 = time.monotonic()
                    deadline = self._deadline()
                    pre_state = state
                    state, metrics = self.step_fn(pre_state, i)
                    dt = time.monotonic() - t0
                    if dt > deadline and _storages(state) & \
                            _storages(pre_state):
                        # straggler of a step in place: pre_state is the
                        # stepped state, so a re-dispatch would apply step
                        # i twice; the slow attempt's result is kept
                        self.report.stragglers_kept += 1
                        self._m_kept.inc()
                    elif dt > deadline:
                        # straggler: one speculative re-dispatch from the
                        # PRE-step state; the slow attempt's result is
                        # discarded, so step i applies exactly once
                        self.report.stragglers_redispatched += 1
                        self._m_stragglers.inc()
                        t0 = time.monotonic()
                        state, metrics = self.step_fn(pre_state, i)
                        dt = time.monotonic() - t0
                    self._durations.append(dt)
                    if len(self._durations) > 64:
                        self._durations.pop(0)
                    self.report.heartbeats += 1
                    self._m_heartbeats.inc()
                    self.report.steps_done = i + 1
                    self._m_steps.set(i + 1)
                    if (i + 1) % self.cfg.ckpt_every == 0:
                        self.ckpt.save(i, state)
                self.ckpt.wait()
                self.report.restarts = restarts
                return state, self.report
            except StepFailure:
                restarts += 1
                self.report.restarts = restarts
                self._m_restarts.inc()
                if restarts > self.cfg.max_restarts:
                    raise
                self.ckpt.wait()
