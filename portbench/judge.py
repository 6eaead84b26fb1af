"""The comparison that decides ``correct``.

Every answer the timed window produced is kept by its input slot: the
distinct answers of a slot (one, from a deterministic program) are
stored, and past ``CAP`` of them only their largest distance from the
first.  Once the window has closed, the plain reference computes each
slot's logits, and the widest gap of any kept answer from them is taken
in steps of the output layer's integer pre-activation (|gamma| /
sqrt(var + eps) of each class): float rounding reads far below one step,
a single flipped activation bit reaching the output layer reads at
least two.
"""
from __future__ import annotations

import numpy as np

CAP = 8


class Answers:
    """Answers by slot: ``add(slot, logits)`` with a host array that the
    caller may overwrite afterwards."""

    def __init__(self):
        self.kept: dict = {}
        self.drift: dict = {}
        self.count = 0

    def add(self, slot, logits: np.ndarray) -> None:
        self.count += 1
        kept = self.kept.setdefault(slot, [])
        for v in kept:
            if np.array_equal(v, logits):
                return
        if len(kept) < CAP:
            kept.append(logits.copy())
            return
        d = _finite(np.abs(logits.astype(np.float64) - kept[0])).max(axis=0)
        self.drift[slot] = np.maximum(self.drift.get(slot, d), d)


def _finite(d: np.ndarray) -> np.ndarray:
    return np.where(np.isfinite(d), d, np.inf)


def gap(logits: np.ndarray, ref: np.ndarray, step: np.ndarray) -> float:
    """Widest |logits - ref| in output steps; a missing or non-finite
    logit reads as infinite."""
    if logits.shape != ref.shape:
        return float("inf")
    d = _finite(np.abs(logits.astype(np.float64) - ref) / step)
    return float(d.max()) if d.size else float("inf")


def widest_gap(answers: Answers, reference, step: np.ndarray) -> float:
    """The widest gap over every answer; ``reference(slot)`` gives the
    slot's float64 logits.  Answers past ``CAP`` are bounded by the
    first kept answer's gap plus their drift from it."""
    worst = 0.0
    for slot, kept in answers.kept.items():
        ref = reference(slot)
        gaps = [gap(v, ref, step) for v in kept]
        worst = max(worst, *gaps)
        if slot in answers.drift:
            worst = max(worst, gaps[0] + float(np.max(answers.drift[slot]
                                                      / step)))
    return worst
