"""Packedness dataflow pass: activations stay bit-packed across every
device-memory crossing of a traced packed forward.

The reference (``repro/analysis/packedness.py``) classifies by dtype:
``uint32`` means packed.  Here packed words are ``torch.int32`` like every
accumulator, so a value's class comes from what made it:

* ``packed``: the output of a word-producing kernel (:data:`WORD_KERNELS`:
  K5, K2, K1-fused, K3, K4-fused, K6; ``KernelSpec.makes`` in
  ``kernels/library.py``); a parameter that is one of the
  packed tree's word leaves (:data:`WORD_LEAVES`, the ones ``convert.py``
  moves with ``view(np.int32)``); a layout-only op (view, reshape, slice,
  cat, pad, copy; :data:`LAYOUT_OPS`) or a bitwise op of packed values
  (the bit-domain pool) keeps it;
* ``float``: a floating value (folded BN thresholds, V, the LM's residual
  stream, logits), K8's output among them;
* ``unpacked``: an integer value derived from a kernel's output, K4's,
  K7's and K1's int32 accumulators first (:data:`ACCUMULATOR_KERNELS`);
* ``staging``: an integer value derived only from the arguments (bit
  planes of the raw input, token ids, a conv plan's correction table).

Escape rule: a value a kernel produced in unpacked form may reach another
kernel only through an epilogue kernel (:data:`EPILOGUE_KERNELS`: K2,
whose job is consuming the int32 bridge).  Reaching any other kernel
(host-side re-binarized and fed to K5, say) is an escape, reported with
producer and consumer.  Two policies: ``strict`` (the BCNN and the BMLP:
every non-packed kernel output is tracked, through float too) and
``float-residual`` (the binary LM: float kernel outputs are legal and an
int -> float conversion ends the taint).

``max_live_unpacked_bytes`` is the headline: the peak device memory held
by unpacked values at any op of the forward (a view shares its base's
bytes).  ``python -m repro_torch.analysis --check`` pins the report.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.analysis import graph
from repro_torch.kernels import library as _lib

POLICIES = ("strict", "float-residual")
EPILOGUE_KERNELS = frozenset({"bn_sign_pack"})
WORD_KERNELS = frozenset(k for k, spec in _lib.SPECS.items()
                         if spec.makes == _lib.WORDS)
ACCUMULATOR_KERNELS = frozenset(k for k, spec in _lib.SPECS.items()
                                if spec.makes == _lib.ACCUMULATOR)
# Packed-tree leaves that hold words: every layer's packed weights and the
# BCNN's pool masks.
WORD_LEAVES = frozenset({"w_packed", "pool_masks"})
# aten ops that move or copy values without computing on them
LAYOUT_OPS = frozenset({
    "alias", "as_strided", "cat", "clone", "constant_pad_nd", "contiguous",
    "expand", "flatten", "narrow", "pad", "permute", "reshape", "select",
    "slice", "split", "squeeze", "stack", "t", "transpose", "unflatten",
    "unsqueeze", "view", "_unsafe_view", "_to_copy", "copy", "lift_fresh",
    "index", "unbind"})
BITWISE_OPS = frozenset({"bitwise_and", "bitwise_or", "bitwise_xor",
                         "bitwise_not"})


@dataclasses.dataclass(frozen=True)
class Escape:
    """An unpacked kernel output that reached a non-epilogue kernel."""
    producer: str
    consumer: str
    shape: tuple[int, ...]
    dtype: str
    nbytes: int

    def describe(self) -> str:
        return (f"{self.producer} -> {self.consumer}: unpacked "
                f"{self.dtype}{list(self.shape)} ({self.nbytes} B) "
                f"crossed device memory outside the epilogue contract")


@dataclasses.dataclass(frozen=True)
class PackednessReport:
    """The pass's verdict on one traced forward."""
    policy: str
    launch_count: int
    complete: bool                # every launch read only traced values
    hbm_values: dict[str, int]    # class -> storages crossing a launch
    hbm_bytes: dict[str, int]     # class -> the largest such value
    max_live_unpacked_bytes: int
    max_unpacked_shape: tuple[int, ...]
    escapes: tuple[Escape, ...]

    @property
    def ok(self) -> bool:
        return not self.escapes and self.complete

    def to_json(self) -> dict[str, Any]:
        """The ``packedness/*`` report cells' form."""
        return {
            "policy": self.policy,
            "launch_count": self.launch_count,
            "complete": self.complete,
            "hbm_values": dict(sorted(self.hbm_values.items())),
            "hbm_bytes": dict(sorted(self.hbm_bytes.items())),
            "max_live_unpacked_bytes": self.max_live_unpacked_bytes,
            "max_unpacked_shape": list(self.max_unpacked_shape),
            "escapes": [e.describe() for e in self.escapes],
        }


def _op_base(name: str) -> str:
    """'aten.view.default' -> 'view'."""
    parts = name.split(".")
    return parts[1] if len(parts) > 1 else name


def _is_word_leaf(path: tuple) -> bool:
    return any(isinstance(p, str) and p in WORD_LEAVES for p in path)


class _Walker:
    """Classifies every value of a trace and follows the taint roots."""

    def __init__(self, tr: graph.Trace, policy: str):
        if policy not in POLICIES:
            raise ValueError(f"policy must be one of {POLICIES}, got "
                             f"{policy!r}")
        self.tr, self.policy = tr, policy
        n = len(tr.values)
        self.cls = ["staging"] * n
        self.producer = ["input"] * n
        self.kernel_out = [False] * n
        self.ancestry = [False] * n
        self.roots: list[frozenset[int]] = [frozenset()] * n
        self.last_use = [-1] * n
        self.boundary: set[int] = set()
        self.escapes: dict[int, list[str]] = {}
        self.complete = True

    def _storage(self, i: int) -> int:
        while self.tr.values[i].base is not None:
            i = self.tr.values[i].base
        return i

    def _class_of_leaf(self, v: graph.Value) -> str:
        if v.dtype.is_floating_point:
            return "float"
        return "packed" if _is_word_leaf(v.path) else "staging"

    def _tracked_root(self, i: int) -> bool:
        if not self.kernel_out[i] or self.cls[i] == "packed":
            return False
        return not (self.cls[i] == "float"
                    and self.policy == "float-residual")

    def _carried(self, i: int) -> set[int]:
        roots = set(self.roots[i])
        if self._tracked_root(i):
            roots.add(i)
        return roots

    def run(self) -> None:
        for i in self.tr.inputs:
            self.cls[i] = self._class_of_leaf(self.tr.values[i])
        for step, op in enumerate(self.tr.ops):
            for i in op.inputs:
                self.last_use[self._storage(i)] = step
                if self.tr.values[i].origin == "const":
                    self.cls[i] = self._class_of_leaf(self.tr.values[i])
                    if op.kernel is not None:
                        self.complete = False
            if op.kernel is not None:
                self._visit_kernel(op)
            else:
                self._visit_op(op)
        end = len(self.tr.ops)
        for i in self.tr.outputs:
            self.last_use[self._storage(i)] = end
            self.boundary.add(self._storage(i))   # the result stays there

    def _visit_kernel(self, op: graph.TracedOp) -> None:
        for i in op.inputs:
            self.boundary.add(self._storage(i))
            if op.kernel in EPILOGUE_KERNELS:
                continue
            for r in self._carried(i):
                if op.kernel not in self.escapes.setdefault(r, []):
                    self.escapes[r].append(op.kernel)
        for i in op.outputs:
            self.kernel_out[i] = self.ancestry[i] = True
            self.producer[i] = op.kernel
            self.boundary.add(i)
            if op.kernel in WORD_KERNELS:
                self.cls[i] = "packed"
            elif op.kernel in ACCUMULATOR_KERNELS:
                self.cls[i] = "unpacked"
            else:                           # K8's float output
                self.cls[i] = "float"

    def _visit_op(self, op: graph.TracedOp) -> None:
        base = _op_base(op.name)
        ins = op.inputs
        ancestry = any(self.ancestry[i] for i in ins)
        roots: set[int] = set()
        for i in ins:
            roots |= self._carried(i)
        all_packed = bool(ins) and all(self.cls[i] == "packed" for i in ins)
        for i in op.outputs:
            v = self.tr.values[i]
            self.producer[i] = base
            self.ancestry[i] = ancestry
            if all_packed and v.dtype == torch.int32 and \
                    (base in LAYOUT_OPS or base in BITWISE_OPS):
                self.cls[i] = "packed"
            elif v.dtype.is_floating_point:
                self.cls[i] = "float"
            else:
                self.cls[i] = "unpacked" if ancestry else "staging"
            out_roots = roots
            if out_roots and self.policy == "float-residual" and \
                    self.cls[i] == "float":
                out_roots = set()       # int -> float launders
            self.roots[i] = frozenset(out_roots)

    def max_live(self) -> tuple[int, tuple[int, ...]]:
        """Peak bytes of live unpacked storage (a view counts as its
        base) and the largest unpacked value's shape."""
        events, best = [], (0, ())
        produced = {}
        for step, op in enumerate(self.tr.ops):
            for i in op.outputs:
                produced.setdefault(i, step)
        for i, v in enumerate(self.tr.values):
            if self.cls[i] != "unpacked" or v.base is not None or \
                    self.last_use[i] < 0 or i not in produced:
                continue
            events.append((produced[i], 0, v.nbytes))
            events.append((self.last_use[i], 1, -v.nbytes))
            best = max(best, (v.nbytes, v.shape))
        live = peak = 0
        for _, _, delta in sorted(events):
            live += delta
            peak = max(peak, live)
        return peak, best[1]


def analyze_trace(tr: graph.Trace, policy: str = "strict"
                  ) -> PackednessReport:
    """The pass over an existing trace (``graph.trace``)."""
    w = _Walker(tr, policy)
    w.run()
    hbm_values: dict[str, int] = {}
    hbm_bytes: dict[str, int] = {}
    for i in w.boundary:
        c = w.cls[i]
        hbm_values[c] = hbm_values.get(c, 0) + 1
        hbm_bytes[c] = max(hbm_bytes.get(c, 0), tr.values[i].nbytes)
    escapes = [Escape(w.producer[r], k, tr.values[r].shape,
                      str(tr.values[r].dtype).removeprefix("torch."),
                      tr.values[r].nbytes)
               for r, ks in w.escapes.items() for k in ks]
    peak, shape = w.max_live()
    return PackednessReport(
        policy=policy,
        launch_count=sum(1 for op in tr.ops if op.kernel is not None),
        complete=w.complete, hbm_values=hbm_values, hbm_bytes=hbm_bytes,
        max_live_unpacked_bytes=peak, max_unpacked_shape=shape,
        escapes=tuple(sorted(escapes,
                             key=lambda e: (e.producer, e.consumer))))


def analyze_packedness(fn, *args, policy: str = "strict"
                       ) -> PackednessReport:
    """Trace ``fn(*args)`` on fake card tensors (nothing runs) and run the
    pass under ``policy``: ``'strict'`` or ``'float-residual'``."""
    if policy not in POLICIES:
        raise ValueError(f"policy must be one of {POLICIES}, got {policy!r}")
    return analyze_trace(graph.trace(fn, *args), policy)


def model_policy(kind: str) -> str:
    """The policy each workload family is held to."""
    return "float-residual" if kind == "transformer" else "strict"
