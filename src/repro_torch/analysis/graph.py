"""Traced-program graph core: a forward run on fake tensors, op by op,
without running a kernel or touching a device.

The reference walks a jaxpr; the port has none, so :func:`trace` runs the
function itself under ``FakeTensorMode`` with a ``TorchDispatchMode``
that records every op: its name, the values it reads and the values it
makes (shape, dtype, bytes), and, for a ``repro_torch::`` op
(``kernels.library``), the launch's estimate (``library.estimate_call``:
kernel, route, grid, threads, shared memory) at an explicit SM count; a
launch whose estimate does not fit a block raises
``kernels.smem.SmemBudgetError``, as the launcher would on the card.  Every
static pass reads this one trace: :func:`kernel_launches` (the launch
list the probes record), :func:`count_kernel_launches`,
:func:`max_intermediate_bytes` (the largest tensor an op outside a kernel
makes), ``analysis.packedness`` and ``analysis.smem.estimate_forward``.

The function's tensor arguments (the packed tree and the input, any
nesting of dicts, lists and tuples) are replaced by fake twins on the
card (``torch.empty_strided(..., device="cuda")``); no data moves, so a
full-width network traces on a host without a card.  CPU-only PyTorch
refuses a few Python bindings on such twins (indexing, ``~``,
``contiguous`` of a strided tensor, a device without an index), which
guard the card's device first; a ``TorchFunctionMode`` routes those to
the aten ops underneath.  A forward that reads a value back to the host
(``.item()``, ``.tolist()``) cannot be traced: :class:`HostSyncError`.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch
from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                           DynamicOutputShapeException,
                                           FakeTensorMode)
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import library as _lib
from repro_torch.kernels import smem as _smem

_CUDA0 = torch.device("cuda", 0)


@dataclasses.dataclass(frozen=True)
class KernelLaunch:
    """One traced kernel launch: the kernel, its grid and its route."""
    kernel: str
    grid: tuple[int, ...]
    route: str


@dataclasses.dataclass
class Value:
    """One tensor the trace saw: an argument leaf (``origin`` 'input',
    with its ``path`` in the arguments), or an op's output (``origin`` the
    op's index); ``base`` is the value it aliases (a view), else None."""
    shape: tuple[int, ...]
    dtype: torch.dtype
    nbytes: int
    origin: Any
    path: tuple = ()
    base: int | None = None


@dataclasses.dataclass
class TracedOp:
    """One op: its name, the values it reads and makes, and for a kernel
    launch its kernel name and estimate."""
    name: str
    inputs: tuple[int, ...]
    outputs: tuple[int, ...]
    kernel: str | None = None
    estimate: _smem.LaunchEstimate | None = None


@dataclasses.dataclass
class Trace:
    """A traced call: its values, its ops in order, the values of the
    arguments' tensor leaves and of the result's."""
    values: list[Value]
    ops: list[TracedOp]
    inputs: list[int]
    outputs: list[int]

    def launches(self) -> list[KernelLaunch]:
        return [KernelLaunch(op.kernel, op.estimate.grid, op.estimate.route)
                for op in self.ops if op.kernel is not None]


class HostSyncError(RuntimeError):
    """The traced function read a device value back to the host."""


def _cuda0(d):
    """A card device without an index, as index 0 (CPU-only PyTorch asks
    the card for its current index); anything else as it is."""
    if isinstance(d, str) and d == "cuda":
        return _CUDA0
    if isinstance(d, torch.device) and d.type == "cuda" and d.index is None:
        return _CUDA0
    return d


def _getitem(t: torch.Tensor, idx) -> torch.Tensor:
    """``t[idx]`` through aten ops, as PyTorch's own indexing applies it:
    ints select, slices slice, None unsqueezes, then integer tensors (or
    lists) index the dims they stand at."""
    if not isinstance(idx, tuple):
        idx = (idx,)
    used = sum(1 for i in idx if i is not None and i is not Ellipsis)
    expanded = []
    for i in idx:
        if i is Ellipsis:
            expanded += [slice(None)] * (t.dim() - used)
        else:
            expanded.append(i)
    aten = torch.ops.aten
    out, dim, index = t, 0, {}
    for i in expanded:
        if i is None:
            out = aten.unsqueeze.default(out, dim)
            dim += 1
        elif isinstance(i, bool):
            raise NotImplementedError("boolean indexing is not traced")
        elif isinstance(i, int):
            out = aten.select.int(out, dim, i)
        elif isinstance(i, slice):
            if i != slice(None):
                out = aten.slice.Tensor(out, dim, i.start, i.stop,
                                        i.step or 1)
            dim += 1
        else:
            if isinstance(i, (list, tuple)):
                i = torch.tensor(i, device=t.device)
            if i.dtype == torch.bool:
                raise NotImplementedError("boolean indexing is not traced")
            index[dim] = i
            dim += 1
    if index:
        out = aten.index.Tensor(out, [index.get(d) for d in
                                      range(max(index) + 1)])
    return out


class _CardBindings(TorchFunctionMode):
    """The few Python bindings CPU-only PyTorch refuses on fake card
    tensors, routed to the aten ops they call."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if func is torch.Tensor.__getitem__:
            return _getitem(*args)
        if func is torch.Tensor.contiguous:
            t = args[0]
            if t.is_contiguous():
                return t
            return torch.ops.aten.clone.default(
                t, memory_format=torch.contiguous_format)
        if func is torch.Tensor.__invert__:
            return torch.ops.aten.bitwise_not.default(args[0])
        if func is torch.Tensor.cuda:
            return args[0].to(_CUDA0)
        args = tuple(_cuda0(a) for a in args)
        if "device" in kwargs:
            kwargs = {**kwargs, "device": _cuda0(kwargs["device"])}
        return func(*args, **kwargs)


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _aliases(func) -> bool:
    return any(r.alias_info is not None for r in func._schema.returns)


class _Recorder(TorchDispatchMode):
    """Records every op of a fake run into a :class:`Trace`."""

    def __init__(self, sms: int | None):
        super().__init__()
        self.sms = sms
        self.values: list[Value] = []
        self.ops: list[TracedOp] = []
        self.ids: dict[int, int] = {}
        self.keep: list[torch.Tensor] = []     # ids stay unique while alive

    def value(self, t: torch.Tensor, origin, path=(), base=None) -> int:
        self.keep.append(t)
        self.values.append(Value(tuple(t.shape), t.dtype,
                                 t.numel() * t.element_size(), origin, path,
                                 base))
        self.ids[id(t)] = len(self.values) - 1
        return len(self.values) - 1

    def lookup(self, t: torch.Tensor) -> int:
        """A tensor's value; one the trace never saw made (a constant the
        function holds) becomes a value of origin 'const'."""
        idx = self.ids.get(id(t))
        return self.value(t, "const") if idx is None else idx

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        kernel = _lib.kernel_of(func)
        estimate = None
        if kernel is not None:      # refused before the op runs
            estimate = _smem.preflight(
                _lib.estimate_call(kernel, args, sms=self.sms))
        try:
            out = func(*args, **kwargs)
        except (DataDependentOutputException,
                DynamicOutputShapeException) as e:
            raise HostSyncError(f"{func} needs a device value on the host: "
                                f"{e}") from e
        made = _tensors(out)
        if not made:                # ``.device`` and the like: no value
            return out
        inputs = tuple(self.lookup(t)
                       for t in _tensors((args, kwargs)))
        step = len(self.ops)
        base = inputs[0] if inputs and _aliases(func) else None
        outputs = tuple(self.value(t, step, base=base) for t in made)
        self.ops.append(TracedOp(str(func), inputs, outputs, kernel,
                                 estimate))
        return out


def _twin(tree, make, path=()):
    """``tree`` with every tensor leaf replaced by ``make(leaf, path)``."""
    if isinstance(tree, torch.Tensor):
        return make(tree, path)
    if isinstance(tree, list):
        return [_twin(x, make, (*path, i)) for i, x in enumerate(tree)]
    if isinstance(tree, tuple):
        return tuple(_twin(x, make, (*path, i)) for i, x in enumerate(tree))
    if isinstance(tree, dict):
        return {k: _twin(x, make, (*path, k)) for k, x in tree.items()}
    return tree


def trace(fn, *args, sms: int | None = None, fake: bool = True) -> Trace:
    """Run ``fn(*args)`` on fake twins of its tensor arguments on the card
    and record every op (module docstring).  ``sms``: the SM count the
    launches' tile rules take (default: the card's, or
    ``library.CARDLESS_SMS`` without one).  ``fake=False`` records a real run
    on the arguments as they are instead (on the card: every kernel
    launches), for holding a fake trace to."""
    rec = _Recorder(sms)
    inputs: list[int] = []

    def make(t, path):
        if fake:
            t = torch.empty_strided(tuple(t.shape), t.stride(),
                                    dtype=t.dtype, device=_CUDA0)
        inputs.append(rec.value(t, "input", path))
        return t

    if not fake:
        with rec:
            out = fn(*_twin(args, make))
    else:
        with FakeTensorMode(allow_non_fake_inputs=True):
            fake_args = _twin(args, make)
            with _CardBindings(), rec:
                out = fn(*fake_args)
    outputs = [rec.lookup(t) for t in _tensors(out)]
    return Trace(rec.values, rec.ops, inputs, outputs)


def kernel_launches(fn, *args, sms: int | None = None) -> list[KernelLaunch]:
    """Every kernel launch of ``fn(*args)``, in launch order, with its
    kernel, grid and route; nothing runs."""
    return trace(fn, *args, sms=sms).launches()


def count_kernel_launches(fn, *args) -> int:
    """The number of kernel launches of ``fn(*args)``."""
    return len(kernel_launches(fn, *args))


def intermediates(tr: Trace):
    """Each value an op outside a kernel makes (no view, no kernel
    output), as (value, index)."""
    for op in tr.ops:
        if op.kernel is not None:
            continue
        for i in op.outputs:
            if tr.values[i].base is None:
                yield tr.values[i], i


def max_intermediate_bytes(fn, *args) -> tuple[int, tuple[int, ...]]:
    """(bytes, shape) of the largest tensor an op outside a kernel makes:
    the device-memory high-water mark of the plain tensor ops between
    kernels."""
    best = max(intermediates(trace(fn, *args)),
               key=lambda vi: vi[0].nbytes, default=None)
    return (0, ()) if best is None else (best[0].nbytes, best[0].shape)
