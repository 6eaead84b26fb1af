"""Shared-memory analysis: each kernel launch's grid, threads and dynamic
shared memory, in closed form, and what the card says of it.

The counterpart of the reference's VMEM pass (``analysis/vmem.py``).  On
the H100 the scarce per-launch resources are a block's shared memory
(232,448 bytes opt-in) and the SM's 65,536 registers, so each estimate
gives, for one launch:

* the kernel, and its ``route`` (the instance or path it takes);
* the grid and the threads a block, from the wrappers' own tile rules
  (``binary_matmul.gemm_route`` / ``stack_tile``, ``binary_conv.conv_tile``,
  ``bitpack.packs_aligned``, ``fused_epilogue.bn_sign_aligned``) at an
  explicit SM count: the card's, or ``library.CARDLESS_SMS`` without one;
* the dynamic shared memory as named terms, mirroring each launcher's
  arithmetic in ``csrc/`` (K1's band and chunk search included);
* on the card, the registers a thread and the static shared memory of
  the kernel instance, from its ptxas report (:func:`with_ptxas`).

The cost model itself lives beside the kernels: the types and the budget
in ``kernels/smem.py``, each launch's estimate in its kernel's module,
each op call's in ``kernels/library.py`` (:func:`estimate_call`); this
module re-exports them.  K1's and K6's launchers raise
:class:`SmemBudgetError` before launching where a block cannot hold the
launch, and a fake trace (``analysis.graph``) raises it for any launch
whose estimate does not fit.  :func:`estimate_forward` is the traced
view: one estimate per launch of a forward.  Each estimate carries the
arguments of its launcher's query entry (``csrc/common.cuh``:
``launch_query``); :func:`query_card` asks the built library what it
would launch, which ``chip_smoke.py`` holds every traced estimate to.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools
import re

from repro_torch.analysis import graph
from repro_torch.kernels import _build
from repro_torch.kernels import library as _lib
from repro_torch.kernels.binary_attention import attention_estimate
from repro_torch.kernels.binary_conv import bitplane_estimate, conv_estimate
from repro_torch.kernels.binary_matmul import (dense_stack_estimate,
                                               gemm_estimate, stack_terms)
from repro_torch.kernels.bitpack import bitpack_estimate
from repro_torch.kernels.fused_epilogue import bn_sign_pack_estimate
from repro_torch.kernels.library import estimate_call
from repro_torch.kernels.smem import (MAX_THREADS, REGS_PER_SM, SMEM_BUDGET,
                                      LaunchEstimate, SmemBudgetError,
                                      SmemTerm, preflight)

__all__ = [
    "MAX_THREADS", "REGS_PER_SM", "SMEM_BUDGET", "LaunchEstimate",
    "SmemBudgetError", "SmemTerm", "preflight", "attention_estimate",
    "bitpack_estimate", "bitplane_estimate", "bn_sign_pack_estimate",
    "conv_estimate", "dense_stack_estimate", "gemm_estimate", "stack_terms",
    "estimate_call", "estimate_forward", "query_card", "parse_ptxas",
    "ptxas_resources", "with_ptxas", "check_against_card", "CardLaunch",
]


def estimate_forward(fn, *args) -> list[LaunchEstimate]:
    """One estimate per launch of ``fn(*args)``, in launch order, from its
    fake trace (``analysis.graph``): nothing runs."""
    return [op.estimate for op in graph.trace(fn, *args).ops
            if op.estimate is not None]


# ---------------------------------------------------------------------------
# On the card: the launchers' queries and the ptxas report
# ---------------------------------------------------------------------------

# Each library's C entry table, its query entry among them: the wrappers'
# own, since ``_build.load`` types a library's entries at its first load
QUERY_ENTRIES = {spec.library: spec.entries for spec in _lib.SPECS.values()}


@dataclasses.dataclass(frozen=True)
class CardLaunch:
    """What a launcher answers for an estimate's query: grid, block,
    dynamic shared memory, the instance's registers a thread and static
    shared memory (``cudaFuncGetAttributes``) and its symbol."""
    grid: tuple[int, int, int]
    block: tuple[int, int, int]
    dynamic: int
    registers: int
    static_smem: int
    symbol: str


def query_card(estimate: LaunchEstimate) -> CardLaunch:
    """Ask the built library what its launcher would launch for
    ``estimate``'s sizes, without launching; needs the card."""
    lib_name, entry, ints = estimate.query
    lib = _build.load(lib_name, QUERY_ENTRIES[lib_name])
    out = (ctypes.c_int * 9)()
    name = ctypes.c_char_p()
    err = getattr(lib, entry)(*ints, ctypes.addressof(out),
                              ctypes.addressof(name))
    _build.check(err, entry)
    return CardLaunch(tuple(out[0:3]), tuple(out[3:6]), out[6], out[7],
                      out[8], name.value.decode())


_PTXAS_ENTRY = re.compile(r"Compiling entry function '([^']+)'")
_PTXAS_USED = re.compile(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?")


def parse_ptxas(text: str) -> dict[str, tuple[int, int]]:
    """``{symbol: (registers a thread, static shared memory bytes)}`` of
    every entry function in a ptxas ``-v`` log."""
    out, entry = {}, None
    for line in text.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            entry = m.group(1)
            continue
        m = _PTXAS_USED.search(line)
        if m and entry is not None:
            out[entry] = (int(m.group(1)), int(m.group(2) or 0))
            entry = None
    return out


@functools.lru_cache(maxsize=None)
def ptxas_resources() -> dict[str, tuple[int, int]]:
    """The ptxas report of every built library, parsed, by (mangled)
    symbol, as ``cudaFuncGetName`` names a kernel instance."""
    out = {}
    for text in _build.ptxas_report().values():
        out.update(parse_ptxas(text))
    return out


def with_ptxas(estimate: LaunchEstimate, launch: CardLaunch
               ) -> LaunchEstimate:
    """``estimate`` with the registers and static shared memory of the
    instance ``launch`` names, from the ptxas report; raises where the
    report lacks it or disagrees with the runtime's attributes."""
    found = ptxas_resources().get(launch.symbol)
    if found is None:
        raise LookupError(f"{launch.symbol} is not in the ptxas report")
    if found != (launch.registers, launch.static_smem):
        raise AssertionError(
            f"{launch.symbol}: ptxas reports {found} (registers, static "
            f"shared memory), the runtime {launch.registers}, "
            f"{launch.static_smem}")
    return dataclasses.replace(estimate, registers=found[0],
                               static_smem=found[1])


def check_against_card(estimate: LaunchEstimate) -> LaunchEstimate:
    """Hold ``estimate`` to its launcher's query (grid, threads, dynamic
    shared memory) and return it with the instance's registers and
    static shared memory; raises on any difference."""
    launch = query_card(estimate)
    want = (estimate.grid, (estimate.threads, 1, 1), estimate.dynamic)
    got = (launch.grid, launch.block, launch.dynamic)
    if got != want:
        raise AssertionError(f"{estimate.kernel} ({estimate.route}): the "
                             f"launcher would launch grid, block, smem "
                             f"{got}, the estimate says {want}")
    return with_ptxas(estimate, launch)
