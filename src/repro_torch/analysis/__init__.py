"""Static analysis of the port: machine-checked packed-BCNN invariants.

The passes, each over a fake trace of a forward (:mod:`.graph`) or over
the source:

* :mod:`.packedness`: a dataflow proof that activations stay packed
  between kernels;
* :mod:`.smem`: per-launch shared-memory estimation (the cost model of
  ``kernels/smem.py`` and the kernel modules), the traced view the
  report records, and the card's own account of each launch;
* :mod:`.collectives`: the sharded forward's collective rules, on the
  port's own gather counters;
* :mod:`.lint`: the repo's conventions over ``src/repro_torch``
  (``python -m repro_torch.analysis.lint``).

:mod:`.report` merges them into the baseline ``python -m
repro_torch.analysis --check`` gates (``ANALYSIS_baseline.json`` beside
this file).
"""
from repro_torch.analysis.graph import (HostSyncError, KernelLaunch, Trace,
                                        count_kernel_launches,
                                        kernel_launches,
                                        max_intermediate_bytes, trace)
from repro_torch.analysis.smem import (LaunchEstimate, SmemBudgetError,
                                       SmemTerm, estimate_call,
                                       estimate_forward, preflight)

__all__ = [
    "HostSyncError", "KernelLaunch", "Trace", "count_kernel_launches",
    "kernel_launches", "max_intermediate_bytes", "trace",
    "LaunchEstimate", "SmemBudgetError", "SmemTerm", "estimate_call",
    "estimate_forward", "preflight",
]
