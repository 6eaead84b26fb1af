"""Runtime: keep serving alive through failures.

* ``faults`` — the fault-injection harness (scripted chaos via the
  server's ``flush_hook`` seam).

The reference's serving supervisor, elastic mesh planning and training
supervision are not ported yet (ROADMAP.md, queue 1, item 6).
"""
from repro_torch.runtime.faults import (FAULT_KINDS, FaultInjector, FaultPlan,
                                        FaultSpec, InjectedFault,
                                        PersistentFlushError,
                                        PoisonRequestError,
                                        TransientFlushError)

__all__ = [
    "FAULT_KINDS", "FaultInjector", "FaultPlan", "FaultSpec",
    "InjectedFault", "PersistentFlushError", "PoisonRequestError",
    "TransientFlushError",
]
