"""Runtime: keep serving alive through failures.

* ``fault_tolerance`` — step-loop supervision (checkpoint/restart,
  straggler re-dispatch).
* ``elastic`` — survivor-mesh planning on a device-set change.
* ``faults`` — the fault-injection harness (scripted chaos via the
  server's ``flush_hook`` seam).
* ``supervisor`` — serving-loop supervision (device loss -> elastic
  mesh degradation with packed-weight warm restore).
"""
from repro_torch.runtime.elastic import MeshPlan, remesh_plan
from repro_torch.runtime.fault_tolerance import (StepFailure, Supervisor,
                                                 SupervisorConfig,
                                                 SupervisorReport)
from repro_torch.runtime.faults import (FAULT_KINDS, FaultInjector, FaultPlan,
                                        FaultSpec, InjectedFault,
                                        PersistentFlushError,
                                        PoisonRequestError,
                                        TransientFlushError)
from repro_torch.runtime.supervisor import DegradeEvent, ServingSupervisor

__all__ = [
    "MeshPlan", "remesh_plan",
    "StepFailure", "Supervisor", "SupervisorConfig", "SupervisorReport",
    "FAULT_KINDS", "FaultInjector", "FaultPlan", "FaultSpec",
    "InjectedFault", "PersistentFlushError", "PoisonRequestError",
    "TransientFlushError",
    "DegradeEvent", "ServingSupervisor",
]
