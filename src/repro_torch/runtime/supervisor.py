"""Serving supervisor: elastic degradation of the packed-inference
server.

``Supervisor`` (``fault_tolerance.py``) owns a step loop.  This module
owns the SERVING loop: a :class:`ServingSupervisor` wraps a
:class:`~repro_torch.train.serve.PackedInferenceServer` and turns
:class:`~repro_torch.train.serve.DeviceLossError`, raised out of a flush
when a device behind the engine disappears, into mesh degradation
instead of a dead server:

1. the failed window is already back at the front of the queue (the
   server requeues before re-raising: zero requests lost);
2. :func:`~repro_torch.runtime.elastic.remesh_plan` computes the
   survivor (data, model) mesh, never growing the model degree, over a
   prefix of the supervisor's device list;
3. the packed weights are warm-restored, from the newest packed
   checkpoint (``checkpoint.load_packed_checkpoint``) when a
   ``ckpt_dir`` is configured, else from the live tree
   (``sharding.reshard_packed(..., None)``): 32x-compressed packed
   words either way;
4. the engine is swapped under the queue by
   ``PackedInferenceServer.rebuild_engine`` on the new mesh (NO flush
   through the dead engine), and the survivors serve the requeued
   requests on the next step, bit-exact.

Observability: ``serve.degraded`` counts degradations, the
``serve.degraded_state`` gauge is 1 only while a degrade is in flight
(0 after recovery), and each event is kept in
:attr:`ServingSupervisor.events`.
"""
from __future__ import annotations

import dataclasses
import time

from repro_torch.checkpoint import (latest_step, load_packed_checkpoint,
                                    save_packed_checkpoint)
from repro_torch.distributed.sharding import reshard_packed
from repro_torch.runtime.elastic import remesh_plan
from repro_torch.train.serve import DeviceLossError, ServeRequest


@dataclasses.dataclass(frozen=True)
class DegradeEvent:
    """One completed elastic degradation; ``wall_s`` is its host time
    (remesh, restore and rebuild), not part of its identity."""
    survivors: int
    mesh_shape: tuple[int, int]
    restored_from: str            # 'checkpoint' | 'live'
    requeued: int
    wall_s: float = dataclasses.field(default=0.0, compare=False)


class ServingSupervisor:
    """Keeps one server serving through device loss.

    ``key`` names the registered model to supervise; ``devices`` is the
    device list the survivor prefix is drawn from: by default the
    supervised engine's mesh devices, or the server's device where the
    engine has no mesh.  ``ckpt_dir`` enables checkpoint warm-restore:
    call :meth:`checkpoint` while healthy, and a degrade restores from the
    newest packed checkpoint instead of the live tree.
    """

    def __init__(self, server, key, *, ckpt_dir: str | None = None,
                 devices=None, min_model: int = 1,
                 backend: str = "auto", dense_stack: str = "auto"):
        self.server = server
        self.key = key
        self.ckpt_dir = ckpt_dir
        if devices is None:
            mesh = getattr(server.engine(key).fwd, "mesh", None)
            devices = mesh.devices if mesh is not None else [server.device]
        self.devices = list(devices)
        self.min_model = min_model
        self.backend = backend
        self.dense_stack = dense_stack
        self.events: list[DegradeEvent] = []
        m = server.telemetry.metrics
        self._m_degraded = m.counter("serve.degraded")
        self._g_degraded = m.gauge("serve.degraded_state")
        self._ckpt_steps = 0

    # -- checkpointing (healthy path) ---------------------------------------

    def checkpoint(self) -> str | None:
        """Save the supervised engine's packed tree (no-op without a
        ``ckpt_dir``).  Returns the checkpoint path."""
        if self.ckpt_dir is None:
            return None
        packed = self.server.engine(self.key).packed
        path = save_packed_checkpoint(self.ckpt_dir, self._ckpt_steps,
                                      reshard_packed(packed, None))
        self._ckpt_steps += 1
        return path

    # -- supervised stepping ------------------------------------------------

    def step(self, now: float | None = None) -> list[ServeRequest]:
        """``server.step`` with device-loss recovery: on
        :class:`DeviceLossError` the mesh degrades to the survivors and
        the step is re-driven so the requeued window completes on the new
        engine."""
        try:
            return self.server.step(now)
        except DeviceLossError as e:
            self.degrade(e.survivors)
            return self.server.step(now)

    def drain(self) -> list[ServeRequest]:
        """``server.flush`` with the same recovery contract."""
        try:
            return self.server.flush()
        except DeviceLossError as e:
            self.degrade(e.survivors)
            return self.server.flush()

    # -- elastic degradation ------------------------------------------------

    def _current_model_degree(self) -> int:
        mesh = getattr(self.server.engine(self.key).fwd, "mesh", None)
        if mesh is None:
            return 1
        return int(mesh.shape.get("model", 1))

    def degrade(self, survivors: int) -> DegradeEvent:
        """Shrink to ``survivors`` devices: remesh, warm-restore the packed
        weights, rebuild the engine under the queue.  Raises
        ``ValueError`` for more survivors than the device list holds."""
        if survivors > len(self.devices):
            raise ValueError(f"{survivors} survivors of "
                             f"{len(self.devices)} devices")
        t0 = time.perf_counter()
        self._m_degraded.inc()
        self._g_degraded.set(1)
        requeued = self.server.pending()
        plan = remesh_plan(survivors,
                           prefer_model=self._current_model_degree(),
                           min_model=self.min_model)
        mesh = plan.build(self.devices[:survivors])
        step = (latest_step(self.ckpt_dir)
                if self.ckpt_dir is not None else None)
        live = reshard_packed(self.server.engine(self.key).packed, None)
        if step is not None:
            packed, _ = load_packed_checkpoint(self.ckpt_dir, step, live)
            restored_from = "checkpoint"
        else:
            packed, restored_from = live, "live"
        self.server.rebuild_engine(self.key, packed=packed,
                                   backend=self.backend,
                                   dense_stack=self.dense_stack,
                                   mesh=mesh)
        self._g_degraded.set(0)        # recovery complete
        event = DegradeEvent(survivors=survivors, mesh_shape=plan.shape,
                             restored_from=restored_from,
                             requeued=requeued,
                             wall_s=time.perf_counter() - t0)
        self.events.append(event)
        return event
