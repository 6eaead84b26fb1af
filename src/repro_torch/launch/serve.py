"""Packed-inference serving launcher (the Espresso prediction phase).

Builds a BCNN or BMLP with random weights (seed 0), registers it with
``train.serve.PackedInferenceServer`` (pack + fold BN ONCE via the
weight cache, on ``--device``), replays a deterministic arrival trace
against the continuous-batching queue, and prints per-request p50/p99
latency, throughput, and the bucket and K4 route of every flush:

    # on the card: the paper's BCNNSpec() at full width
    PYTHONPATH=src python -m repro_torch.launch.serve --model bcnn \
        --requests 64 --max-batch 16 --deadline-ms 5

    # on the CPU, CI-sized shapes (models.cnn.demo_model) and few requests
    PYTHONPATH=src python -m repro_torch.launch.serve --model bmlp \
        --smoke --device cpu

    # a (data, model) mesh behind the queue; every position on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --model bcnn \
        --mesh 2,2

    # the chaos drill: scripted faults on a (4, 2) mesh, recovery report
    PYTHONPATH=src python -m repro_torch.launch.serve --model bcnn --chaos

Without ``--smoke`` the model is ``BCNNSpec()`` or ``BMLPSpec()``.  A
mesh's positions go round-robin over the visible devices of ``--device``
(``launch.mesh.make_host_mesh``), so one card holds them all; the
reference forces host devices for its mesh instead.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import statistics
import tempfile
import time

import torch

from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import cnn
from repro_torch.train import serve as SV


def build_model(kind: str, smoke: bool):
    """(params, spec, kind): ``demo_model`` when ``smoke``, else the
    paper's network at full width, weights from seed 0."""
    if smoke:
        return cnn.demo_model(kind, smoke=True)
    gen = torch.Generator().manual_seed(0)
    if kind == "bcnn":
        spec = cnn.BCNNSpec()
        return cnn.init_bcnn(gen, spec), spec, kind
    spec = cnn.BMLPSpec()
    return cnn.init_bmlp(gen, spec), spec, kind


def run_chaos(params, spec, kind: str, *, device="cuda",
              backend: str = "auto", deadline_ms: float = 5.0) -> dict:
    """The chaos drill: scripted faults of every kind against one
    supervised server on a (4, 2) mesh, then a recovery report with hard
    invariants (the reference's ``run_chaos``).  Returns the report;
    ``report["invariants"]`` maps each invariant to whether it held.

    Phases (each installs a fresh ``FaultInjector`` so its dispatch
    indices are phase-local; the ``SimClock`` makes the whole drill
    deterministic):

    1. ``transient``   — dispatch fails twice, heals inside the retry
       budget: every request ``ok``, retries > 0.
    2. ``poison``      — one rid fails every cohort containing it:
       bisection isolates it (``error``), cohort-mates ``ok``.
    3. ``persistent``  — a whole cohort keeps failing (``error`` x4);
       the NEXT wave is untouched (failure isolation).
    4. ``slow``        — a 1 s flush stall; the following wave ages past
       ``timeout_grace`` and completes ``timeout``.
    5. ``device_loss`` — 8 -> 4 devices: elastic degrade (remesh +
       packed-checkpoint warm restore + engine rebuild under the
       queue), requeued wave served ``ok`` and bit-exact.
    6. ``device_loss@bisect`` — the loss OVERLAPS bisection: a poison
       rid splits the cohort, the loss strikes a clean bisected half,
       and the not-yet-dispatched siblings must requeue too; degrade
       4 -> 2, poison ``error``, everything else ``ok``.
    7. ``shed``        — queue filled to ``max_queue``; the next submit
       raises the typed ``BackpressureError``.
    8. ``recovery``    — a clean wave on the degraded mesh: all ``ok``,
       bit-exact, degraded gauge back at 0.

    Served rows are held to the unsharded forward exactly; the packed
    checkpoint lives in a temporary directory removed at the end.
    """
    from repro_torch.runtime import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.runtime.supervisor import ServingSupervisor

    clock = SV.SimClock()
    srv = SV.PackedInferenceServer(
        max_batch=8, default_deadline=deadline_ms / 1e3, max_queue=16,
        timeout_grace=50.0, clock=clock, device=device)
    srv.register("demo", params, spec, kind=kind, backend=backend,
                 mesh=make_host_mesh(4, 2, device=device))
    eng = srv.engine()
    gen = torch.Generator().manual_seed(0)
    xs = torch.randint(0, 256, (16, *eng.example_shape), generator=gen,
                       dtype=torch.uint8)
    ref = cnn.make_packed_forward(eng.packed, backend=backend)(xs).cpu()

    submitted: list[int] = []
    finished: dict[int, SV.ServeRequest] = {}
    report: list[dict] = []
    shed = 0

    with tempfile.TemporaryDirectory(prefix="chaos_ckpt_") as ckpt_dir:
        sup = ServingSupervisor(srv, "demo", ckpt_dir=ckpt_dir,
                                backend=backend)
        sup.checkpoint()                 # healthy-path packed checkpoint

        def wave(n, *, plan=None, supervised=False, advance=0.006,
                 phase=""):
            inj = FaultInjector(plan).attach(srv) if plan is not None \
                else None
            if plan is None:
                srv.flush_hook = None
            wave_rids = []
            for _ in range(n):
                i = len(submitted) % 16
                rid = srv.submit(xs[i])
                submitted.append(rid)
                wave_rids.append((rid, i))
            clock.advance(advance)
            for r in (sup.step() if supervised else srv.step()):
                finished[r.rid] = r
            statuses = [finished[rid].status if rid in finished else "LOST"
                        for rid, _ in wave_rids]
            exact = all(finished[rid].status != "ok"
                        or torch.equal(finished[rid].result, ref[i])
                        for rid, i in wave_rids if rid in finished)
            report.append({"phase": phase, "statuses": statuses,
                           "bitexact": exact,
                           "injected": list(inj.injected) if inj else []})

        wave(8, plan=FaultPlan.of(FaultSpec("transient", times=2)),
             phase="transient")
        poison_rid = len(submitted) + 3
        wave(8, plan=FaultPlan.of(FaultSpec("poison", rid=poison_rid)),
             phase="poison")
        wave(4, plan=FaultPlan.of(FaultSpec("persistent")),
             phase="persistent")
        wave(4, plan=None, phase="persistent-aftermath")
        wave(4, plan=FaultPlan.of(FaultSpec("slow", delay_s=1.0)),
             phase="slow")
        wave(4, plan=None, advance=0.400, phase="slow-aftermath(timeout)")
        wave(8, plan=FaultPlan.of(FaultSpec("device_loss", survivors=4)),
             supervised=True, phase="device_loss")
        # device loss overlapping bisection: with the default 3-attempt
        # budget, dispatches 0-2 fail on the full poisoned cohort and 3-5
        # on its poisoned first half, so dispatch 6 is the first CLEAN
        # bisected pair: the armed loss fires there, with the poison pair
        # and the whole second half never dispatched.
        poison_rid2 = len(submitted) + 3
        wave(8, plan=FaultPlan.of(
                FaultSpec("poison", rid=poison_rid2),
                FaultSpec("device_loss", survivors=2, at_dispatch=6)),
             supervised=True, phase="device_loss@bisect")
        # shed: fill the queue to max_queue, the next submit must raise
        srv.flush_hook = None
        submitted.extend(srv.submit(xs[i % 16]) for i in range(16))
        try:
            srv.submit(xs[0])
            report.append({"phase": "shed", "statuses": ["NOT-RAISED"],
                           "bitexact": True, "injected": []})
        except SV.BackpressureError:
            shed += 1
            report.append({"phase": "shed", "statuses": ["shed"],
                           "bitexact": True, "injected": []})
        clock.advance(0.006)
        for r in sup.step():
            finished[r.rid] = r
        wave(8, plan=None, phase="recovery")

    m = srv.telemetry.metrics
    lost = [rid for rid in submitted
            if rid not in finished
            or finished[rid].status not in SV.TERMINAL_STATES]
    tally = {s: sum(1 for r in finished.values() if r.status == s)
             for s in SV.TERMINAL_STATES}
    tally["shed"] = shed
    invariants = {
        "retries>0": m.value("serve.retries") > 0,
        "errors>0": m.value("serve.errors") > 0,
        "timeouts>0": m.value("serve.timeouts") > 0,
        "shed>0": m.value("serve.shed") > 0,
        "degraded==2": m.value("serve.degraded") == 2,
        "degraded_state==0": m.value("serve.degraded_state") == 0,
        "zero_lost": not lost,
        "all_waves_bitexact": all(p["bitexact"] for p in report),
        "recovery_all_ok": all(
            finished[rid].status == "ok" for rid in submitted[-8:]
            if rid in finished),
        "ckpt_restore": bool(sup.events
                             and all(e.restored_from == "checkpoint"
                                     for e in sup.events)),
        "survivor_mesh": ([e.mesh_shape for e in sup.events]
                          == [(2, 2), (1, 2)]),
    }
    return {
        "tally": tally, "submitted": len(submitted), "lost": len(lost),
        "invariants": invariants, "phases": report,
        "events": [dataclasses.asdict(e) for e in sup.events],
        "metrics": {k: v for k, v in m.snapshot().items()
                    if k.startswith(("serve.", "faults."))},
    }


def print_chaos(out: dict) -> None:
    """The drill's report as lines: each phase's statuses, the tally, the
    degrade events and each invariant."""
    for p in out["phases"]:
        print(f"  {p['phase']:26s} {p['statuses']}"
              f"{'' if p['bitexact'] else '  BITEXACT-FAIL'}")
    print(f"terminal tally: {out['tally']}  (submitted={out['submitted']}, "
          f"lost={out['lost']})")
    print(f"degrade events: {out['events']}")
    print("recovery invariants:")
    for name, ok in out["invariants"].items():
        print(f"  [{'PASS' if ok else 'FAIL'}] {name}")


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--model", choices=("bcnn", "bmlp"), default="bmlp")
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--max-batch", type=int, default=8)
    ap.add_argument("--deadline-ms", type=float, default=5.0)
    ap.add_argument("--arrival-ms", type=float, default=0.0,
                    help="inter-arrival gap (0 = back-to-back)")
    ap.add_argument("--device", default="cuda",
                    help="where the model is packed and run: 'cuda' (the "
                         "default; raises without a card) or 'cpu'")
    ap.add_argument("--mesh", default=None,
                    help="data,model mesh behind the queue, e.g. 2,2")
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized shapes and request count")
    ap.add_argument("--chaos", action="store_true",
                    help="run the scripted fault-injection drill on a "
                         "(4, 2) mesh and print a recovery report; exits "
                         "non-zero if any recovery invariant fails")
    ap.add_argument("--chaos-report", default=None, metavar="PATH",
                    help="write the chaos recovery report as JSON")
    ap.add_argument("--metrics", action="store_true",
                    help="print the server's telemetry metrics snapshot "
                         "as JSON after the run")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="enable span tracing and write a Chrome "
                         "trace_event JSON (open in Perfetto / "
                         "chrome://tracing)")
    args = ap.parse_args(argv)
    if args.smoke:
        args.requests = min(args.requests, 12)
    mesh = None
    if args.mesh:
        try:
            shape = tuple(int(d) for d in args.mesh.split(","))
            if len(shape) != 2 or any(d < 1 for d in shape):
                raise ValueError(args.mesh)
        except ValueError:
            ap.error(f"--mesh must be 'data,model' positive ints, "
                     f"got {args.mesh!r}")
        mesh = make_host_mesh(*shape, device=args.device)

    params, spec, kind = build_model(args.model, args.smoke)
    if args.chaos:
        print(f"chaos drill: 8 phases on a (4,2) mesh of {args.device}, "
              f"SimClock-driven")
        out = run_chaos(params, spec, kind, device=args.device,
                        deadline_ms=args.deadline_ms)
        print_chaos(out)
        if args.chaos_report:
            with open(args.chaos_report, "w") as f:
                json.dump(out, f, indent=1, sort_keys=True)
            print(f"wrote chaos report -> {args.chaos_report}")
        bad = [n for n, ok in out["invariants"].items() if not ok]
        if bad:
            raise SystemExit(f"chaos drill FAILED: {bad}")
        print("chaos drill PASSED: server degraded, recovered, lost nothing")
        return

    srv = SV.PackedInferenceServer(max_batch=args.max_batch,
                                   default_deadline=args.deadline_ms / 1e3,
                                   device=args.device)
    if args.trace_out:
        srv.telemetry.enable_tracing()
    t0 = time.monotonic()
    srv.register("demo", params, spec, kind=kind, mesh=mesh)
    eng = srv.engine()
    print(f"registered {kind} on {srv.device} (packed once in "
          f"{time.monotonic() - t0:.2f}s) buckets={eng.buckets}"
          f" batch_multiple={eng.batch_multiple} route@1="
          f"{srv.route_for(1)} route@{args.max_batch}="
          f"{srv.route_for(args.max_batch)}")

    gen = torch.Generator().manual_seed(0)
    xs = torch.randint(0, 256, (args.requests, *eng.example_shape),
                       generator=gen, dtype=torch.uint8)
    t0 = time.monotonic()
    # Collect completions from the step() returns, NOT from srv.served:
    # served is bounded history (truncated to the mailbox cap), so
    # percentiles over it would drop the oldest requests once --requests
    # exceeds the cap.
    done = []
    for i in range(args.requests):
        srv.submit(xs[i])
        if args.arrival_ms:
            time.sleep(args.arrival_ms / 1e3)
        done += srv.step()
    while srv.pending():
        done += srv.step()
        time.sleep(args.deadline_ms / 4e3)
    wall = time.monotonic() - t0

    lats = sorted(r.latency for r in done)
    p50 = statistics.median(lats)
    p99 = SV.latency_percentile(lats, 0.99)
    print(f"served {len(done)} requests in {wall:.2f}s "
          f"({len(done) / wall:.1f} req/s)")
    print(f"latency p50={p50 * 1e3:.2f}ms p99={p99 * 1e3:.2f}ms")
    for f in srv.flushes:
        print(f"  flush batch={f.batch} bucket={f.bucket} route={f.route} "
              f"wall={f.wall_s * 1e3:.2f}ms")
    print(f"weight cache: {srv.cache.misses} pack(s), {srv.cache.hits} "
          f"hit(s); scratch pool: {srv.pool.allocations} buffer(s) for "
          f"{len(srv.flushes)} flushes")
    if args.metrics:
        print(json.dumps(srv.telemetry.metrics.snapshot(), indent=1,
                         sort_keys=True))
    if args.trace_out:
        srv.telemetry.tracer.export(args.trace_out)
        print(f"wrote {len(srv.telemetry.tracer.events)} trace events -> "
              f"{args.trace_out} (open in Perfetto / chrome://tracing)")


if __name__ == "__main__":
    main()
