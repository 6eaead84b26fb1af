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

Without ``--smoke`` the model is ``BCNNSpec()`` or ``BMLPSpec()``.  The
reference's ``--mesh`` and ``--chaos`` are not ported (ROADMAP.md, queue
1, items 6 and 7).
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

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
    ap.add_argument("--smoke", action="store_true",
                    help="CI-sized shapes and request count")
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

    params, spec, kind = build_model(args.model, args.smoke)
    srv = SV.PackedInferenceServer(max_batch=args.max_batch,
                                   default_deadline=args.deadline_ms / 1e3,
                                   device=args.device)
    if args.trace_out:
        srv.telemetry.enable_tracing()
    t0 = time.monotonic()
    srv.register("demo", params, spec, kind=kind)
    eng = srv.engine()
    print(f"registered {kind} on {srv.device} (packed once in "
          f"{time.monotonic() - t0:.2f}s) buckets={eng.buckets}"
          f" route@1={srv.route_for(1)} route@{args.max_batch}="
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
