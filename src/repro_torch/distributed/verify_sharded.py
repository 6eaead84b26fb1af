"""Sharded packed-forward verifier, in one process.

Proves that ``make_sharded_forward`` is

* **bit-identical** to the unsharded packed forward (the int32 pre-BN
  outputs and the logits) for every mesh shape (data, model) in
  :data:`MESH_SHAPES`, for both evaluation networks, including stages
  that are not word-divisible and so replicate;
* **gather-free on the data-parallel path**: an (8, 1) mesh gathers
  nothing;
* **packed-words-only on the model path**: a model mesh gathers exactly
  the packed words of its sharded seams (:func:`expected_gathers`); an
  int32 partial sum or an unpacked activation crossing positions would
  show as more bytes;

plus a serving cell (a ``PackedInferenceServer`` with a (4, 2) mesh
behind its queue) and a degrade cell (a supervised server losing 4 of
its 8 positions).

The reference forces 8 CPU devices on JAX in a process of its own
(``src/repro/distributed/subproc.py``).  The port's mesh takes any list
of devices, one device standing at several positions, so the verifier
runs in the caller's process and needs no forced count:

    PYTHONPATH=src python -m repro_torch.distributed.verify_sharded \\
        [--json] [--device cpu]

On the card (the default device) each position runs the kernels; on the
CPU their plain versions.
"""
from __future__ import annotations

import argparse
import json
import math
import time

import torch

from repro_torch import telemetry
from repro_torch.core.binarize import WORD_BITS
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import cnn

MESH_SHAPES = ((8, 1), (4, 2), (2, 4), (1, 8))
BATCH = 8

# Small nets that still hit every seam: stages word-divisible at every
# model degree up to 4 (128 % (32·4) == 0 shards the bit-plane first stage
# 4 ways; 64 % (32·2) == 0 shards only 2 ways), a stage (48, and 96 in
# the MLP) that is NOT word-divisible for model > 1 (it replicates), a
# pooled sharded stage (sharded pool masks), the grouped conv->dense
# flatten, and at model 8 nothing word-divisible at all.
BCNN_SPEC = cnn.BCNNSpec(
    input_hw=(8, 8), c_in=3,
    stages=(cnn.ConvStage(128), cnn.ConvStage(48, pool=True),
            cnn.ConvStage(64, pool=True)),
    dense=(128, 10))
BMLP_SIZES = (784, 128, 96, 10)


def build(kind: str, device) -> tuple:
    """(packed tree on ``device``, input batch on the host, the unsharded
    forward's int32 pre-BN outputs, its logits), weights from seed 0."""
    gen = torch.Generator().manual_seed(0)
    if kind == "bcnn":
        packed = cnn.pack_bcnn(cnn.init_bcnn(gen, BCNN_SPEC), BCNN_SPEC,
                               device=device)
        x = torch.randint(0, 256, (BATCH, *BCNN_SPEC.input_hw,
                                   BCNN_SPEC.c_in), generator=gen,
                          dtype=torch.uint8)
        forward_int = cnn.bcnn_forward_packed_int
    else:
        spec = cnn.BMLPSpec(sizes=BMLP_SIZES)
        packed = cnn.pack_bmlp(cnn.init_bmlp(gen, spec), spec, device=device)
        x = torch.randint(0, 256, (BATCH, BMLP_SIZES[0]), generator=gen,
                          dtype=torch.uint8)
        forward_int = cnn.bmlp_forward_packed_int
    want_int = forward_int(packed, x.to(device))
    return packed, x, want_int, cnn.apply_output_batchnorm(packed, want_int)


def seam_shapes(packed, shard_plan: dict) -> list[tuple[int, ...]]:
    """The per-example shape of the packed words each sharded stage's
    seam reassembles, in forward order: (OH, OW, Cw) after a conv stage
    (and its pool), (Nw,) after a dense layer."""
    if cnn.packed_kind(packed) == "bmlp":
        douts = [p["w_packed"].shape[0] for p in packed["layers"]]
        return [(d // WORD_BITS,) for d, s in zip(douts, shard_plan["layer"])
                if s > 1]
    shapes = []
    for pc, st, s in zip(packed["convs"], packed["spec"].stages,
                         shard_plan["conv"]):
        if s > 1:
            oh, ow = pc["out_hw"]
            if st.pool:
                oh, ow = oh // 2, ow // 2
            shapes.append((oh, ow, pc["c_out"] // WORD_BITS))
    douts = [p["w_packed"].shape[0] for p in packed["denses"]]
    return shapes + [(d // WORD_BITS,) for d, s in
                     zip(douts, shard_plan["dense"]) if s > 1]


def expected_gathers(packed, shard_plan: dict, mesh, batch: int) -> tuple:
    """(gathers, bytes) of one forward of ``batch`` examples: one gather
    per sharded seam, each position receiving its ``|model| - 1`` peers'
    word spans of its data slice, so a seam of ``w`` words per example
    moves ``(|model| - 1) · batch · w · 4`` bytes."""
    shapes = seam_shapes(packed, shard_plan)
    peers = mesh.shape.get("model", 1) - 1
    return len(shapes), sum(peers * batch * math.prod(s) * 4
                            for s in shapes)


def gather_counts() -> tuple[int, int]:
    """(``sharding.gathers``, ``sharding.gathered_bytes``) so far."""
    m = telemetry.default().metrics
    return m.value("sharding.gathers"), m.value("sharding.gathered_bytes")


def run_cells(device="cuda", backend: str = "auto") -> list[dict]:
    built = {kind: build(kind, device) for kind in ("bcnn", "bmlp")}
    results = []
    for kind in ("bcnn", "bmlp"):
        packed, x, want_int, want = built[kind]
        for shape in MESH_SHAPES:
            mesh = make_host_mesh(*shape, device=device)
            fwd = SH.make_sharded_forward(packed, mesh, backend=backend)
            g0, b0 = gather_counts()
            t0 = time.perf_counter()
            got_int = fwd.forward_int(x)
            t_first = time.perf_counter() - t0
            g1, b1 = gather_counts()
            t0 = time.perf_counter()
            got = fwd(x)
            t_steady = time.perf_counter() - t0
            expect = expected_gathers(packed, fwd.shard_plan, mesh, BATCH)
            bitexact = (torch.equal(got_int, want_int)
                        and torch.equal(got, want))
            gathers = (g1 - g0, b1 - b0)
            results.append({
                "kind": kind, "mesh": list(shape), "backend": backend,
                "bitexact": bitexact,
                "shard_plan": {k: list(v)
                               for k, v in fwd.shard_plan.items()},
                "gathers": gathers[0], "gathered_bytes": gathers[1],
                "expected_gathers": list(expect),
                "fwd_first_us": t_first * 1e6, "fwd_us": t_steady * 1e6,
                "ok": (bitexact and gathers == expect
                       and (shape[1] > 1 or gathers == (0, 0))),
            })
    results.append(serve_cell(built, device, backend))
    results.append(degrade_cell(built, device, backend))
    return results


def serve_cell(built: dict, device, backend: str) -> dict:
    """A ``PackedInferenceServer`` with the (4, 2) mesh behind its queue.

    Ragged submits, a deadline flush and a second flush must return rows
    bit-identical to the unsharded forward, and the flush buckets must
    honour the mesh's ``batch_multiple`` (4 here): the 5 first requests
    ride bucket 8, the 3 later ones bucket 4.
    """
    from repro_torch.train import serve as SV

    packed, x, _, want = built["bcnn"]
    clock = SV.SimClock()
    srv = SV.PackedInferenceServer(max_batch=BATCH, default_deadline=0.005,
                                   clock=clock, device=device)
    srv.register("bcnn-serve", packed=packed, backend=backend,
                 mesh=make_host_mesh(4, 2, device=device))
    eng = srv.engine()
    rids = [srv.submit(x[i]) for i in range(5)]
    done = srv.step()                       # deadline still in the future
    clock.advance(1.0)
    done += srv.step()
    rids += [srv.submit(x[i]) for i in range(5, BATCH)]
    clock.advance(1.0)
    done += srv.step()
    by = {r.rid: r.result for r in done}
    bitexact = (sorted(by) == rids and torch.equal(
        torch.stack([by[rid] for rid in rids]), want.cpu()))
    t0 = time.perf_counter()
    srv.serve([x[i] for i in range(BATCH)])
    t_steady = time.perf_counter() - t0
    flushes = [(f.bucket, f.route) for f in srv.flushes[:2]]
    return {
        "kind": "bcnn", "mesh": [4, 2], "backend": "serve",
        "bitexact": bitexact,
        "shard_plan": {k: list(v) for k, v in eng.fwd.shard_plan.items()},
        "buckets": list(eng.buckets), "flushes": flushes,
        "fwd_us": t_steady * 1e6,
        "ok": (bitexact and all(b % eng.batch_multiple == 0
                                for b in eng.buckets)
               and flushes == [(8, "gemv"), (4, "gemv")]),
    }


def degrade_cell(built: dict, device, backend: str) -> dict:
    """A supervised server on the (4, 2) mesh loses 4 of its 8 positions
    mid-flight (``runtime.faults`` injection).  The ``ServingSupervisor``
    must remesh onto the survivors (``remesh_plan`` -> (2, 2)), re-place
    the packed weights, rebuild the engine under the queue and serve the
    requeued window bit-identical to the unsharded forward."""
    from repro_torch.runtime.faults import FaultInjector, FaultPlan, FaultSpec
    from repro_torch.runtime.supervisor import ServingSupervisor
    from repro_torch.train import serve as SV

    packed, x, _, want = built["bcnn"]
    clock = SV.SimClock()
    srv = SV.PackedInferenceServer(max_batch=BATCH, default_deadline=0.005,
                                   clock=clock, device=device)
    srv.register("bcnn-degrade", packed=packed, backend=backend,
                 mesh=make_host_mesh(4, 2, device=device))
    sup = ServingSupervisor(srv, "bcnn-degrade", backend=backend)
    FaultInjector(FaultPlan.of(
        FaultSpec("device_loss", survivors=4))).attach(srv)
    rids = [srv.submit(x[i]) for i in range(BATCH)]
    t0 = time.perf_counter()
    done = sup.step()           # loss -> degrade -> requeued window served
    t_first = time.perf_counter() - t0
    by = {r.rid: r for r in done}
    bitexact = (sorted(by) == rids
                and all(by[rid].status == "ok" for rid in rids)
                and torch.equal(torch.stack([by[rid].result for rid in rids]),
                                want.cpu()))
    eng = srv.engine("bcnn-degrade")
    m = srv.telemetry.metrics
    return {
        "kind": "bcnn", "mesh": list(eng.fwd.mesh.shape.values()),
        "backend": "degrade", "bitexact": bitexact,
        "shard_plan": {k: list(v) for k, v in eng.fwd.shard_plan.items()},
        "fwd_first_us": t_first * 1e6,
        "ok": (bitexact and sup.events[0].mesh_shape == (2, 2)
               and tuple(eng.fwd.mesh.shape.values()) == (2, 2)
               and eng.fwd.mesh.size == 4
               and m.value("serve.degraded") == 1
               and m.value("serve.degraded_state") == 0),
    }


def main(argv: list[str] | None = None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--json", action="store_true",
                    help="machine-readable output only")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default; raises without a card) or "
                         "'cpu'")
    args = ap.parse_args(argv)
    results = run_cells(device=args.device)
    if args.json:
        print(json.dumps(results))
    else:
        for r in results:
            print(f"{r['kind']} mesh={tuple(r['mesh'])} {r['backend']:7s} "
                  f"bitexact={r['bitexact']} "
                  f"gathers={r.get('gathers', '-')} "
                  f"bytes={r.get('gathered_bytes', '-')} "
                  f"shards={r['shard_plan']} "
                  f"{'OK' if r['ok'] else 'FAIL'}")
    bad = [r for r in results if not r["ok"]]
    if bad:
        raise SystemExit(f"{len(bad)} sharded-forward cells failed")


if __name__ == "__main__":
    main()
