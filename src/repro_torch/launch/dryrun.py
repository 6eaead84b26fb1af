"""The dry run: every (arch x shape) cell reckoned on the production mesh
with no card and no memory (the reference's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \
        --shape train_4k [--multi-pod] [--quant binary] [--out DIR]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The reference lowers and compiles each cell's step on 512 XLA devices and
reads XLA's memory and cost analyses.  The port has no such compiler.
For each cell it builds the state, params, cache and batch as meta
tensors (``launch.specs``, ``models.common.MetaGenerator``), places them
by the sharding rules on ``launch.mesh.make_production_mesh`` and records,
per position and from the specs alone:

* ``bytes_per_position``: params, optimizer state (``mu``, ``nu``, the
  step counter), gradient accumulators (train), decode cache and batch,
  the largest position's, and whether their sum fits the card's memory
  (``sharding.HBM_BYTES``, one H100's 80 GB).  Activations are not
  counted;
* ``step_traffic`` (train): what the port's sharded step
  (``train/trainer.py``) gathers, reduces and sums on this mesh, by the
  counting rule of ``distributed/fsdp.py`` applied to shapes
  (``fsdp.step_traffic``), summed over the data slices;
* ``param_counts`` and ``model_flops``: 6 x active params x tokens for
  train, 2 x for prefill and decode (one new token a sequence); the
  attention's own FLOPs are left out.

None of these is XLA's compiled quantity.  ``utils/hlo.py`` (collective
bytes read from compiled HLO) and ``utils/flags.py`` (``analysis_mode``,
which unrolls ``lax.scan`` for XLA's cost analysis) need no counterpart:
the port counts its own traffic, and its layers loop in Python.
Outputs: one JSON file per cell under ``--out``.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from repro_torch.configs import SHAPES, get_config, get_shape, list_configs
from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.core.quantize import QuantMode
from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import sharding as SH
from repro_torch.launch import specs as SP
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import common as C
from repro_torch.models import linear as LN
from repro_torch.models import model as M
from repro_torch.tree import tree_map


# --------------------------------------------------------------------------
# cell applicability
# --------------------------------------------------------------------------

def cell_skip_reason(cfg: ArchConfig, shape: ShapeConfig) -> str | None:
    if shape.name == "long_500k" and not cfg.subquadratic:
        return ("pure full-attention arch: long_500k requires "
                "sub-quadratic attention (unbounded KV at 524288); run "
                "for SSM/hybrid only")
    return None


def _microbatches(cfg: ArchConfig, shape: ShapeConfig, positions: int
                  ) -> int:
    """Gradient-accumulation depth that keeps a microbatch's saved layer
    inputs (B_mb x S x D x 2 bytes x L, over the mesh's positions) under
    4 GiB a position: the reference's rule, over ``positions`` rather
    than its literal 256."""
    tokens = shape.global_batch * shape.seq_len
    act_bytes = tokens * cfg.d_model * 2 * cfg.num_layers // positions
    target = 4 << 30
    mb = 1
    while mb < shape.global_batch and act_bytes // mb > target:
        mb *= 2
    return min(mb, 8)


# --------------------------------------------------------------------------
# meta trees
# --------------------------------------------------------------------------

def _train_params(cfg: ArchConfig):
    """The float32 master params as meta tensors."""
    return M.init_model(C.MetaGenerator(), cfg, device="meta")


def _serve_params(cfg: ArchConfig):
    """The inference params: packed in the binary modes (paper C2),
    float32 leaves cast to bfloat16, as the reference deploys them."""
    p = _train_params(cfg)
    if cfg.quant.mode != QuantMode.FLOAT:
        p = LN.maybe_pack_tree(p, cfg.quant, device="meta")
    return tree_map(lambda t: t.to(torch.bfloat16)
                    if isinstance(t, torch.Tensor)
                    and t.dtype == torch.float32 else t, p)


def _most(tree, specs, mesh) -> int:
    return max(SH.position_bytes(tree, specs, mesh))


def _train_cell(cfg, shape, mesh) -> dict:
    """The reference's baseline train cell: FSDP, float32 masters and
    gradients."""
    mb = _microbatches(cfg, shape, mesh.size)
    params = _train_params(cfg)
    pspecs = SH.param_specs(params, mesh)
    batch = SP.train_batch_specs(cfg, shape)
    p_bytes = _most(params, pspecs, mesh)
    out = {"params": p_bytes,
           "opt_state": 2 * p_bytes + 4,          # mu, nu, the counter
           "grads": p_bytes,
           "batch": _most(batch, SH.batch_specs(batch, mesh), mesh)}
    traffic = FS.step_traffic(params, pspecs, mesh, microbatches=mb)
    return {"fsdp": True, "microbatches": mb, "bytes_per_position": out,
            "step_traffic": {k.split(".", 1)[1]: v
                             for k, v in traffic.items()}}


def _prefill_cell(cfg, shape, mesh) -> dict:
    params = _serve_params(cfg)
    pspecs = SH.param_specs(params, mesh)
    batch = SP.prefill_batch_specs(cfg, shape)
    bspecs = SH.batch_specs(batch, mesh)
    return {"bytes_per_position": {
        "params": _most(params, pspecs, mesh),
        "batch": _most(batch, bspecs, mesh)}, "step_traffic": None}


def _decode_cell(cfg, shape, mesh) -> dict:
    params = _serve_params(cfg)
    pspecs = SH.param_specs(params, mesh)
    cache = M.init_cache(params, cfg, shape.global_batch, shape.seq_len)
    # the production default: S over 'model' (GQA head counts rarely
    # divide 16), S over the data axes too at batch 1
    cspecs = SH.cache_specs(cache, mesh,
                            shard_seq=shape.global_batch == 1,
                            kv_layout="seq_model")
    tokens = {"tokens": SP.decode_token_specs(shape)}
    return {"bytes_per_position": {
        "params": _most(params, pspecs, mesh),
        "cache": _most(cache, cspecs, mesh),
        "batch": _most(tokens, SH.batch_specs(tokens, mesh), mesh)},
        "step_traffic": None}


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6 x active params x tokens (train), 2 x (prefill, decode: one new
    token a sequence); attention's own FLOPs left out."""
    active = cfg.param_counts()["active"]
    if shape.kind == "train":
        return 6.0 * active * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * active * shape.global_batch * shape.seq_len
    return 2.0 * active * shape.global_batch


# --------------------------------------------------------------------------
# cell runner
# --------------------------------------------------------------------------

def run_cell(arch: str, shape_name: str, *, multi_pod: bool = False,
             quant: str | None = None, out_dir: str | None = None) -> dict:
    """One cell's record (written to ``out_dir`` where given)."""
    cfg = get_config(arch, quant=quant)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    record: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "axes": list(mesh.axes), "positions": mesh.size,
        "quant": quant or "float", "kind": shape.kind,
        "num_layers": cfg.num_layers,
    }
    skip = cell_skip_reason(cfg, shape)
    if skip:
        record["status"] = "skipped"
        record["skip_reason"] = skip
        _save(record, out_dir)
        return record
    by_kind = {"train": _train_cell, "prefill": _prefill_cell,
                "decode": _decode_cell}
    t0 = time.monotonic()
    record.update(by_kind[shape.kind](cfg, shape, mesh))
    total = sum(record["bytes_per_position"].values())
    record.update({
        "status": "ok",
        "build_s": time.monotonic() - t0,
        "bytes_per_position_total": total,
        "hbm_bytes": SH.HBM_BYTES,
        "fits_hbm": total <= SH.HBM_BYTES,
        "param_counts": cfg.param_counts(),
        "model_flops": model_flops(cfg, shape),
        "model_flops_per_position": model_flops(cfg, shape) / mesh.size,
    })
    _save(record, out_dir)
    return record


def _cell_id(record: dict) -> str:
    return (f"{record['arch']}__{record['shape']}__{record['mesh']}"
            f"__{record['quant']}")


def _save(record: dict, out_dir: str | None) -> None:
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, _cell_id(record) + ".json")
        with open(path, "w") as f:
            json.dump(record, f, indent=1)
    line = (f"[dryrun] {record['arch']:28s} {record['shape']:12s} "
            f"{record['mesh']:9s} {record['quant']:13s} "
            f"-> {record['status']}")
    if record["status"] == "ok":
        line += (f"  {record['bytes_per_position_total'] / 1e9:.4g} GB a "
                 f"position (fits {record['fits_hbm']})  flops/position "
                 f"{record['model_flops_per_position']:.3e}")
    print(line, flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=list_configs())
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--quant", default=None,
                    choices=[None, "float", "binary_weight", "binary"])
    ap.add_argument("--out", default="experiments/dryrun_torch")
    args = ap.parse_args(argv)

    if args.all:
        cells = [(a, s) for a in list_configs() for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch and --shape, or --all")
    failures = []
    for a, s in cells:
        try:
            run_cell(a, s, multi_pod=args.multi_pod, quant=args.quant,
                     out_dir=args.out)
        except Exception as e:  # noqa: BLE001 — report every cell's failure
            failures.append((a, s, repr(e)))
            print(f"[dryrun] {a} {s} FAILED: {e!r}")
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + ", ".join(f"{a}/{s}" for a, s, _ in failures))


if __name__ == "__main__":
    main()
