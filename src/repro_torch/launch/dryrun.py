"""The dry run: every (arch x shape) cell reckoned on the production mesh
with no card and no memory (the reference's ``launch/dryrun.py``).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch starcoder2-3b \
        --shape train_4k [--multi-pod] [--quant binary] [--out DIR] \
        [--fsdp true|false|auto] [--grads-bf16] [--replicate-embed] \
        [--ssm-split] [--kv-int8] [--kv-layout seq_model|batch_heads] \
        [--layers N] [--tag TAG]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The options are the reference's ``run_cell(..., layers_override, opts,
tag)``, with its defaults and meanings: ``fsdp`` (True, False or
``"auto"``, ``sharding.should_fsdp``) and ``replicate_embed`` choose the
params' specs (the prefill and decode cells replicate over the data
axes only where ``fsdp`` is False), ``grads_bf16`` halves the gradient
accumulators and the gradients' traffic, ``ssm_split`` builds Mamba-2's
split form (``fused_proj=False``, tensor-parallel over ``model``),
``kv_int8`` the int8 decode cache, ``kv_layout`` the cache's layout
(``"seq_model"`` by default), ``layers_override`` the depth; the record
carries ``opts``, ``tag`` and ``layers_override``, and the cell's file
name the depth and the tag, as the reference's does.

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
* ``param_specs`` (and ``cache_specs`` for decode): ``{path: spec}``;
* ``step_traffic`` (train): what the port's sharded step
  (``train/trainer.py``: FSDP over the data axes, tensor parallelism over
  ``model`` wherever ``fsdp.split_blocks`` lets a block split on whole
  units, the embedding and the head vocabulary-parallel wherever
  ``fsdp.vocab_split`` lets them) moves on this mesh, by the counting
  rule of
  ``distributed/fsdp.py`` applied to shapes (``fsdp.step_traffic``),
  summed over the data slices: the weights' gathers, reduces and partial
  sums, and the tensor-parallel blocks' activation reduces, input-gradient
  reduces and gathers (``tp_*``);
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
import dataclasses
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


def _fsdp(cfg, mesh, opts: dict) -> bool:
    """The reference's train-cell rule: FSDP unless ``opts["fsdp"]`` is
    False; ``"auto"`` asks ``sharding.should_fsdp``."""
    fsdp = opts.get("fsdp")
    if fsdp is None:
        return True
    if fsdp == "auto":
        return SH.should_fsdp(cfg, mesh)
    return bool(fsdp)


def _spec_record(specs: dict) -> dict:
    return {p: list(spec) for p, spec in specs.items()}


def _train_cell(cfg, shape, mesh, opts: dict) -> dict:
    """The reference's train cell: FSDP (or ZeRO-0, ``opts["fsdp"]``),
    float32 masters and gradients (bfloat16 with ``grads_bf16``), the
    table replicated with ``replicate_embed``."""
    mb = _microbatches(cfg, shape, mesh.size)
    fsdp = _fsdp(cfg, mesh, opts)
    grads_bf16 = bool(opts.get("grads_bf16", False))
    params = _train_params(cfg)
    pspecs = SH.param_specs(params, mesh, fsdp=fsdp,
                            replicate_embed=opts.get("replicate_embed",
                                                     False))
    batch = SP.train_batch_specs(cfg, shape)
    p_bytes = _most(params, pspecs, mesh)
    grads = p_bytes if not grads_bf16 else _most(
        tree_map(lambda t: t.to(torch.bfloat16), params), pspecs, mesh)
    out = {"params": p_bytes,
           "opt_state": 2 * p_bytes + 4,          # mu, nu, the counter
           "grads": grads,
           "batch": _most(batch, SH.batch_specs(batch, mesh), mesh)}
    traffic = FS.step_traffic(params, pspecs, mesh, microbatches=mb,
                              grads_bf16=grads_bf16, cfg=cfg, batch=batch)
    return {"fsdp": fsdp, "microbatches": mb, "bytes_per_position": out,
            "param_specs": _spec_record(pspecs),
            "step_traffic": {k.split(".", 1)[1]: v
                             for k, v in traffic.items()}}


def _serve_specs(params, mesh, opts: dict) -> dict:
    """The serving cells' params specs: FSDP unless ``opts["fsdp"]`` is
    False, as the reference's prefill and decode builders read it."""
    return SH.param_specs(params, mesh,
                          fsdp=opts.get("fsdp", True) is not False)


def _prefill_cell(cfg, shape, mesh, opts: dict) -> dict:
    params = _serve_params(cfg)
    pspecs = _serve_specs(params, mesh, opts)
    batch = SP.prefill_batch_specs(cfg, shape)
    bspecs = SH.batch_specs(batch, mesh)
    return {"bytes_per_position": {
        "params": _most(params, pspecs, mesh),
        "batch": _most(batch, bspecs, mesh)},
        "param_specs": _spec_record(pspecs), "step_traffic": None}


def _decode_cell(cfg, shape, mesh, opts: dict) -> dict:
    params = _serve_params(cfg)
    pspecs = _serve_specs(params, mesh, opts)
    cache = M.init_cache(params, cfg, shape.global_batch, shape.seq_len)
    # the production default: S over 'model' (GQA head counts rarely
    # divide 16), S over the data axes too at batch 1
    cspecs = SH.cache_specs(cache, mesh,
                            shard_seq=shape.global_batch == 1,
                            kv_layout=opts.get("kv_layout", "seq_model"))
    tokens = {"tokens": SP.decode_token_specs(shape)}
    return {"bytes_per_position": {
        "params": _most(params, pspecs, mesh),
        "cache": _most(cache, cspecs, mesh),
        "batch": _most(tokens, SH.batch_specs(tokens, mesh), mesh)},
        "param_specs": _spec_record(pspecs),
        "cache_specs": _spec_record(cspecs), "step_traffic": None}


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
             quant: str | None = None, out_dir: str | None = None,
             layers_override: int | None = None, opts: dict | None = None,
             tag: str = "") -> dict:
    """One cell's record (written to ``out_dir`` where given), with the
    reference's options (the module docstring)."""
    opts = dict(opts or {})
    cfg = get_config(arch, quant=quant)
    if opts.get("ssm_split") and cfg.ssm is not None:
        cfg = dataclasses.replace(cfg, ssm=dataclasses.replace(
            cfg.ssm, fused_proj=False))
    if opts.get("kv_int8"):
        cfg = dataclasses.replace(cfg, kv_cache_dtype="int8")
    if layers_override is not None:
        cfg = dataclasses.replace(cfg, num_layers=layers_override)
    shape = get_shape(shape_name)
    mesh = make_production_mesh(multi_pod=multi_pod)
    record: dict = {
        "arch": arch, "shape": shape_name,
        "mesh": "x".join(str(n) for n in mesh.shape.values()),
        "axes": list(mesh.axes), "positions": mesh.size,
        "quant": quant or "float", "kind": shape.kind,
        "layers_override": layers_override,
        "num_layers": cfg.num_layers,
        "opts": opts, "tag": tag,
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
    record.update(by_kind[shape.kind](cfg, shape, mesh, opts))
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
    base = (f"{record['arch']}__{record['shape']}__{record['mesh']}"
            f"__{record['quant']}")
    if record.get("layers_override"):
        base += f"__L{record['layers_override']}"
    if record.get("tag"):
        base += f"__{record['tag']}"
    return base


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
    ap.add_argument("--fsdp", default=None, choices=["true", "false",
                                                     "auto"])
    ap.add_argument("--grads-bf16", action="store_true")
    ap.add_argument("--replicate-embed", action="store_true")
    ap.add_argument("--ssm-split", action="store_true")
    ap.add_argument("--kv-int8", action="store_true")
    ap.add_argument("--kv-layout", default=None,
                    choices=["seq_model", "batch_heads"])
    ap.add_argument("--layers", type=int, default=None)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)
    opts = {k: v for k, v in (
        ("fsdp", {"true": True, "false": False, "auto": "auto"}.get(
            args.fsdp)),
        ("grads_bf16", args.grads_bf16 or None),
        ("replicate_embed", args.replicate_embed or None),
        ("ssm_split", args.ssm_split or None),
        ("kv_int8", args.kv_int8 or None),
        ("kv_layout", args.kv_layout)) if v is not None}

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
                     out_dir=args.out, layers_override=args.layers,
                     opts=opts, tag=args.tag)
        except Exception as e:  # noqa: BLE001 — report every cell's failure
            failures.append((a, s, repr(e)))
            print(f"[dryrun] {a} {s} FAILED: {e!r}")
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: "
                         + ", ".join(f"{a}/{s}" for a, s, _ in failures))


if __name__ == "__main__":
    main()
