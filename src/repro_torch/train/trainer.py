"""The training step (the reference's ``train/trainer.py``): loss,
gradients, AdamW, with microbatched gradient accumulation, optional
1-bit gradient compression (signSGD-EF), bfloat16 gradients, and the
paper's latent clipping in the binary modes.

``make_train_step(cfg, tc)`` returns ``step(state, batch) -> (state,
metrics)`` over ``state = {"params", "opt": {"mu", "nu", "step"},
["ef_error"]}``, the reference's layout, so a state crosses between the
packages (``convert.train_state_to_torch``, ``checkpoint/``).  The step
writes the new state into the tensors of the one it is given, as the
reference's launcher donates its state to the jitted step: a 3B-parameter
model has no room for two.  A caller that needs the state from before a
step (``Supervisor``'s straggler re-dispatch) passes the step a copy.

Over a mesh.  ``make_train_step(cfg, tc, mesh=mesh)`` is the step over
a single-controller mesh (``launch.mesh``): the state placed by
:func:`state_specs` (the reference's launcher's specs: ``param_specs``
for the params, ``mu``, ``nu`` and ``ef_error``, the counter replicated),
the batch by ``sharding.batch_specs``.  Each data slice runs its forward
and backward in turn, FSDP over the data axes and tensor-parallel over
``model``: a block that splits on whole units (``fsdp.split_blocks``)
runs at each model position on that position's slices, inside the block
functions, the embedding and the loss's logits run vocabulary-parallel
where the table's and the head's vocabulary split over ``model``
(``fsdp.vocab_split``), every other weight is gathered whole per layer
group, and each gradient is reduced to the copies that hold its slices
(``distributed/fsdp.py``, which counts every gather and reduce); the loss
is the mean of the data slices' and microbatches' losses, the gradients'
norm and the compression scale sum over whole leaves, and AdamW and
``clip_latent`` run on each copy of each leaf, once.

Gradients.  The params of a model zoo tree are stacked over depth; the
step differentiates with respect to per-layer views of them
(``common.layer_of``), each an autograd leaf whose ``.grad`` is set
beforehand to the matching view of one zeroed buffer per stacked leaf.
Backward then adds each layer's gradient into that buffer in place:
no full-size zero gradient is made for every layer that indexes a
stacked leaf, and microbatches accumulate in the same buffers.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.quantize import QuantMode
from repro_torch.distributed import fsdp as FS
from repro_torch.distributed import sharding as SH
from repro_torch.models import common as C
from repro_torch.models import model as M
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw as OPT
from repro_torch.optim import compress as CMP
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import leaves_with_path, sorted_paths


@dataclass(frozen=True)
class TrainConfig:
    microbatches: int = 1
    compress_grads: bool = False
    grads_bf16: bool = False       # differentiate with respect to bf16
                                   # casts of the float32 masters: bf16
                                   # gradients (half the data-parallel
                                   # bytes); AdamW updates the masters
    lr: float = 3e-4
    warmup: int = 100
    total_steps: int = 10000


def make_opt_config(cfg, tc: TrainConfig) -> OPT.AdamWConfig:
    return OPT.AdamWConfig(lr=tc.lr,
                           clip_latent=cfg.quant.mode != QuantMode.FLOAT)


def init_train_state(gen: torch.Generator, cfg, tc: TrainConfig,
                     device="cuda") -> dict:
    """Params from ``M.init_model`` (drawn from ``gen``, placed on
    ``device``: the card unless the caller asks for the CPU), zero
    moments and error buffer."""
    params = M.init_model(gen, cfg, device=device)
    state = {"params": params, "opt": OPT.adamw_init(params)}
    if tc.compress_grads:
        state["ef_error"] = CMP.signsgd_ef_init(params)
    return state


def grad_leaves(params: dict, cfg, dtype=None) -> tuple:
    """(leaves, grads): ``leaves`` is the params' tree with every stacked
    group of layers split into a list of per-group trees of autograd leaf
    views (``common.layer_of`` reads them), cast to ``dtype`` first where
    given; ``grads`` is a zeroed tree of the params' structure (in
    ``dtype`` if given), each leaf view's ``.grad`` preset to its view of
    it, so that backward accumulates into ``grads`` in place
    (``common.grad_views``)."""
    leaves, grads = {}, {}
    for k, v in params.items():
        if k == "stack":
            pairs = [C.grad_views(seg, dtype, n)
                     for (_, n), seg in zip(TF.segments_of(cfg), v)]
            leaves[k] = [lv for lv, _ in pairs]
            grads[k] = [gv for _, gv in pairs]
        elif k == "encdec":
            depth = {"enc": cfg.encoder_layers, "dec": cfg.num_layers}
            pairs = {e: C.grad_views(sub, dtype, depth.get(e))
                     for e, sub in v.items()}
            leaves[k] = {e: lv for e, (lv, _) in pairs.items()}
            grads[k] = {e: gv for e, (_, gv) in pairs.items()}
        else:
            leaves[k], grads[k] = C.grad_views(v, dtype)
    return leaves, grads


def _split_microbatches(batch: dict, n: int) -> list[dict]:
    """``n`` equal slices of every batch tensor along axis 0."""
    out = []
    for i in range(n):
        mb = {}
        for k, x in batch.items():
            if x.shape[0] % n:
                raise ValueError(f"batch {x.shape[0]} of {k!r} does not "
                                 f"split into {n} microbatches")
            m = x.shape[0] // n
            mb[k] = x[i * m:(i + 1) * m]
        out.append(mb)
    return out


def state_specs(state: dict, mesh, *, fsdp: bool = True) -> dict:
    """{path: spec} of a train state on ``mesh``: ``param_specs`` for the
    params and for ``mu``, ``nu`` and ``ef_error`` alike, the step counter
    replicated (the reference's ``launch/train.py``)."""
    pspecs = SH.param_specs(state["params"], mesh, fsdp=fsdp)
    prefixes = ["params", "opt/mu", "opt/nu"]
    if "ef_error" in state:
        prefixes.append("ef_error")
    out = {"opt/step": ()}
    for pre in prefixes:
        out.update({f"{pre}/{p}": spec for p, spec in pspecs.items()})
    return out


def make_train_step(cfg, tc: TrainConfig, mark=None, *, mesh=None):
    """``step(state, batch) -> (state, {"loss", "grad_norm", "lr"})``,
    float32 0-d tensors.  ``batch``: {"tokens", "labels"} (and
    "embeds"/"enc_embeds" where the config takes them) on the params'
    device.  The new state is written into ``state``'s tensors.

    With ``mesh``, the step over it: ``state`` placed on it by
    :func:`state_specs` (``sharding.Shardings(mesh, specs).place``), the
    batch placed by ``sharding.batch_specs`` (or tensors, placed by them
    here); its rows must split over the mesh's data slices.

    ``mark``, where given, is called with ``"begin"`` as the step starts
    and then after each part of it with that part's name: ``"grad
    buffers"``, ``"forward"`` and ``"backward"`` for each microbatch,
    ``"compress"`` where it runs, ``"adamw"``.  A caller times the parts
    with it (a CUDA event recorded at each mark)."""
    opt_cfg = make_opt_config(cfg, tc)
    dtype = torch.bfloat16 if tc.grads_bf16 else None
    mark = mark or (lambda name: None)
    if mesh is not None:
        return _sharded_train_step(cfg, tc, mesh, mark, opt_cfg, dtype)

    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        mark("begin")
        params = state["params"]
        leaves, grads = grad_leaves(params, cfg, dtype)
        views = [(t, t.grad) for _, t in leaves_with_path(leaves)
                 if t.requires_grad]
        mark("grad buffers")
        n = tc.microbatches
        loss = None
        for mb in _split_microbatches(batch, n):
            mb_loss = M.loss_fn(leaves, cfg, mb)
            mark("forward")
            mb_loss.backward()
            mark("backward")
            mb_loss = mb_loss.detach()
            loss = mb_loss if loss is None else loss + mb_loss
        if any(t.grad is not g for t, g in views):
            raise RuntimeError("backward replaced a preset gradient buffer "
                               "instead of adding into it")
        del leaves, views
        if n > 1:
            loss = loss / n
            for _, g in leaves_with_path(grads):
                g.div_(n)
        if tc.compress_grads:
            CMP.signsgd_ef_compress(grads, state["ef_error"])
            mark("compress")
        lr_scale = cosine_schedule(state["opt"]["step"], warmup=tc.warmup,
                                   total=tc.total_steps)
        new_params, new_opt, gnorm = OPT.adamw_update(
            opt_cfg, params, grads, state["opt"], lr_scale)
        mark("adamw")
        new_state = {"params": new_params, "opt": new_opt}
        if tc.compress_grads:
            new_state["ef_error"] = state["ef_error"]
        metrics = {"loss": loss, "grad_norm": gnorm,
                   "lr": lr_scale * opt_cfg.lr}
        return new_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# The step over a mesh
# ---------------------------------------------------------------------------

def _data_rows(batch: dict, mesh, firsts: list) -> list[dict]:
    """Each data slice's rows of a batch placed by ``batch_specs`` (placed
    here where a leaf is a tensor), from its first position."""
    if not all(isinstance(v, SH.Placed) for v in batch.values()):
        batch = SH.Shardings(mesh, SH.batch_specs(batch, mesh)).place(batch)
    rows = [{k: v.shards[p] for k, v in batch.items()} for p in firsts]
    for k, v in batch.items():
        if sum(r[k].shape[0] for r in rows) != v.shape[0]:
            raise ValueError(f"batch {v.shape[0]} of {k!r} does not split "
                             f"over the mesh's {len(firsts)} data slices")
    return rows


def _copies(placed) -> list[torch.Tensor]:
    return [t for t, _, _ in placed.copies()]


def _sharded_train_step(cfg, tc: TrainConfig, mesh, mark, opt_cfg, dtype):
    def train_step(state: dict, batch: dict) -> tuple[dict, dict]:
        mark("begin")
        params = state["params"]
        for path, leaf in leaves_with_path(state):
            if not isinstance(leaf, SH.Placed) or leaf.mesh is not mesh:
                raise ValueError(f"state leaf {path} is not placed on the "
                                 f"step's mesh (trainer.state_specs, "
                                 f"sharding.Shardings.place)")
        sp = FS.ShardedParams(params, mesh, cfg, dtype)
        views = [(t, t.grad) for t in sp.views()]
        mark("grad buffers")
        dev0 = mesh.devices[0]
        n = tc.microbatches
        loss = None
        for d, rows in enumerate(_data_rows(batch, mesh, sp.firsts)):
            for mb in _split_microbatches(rows, n):
                mb_loss = M.loss_fn(sp.tree_for(d), cfg, mb)
                mark("forward")
                mb_loss.backward()
                mark("backward")
                mb_loss = mb_loss.detach().to(dev0)
                loss = mb_loss if loss is None else loss + mb_loss
        if any(t.grad is not g for t, g in views):
            raise RuntimeError("backward replaced a preset gradient buffer "
                               "instead of adding into it")
        del views
        pieces = sp.n_data * n
        if pieces > 1:
            loss = loss / pieces
            for leaf in sp.leaves.values():
                for g in leaf.grads:
                    g.div_(pieces)
        paths = list(sorted_paths(params))
        if tc.compress_grads:
            errors = dict(leaves_with_path(state["ef_error"]))
            for path in paths:
                leaf = sp.leaves[path]
                es = _copies(errors[path])
                sums = [CMP.add_error(g, e) for g, e in zip(leaf.grads, es)]
                scale = sp.whole_sum(path, sums.__getitem__) / \
                    math.prod(leaf.placed.shape)
                for g, e in zip(leaf.grads, es):
                    CMP.apply_scale(g, e, scale.to(g.device))
            mark("compress")
        steps = _copies(state["opt"]["step"])
        lr_scale = cosine_schedule(steps[0], warmup=tc.warmup,
                                   total=tc.total_steps)
        for s in steps:
            s.add_(1)
        total = None
        for path in paths:
            grads = sp.leaves[path].grads
            part = sp.whole_sum(path, lambda i: OPT.sum_sq(grads[i]))
            total = part if total is None else total + part
        gn = torch.sqrt(total)
        scalars = OPT.step_scalars(opt_cfg, steps[0], gn, lr_scale)
        on = {}
        trees = [dict(leaves_with_path(t)) for t in
                 (params, state["opt"]["mu"], state["opt"]["nu"])]
        for path in paths:
            ps, ms, vs = (_copies(t[path]) for t in trees)
            for p, g, m, v in zip(ps, sp.leaves[path].grads, ms, vs):
                if p.device not in on:
                    on[p.device] = tuple(
                        x.to(p.device) if isinstance(x, torch.Tensor) else x
                        for x in scalars)
                OPT.update_leaf(opt_cfg, p, g, m, v, on[p.device])
        mark("adamw")
        metrics = {"loss": loss, "grad_norm": gn,
                   "lr": lr_scale * opt_cfg.lr}
        return state, metrics

    return train_step
