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

Gradients.  The params of a model zoo tree are stacked over depth; the
step differentiates with respect to per-layer views of them
(``common.layer_of``), each an autograd leaf whose ``.grad`` is set
beforehand to the matching view of one zeroed buffer per stacked leaf.
Backward then adds each layer's gradient into that buffer in place:
no full-size zero gradient is made for every layer that indexes a
stacked leaf, and microbatches accumulate in the same buffers.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.core.quantize import QuantMode
from repro_torch.models import model as M
from repro_torch.models import transformer as TF
from repro_torch.optim import adamw as OPT
from repro_torch.optim import compress as CMP
from repro_torch.optim.schedule import cosine_schedule
from repro_torch.tree import leaves_with_path, tree_index, tree_map


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


def _leaf(p: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    t = p.detach()
    if t.is_floating_point():
        t.requires_grad_(True)
        t.grad = g
    return t


def _leaves(src, grads):
    return tree_map(_leaf, src, grads)


def _unstacked(src, grads, n: int) -> list:
    return [_leaves(tree_index(src, i), tree_index(grads, i))
            for i in range(n)]


def grad_leaves(params: dict, cfg, dtype=None) -> tuple:
    """(leaves, grads): ``leaves`` is the params' tree with every stacked
    group of layers split into a list of per-group trees of autograd leaf
    views (``common.layer_of`` reads them), cast to ``dtype`` first where
    given; ``grads`` is a zeroed tree of the params' structure (in
    ``dtype`` if given), each leaf view's ``.grad`` preset to its view of
    it, so that backward accumulates into ``grads`` in place."""
    src = params if dtype is None else tree_map(
        lambda p: p.to(dtype) if p.dtype == torch.float32 else p, params)
    grads = tree_map(torch.zeros_like, src)
    leaves = {k: _leaves(v, grads[k]) for k, v in src.items()
              if k not in ("stack", "encdec")}
    if "stack" in src:
        leaves["stack"] = [
            _unstacked(seg, gseg, n) for (_, n), seg, gseg in
            zip(TF.segments_of(cfg), src["stack"], grads["stack"])]
    if "encdec" in src:
        e, ge = src["encdec"], grads["encdec"]
        depth = {"enc": cfg.encoder_layers, "dec": cfg.num_layers}
        leaves["encdec"] = {
            k: _unstacked(v, ge[k], depth[k]) if k in depth
            else _leaves(v, ge[k]) for k, v in e.items()}
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


def make_train_step(cfg, tc: TrainConfig, mark=None):
    """``step(state, batch) -> (state, {"loss", "grad_norm", "lr"})``,
    float32 0-d tensors.  ``batch``: {"tokens", "labels"} (and
    "embeds"/"enc_embeds" where the config takes them) on the params'
    device.  The new state is written into ``state``'s tensors.

    ``mark``, where given, is called with ``"begin"`` as the step starts
    and then after each part of it with that part's name: ``"grad
    buffers"``, ``"forward"`` and ``"backward"`` for each microbatch,
    ``"compress"`` where it runs, ``"adamw"``.  A caller times the parts
    with it (a CUDA event recorded at each mark)."""
    opt_cfg = make_opt_config(cfg, tc)
    dtype = torch.bfloat16 if tc.grads_bf16 else None
    mark = mark or (lambda name: None)

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
