"""Sharding rules and placement over a (pod, data, model) mesh, driven
from one process: the reference's ``src/repro/distributed/sharding.py``,
both halves, single-controller as the reference is.  One process holds
the mesh (``launch.mesh.Mesh``) and drives every position; a tensor
placed on a mesh is a :class:`Placed`, each position's slice on that
position's device.  Specs are tuples, an axis name (or a tuple of names,
or None) per dim, the reference's ``PartitionSpec`` objects; ``_fit`` drops
every assignment whose mesh size does not divide its dim, so a small
model replicates instead of failing.

Logical axes: ``pod`` (outer data-parallel), ``data`` (data-parallel and
FSDP), ``model`` (tensor and expert parallel).

The LM half (``:71-305`` there):

* :func:`param_specs` matches each leaf's path against ``_PARAM_RULES``
  (column-parallel projections shard d_out over ``model``, row-parallel
  d_in, experts E, embeddings the vocab; FSDP one other large dim over
  ``data``; packed inference words and scales as well), ``{path:
  spec}``; :func:`drop_fsdp` and :func:`should_fsdp` (18 B a parameter
  against the card's memory) choose ZeRO-0 instead;
* :func:`batch_specs`, :func:`cache_specs`, :func:`logical_activation_spec`
  for batches, decode caches and activations;
* :class:`Shardings` places a tree by its specs, slicing each tensor on
  its own device (the reference's ``param_shardings(params, mesh)`` is
  ``Shardings(mesh, param_specs(params, mesh)).place(params)``).  The train
  step over the placed state, whose gathers and reductions the port
  writes out where the reference leaves them to GSPMD, is
  ``train/trainer.py`` with ``distributed/fsdp.py``.

The packed half (``:334-635`` there), for the packed BCNN and BMLP:

* The batch shards over ``data``; packed activations are batch-sharded
  over ``data`` and replicated over ``model``.
* Every stage whose C_out splits into whole 32-bit words per shard
  (``c_out % (32·|model|) == 0``, :func:`packed_stage_shards`) shards
  its output channels over ``model``: its packed weight rows, folded BN
  thresholds (tau/flip), pad-correction columns (the last axis of the
  (OH, OW, C_out) correction) and pool-mask words.  Its conv or GEMM +
  BN-sign + repack (+ bit-domain pool) is then local, and it emits its
  own span of packed words.  A stage that fails the test replicates,
  never splits a word.
* The output layer always replicates: its int32 output feeds the float
  output batch norm, not a word-packing epilogue.
* The only traffic between positions is the gather of the sharded
  stages' packed words along the last axis (``models.cnn``), never an
  int32 partial sum; a mesh with ``|model| = 1`` gathers nothing.

XLA's ``ShardedForward.lower`` has no counterpart here.
"""
from __future__ import annotations

import dataclasses
import math
import re
from typing import Any

import torch

from repro_torch import telemetry as _telemetry
from repro_torch.core.binarize import WORD_BITS
from repro_torch.launch.mesh import Mesh
from repro_torch.models import cnn as _cnn
from repro_torch.tree import leaves_with_path, map_with_path

DATA_AXES = ("pod", "data")      # batch shards over both when present


def _axis_size(mesh: Mesh, name) -> int:
    if name is None:
        return 1
    if isinstance(name, (tuple, list)):
        s = 1
        for n in name:
            s *= _axis_size(mesh, n)
        return s
    return mesh.shape[name] if name in mesh.shape else 0


def _fit(mesh: Mesh, spec: tuple, shape: tuple[int, ...]) -> tuple:
    """Drop axis assignments that don't divide the dim (or don't exist)."""
    out = []
    for dim, ax in zip(shape, spec):
        if ax is None:
            out.append(None)
            continue
        size = _axis_size(mesh, ax)
        if size and size > 1 and dim % size == 0:
            out.append(ax)
        elif size == 1:
            out.append(None)
        elif isinstance(ax, tuple) and len(ax) > 1:
            # try partial tuples: ('pod','data') -> 'data'
            for sub in (ax[1:], ax[:1]):
                ssize = _axis_size(mesh, sub)
                if ssize and dim % ssize == 0:
                    out.append(sub if len(sub) > 1 else sub[0])
                    break
            else:
                out.append(None)
        else:
            out.append(None)
    return tuple(out)


# ---------------------------------------------------------------------------
# Parameter rules (the LM half)
# ---------------------------------------------------------------------------

# (regex on the '/'-joined path, spec of the UNSTACKED leaf): a leading
# axis of layers stacked over depth gets None prepended.  The reference's
# table as it stands.
_PARAM_RULES: list[tuple[str, tuple]] = [
    # attention projections (column-parallel qkv, row-parallel o)
    (r"attn/wq/w$",      ("data", "model")),
    (r"attn/wk/w$",      ("data", "model")),
    (r"attn/wv/w$",      ("data", "model")),
    (r"attn/wo/w$",      ("model", "data")),
    (r"xattn/wq/w$",     ("data", "model")),
    (r"xattn/wk/w$",     ("data", "model")),
    (r"xattn/wv/w$",     ("data", "model")),
    (r"xattn/wo/w$",     ("model", "data")),
    # dense FFN
    (r"mlp/w_up/w$",     ("data", "model")),
    (r"mlp/w_gate/w$",   ("data", "model")),
    (r"mlp/w_down/w$",   ("model", "data")),
    (r"shared/w_up/w$",  ("data", "model")),
    (r"shared/w_gate/w$", ("data", "model")),
    (r"shared/w_down/w$", ("model", "data")),
    # MoE experts: E over model (expert parallelism), FSDP over data
    (r"mlp/router/w$",   (None, None)),
    (r"mlp/we_up/we$",   ("model", "data", None)),      # (E, D, F)
    (r"mlp/we_gate/we$", ("model", "data", None)),
    (r"mlp/we_down/we$", ("model", None, "data")),
    # RG-LRU (width shards over model; elementwise recurrence)
    (r"rec/w_gelu/w$",   ("data", "model")),
    (r"rec/w_rec_in/w$", ("data", "model")),
    (r"rec/wa/w$",       ("data", "model")),
    (r"rec/wx/w$",       ("data", "model")),
    (r"rec/conv_w$",     (None, "model")),
    (r"rec/conv_b$",     ("model",)),
    (r"rec/ba$",         ("model",)),
    (r"rec/bx$",         ("model",)),
    (r"rec/lambda_p$",   ("model",)),
    (r"rec/w_out/w$",    ("model", "data")),
    # Mamba-2, fused form: FSDP only (the in-projection interleaves five
    # blocks on one axis, which a 'model' split would cut across)
    (r"ssm/in_proj/w$",  ("data", None)),
    (r"ssm/out_proj/w$", (None, "data")),
    # Mamba-2, split form: d_inner/heads over 'model'; B/C/dt replicate
    (r"ssm/[zx]_proj/w$",   ("data", "model")),
    (r"ssm/(b|c|dt)_proj/w$", ("data", None)),
    (r"ssm/conv_w_x$",   (None, "model")),
    (r"ssm/conv_b_x$",   ("model",)),
    (r"ssm/norm_tp/scale$", ("model",)),
    (r"ssm/out_proj_tp/w$", ("model", "data")),
    (r"ssm/.*",          (None,)),
    # embeddings / head: vocab over model
    (r"embed/table$",    ("model", "data")),
    (r"head/w$",         ("data", "model")),
    (r"dec_pos$",        (None, None)),
    # packed (1-bit) inference weights: (d_out, kw) — column-parallel
    # shard d_out; row-parallel shard the packed-word (d_in) axis.
    (r"attn/w[qkv]/w_packed$", ("model", "data")),
    (r"attn/wo/w_packed$",     ("data", "model")),
    (r"xattn/w[qkv]/w_packed$", ("model", "data")),
    (r"xattn/wo/w_packed$",    ("data", "model")),
    (r"mlp/w_(up|gate)/w_packed$", ("model", "data")),
    (r"mlp/w_down/w_packed$",  ("data", "model")),
    (r"head/w_packed$",        ("model", "data")),
    (r"attn/w[qkv]/alpha$",    ("model",)),
    (r"attn/wo/alpha$",        (None,)),
    (r"mlp/w_(up|gate)/alpha$", ("model",)),
    (r"mlp/w_down/alpha$",     (None,)),
    (r"head/alpha$",           ("model",)),
    (r"w_packed$",             (None, None)),   # fallback: replicate
    (r"alpha$",                (None,)),
]

# The card's memory: one H100 80GB HBM3 (``should_fsdp``'s default and
# the dry run's fit test).  The reference's 16e9 is a TPU's HBM.
HBM_BYTES = 80e9


def drop_fsdp(spec: tuple) -> tuple:
    """ZeRO-0: replicate over 'data' (weights and optimizer state fit a
    position), keep 'model'.  The step then reduces gradients instead of
    gathering weights per layer."""
    return tuple(None if ax == "data" else ax for ax in spec)


def _ndim(leaf) -> int:
    return getattr(leaf, "ndim", 0)


def param_specs(params: Any, mesh: Mesh, *, fsdp: bool = True,
                replicate_embed: bool = False) -> dict[str, tuple]:
    """{path: spec} for every leaf of a model or optimizer params tree
    (tensors of any device, meta included), one entry per dim.

    ``fsdp=False`` replicates over 'data' (ZeRO-0, :func:`should_fsdp`);
    ``replicate_embed=True`` replicates the embedding table (a
    vocab-sharded table makes every lookup a masked gather)."""
    out = {}
    for pstr, leaf in leaves_with_path(params):
        if _ndim(leaf) == 0:
            out[pstr] = ()
            continue
        if replicate_embed and re.search(r"embed/table$", pstr):
            out[pstr] = ()
            continue
        # the matching rule of the highest rank that fits the leaf
        # (an MoE expert's 3-d rule over a dense 2-d one)
        chosen = None
        for pat, spec in _PARAM_RULES:
            if re.search(pat, pstr) and len(spec) <= leaf.ndim:
                if chosen is None or len(spec) > len(chosen):
                    chosen = spec
        if chosen is None:
            out[pstr] = ()
            continue
        if not fsdp:
            chosen = drop_fsdp(chosen)
        full = (None,) * (leaf.ndim - len(chosen)) + tuple(chosen)
        out[pstr] = _fit(mesh, full, tuple(leaf.shape))
    return out


def should_fsdp(cfg, mesh: Mesh, *, hbm_bytes: float = HBM_BYTES,
                budget: float = 0.6) -> bool:
    """Keep FSDP only where the state replicated over 'data' would pass
    ``budget`` of a position's memory: total params / |model| x 18 B (4
    float32 master, 8 Adam, 2 bfloat16 copy, 4 gradient).  ``hbm_bytes``
    defaults to the H100's 80 GB (:data:`HBM_BYTES`); the reference's
    default, 16e9, is a TPU's HBM, so the two packages decide alike only
    where the caller passes the same figure."""
    tp = _axis_size(mesh, "model") or 1
    total = cfg.param_counts()["total"]
    return total / tp * 18.0 > budget * hbm_bytes


# ---------------------------------------------------------------------------
# Batches, caches, activations
# ---------------------------------------------------------------------------

def batch_specs(batch_like: Any, mesh: Mesh, *,
                shard_seq: bool = False) -> dict[str, tuple]:
    """{path: spec} of an input batch: the batch dim over (pod, data); with
    ``shard_seq`` the sequence dim instead (long context, batch 1)."""
    out = {}
    for pstr, leaf in leaves_with_path(batch_like):
        nd = _ndim(leaf)
        if nd == 0:
            out[pstr] = ()
        elif shard_seq and nd >= 2:
            out[pstr] = _fit(mesh, (None, DATA_AXES) + (None,) * (nd - 2),
                             tuple(leaf.shape))
        else:
            out[pstr] = _fit(mesh, (DATA_AXES,) + (None,) * (nd - 1),
                             tuple(leaf.shape))
    return out


def cache_specs(cache: Any, mesh: Mesh, *, shard_seq: bool = False,
                kv_layout: str = "batch_heads") -> dict[str, tuple]:
    """{path: spec} of a decode cache: attention K/V (..., B, S, H, D),
    recurrent states (L, B, ...).

    ``kv_layout``: ``'batch_heads'`` puts the batch over (pod, data) and
    the heads over 'model'; ``'seq_model'`` the batch over (pod, data) and
    S over 'model' (GQA head counts rarely divide the model degree, S
    does).  ``shard_seq``: S over (pod, data) too (batch 1, long
    context)."""
    out = {}
    for pstr, leaf in leaves_with_path(cache):
        nd = _ndim(leaf)
        shape = tuple(getattr(leaf, "shape", ()))
        if nd == 0:
            out[pstr] = ()
        elif re.search(r"(^|/)(k|v)$", pstr) and nd >= 4:
            lead = (None,) * (nd - 4)
            if shard_seq:
                spec = lead + (None, DATA_AXES, "model", None)
            elif kv_layout == "seq_model":
                spec = lead + (DATA_AXES, "model", None, None)
            else:
                spec = lead + (DATA_AXES, None, "model", None)
            out[pstr] = _fit(mesh, spec, shape)
        elif re.search(r"(k|v)_scale$", pstr) and nd >= 3:
            # int8 K/V scales (..., B, S, H): the K/V layout without D
            lead = (None,) * (nd - 3)
            if shard_seq:
                spec = lead + (None, DATA_AXES, "model")
            elif kv_layout == "seq_model":
                spec = lead + (DATA_AXES, "model", None)
            else:
                spec = lead + (DATA_AXES, None, "model")
            out[pstr] = _fit(mesh, spec, shape)
        elif nd >= 3:
            # stacked recurrent states (L, B, ...): the batch is axis 1
            out[pstr] = _fit(mesh, (None, DATA_AXES) + (None,) * (nd - 2),
                             shape)
        elif nd == 2:
            out[pstr] = _fit(mesh, (DATA_AXES, None), shape)
        else:
            out[pstr] = ()
    return out


def logical_activation_spec(mesh: Mesh, ndim: int, *,
                            shard_seq: bool = False) -> tuple:
    """The spec of an activation of ``ndim`` dims: the batch over (pod,
    data), or with ``shard_seq`` the sequence."""
    big = (1 << 30,) * ndim
    if shard_seq:
        return _fit(mesh, (None, DATA_AXES) + (None,) * (ndim - 2), big)
    return _fit(mesh, (DATA_AXES,) + (None,) * (ndim - 1), big)


# ---------------------------------------------------------------------------
# Shard plans and per-leaf specs
# ---------------------------------------------------------------------------

def packed_stage_shards(c_out: int, mesh: Mesh) -> int:
    """C_out-parallel shard count of one packed stage: the ``model``
    axis size where every shard owns whole 32-bit words
    (``c_out % (32·|model|) == 0``), else 1 (the stage replicates)."""
    nm = _axis_size(mesh, "model")
    if nm > 1 and c_out % (WORD_BITS * nm) == 0:
        return nm
    return 1


def bcnn_shard_plan(packed: Any, mesh: Mesh) -> dict:
    """Per-stage shard counts of a ``pack_bcnn`` tree on ``mesh``; the
    last dense layer always replicates."""
    conv = tuple(packed_stage_shards(p["c_out"], mesh)
                 for p in packed["convs"])
    douts = [p["w_packed"].shape[0] for p in packed["denses"]]
    dense = tuple(packed_stage_shards(d, mesh) for d in douts[:-1]) + (1,)
    return {"conv": conv, "dense": dense}


def bmlp_shard_plan(packed: Any, mesh: Mesh) -> dict:
    """Per-layer shard counts of a ``pack_bmlp`` tree on ``mesh``; the
    output layer always replicates."""
    douts = [p["w_packed"].shape[0] for p in packed["layers"]]
    layer = tuple(packed_stage_shards(d, mesh) for d in douts[:-1]) + (1,)
    return {"layer": layer}


@dataclasses.dataclass(frozen=True, eq=False)
class Placed:
    """One tensor placed on a mesh (:func:`shard_packed`,
    :class:`Shardings`): its spec (an axis name or None per dim; the
    packed half drops trailing Nones), its global shape, the mesh, and
    each position's slice on that position's device, row-major.
    Positions with the same device and slice share one tensor, a *copy*:
    whatever updates a copy updates it once for all of them."""
    spec: tuple
    shape: tuple[int, ...]
    mesh: Mesh
    shards: tuple[torch.Tensor, ...]

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def dtype(self) -> torch.dtype:
        return self.shards[0].dtype

    def copies(self) -> list[tuple[torch.Tensor, tuple, list[int]]]:
        """(tensor, its slice of the whole, the positions holding it) of
        every distinct tensor, in the order of their first positions."""
        out, seen = [], {}
        for i, t in enumerate(self.shards):
            if id(t) in seen:
                out[seen[id(t)]][2].append(i)
                continue
            seen[id(t)] = len(out)
            out.append((t, _index(self.mesh, self.spec, self.shape, i), [i]))
        return out

    def full(self, device=None) -> torch.Tensor:
        """The whole tensor on ``device`` (the first position's device if
        None), assembled there from one copy of each slice."""
        device = torch.device(device) if device is not None \
            else self.shards[0].device
        out = torch.empty(self.shape, dtype=self.dtype, device=device)
        done = set()
        for t, idx, _ in self.copies():
            key = tuple((sl.start, sl.stop) for sl in idx)
            if key not in done:
                done.add(key)
                out[idx] = t.to(device)
        return out

    def to_host(self) -> torch.Tensor:
        """The whole tensor on the CPU, from every position's slice."""
        return self.full("cpu")

    def nbytes(self, position: int) -> int:
        """The bytes ``position`` holds (shared or not)."""
        t = self.shards[position]
        return t.numel() * t.element_size()


def _layout(mesh: Mesh, spec: tuple, shape: tuple[int, ...]):
    """(each position's slice, each position's copy number): positions
    with the same device and slice share a copy, numbered in the order of
    their first positions."""
    idxs, keys, copy_of = [], {}, []
    for i, dev in enumerate(mesh.devices):
        idx = _index(mesh, spec, shape, i)
        key = (dev, tuple((sl.start, sl.stop) for sl in idx))
        copy_of.append(keys.setdefault(key, len(keys)))
        idxs.append(idx)
    return idxs, copy_of


def _place_leaf(t: torch.Tensor, spec: tuple, mesh: Mesh) -> Placed:
    """``t`` placed by ``spec``: each copy sliced on ``t``'s own device and
    only the slice moved; a copy of the whole tensor on its own device is
    ``t`` itself, any other a new tensor (so ``t`` can be freed)."""
    shape = tuple(t.shape)
    idxs, copy_of = _layout(mesh, spec, shape)
    made: dict[int, torch.Tensor] = {}
    shards = []
    for i, (idx, c) in enumerate(zip(idxs, copy_of)):
        if c not in made:
            dev = mesh.devices[i]
            whole = all(sl.start == 0 and sl.stop == d
                        for sl, d in zip(idx, shape))
            made[c] = t.to(dev) if whole else t[idx].to(
                dev, copy=True, memory_format=torch.contiguous_format)
        shards.append(made[c])
    return Placed(tuple(spec), shape, mesh, tuple(shards))


@dataclasses.dataclass(frozen=True, eq=False)
class Shardings:
    """Where every tensor of a tree goes: the mesh and ``{path: spec}``
    (the reference's tree of ``NamedSharding`` objects)."""
    mesh: Mesh
    specs: dict

    def place_leaf(self, path: str, t: torch.Tensor) -> Placed:
        return _place_leaf(t, self.specs[path], self.mesh)

    def place(self, tree: Any, *, donate: bool = False) -> Any:
        """``tree`` with every tensor a :class:`Placed` (a tree placed
        before is placed anew from its whole tensors).  ``donate``: the
        reference's donated state; each dict or list entry of ``tree`` is
        replaced by its placed value as it is made, so a source tensor
        that nothing else holds is freed at once and the state never
        exists twice."""
        def walk(path, node):
            if isinstance(node, (dict, list, tuple)):
                keys = node.keys() if isinstance(node, dict) \
                    else range(len(node))
                out = {} if isinstance(node, dict) else [None] * len(node)
                for k in keys:
                    out[k] = walk(f"{path}/{k}" if path else str(k), node[k])
                    if donate and not isinstance(node, tuple):
                        node[k] = out[k]
                return tuple(out) if isinstance(node, tuple) else out
            if isinstance(node, Placed):
                node = node.full()
            if isinstance(node, torch.Tensor):
                return self.place_leaf(path, node)
            return node
        return walk("", tree)


def unshard(tree: Any, device=None) -> Any:
    """``tree`` with every :class:`Placed` made whole on ``device`` (its
    first position's device if None)."""
    return map_with_path(lambda _, leaf: leaf.full(device)
                         if isinstance(leaf, Placed) else leaf, tree)


def position_bytes(tree: Any, specs: dict, mesh: Mesh) -> list[int]:
    """The bytes each position holds of ``tree`` (tensors of any device,
    meta included) placed by ``specs``, shared copies counted at every
    position that holds them."""
    out = [0] * mesh.size
    for path, leaf in leaves_with_path(tree):
        if not isinstance(leaf, (torch.Tensor, Placed)):
            continue
        item = torch.empty((), dtype=leaf.dtype).element_size()
        for i in range(mesh.size):
            n = 1
            for sl in _index(mesh, specs[path], tuple(leaf.shape), i):
                n *= sl.stop - sl.start
            out[i] += n * item
    return out


def data_positions(mesh: Mesh) -> tuple[list[int], list[int]]:
    """(each position's data slice, the first position of each data
    slice): the data slices are the positions' coordinates over the
    mesh's data axes (``DATA_AXES``), row-major."""
    data_axes = [ax for ax in DATA_AXES if ax in mesh.shape]
    index = []
    for i in range(mesh.size):
        c, k = mesh.coords(i), 0
        for ax in data_axes:
            k = k * mesh.shape[ax] + c[ax]
        index.append(k)
    n = math.prod(mesh.shape[ax] for ax in data_axes)
    return index, [index.index(d) for d in range(n)]


def _is_array(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, Placed))


def _bcnn_spec_rule(shard_plan: dict):
    """path + leaf -> spec tuple (or None for a non-tensor static)."""
    conv, dense = shard_plan["conv"], shard_plan["dense"]

    def rule(pstr: str, leaf) -> tuple | None:
        if not _is_array(leaf):
            return None
        m = re.match(r"convs/(\d+)/(w_packed|correction|rowsum)$", pstr)
        if m and conv[int(m.group(1))] > 1:
            if m.group(2) == "correction":      # (OH, OW, C_out)
                return (None, None, "model")
            return ("model",) if leaf.ndim == 1 else ("model", None)
        m = re.match(r"(folded_conv)/(\d+)/(tau|flip)$", pstr)
        if m and conv[int(m.group(2))] > 1:
            return ("model",)
        m = re.match(r"pool_masks/(\d+)$", pstr)
        if m and conv[int(m.group(1))] > 1:
            return ("model",)                   # (Cw,) packed-word spans
        m = re.match(r"denses/(\d+)/w_packed$", pstr)
        if m and dense[int(m.group(1))] > 1:
            return ("model", None)
        m = re.match(r"folded_dense/(\d+)/(tau|flip)$", pstr)
        if m and dense[int(m.group(1))] > 1:
            return ("model",)
        return ()                               # replicate (bn_out, fallback)

    return rule


def _bmlp_spec_rule(shard_plan: dict):
    layer = shard_plan["layer"]

    def rule(pstr: str, leaf) -> tuple | None:
        if not _is_array(leaf):
            return None
        m = re.match(r"layers/(\d+)/(w_packed|w_rowsum)$", pstr)
        if m and layer[int(m.group(1))] > 1:
            return ("model",) if leaf.ndim == 1 else ("model", None)
        m = re.match(r"folded/(\d+)/(tau|flip)$", pstr)
        if m and layer[int(m.group(1))] > 1:
            return ("model",)
        return ()

    return rule


def _shard_plan(packed: Any, mesh: Mesh) -> dict:
    if _cnn.packed_kind(packed) == "bcnn":
        return bcnn_shard_plan(packed, mesh)
    return bmlp_shard_plan(packed, mesh)


def _packed_rule(packed: Any, mesh: Mesh):
    kind = _cnn.packed_kind(packed)
    if kind == "transformer":
        raise ValueError("the sharding rules cover the bcnn and the bmlp, "
                         "not the transformer")
    if kind == "bcnn":
        return _bcnn_spec_rule(bcnn_shard_plan(packed, mesh))
    return _bmlp_spec_rule(bmlp_shard_plan(packed, mesh))


def _fitted_spec(mesh: Mesh, s: tuple, leaf) -> tuple:
    """``_fit``-checked spec of one tensor with trailing Nones dropped.
    Placement and :func:`packed_param_specs` both go through it, so a
    rule whose axis cannot divide the dim replicates everywhere alike."""
    fitted = _fit(mesh, tuple(s) + (None,) * (leaf.ndim - len(s)),
                  tuple(leaf.shape))
    while fitted and fitted[-1] is None:
        fitted = fitted[:-1]
    return fitted


def _index(mesh: Mesh, spec: tuple, shape: tuple[int, ...],
           position: int) -> tuple:
    """The slices of a tensor of ``shape`` that ``position`` holds under
    ``spec``."""
    coords = mesh.coords(position)
    idx = []
    for dim, ax in zip(shape, tuple(spec) + (None,) * len(shape)):
        if ax is None:
            idx.append(slice(0, dim))
            continue
        n, k = 1, 0
        for name in (ax if isinstance(ax, tuple) else (ax,)):
            k = k * mesh.shape[name] + coords[name]
            n *= mesh.shape[name]
        size = dim // n
        idx.append(slice(k * size, (k + 1) * size))
    return tuple(idx)


def packed_param_specs(packed: Any, mesh: Mesh) -> dict[str, tuple]:
    """{'/'-joined path: spec tuple} for every tensor of a packed BCNN or
    BMLP tree: exactly the specs placement uses (the reference's
    ``PartitionSpec``\\ s as tuples)."""
    rule = _packed_rule(packed, mesh)
    out = {}
    for path, leaf in leaves_with_path(packed):
        s = rule(path, leaf)
        if s is not None:
            out[path] = _fitted_spec(mesh, s, leaf)
    return out


def shard_packed(packed: Any, mesh: Mesh) -> Any:
    """The packed tree with every tensor replaced by a :class:`Placed`:
    each position's slice on that position's device (pack once, place
    once).  Statics (plan geometry, the spec) pass through untouched; a
    tree placed before is placed anew from its host copy."""
    rule = _packed_rule(packed, mesh)

    def put(path, leaf):
        s = rule(path, leaf)
        if s is None:
            return leaf
        host = leaf.to_host() if isinstance(leaf, Placed) else leaf
        spec = _fitted_spec(mesh, s, host)
        shape = tuple(host.shape)
        copies, shards = {}, []
        for i, dev in enumerate(mesh.devices):
            idx = _index(mesh, spec, shape, i)
            key = (dev, tuple((sl.start, sl.stop) for sl in idx))
            if key not in copies:
                copies[key] = host[idx].to(dev).contiguous()
            shards.append(copies[key])
        return Placed(spec, shape, mesh, tuple(shards))

    return map_with_path(put, packed)


def reshard_packed(packed: Any, mesh: Mesh | None) -> Any:
    """Move a packed tree to a DIFFERENT mesh (elastic degradation).

    Every tensor is pulled to the host first: after a device loss the old
    placement may name devices that are gone.  ``mesh=None`` returns the
    host tree (the checkpoint-shaped view); otherwise the tree is placed
    by :func:`shard_packed` under the new mesh's own plan.  Cheap: the
    bytes that cross the host are the packed words, not float weights.
    """
    def host(_, leaf):
        if isinstance(leaf, Placed):
            return leaf.to_host()
        return leaf.cpu() if isinstance(leaf, torch.Tensor) else leaf

    tree = map_with_path(host, packed)
    return tree if mesh is None else shard_packed(tree, mesh)


def shard_bcnn(packed: Any, mesh: Mesh) -> Any:
    if _cnn.packed_kind(packed) != "bcnn":
        raise ValueError("shard_bcnn takes a pack_bcnn tree")
    return shard_packed(packed, mesh)


def shard_bmlp(packed: Any, mesh: Mesh) -> Any:
    if _cnn.packed_kind(packed) != "bmlp":
        raise ValueError("shard_bmlp takes a pack_bmlp tree")
    return shard_packed(packed, mesh)


# ---------------------------------------------------------------------------
# The sharded forward
# ---------------------------------------------------------------------------

class ShardedForward:
    """The packed forward over a mesh, called as ``fwd(x) -> logits``.

    Holds each position's local tree (its slices of the placed tree), so
    calls are ``fwd(x)``; ``forward_int(x)`` returns the output layer's
    int32 pre-BN values.  ``shard_plan`` gives each stage's C_out split;
    ``kind`` and ``batch_multiple`` are the serving seams: the request
    queue (``train.serve.PackedInferenceServer``) rounds its flush
    buckets up to multiples of ``batch_multiple``.

    ``x`` (numpy or a tensor on any device, uint8, (B, *input shape))
    splits over ``data``: each position takes its data slice, on its
    device.  The rows of each data slice come back from its first
    position and are concatenated, in batch order, on the mesh's first
    device (the caller reading a data-sharded output); that is not
    counted as a gather.  With tracing on, a call is split into the
    spans ``sharded.dispatch`` (every position's launches enqueued) and
    ``sharded.block`` (waiting for the cards).
    """

    def __init__(self, placed: Any, shard_plan: dict, mesh: Mesh, kind: str,
                 *, backend: str, dense_stack: str, telemetry=None):
        self.shard_plan = shard_plan
        self.mesh = mesh
        self.kind = kind
        self.telemetry = (telemetry if telemetry is not None
                          else _telemetry.default())
        self._backend = backend
        self._dense_stack = dense_stack
        self._input_shape = _cnn.packed_input_shape(placed)
        self._trees = [map_with_path(
            lambda _, leaf: leaf.shards[i] if isinstance(leaf, Placed)
            else leaf, placed) for i in range(mesh.size)]
        coords = [mesh.coords(i) for i in range(mesh.size)]
        # each position's data slice, and the first position of each data
        # slice, which returns its rows
        self._data_index, self._firsts = data_positions(mesh)
        #: every batch must be a multiple of this: the product of the
        #: mesh's data-parallel axis sizes
        self.batch_multiple = len(self._firsts)
        # each position's peers along 'model', in model order
        self._peers = [[j for j in range(mesh.size)
                        if all(coords[j][ax] == c[ax] for ax in mesh.axes
                               if ax != "model")] for c in coords]

    def _run(self, x, logits: bool) -> torch.Tensor:
        x = _cnn.check_input(self.kind, self._input_shape, x)
        if x.shape[0] % self.batch_multiple:
            raise ValueError(f"batch {x.shape[0]} is not a multiple of the "
                             f"mesh's data size {self.batch_multiple}")
        rows = x.shape[0] // self.batch_multiple
        copies, xs = {}, []
        for d, dev in zip(self._data_index, self.mesh.devices):
            if (d, dev) not in copies:
                copies[d, dev] = x[d * rows:(d + 1) * rows].to(dev)
            xs.append(copies[d, dev])
        forward = (_cnn.bcnn_forward_positions if self.kind == "bcnn"
                   else _cnn.bmlp_forward_positions)
        zs = forward(self._trees, xs, self._peers, self.shard_plan,
                     backend=self._backend, dense_stack=self._dense_stack)
        out = self.mesh.devices[0]
        parts = [_cnn.apply_output_batchnorm(self._trees[p], zs[p])
                 if logits else zs[p] for p in self._firsts]
        return torch.cat([z.to(out) for z in parts])

    def _traced(self, x, logits: bool) -> torch.Tensor:
        tr = self.telemetry.tracer
        if not tr.enabled:
            return self._run(x, logits)
        with tr.span("sharded.dispatch", mesh=list(self.mesh.shape.values()),
                     kind=self.kind):
            out = self._run(x, logits)
        with tr.span("sharded.block"):
            for dev in {d for d in self.mesh.devices if d.type == "cuda"}:
                torch.cuda.synchronize(dev)
        return out

    def __call__(self, x) -> torch.Tensor:
        return self._traced(x, logits=True)

    def forward_int(self, x) -> torch.Tensor:
        """The output layer's int32 pre-BN values, (B, n_classes)."""
        return self._traced(x, logits=False)


def make_sharded_forward(packed: Any, mesh: Mesh, *, backend: str = "auto",
                         dense_stack: str = "auto",
                         telemetry=None) -> ShardedForward:
    """The packed BCNN or BMLP forward on a ('data', 'model') mesh.

    The batch shards over 'data'; every word-divisible stage C_out-shards
    over 'model' (:func:`packed_stage_shards`), other stages replicate.
    Each position runs every stage, replicated ones included, on its
    batch slice; the only traffic between positions is the gather of
    packed words at the sharded stages' seams, none on a pure
    data-parallel mesh.  Bit-identical to the unsharded forward
    (``distributed/verify_sharded.py`` sweeps the mesh shapes).

    ``dense_stack`` goes to the model: hidden dense stacks that no layer
    of which is model-sharded take the single-launch stack under
    ``'auto'`` (the residency rule is shape math, so every position
    agrees); model-sharded layers run the per-layer fused kernel on their
    local word-aligned rows.
    """
    _cnn.check_dense_stack(dense_stack)
    placed = shard_packed(packed, mesh)     # raises for the transformer
    return ShardedForward(placed, _shard_plan(packed, mesh), mesh,
                          _cnn.packed_kind(packed),
                          backend=backend, dense_stack=dense_stack,
                          telemetry=telemetry)
