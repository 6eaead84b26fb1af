"""The sharded train step's traffic between mesh positions: the
collectives GSPMD writes for the reference's sharded step
(``src/repro/launch/train.py:53-80``), written out and counted here.

The step (``train/trainer.py``) works on a state placed by
``sharding.param_specs`` (:class:`~repro_torch.distributed.sharding.
Placed` leaves): FSDP over the data axes, tensor parallelism over
``model``.

* Each data slice of the batch (``sharding.data_positions``) runs its
  forward and backward once.  Outside the tensor-parallel parts it runs
  at its first position, each weight whole: a leaf split over the mesh
  is *gathered* there from its copies, the leaves of a layer group as
  the group runs (a ``common.Deferred`` that ``common.remat`` makes, and
  makes again in the backward's recompute), every other leaf once a
  microbatch.
* A layer's block runs tensor-parallel over the data slice's |model|
  positions where its split falls on whole units (:func:`split_blocks`:
  attention when |model| divides the query and the KV heads, the dense
  FFN its d_ff, MoE its experts, RG-LRU its width, Mamba-2's split form
  its heads; the fused Mamba-2 never).  Each position computes with its
  own slice of the block's leaves split over ``model``, gathered over
  the data axes only, never over ``model`` (:class:`_Block`, a
  ``common.Deferred`` made again in the recompute, which runs whole);
  every other leaf of the block is gathered once, as above.  The block
  functions run each position on its slice and combine them through
  :class:`~repro_torch.models.common.Parallel`'s collectives: the
  column-parallel input fanned out to the positions, the row-parallel
  partial outputs summed in float32, an activation split over ``model``
  gathered (RG-LRU's conv output).
* The embedding's table and the untied head's weight run
  vocabulary-parallel where their placed spec holds ``model`` on the
  vocabulary axis (:func:`vocab_split`; ``_fit`` drops it where |model|
  does not divide the vocabulary, and ``replicate_embed`` replicates the
  table: such a leaf is gathered whole).  Each position gathers its own
  vocabulary slice over the data axes only, once a microbatch, and the
  tree the data slice runs on holds a :class:`_Positions` in the leaf's
  node's place: the lookup (``common.embed``) sums the positions' masked
  rows, and the loss (``models/model.py::loss_fn``) reduces each
  position's logit columns to a partial log-sum-exp and target logit.
* A gathered weight's gradient is *reduced* back to the copies: each
  copy gets its slice, added by autograd into its own accumulator
  (the copy's preset ``.grad``), so a copy that several positions share
  is updated once.
* The gradients' norm and the compression scale are sums over whole
  leaves: one partial sum per distinct slice, added on the mesh's first
  device, each element counted once.

Counting, on ``telemetry.default()``'s registry.  The weights
(:data:`WEIGHT_COUNTERS`):

* ``sharding.gathers`` +1 per gather of a leaf (or of one position's
  slice of it) held in more than one slice, ``sharding.gathered_bytes``
  + the bytes of the slices that the computing position does not hold;
* ``sharding.reduces`` +1 per copy that position does not hold, per
  backward through a gather, ``sharding.reduced_bytes`` + that copy's
  slice's bytes;
* ``sharding.partial_sums`` + (slices - 1) per leaf per whole-leaf sum
  (float32 scalars).

The activations between model positions (:data:`TP_COUNTERS`), each +1
a collective and + the bytes of the |model| - 1 positions' tensors that
the data slice's first position does not hold.  The vocabulary-parallel
embedding and loss count on the same kinds as the tensor-parallel
blocks (no counters of their own):

* ``sharding.tp_reduces`` / ``sharding.tp_reduced_bytes``: the forward's
  sums over ``model`` of row-parallel partial outputs (float32), and in
  the binary modes of each row-parallel linear's partial sums of |w|
  (its alpha, float64), of Mamba-2's partial sums of squares before its
  norm, and of the loss's target logits (float32), in the forward and
  again in the recompute; the embedding's masked rows (in the activation
  dtype), once a microbatch;
* ``sharding.tp_grad_reduces`` / ``sharding.tp_grad_reduced_bytes``: the
  backward's sums over ``model`` of the float32 partial gradients of a
  fanned-out input (the residual stream's normed input, the loss's
  normed hidden state, whisper's encoder output, MoE's routing weights,
  RG-LRU's gathered conv output, Mamba-2's B, C, dt and its norm's sum
  of squares), rounded once after the sum;
* ``sharding.tp_gathers`` / ``sharding.tp_gathered_bytes``: activations
  gathered over ``model`` (RG-LRU's conv output, float32; the loss's
  partial log-sum-exps, float32), in the forward and again in the
  recompute.

:func:`step_traffic` reckons all of them from shapes, specs, the mesh,
the config and the batch's shape alone (each block module's
``parallel_traffic`` for the activations, ``common.embed_traffic`` and
``model.loss_traffic`` for the vocabulary's); the tests and
``chip_smoke.py`` hold the counts to it, and the dry run
(``launch/dryrun.py``) reports it for meshes no card holds.
"""
from __future__ import annotations

import re

import torch

from repro_torch import telemetry as _telemetry
from repro_torch.distributed import sharding as SH
from repro_torch.models import attention as A
from repro_torch.models import common as C
from repro_torch.models import ffn as FF
from repro_torch.models import model as M
from repro_torch.models import moe as MOE
from repro_torch.models import rglru as R
from repro_torch.models import ssm as S
from repro_torch.models.common import Deferred, Parallel, grad_views
from repro_torch.tree import leaves_with_path, map_with_path

# Paths of the stacked layer groups: gathered per group, twice a
# microbatch (the forward and the backward's recompute).
LAYERED = ("stack/", "encdec/enc/", "encdec/dec/")
_STACKS = re.compile(r"^(stack/\d+|encdec/(enc|dec))$")
# A layered leaf's block: the key under its layer
_BLOCK = re.compile(r"^(?:stack/\d+/\d+|encdec/(?:enc|dec))/([^/]+)/")
WEIGHT_COUNTERS = ("sharding.gathers", "sharding.gathered_bytes",
                   "sharding.reduces", "sharding.reduced_bytes",
                   "sharding.partial_sums")
TP_COUNTERS = ("sharding.tp_reduces", "sharding.tp_reduced_bytes",
               "sharding.tp_grad_reduces", "sharding.tp_grad_reduced_bytes",
               "sharding.tp_gathers", "sharding.tp_gathered_bytes")
COUNTERS = WEIGHT_COUNTERS + TP_COUNTERS
# A traffic entry's kind (``common.Parallel``): its counters, and its
# passes a step (the forward's collectives run again in the recompute)
_TP_KINDS = {"reduce": ("sharding.tp_reduces", "sharding.tp_reduced_bytes",
                        2),
             "gather": ("sharding.tp_gathers", "sharding.tp_gathered_bytes",
                        2),
             "grad": ("sharding.tp_grad_reduces",
                      "sharding.tp_grad_reduced_bytes", 1)}


def layered(path: str) -> bool:
    return path.startswith(LAYERED)


def block_of(path: str) -> str | None:
    """The block key of a layered leaf's path (``'attn'``, ``'mlp'``,
    ``'ln1'``...), None for any other leaf."""
    hit = _BLOCK.match(path)
    return hit.group(1) if hit else None


def split_blocks(cfg, m: int) -> frozenset:
    """The blocks that run tensor-parallel over ``m`` model positions:
    those whose split falls on whole units.  Attention (self and cross)
    where ``m`` divides the query and the KV heads, so GQA groups stay
    whole; the FFN (``'mlp'``) where it divides ``d_ff``, or for MoE the
    experts (and the shared experts' width); RG-LRU (``'rec'``) where it
    divides the width; Mamba-2's split form (``'ssm'``) where it divides
    the heads (``ssm.heads_split``).  The fused Mamba-2 never: its
    in-projection interleaves five blocks on one axis.  The embedding and
    the head are not blocks: :func:`vocab_split`."""
    if m <= 1:
        return frozenset()
    out = set()
    if cfg.num_heads and A.heads_split(cfg, m):
        out |= {"attn", "xattn"}
    if cfg.moe is not None:
        if MOE.experts_split(cfg, m):
            out.add("mlp")
    elif cfg.d_ff and cfg.d_ff % m == 0:
        out.add("mlp")
    if cfg.rglru is not None and R.width_split(cfg, m):
        out.add("rec")
    if cfg.ssm is not None and S.heads_split(cfg, m):
        out.add("ssm")
    return frozenset(out)


def vocab_split(path: str, spec: tuple) -> bool:
    """Whether leaf ``path`` placed by ``spec`` runs vocabulary-parallel:
    one of ``sharding.VOCAB_LEAVES`` (the embedding's table, the untied
    head's weight), whose rule puts ``model`` on the vocabulary axis,
    with ``model`` still in ``spec``.  ``sharding._fit`` drops that
    assignment where |model| does not divide the vocabulary, and
    ``replicate_embed`` gives the table the spec (): then the leaf is
    gathered whole, as any other."""
    return path in SH.VOCAB_LEAVES and "model" in _names(spec)


def _names(spec) -> set:
    out = set()
    for ax in spec:
        out |= set(ax) if isinstance(ax, (tuple, list)) else {ax}
    return out


def _count(name: str, n: int) -> None:
    if n:
        _telemetry.default().metrics.counter(name).inc(n)


def _key(idx: tuple) -> tuple:
    return tuple((sl.start, sl.stop) for sl in idx)


def _numel(idx: tuple) -> int:
    n = 1
    for sl in idx:
        n *= sl.stop - sl.start
    return n


def _region(idxs: list) -> tuple:
    """The smallest box holding every slice of ``idxs``."""
    return tuple(slice(min(ix[k].start for ix in idxs),
                       max(ix[k].stop for ix in idxs))
                 for k in range(len(idxs[0])))


def _within(idx: tuple, region: tuple) -> tuple:
    return tuple(slice(sl.start - r.start, sl.stop - r.start)
                 for sl, r in zip(idx, region))


class _Site:
    """One region of a leaf (the whole leaf, or one position's slice of a
    tensor-parallel leaf; one group of a stacked leaf) for one computing
    position: the region's shape, the slice of it each copy used holds,
    the copy that position holds, and the copy each distinct slice is read
    from (one on the computing device where there is one)."""

    def __init__(self, shape, dtype, device, idxs, devices, own):
        self.shape, self.dtype, self.device = shape, dtype, device
        self.idxs, self.devices, self.own = idxs, devices, own
        self.item = torch.empty((), dtype=dtype).element_size()
        self.sources = {}
        for i, (idx, dev) in enumerate(zip(idxs, devices)):
            k = _key(idx)
            if k not in self.sources or (dev == device and devices[
                    self.sources[k]] != device):
                self.sources[k] = i

    def assemble(self, parts) -> torch.Tensor:
        if len(self.sources) == 1:            # replicated over devices
            (i,) = self.sources.values()
            return parts[i].to(self.device, copy=True)
        out = torch.empty(self.shape, dtype=self.dtype, device=self.device)
        for i in self.sources.values():
            out[self.idxs[i]] = parts[i]
        _count("sharding.gathers", 1)
        _count("sharding.gathered_bytes",
               (_numel(tuple(slice(0, d) for d in self.shape))
                - _numel(self.idxs[self.own])) * self.item)
        return out

    def scatter(self, g: torch.Tensor) -> list:
        out = []
        for i, (idx, dev) in enumerate(zip(self.idxs, self.devices)):
            out.append(g[idx].to(dev))
            if i != self.own:
                _count("sharding.reduces", 1)
                _count("sharding.reduced_bytes", _numel(idx) * self.item)
        return out


class _Gather(torch.autograd.Function):
    """Forward: the region from its copies; backward: each copy's slice
    of the gradient (the reduce)."""

    @staticmethod
    def forward(ctx, site, *parts):
        ctx.site = site
        return site.assemble(parts)

    @staticmethod
    def backward(ctx, g):
        return (None, *ctx.site.scatter(g))


class _Leaf:
    """A placed params leaf prepared for one step: its copies (cast to
    ``dtype`` where given), for a float leaf each an autograd leaf whose
    ``.grad`` is preset to a zeroed accumulator (per group for a stacked
    leaf: views of the copy and of its accumulator), by
    ``common.grad_views``."""

    def __init__(self, path: str, placed: SH.Placed, dtype, ranks):
        self.path, self.placed = path, placed
        copies = placed.copies()
        self.idxs = [idx for _, idx, _ in copies]
        self.holders = [pos for _, _, pos in copies]
        self.copy_of = {p: i for i, pos in enumerate(self.holders)
                        for p in pos}
        self.split = "model" in _names(placed.spec)
        self.groups = placed.shape[0] if layered(path) else None
        if self.groups is not None and any(
                idx[0] != slice(0, self.groups) for idx in self.idxs):
            raise ValueError(f"{path}: the layer axis is split")
        made = [grad_views(t, dtype, self.groups) for t, _, _ in copies]
        self.grads = [g for _, g in made]
        self.float = self.grads[0].is_floating_point()
        self.dtype = self.grads[0].dtype
        views = [v for v, _ in made]
        # Per copy, or per group and then per copy.
        self.views = views if self.groups is None else \
            [list(vs) for vs in zip(*views)]
        self.sites = {}
        self.ranks = ranks

    def views_flat(self) -> list:
        if self.groups is None:
            return list(self.views)
        return [v for vs in self.views for v in vs]

    def _site(self, d: int, grouped: bool, j: int | None):
        """(the site, the copies it reads) of data slice ``d``: the whole
        leaf at its first position, or with ``j`` the region of its
        ``j``-th model position's slice over the data axes."""
        if (d, grouped, j) not in self.sites:
            mesh = self.placed.mesh
            at = self.ranks[d][0 if j is None else j]
            if j is None:
                used = list(range(len(self.idxs)))
                region = tuple(slice(0, n) for n in self.placed.shape)
            else:
                column = [rank[j] for rank in self.ranks]
                used = sorted({self.copy_of[p] for p in column})
                region = _region([self.idxs[i] for i in used])
            own = used.index(self.copy_of[at])
            cut = 1 if grouped else 0
            idxs = [_within(self.idxs[i], region)[cut:] for i in used]
            shape = tuple(r.stop - r.start for r in region[cut:])
            devices = [mesh.devices[self.holders[i][0]] for i in used]
            self.sites[d, grouped, j] = (
                _Site(shape, self.dtype, mesh.devices[at], idxs, devices,
                      own), used)
        return self.sites[d, grouped, j]

    def gather(self, d: int, g: int | None = None,
               j: int | None = None) -> torch.Tensor:
        """The whole leaf (group ``g`` of a stacked one) for data slice
        ``d``, or with ``j`` its ``j``-th model position's slice, gathered
        over the data axes only: the copy itself where one holds it all,
        else gathered."""
        views = self.views if g is None else self.views[g]
        site, used = self._site(d, g is not None, j)
        parts = [views[i] for i in used]
        if len(parts) == 1 and site.devices[0] == site.device:
            return parts[0]
        if self.float:
            return _Gather.apply(site, *parts)
        return site.assemble(parts)

    def distinct(self) -> list[int]:
        """One copy of each distinct slice, in position order."""
        seen, out = set(), []
        for i, idx in enumerate(self.idxs):
            if _key(idx) not in seen:
                seen.add(_key(idx))
                out.append(i)
        return out


class _Layer(Deferred):
    """One group's slice of a stacked leaf, gathered when the group
    runs."""

    def __init__(self, leaf: _Leaf, d: int, g: int):
        self.leaf, self.d, self.g = leaf, d, g
        self.requires_grad = leaf.float

    def value(self) -> torch.Tensor:
        return self.leaf.gather(self.d, self.g)


class _Fan(torch.autograd.Function):
    """Forward: ``x`` at every position's device, at least float32 (an
    exact upcast; one copy a device, a view of it a position); backward:
    the positions' partial gradients, float32 (the column-parallel
    products keep them so: ``linear.apply_linear``'s ``column``), summed
    on ``x``'s device and rounded once to ``x``'s dtype, as one whole
    product's gradient is (counted)."""

    @staticmethod
    def forward(ctx, devices, x):
        ctx.home, ctx.dtype = x.device, x.dtype
        wide = torch.promote_types(x.dtype, torch.float32)
        copies = {}
        for dev in devices:
            if dev not in copies:
                copies[dev] = x.to(dev, wide)
        return tuple(copies[dev].view_as(copies[dev]) for dev in devices)

    @staticmethod
    def backward(ctx, *gs):
        total = gs[0].to(ctx.home, copy=True)
        for g in gs[1:]:
            total.add_(g.to(ctx.home))
        _count("sharding.tp_grad_reduces", 1)
        _count("sharding.tp_grad_reduced_bytes",
               (len(gs) - 1) * total.numel() * total.element_size())
        return None, total.to(ctx.dtype)


class _Reduce(torch.autograd.Function):
    """Forward: the sum of the positions' tensors on ``home``, in float32
    (float64 stays float64), or with ``wide`` False in their own dtype
    (counted); backward: the gradient at every position."""

    @staticmethod
    def forward(ctx, home, wide, *parts):
        ctx.devices = [p.device for p in parts]
        dtype = torch.promote_types(parts[0].dtype, torch.float32) \
            if wide else parts[0].dtype
        out = parts[0].to(home, dtype, copy=True)
        for p in parts[1:]:
            out.add_(p.to(home, dtype))
        _count("sharding.tp_reduces", 1)
        _count("sharding.tp_reduced_bytes",
               (len(parts) - 1) * out.numel() * out.element_size())
        return out

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(g.to(dev) for dev in ctx.devices))


class _Cat(torch.autograd.Function):
    """Forward: the positions' slices concatenated on ``home`` along
    ``dim`` (counted); backward: each position's slice of the
    gradient."""

    @staticmethod
    def forward(ctx, home, dim, *parts):
        ctx.devices = [p.device for p in parts]
        ctx.dim = dim
        ctx.sizes = [p.shape[dim] for p in parts]
        _count("sharding.tp_gathers", 1)
        _count("sharding.tp_gathered_bytes",
               sum(p.numel() * p.element_size() for p in parts[1:]))
        return torch.cat([p.to(home) for p in parts], dim)

    @staticmethod
    def backward(ctx, g):
        return (None, None, *(s.to(dev) for s, dev in zip(
            torch.split(g, ctx.sizes, ctx.dim), ctx.devices)))


class _Positions(Parallel):
    """A made tensor-parallel block (``common.Parallel``): the positions'
    trees, devices and the home device, with the counted collectives."""

    def __init__(self, trees: list, devices: list, home):
        self.trees, self.devices, self.home = trees, devices, home

    def sub(self, key: str) -> "_Positions":
        return _Positions([t[key] for t in self.trees], self.devices,
                          self.home)

    def fan(self, x: torch.Tensor) -> list:
        return list(_Fan.apply(self.devices, x))

    def reduce(self, parts: list, wide: bool = True) -> torch.Tensor:
        return _Reduce.apply(self.home, wide, *parts)

    def gather(self, parts: list, dim: int = -1) -> torch.Tensor:
        return _Cat.apply(self.home, dim % parts[0].ndim, *parts)


class _Block(Deferred):
    """One group's tensor-parallel block for data slice ``d``: made (when
    the group runs, again in its recompute) into a :class:`_Positions`
    whose tree at position ``j`` holds the ``j``-th model slice of each
    leaf split over ``model`` (gathered over the data axes only) and every
    other leaf whole, one tensor for all positions."""
    requires_grad = True
    full_recompute = True

    def __init__(self, sp: "ShardedParams", d: int, g: int, node, path: str):
        self.sp, self.d, self.g, self.node, self.path = sp, d, g, node, path

    def value(self) -> _Positions:
        sp, d, g = self.sp, self.d, self.g
        whole = {p: sp.leaves[p].gather(d, g)
                 for p, _ in leaves_with_path(self.node, self.path)
                 if not sp.leaves[p].split}
        trees = [map_with_path(
            lambda p, _, j=j: sp.leaves[p].gather(d, g, j)
            if sp.leaves[p].split else whole[p], self.node, self.path)
            for j in range(sp.m)]
        devices = [sp.mesh.devices[p] for p in sp.ranks[d]]
        return _Positions(trees, devices, devices[0])


class ShardedParams:
    """The placed params of a train state, prepared for one step: every
    leaf's copies as autograd leaves with zeroed gradient accumulators
    (``grads``), and, per data slice, the params tree its forward reads
    (:meth:`tree_for`), its tensor-parallel blocks (``cfg``'s
    :func:`split_blocks`) as :class:`_Block` leaves and its
    vocabulary-split nodes (:func:`vocab_split`) as
    :class:`_Positions`."""

    def __init__(self, params, mesh, cfg, dtype=None):
        self.mesh = mesh
        index, self.firsts = SH.data_positions(mesh)
        # Each data slice's positions, in model order
        self.ranks = [[p for p in range(mesh.size) if index[p] == d]
                      for d in range(len(self.firsts))]
        self.m = len(self.ranks[0])
        self.split = split_blocks(cfg, self.m)
        self.params = params
        self.leaves = {p: _Leaf(p, pl, dtype, self.ranks)
                       for p, pl in leaves_with_path(params)}
        self.vocab = {p for p, pl in leaves_with_path(params)
                      if vocab_split(p, pl.spec)}

    @property
    def n_data(self) -> int:
        return len(self.firsts)

    def views(self) -> list:
        return [v for leaf in self.leaves.values() for v in leaf.views_flat()
                if v.requires_grad]

    def _group(self, node, path: str, d: int, g: int):
        """Group ``g`` of a stacked node: its layers' trees of
        :class:`_Layer` leaves, each tensor-parallel block one
        :class:`_Block`."""
        def layer(tree, at):
            return {k: _Block(self, d, g, v, f"{at}/{k}")
                    if k in self.split else map_with_path(
                        lambda p, _: _Layer(self.leaves[p], d, g), v,
                        f"{at}/{k}")
                    for k, v in tree.items()}
        if isinstance(node, dict):
            return layer(node, path)
        return tuple(layer(t, f"{path}/{i}") for i, t in enumerate(node))

    def _vocab(self, node: dict, path: str, d: int) -> _Positions:
        """A vocabulary-split node for data slice ``d``: position ``j``'s
        tree holds its vocabulary slice, gathered over the data axes only,
        the slices in vocabulary order."""
        devices = [self.mesh.devices[p] for p in self.ranks[d]]
        trees = [map_with_path(lambda p, _, j=j: self.leaves[p].gather(
            d, None, j), node, path) for j in range(self.m)]
        return _Positions(trees, devices, devices[0])

    def tree_for(self, d: int):
        """The params tree data slice ``d`` runs on: stacked groups as
        lists of per-group trees of :class:`~repro_torch.models.common.
        Deferred` leaves, vocabulary-split nodes as :class:`_Positions`
        of slices gathered now, every other leaf gathered now."""
        def walk(path, node):
            if _STACKS.match(path):
                first = next(leaves_with_path(node, path))[0]
                return [self._group(node, path, d, g)
                        for g in range(self.leaves[first].groups)]
            if isinstance(node, dict) and any(
                    f"{path}/{k}" in self.vocab for k in node):
                return self._vocab(node, path, d)
            if isinstance(node, dict):
                return {k: walk(f"{path}/{k}" if path else k, v)
                        for k, v in node.items()}
            if isinstance(node, (list, tuple)):
                out = [walk(f"{path}/{i}" if path else str(i), v)
                       for i, v in enumerate(node)]
                return out if isinstance(node, list) else tuple(out)
            return self.leaves[path].gather(d)
        return walk("", self.params)

    def whole_sum(self, path: str, part) -> torch.Tensor:
        """``part(i)`` (copy ``i``'s partial sum) added over one copy of
        each distinct slice of leaf ``path``, on the mesh's first device,
        in position order."""
        dev = self.mesh.devices[0]
        total = None
        picks = self.leaves[path].distinct()
        for i in picks:
            s = part(i).to(dev)
            total = s if total is None else total + s
        _count("sharding.partial_sums", len(picks) - 1)
        return total


# ---------------------------------------------------------------------------
# The reckoning from shapes
# ---------------------------------------------------------------------------

def _activation_traffic(params, cfg, split, m, batch, pieces) -> dict:
    """The :data:`TP_COUNTERS` of one step: each layered block of
    ``params`` that runs tensor-parallel, one call a layer group, sums its
    module's traffic entries (``parallel_traffic``) for each of the
    ``pieces`` data-slice microbatches of ``rows / pieces`` rows."""
    out = dict.fromkeys(TP_COUNTERS, 0)
    blocks = {}                       # block path: (block, groups, leaves)
    for path, leaf in leaves_with_path(params):
        hit = _BLOCK.match(path)
        if hit and hit.group(1) in split:
            blocks.setdefault(hit.group(0), (hit.group(1), leaf.shape[0],
                                             set()))[2].add(path[hit.end():])
    if not blocks:
        return out
    rows, s = tuple(batch["labels"].shape)
    r = rows // pieces
    dt = cfg.activation_dtype
    if cfg.encoder_layers:
        enc = batch["enc_embeds"]
        enc_dt = torch.promote_types(enc.dtype, dt)
        enc_tokens = r * enc.shape[1]
    for path, (block, groups, leaves) in blocks.items():
        tokens, x_dt = (enc_tokens, enc_dt) if path.startswith(
            "encdec/enc/") else (r * s, dt)
        if block == "attn":
            entries = A.parallel_traffic(cfg, tokens, x_dt)
        elif block == "xattn":
            entries = A.parallel_traffic(cfg, tokens, x_dt, enc_tokens,
                                         enc_dt)
        elif block == "rec":
            entries = R.parallel_traffic(cfg, tokens, x_dt, m)
        elif block == "ssm":
            entries = S.parallel_traffic(cfg, tokens, x_dt)
        elif any(p.startswith("router/") for p in leaves):
            entries = MOE.parallel_traffic(cfg, tokens, x_dt)
        else:
            entries = FF.parallel_traffic(cfg, tokens, x_dt)
        for kind, numel, item in entries:
            count, nbytes, passes = _TP_KINDS[kind]
            n = passes * pieces * groups
            out[count] += n
            out[nbytes] += n * (m - 1) * numel * item
    return out


def _vocab_traffic(cfg, vocab: set, m: int, batch, pieces: int) -> dict:
    """The :data:`TP_COUNTERS` of one step's vocabulary-parallel
    embedding and loss, ``vocab`` the vocabulary-split leaves' paths: for
    each of the ``pieces`` microbatches of ``rows / pieces`` rows, the
    lookup's sum once (where the batch has no ``"embeds"``), and each
    loss chunk's entries, the forward's in the forward and again in the
    recompute, the fan's gradient sum once."""
    out = dict.fromkeys(TP_COUNTERS, 0)
    rows, s = tuple(batch["labels"].shape)
    r = rows // pieces
    entries = []                                   # (kind, numel, item, n)
    if "embed/table" in vocab and batch.get("embeds") is None:
        entries += [e + (1,) for e in C.embed_traffic(
            r * s, cfg.d_model, cfg.activation_dtype)]
    if ("embed/table" if cfg.tie_embeddings else "head/w") in vocab:
        chunk, n = M.loss_chunks(s)
        entries += [(kind, numel, item, n * _TP_KINDS[kind][2])
                    for kind, numel, item in M.loss_traffic(cfg, r * chunk)]
    for kind, numel, item, n in entries:
        count, nbytes, _ = _TP_KINDS[kind]
        out[count] += pieces * n
        out[nbytes] += pieces * n * (m - 1) * numel * item
    return out


def step_traffic(params, specs: dict, mesh, *, cfg, batch,
                 microbatches: int = 1, compress: bool = False,
                 grads_bf16: bool = False) -> dict:
    """What one sharded step gathers, reduces and sums, from the params'
    shapes and dtypes (tensors of any device, meta included, or
    ``Placed``), their ``{path: spec}``, the mesh, the config (the
    per-block rule, :func:`split_blocks`, and the blocks' widths) and the
    batch (tensors of any device: its rows and lengths): the counts the
    step adds to :data:`COUNTERS`, by this module's counting rule."""
    index, firsts = SH.data_positions(mesh)
    n_data = len(firsts)
    ranks = [[p for p in range(mesh.size) if index[p] == d]
             for d in range(n_data)]
    m = len(ranks[0])
    split = split_blocks(cfg, m)
    out = dict.fromkeys(COUNTERS, 0)
    pieces = n_data * microbatches
    for path, leaf in leaves_with_path(params):
        shape = tuple(leaf.shape)
        dtype = leaf.dtype
        if grads_bf16 and dtype == torch.float32:
            dtype = torch.bfloat16
        item = torch.empty((), dtype=dtype).element_size()
        idxs, copy_of = SH._layout(mesh, specs[path], shape)
        n_copies = len(set(copy_of))
        n_slices = len({_key(idx) for idx in idxs})
        numel = _numel(tuple(slice(0, s) for s in shape))
        groups, passes = (shape[0], 2) if layered(path) else (1, 1)
        if not dtype.is_floating_point:
            raise ValueError(f"{path}: a params leaf of {dtype}")
        if n_slices > 1:
            out["sharding.partial_sums"] += (n_slices - 1) * (
                2 if compress else 1)
        if vocab_split(path, specs[path]) or (
                block_of(path) in split and "model" in _names(specs[path])):
            # each position gathers its model slice over the data axes
            for j in range(m):
                column = [rank[j] for rank in ranks]
                used = {copy_of[p]: idxs[p] for p in column}
                region = _numel(_region(list(used.values())))
                n_col = len({_key(idx) for idx in used.values()})
                for d in range(n_data):
                    at = ranks[d][j]
                    if n_col > 1:
                        out["sharding.gathers"] += \
                            microbatches * groups * passes
                        out["sharding.gathered_bytes"] += \
                            microbatches * passes * (
                                region - _numel(idxs[at])) * item
                    others = [_numel(ix) for c, ix in used.items()
                              if c != copy_of[at]]
                    out["sharding.reduces"] += \
                        microbatches * groups * len(others)
                    out["sharding.reduced_bytes"] += \
                        microbatches * sum(others) * item
            continue
        if n_slices > 1:
            out["sharding.gathers"] += pieces * groups * passes
            for d in range(n_data):
                own = _numel(idxs[firsts[d]])
                out["sharding.gathered_bytes"] += \
                    microbatches * passes * (numel - own) * item
        if n_copies > 1:
            slice_numel = {c: _numel(idxs[i]) for i, c in enumerate(copy_of)}
            for d in range(n_data):
                own = copy_of[firsts[d]]
                others = [n for c, n in slice_numel.items() if c != own]
                out["sharding.reduces"] += microbatches * groups * len(others)
                out["sharding.reduced_bytes"] += \
                    microbatches * sum(others) * item
    out.update(_activation_traffic(params, cfg, split, m, batch, pieces))
    vocab = {p for p, _ in leaves_with_path(params)
             if vocab_split(p, specs[p])}
    for k, v in _vocab_traffic(cfg, vocab, m, batch, pieces).items():
        out[k] += v
    return out
