"""The sharded train step's traffic between mesh positions: the
collectives GSPMD writes for the reference's sharded step
(``src/repro/launch/train.py:53-80``), written out and counted here.

The step (``train/trainer.py``) works on a state placed by
``sharding.param_specs`` (:class:`~repro_torch.distributed.sharding.
Placed` leaves), FSDP style:

* Each data slice of the batch (``sharding.data_positions``) runs its
  forward and backward once, at its first position, with every weight
  whole.  A leaf split over the mesh is *gathered* there from its copies:
  the leaves of a layer group as the group runs (a
  ``common.Deferred`` that ``common.remat`` makes, and makes again in
  the backward's recompute), every other leaf
  once a microbatch.  There is no tensor-parallel compute over
  ``model``: its positions hold slices, the data slice's first position
  computes.
* The gathered weight's gradient is *reduced* back to the copies: each
  copy gets its slice, added by autograd into its own accumulator
  (the copy's preset ``.grad``), so a copy that several positions share
  is updated once.
* The gradients' norm and the compression scale are sums over whole
  leaves: one partial sum per distinct slice, added on the mesh's first
  device, each element counted once.

Counting, on ``telemetry.default()``'s registry:

* ``sharding.gathers`` +1 per gather of a leaf held in more than one
  slice, ``sharding.gathered_bytes`` + the bytes of the slices that the
  data slice's first position does not hold;
* ``sharding.reduces`` +1 per copy that position does not hold, per
  backward through a gather, ``sharding.reduced_bytes`` + that copy's
  slice's bytes;
* ``sharding.partial_sums`` + (slices - 1) per leaf per whole-leaf sum
  (float32 scalars).

:func:`step_traffic` reckons all five from shapes, specs and the mesh
alone; the tests and ``chip_smoke.py`` hold the counts to it, and the dry
run (``launch/dryrun.py``) reports it for meshes no card holds.
"""
from __future__ import annotations

import re

import torch

from repro_torch import telemetry as _telemetry
from repro_torch.distributed import sharding as SH
from repro_torch.models.common import Deferred, grad_views
from repro_torch.tree import leaves_with_path, map_with_path

# Paths of the stacked layer groups: gathered per group, twice a
# microbatch (the forward and the backward's recompute).
LAYERED = ("stack/", "encdec/enc/", "encdec/dec/")
_STACKS = re.compile(r"^(stack/\d+|encdec/(enc|dec))$")
COUNTERS = ("sharding.gathers", "sharding.gathered_bytes",
            "sharding.reduces", "sharding.reduced_bytes",
            "sharding.partial_sums")


def layered(path: str) -> bool:
    return path.startswith(LAYERED)


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


class _Site:
    """One leaf (or one group of a stacked leaf) for one data slice: the
    whole shape, each copy's slice of it, the copy the data slice's first
    position holds, and the copy each distinct slice is read from (one on
    the computing device where there is one)."""

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
    """Forward: the whole tensor from its copies; backward: each copy's
    slice of the gradient (the reduce)."""

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

    def __init__(self, path: str, placed: SH.Placed, dtype, firsts):
        self.path, self.placed = path, placed
        copies = placed.copies()
        self.idxs = [idx for _, idx, _ in copies]
        self.holders = [pos for _, _, pos in copies]
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
        self.firsts = firsts

    def views_flat(self) -> list:
        if self.groups is None:
            return list(self.views)
        return [v for vs in self.views for v in vs]

    def _site(self, d: int, grouped: bool) -> _Site:
        if (d, grouped) not in self.sites:
            mesh = self.placed.mesh
            first = self.firsts[d]
            own = next(i for i, pos in enumerate(self.holders)
                       if first in pos)
            shape = self.placed.shape[1:] if grouped else self.placed.shape
            idxs = [idx[1:] if grouped else idx for idx in self.idxs]
            devices = [mesh.devices[pos[0]] for pos in self.holders]
            self.sites[d, grouped] = _Site(tuple(shape), self.dtype,
                                           mesh.devices[first], idxs,
                                           devices, own)
        return self.sites[d, grouped]

    def gather(self, d: int, g: int | None = None) -> torch.Tensor:
        """The whole leaf (group ``g`` of a stacked one) for data slice
        ``d``: the copy itself where the leaf has one, else gathered."""
        views = self.views if g is None else self.views[g]
        if len(views) == 1:
            return views[0]
        site = self._site(d, g is not None)
        if self.float:
            return _Gather.apply(site, *views)
        return site.assemble(views)

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


class ShardedParams:
    """The placed params of a train state, prepared for one step: every
    leaf's copies as autograd leaves with zeroed gradient accumulators
    (``grads``), and, per data slice, the params tree its forward reads
    (:meth:`tree_for`)."""

    def __init__(self, params, mesh, dtype=None):
        self.mesh = mesh
        self.firsts = SH.data_positions(mesh)[1]
        self.params = params
        self.leaves = {p: _Leaf(p, pl, dtype, self.firsts)
                       for p, pl in leaves_with_path(params)}

    @property
    def n_data(self) -> int:
        return len(self.firsts)

    def views(self) -> list:
        return [v for leaf in self.leaves.values() for v in leaf.views_flat()
                if v.requires_grad]

    def tree_for(self, d: int):
        """The params tree data slice ``d`` runs on: stacked groups as
        lists of per-group trees of :class:`~repro_torch.models.common.
        Deferred` leaves, every other leaf gathered now."""
        def walk(path, node):
            if _STACKS.match(path):
                first = next(leaves_with_path(node, path))[0]
                return [map_with_path(
                    lambda p, _, g=g: _Layer(self.leaves[p], d, g), node,
                    path) for g in range(self.leaves[first].groups)]
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

def step_traffic(params, specs: dict, mesh, *, microbatches: int = 1,
                 compress: bool = False, grads_bf16: bool = False) -> dict:
    """What one sharded step gathers, reduces and sums, from the params'
    shapes and dtypes (tensors of any device, meta included, or
    ``Placed``), their ``{path: spec}`` and the mesh: the counts the step
    adds to :data:`COUNTERS`, by this module's counting rule."""
    firsts = SH.data_positions(mesh)[1]
    n_data = len(firsts)
    pieces = n_data * microbatches
    out = dict.fromkeys(COUNTERS, 0)
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
            out["sharding.gathers"] += pieces * groups * passes
            for d in range(n_data):
                own = _numel(idxs[firsts[d]])
                out["sharding.gathered_bytes"] += \
                    microbatches * passes * (numel - own) * item
            out["sharding.partial_sums"] += (n_slices - 1) * (
                2 if compress else 1)
        if n_copies > 1:
            slice_numel = {c: _numel(idxs[i]) for i, c in enumerate(copy_of)}
            for d in range(n_data):
                own = copy_of[firsts[d]]
                others = [n for c, n in slice_numel.items() if c != own]
                out["sharding.reduces"] += microbatches * groups * len(others)
                out["sharding.reduced_bytes"] += \
                    microbatches * sum(others) * item
    return out
