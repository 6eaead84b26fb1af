"""The packed BCNN and BMLP forward over a (data, model) mesh.

The packed half of the reference's ``src/repro/distributed/sharding.py``
(``:334–635``), single-controller as the reference is: one process holds
the mesh (``launch.mesh.Mesh``) and drives every position.  Where the
reference's ``shard_map`` runs the forward once per device, the port's
:class:`ShardedForward` runs it once per mesh position, each position on
its own device with its own slice of the packed tree and of the batch.

Sharding rules (the reference's, path by path):

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

The LM and training half (``param_specs``, ``batch_specs``,
``cache_specs``) waits for the port's training stack; XLA's
``ShardedForward.lower`` has no counterpart here.
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
    """One tensor of a packed tree placed on a mesh by :func:`shard_packed`:
    its spec (an axis name or None per dim, trailing Nones dropped), its
    global shape, the mesh, and each position's slice on that position's
    device, row-major.  Positions with the same device and slice share
    one tensor."""
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

    def to_host(self) -> torch.Tensor:
        """The whole tensor on the CPU, from every position's slice."""
        out = torch.empty(self.shape, dtype=self.dtype)
        for i, t in enumerate(self.shards):
            out[_index(self.mesh, self.spec, self.shape, i)] = t.cpu()
        return out


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
    for dim, ax in zip(shape, spec):
        if ax is None:
            idx.append(slice(None))
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
        data_axes = [ax for ax in DATA_AXES if ax in mesh.shape]
        #: every batch must be a multiple of this: the product of the
        #: mesh's data-parallel axis sizes
        self.batch_multiple = math.prod(mesh.shape[ax] for ax in data_axes)
        self._data_index = []
        for c in coords:
            k = 0
            for ax in data_axes:
                k = k * mesh.shape[ax] + c[ax]
            self._data_index.append(k)
        # the first position of each data slice, which returns its rows
        self._firsts = [self._data_index.index(d)
                        for d in range(self.batch_multiple)]
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
