"""Packed-weight checkpoints: save and restore the serving cache's trees.

A ``pack_bcnn``/``pack_bmlp`` tree is MIXED: tensors (packed words,
folded tau/flip, corrections, pool-mask words) interleave with statics
(plan geometry ints, ``None`` pool masks, the spec dataclass).  Statics
come from the model config, which the restoring process already has, so
a packed checkpoint saves ONLY the tensors, keyed by tree path, and
restore grafts them into a caller-supplied template tree of the same
config, placed on a mesh with ``distributed.sharding.shard_packed`` if
one is given: the elastic warm restart, where the survivor mesh's own
plan decides the placement.

The layout is ``checkpointer``'s (``step_<N>/arrays.npz + meta.json``,
tmp + rename); ``meta.extra["packed_kind"]`` tags the tree kind.  Packed
words (``w_packed`` and the pool masks) are written as ``uint32``, the
reference's type, so its checkpoints and the port's load in either.
"""
from __future__ import annotations

import json
import os
import re

import numpy as np
import torch

from repro_torch.checkpoint.checkpointer import (load_checkpoint,
                                                 save_checkpoint)
from repro_torch.distributed.sharding import Placed, shard_packed
from repro_torch.models.cnn import packed_kind
from repro_torch.tree import leaves_with_path, map_with_path

# the paths of a packed tree's word tensors
_WORDS = re.compile(r"(^|/)w_packed$|^pool_masks/\d+$")


def _is_array(leaf) -> bool:
    return isinstance(leaf, (torch.Tensor, Placed))


def _array_leaves(tree) -> dict[str, np.ndarray]:
    """{path: host array} of every tensor of a packed tree, words as
    ``uint32``; statics and ``None`` skipped."""
    out = {}
    for path, leaf in leaves_with_path(tree):
        if not _is_array(leaf):
            continue
        t = leaf if isinstance(leaf, torch.Tensor) else leaf.to_host()
        arr = t.detach().cpu().numpy()
        out[path] = arr.view(np.uint32) if _WORDS.search(path) else arr
    return out


def save_packed_checkpoint(ckpt_dir: str, step: int, packed,
                           extra: dict | None = None) -> str:
    """Write the tensors of a packed tree (atomic, step-tagged)."""
    arrays = _array_leaves(packed)
    meta = {"packed_kind": packed_kind(packed), "n_arrays": len(arrays)}
    meta.update(extra or {})
    return save_checkpoint(ckpt_dir, step, arrays, extra=meta)


def load_packed_checkpoint(ckpt_dir: str, step: int, template, *,
                           mesh=None):
    """Graft a packed checkpoint's tensors into ``template``, a packed
    tree of the SAME config: its statics are kept, each of its tensors is
    replaced by the checkpoint's, on that tensor's device.  With ``mesh``
    the restored tree is placed by ``shard_packed`` under that mesh.
    Returns ``(tree, meta)``.  Raises ``ValueError`` on a kind mismatch
    (checked before grafting) and ``KeyError`` where the checkpoint lacks
    a tensor the template has.
    """
    with open(os.path.join(ckpt_dir, f"step_{step:08d}", "meta.json")) as f:
        got_kind = json.load(f)["extra"].get("packed_kind")
    want_kind = packed_kind(template)
    if got_kind is not None and got_kind != want_kind:
        raise ValueError(f"packed checkpoint kind {got_kind!r} != "
                         f"template kind {want_kind!r}")
    saved, meta = load_checkpoint(ckpt_dir, step, _array_leaves(template))

    def graft(path, leaf):
        if not _is_array(leaf):
            return leaf
        dev = leaf.device if isinstance(leaf, torch.Tensor) else "cpu"
        return saved[path].to(dev)

    restored = map_with_path(graft, template)
    if mesh is not None:
        restored = shard_packed(restored, mesh)
    return restored, meta
