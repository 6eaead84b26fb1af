"""Checkpointing of trees of tensors: atomic, step-tagged.

Layout (the reference's, ``src/repro/checkpoint/checkpointer.py``):
``<dir>/step_<N>/arrays.npz`` + ``<dir>/step_<N>/meta.json``, keyed by
tree path.  Writes go to ``step_<N>.tmp`` and are renamed into place, so
a crash mid-write never corrupts the newest checkpoint.

The file holds numpy arrays; the conversion happens here, at its
boundary, and nowhere in a tree.  A ``uint32`` array on disk is packed
words, which the port keeps as ``int32`` tensors with the same bits: it
loads as such a tensor (``checkpoint.packed`` writes a packed tree's
words as ``uint32``, as the reference does), so a checkpoint written by
either package loads in the other.  A tree placed on a mesh
(``distributed.sharding.Placed`` leaves) is written whole, in the same
layout, so a checkpoint also crosses meshes.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch

from repro_torch.distributed.sharding import Placed
from repro_torch.tree import leaves_with_path, map_with_path


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, Placed):
        leaf = leaf.to_host()
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(np.array(arr))


def save_checkpoint(ckpt_dir: str, step: int, tree,
                    extra: dict | None = None) -> str:
    """Write every leaf of ``tree`` (tensors, numpy arrays or numbers)
    under its path; returns the checkpoint's directory."""
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    arrays = {path: _to_numpy(leaf) for path, leaf in leaves_with_path(tree)}
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    meta = {"step": step, "time": time.time(), "extra": extra or {},
            "n_arrays": len(arrays)}
    with open(os.path.join(tmp, "meta.json"), "w") as f:
        json.dump(meta, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    return final


def latest_step(ckpt_dir: str) -> int | None:
    """The newest finished step in ``ckpt_dir`` (``.tmp`` writes are not
    finished), or None."""
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir)
             if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def load_checkpoint(ckpt_dir: str, step: int, template,
                    device=None, shardings=None) -> tuple:
    """Restore into the structure of ``template``: ``(tree, meta)``, each
    leaf a tensor on ``device`` (the CPU if None) or, with ``shardings``
    (a ``distributed.sharding.Shardings``: a mesh and ``{path: spec}``),
    placed on that mesh a leaf at a time, each position's slice cut on
    the host and only the slice moved (reshard on restore: a checkpoint
    written on one mesh, or by either package, loads on any)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)

    def load(data, key):
        t = _to_tensor(data[key])
        if shardings is not None:
            return shardings.place_leaf(key, t)
        return t.to(device or "cpu")

    with np.load(os.path.join(path, "arrays.npz")) as data:
        tree = map_with_path(lambda key, _: load(data, key), template)
    return tree, meta


class AsyncCheckpointer:
    """Overlap checkpoint writes with the caller (one in-flight save).

    A save that raises in the worker thread is NOT silently lost: the
    exception is re-raised from the next :meth:`wait`, and, because
    :meth:`save` waits for the in-flight write first, from the next
    ``save`` as well.  A supervisor restarting from "the last checkpoint"
    therefore finds out that it never landed.
    """

    def __init__(self, ckpt_dir: str):
        self.ckpt_dir = ckpt_dir
        self._thread: threading.Thread | None = None
        self._error: BaseException | None = None

    def save(self, step: int, tree, extra: dict | None = None) -> None:
        self.wait()
        def snapshot(_, leaf):                      # on the host
            if isinstance(leaf, Placed):
                return leaf.to_host()
            if isinstance(leaf, torch.Tensor):
                return leaf.detach().cpu().clone()
            return leaf

        host_tree = map_with_path(snapshot, tree)

        def work():
            try:
                save_checkpoint(self.ckpt_dir, step, host_tree, extra)
            except BaseException as e:       # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
