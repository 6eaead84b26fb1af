"""Path-keyed walks over the port's trees (nested dicts, lists and
tuples of tensors and statics).

A leaf's path is its keys and list indices joined by ``/``
(``"convs/0/w_packed"``), the same strings the reference builds from a
JAX key path, so checkpoints and sharding specs are keyed alike in both
packages.  ``None`` is an empty subtree, as in JAX: it has no leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator

import torch


def leaves_with_path(tree, prefix: str = "") -> Iterator[tuple[str, Any]]:
    """Every leaf of ``tree`` with its path, depth first."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from leaves_with_path(v, f"{prefix}/{k}" if prefix else str(k))


def sorted_leaves(tree) -> Iterator[Any]:
    """Every leaf of ``tree`` in the reference's order (``jax.tree.leaves``:
    dict keys sorted, lists and tuples in order), where a sum over leaves
    must add in the reference's order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from sorted_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from sorted_leaves(v)
    else:
        yield tree


def sorted_paths(tree, prefix: str = "") -> Iterator[str]:
    """The paths of :func:`sorted_leaves`' leaves, in its order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        items = ((k, tree[k]) for k in sorted(tree))
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix
        return
    for k, v in items:
        yield from sorted_paths(v, f"{prefix}/{k}" if prefix else str(k))


def map_with_path(fn: Callable[[str, Any], Any], tree, prefix: str = ""):
    """The tree with every leaf replaced by ``fn(path, leaf)``; dicts,
    lists, tuples and ``None`` keep their places."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, f"{prefix}/{k}" if prefix else str(k))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        out = [map_with_path(fn, v, f"{prefix}/{i}" if prefix else str(i))
               for i, v in enumerate(tree)]
        return out if isinstance(tree, list) else tuple(out)
    return fn(prefix, tree)


def tree_map(fn: Callable[[Any], Any], *trees):
    """``fn`` over the leaves of trees of one structure, leaf by leaf;
    dicts, lists, tuples and ``None`` keep their places."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, dict):
        return {k: tree_map(fn, *(t[k] for t in trees)) for k in first}
    if isinstance(first, (list, tuple)):
        out = [tree_map(fn, *(t[i] for t in trees))
               for i in range(len(first))]
        return out if isinstance(first, list) else tuple(out)
    return fn(*trees)


def tree_stack(trees: list):
    """Trees of one structure -> one tree, each leaf the ``torch.stack`` of
    theirs along a new axis 0 (the reference's scan-stacked layers)."""
    return tree_map(lambda *xs: torch.stack(xs, dim=0), *trees)


def tree_index(tree, i: int):
    """Axis-0 entry ``i`` of every leaf (one layer of a stacked tree)."""
    return tree_map(lambda x: x[i], tree)


def tree_bytes(tree) -> int:
    """The bytes of every tensor leaf."""
    return sum(x.numel() * x.element_size()
               for _, x in leaves_with_path(tree)
               if hasattr(x, "element_size"))
