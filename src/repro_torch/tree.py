"""Path-keyed walks over the port's trees (nested dicts, lists and
tuples of tensors and statics).

A leaf's path is its keys and list indices joined by ``/``
(``"convs/0/w_packed"``), the same strings the reference builds from a
JAX key path, so checkpoints and sharding specs are keyed alike in both
packages.  ``None`` is an empty subtree, as in JAX: it has no leaves.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator


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
