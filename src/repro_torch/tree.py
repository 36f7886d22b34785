"""Walkers over the port's nested trees: dicts, lists and tuples whose
leaves are tensors, QTensors, ``None`` or plain values.  Parameter,
optimizer-state and cache trees all take this shape."""
from __future__ import annotations

from typing import Any, Callable, Iterator


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``tree``'s structure with ``fn(leaf)`` in place of every leaf."""
    return tree_map_named(lambda _, leaf: fn(leaf), tree)


def tree_map_named(fn: Callable[[str, Any], Any], tree: Any, name: str = "") -> Any:
    """``tree``'s structure with ``fn(name, leaf)`` in place of every leaf;
    ``name`` is the key of the innermost dict entry the leaf sits under (a
    list's items take their list's key), the name the optimizer treats a
    leaf by."""
    if isinstance(tree, dict):
        return {k: tree_map_named(fn, v, k) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map_named(fn, v, name) for v in tree]
    if isinstance(tree, tuple):
        return tuple(tree_map_named(fn, v, name) for v in tree)
    return fn(name, tree)


def tree_leaves(tree: Any) -> Iterator[Any]:
    """Every leaf but ``None``, dict keys in sorted order (the reference's
    flatten order), lists and tuples item by item."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves(tree[k])
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tree_leaves(v)
    elif tree is not None:
        yield tree
