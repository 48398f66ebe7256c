"""The few tree operations the optimiser, the steps and the checkpoints
need, over nested ``dict`` / ``list`` / ``tuple`` containers of tensors
(the port's stand-in for ``jax.tree_util``).

A ``NamedTuple`` is a node whose children are its fields; an
``nn.Module`` is a node whose children are its named buffers (dotted
names), so a model sits in a state tree as its parameter tree does in
the JAX package's. ``None`` is an empty subtree. Walks go in insertion
order, which every function here shares, so a list of leaves and a
``tree_map`` over the same tree line up.
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple

import torch
from torch import nn


def _children(node: Any) -> List[Tuple[Any, Any]]:
    """``(key, child)`` pairs of a node: a dict key, buffer name or
    NamedTuple field (str), or a sequence index (int)."""
    if isinstance(node, nn.Module):
        return list(node.named_buffers())
    if isinstance(node, dict):
        return list(node.items())
    if _is_record(node):
        return list(zip(node._fields, node))
    if isinstance(node, (list, tuple)):
        return list(enumerate(node))
    raise TypeError(f"not a tree node: {type(node).__name__}")


def _is_record(node: Any) -> bool:
    return isinstance(node, tuple) and hasattr(node, "_fields")


def _is_node(node: Any) -> bool:
    return isinstance(node, (nn.Module, dict, list, tuple))


def tree_leaves_with_path(tree: Any, path: Tuple = ()
                          ) -> Iterator[Tuple[Tuple, torch.Tensor]]:
    """``(path, leaf)`` for every tensor leaf, ``path`` the keys from the
    root."""
    if tree is None:
        return
    if not _is_node(tree):
        yield path, tree
        return
    for key, child in _children(tree):
        yield from tree_leaves_with_path(child, path + (key,))


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    return [leaf for _, leaf in tree_leaves_with_path(tree)]


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure); dicts, lists and tuples are rebuilt
    (a NamedTuple as its own type), ``None`` stays ``None``."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_record(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                            for i, v in enumerate(tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def dotted(path: Tuple) -> str:
    """A leaf's path as one dotted name (``blocks.3.mixer.wq.l``)."""
    return ".".join(str(k) for k in path)


def keystr(path: Tuple) -> str:
    """A leaf's checkpoint key in ``jax.tree_util.keystr``'s notation:
    ``['key']`` for a dict key or buffer name, ``[i]`` for an index."""
    return "".join(f"[{k}]" if isinstance(k, int) else f"[{k!r}]"
                   for k in path)


def tree_map_with_path(fn: Callable, tree: Any, path: Tuple = ()) -> Any:
    """``fn(path, leaf)`` over the leaves, rebuilt as :func:`tree_map`
    rebuilds them."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, path + (k,))
                for k, v in tree.items()}
    if _is_record(tree):
        return type(tree)(*(tree_map_with_path(fn, v, path + (f,))
                            for f, v in zip(tree._fields, tree)))
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map_with_path(fn, v, path + (i,))
                          for i, v in enumerate(tree))
    return fn(path, tree)
