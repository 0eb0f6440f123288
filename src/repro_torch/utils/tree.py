"""Small tree helpers over the port's trees. Counterpart of
``repro.utils.tree``.

A tree is a dict, a tuple, a list or a ``NamedTuple`` of trees, ``None``
(no leaf), an ``nn.Module`` (its parameters, as the dict of
``named_parameters()``) or a leaf (a tensor, an array or a scalar). Leaves
come in ``jax.tree_util``'s order: dict keys sorted, sequence and
``NamedTuple`` fields in order, depth first. A ``NamedTuple`` class may
name fields in ``tree_aux`` that are static data and not leaves (as
``train.optim.Q8.last``). Paths are ``jax.tree_util.keystr``'s:
``['key']`` for a dict entry, ``[i]`` for a sequence item, ``.name`` for a
``NamedTuple`` field.

``repro.utils.tree``'s row gather/scatter helpers (``tree_take_rows``,
``tree_put_rows``) serve its jitted search loop; the port's search
indexes its tensors directly and has no use for them.
"""
from __future__ import annotations

from typing import Any, Callable

import numpy as np
import torch
from torch import nn


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(type(x), "_fields")


def _children(tree) -> list | None:
    """``[(path suffix, child), ...]`` of a node, ``None`` for a leaf."""
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return [(f"[{k!r}]", tree[k]) for k in sorted(tree)]
    if _is_namedtuple(tree):
        aux = getattr(type(tree), "tree_aux", ())
        return [(f".{f}", getattr(tree, f)) for f in tree._fields
                if f not in aux]
    if isinstance(tree, (tuple, list)):
        return [(f"[{i}]", c) for i, c in enumerate(tree)]
    return None


def tree_flatten_with_path(tree, prefix: str = "",
                           is_leaf: Callable | None = None) -> list:
    """``[(keystr path, leaf), ...]`` in ``jax.tree_util``'s order. A node
    for which ``is_leaf`` is true is taken whole as a leaf."""
    if tree is None:
        return []
    kids = None if is_leaf is not None and is_leaf(tree) else \
        _children(tree)
    if kids is None:
        return [(prefix, tree)]
    out = []
    for suffix, child in kids:
        out += tree_flatten_with_path(child, prefix + suffix, is_leaf)
    return out


def tree_leaves(tree, is_leaf: Callable | None = None) -> list:
    return [leaf for _, leaf in tree_flatten_with_path(tree, "", is_leaf)]


def _rebuild(tree, leaves: list, is_leaf: Callable | None = None):
    if tree is None:
        return None
    if is_leaf is not None and is_leaf(tree):
        return leaves.pop(0)
    if isinstance(tree, nn.Module):
        tree = dict(tree.named_parameters())
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves, is_leaf) for k in sorted(tree)}
    if _is_namedtuple(tree):
        aux = getattr(type(tree), "tree_aux", ())
        return type(tree)(**{f: getattr(tree, f) if f in aux
                             else _rebuild(getattr(tree, f), leaves, is_leaf)
                             for f in tree._fields})
    if isinstance(tree, (tuple, list)):
        return type(tree)(_rebuild(c, leaves, is_leaf) for c in tree)
    return leaves.pop(0)


def tree_unflatten(like, leaves: list, is_leaf: Callable | None = None):
    """``like``'s structure with its leaves replaced, in flattening order,
    by ``leaves``. A module becomes the dict of its parameter names; a
    node of ``like`` for which ``is_leaf`` is true is one leaf."""
    rest = list(leaves)
    out = _rebuild(like, rest, is_leaf)
    assert not rest, f"{len(rest)} leaves left over"
    return out


def tree_map(fn: Callable, tree, *rest, is_leaf: Callable | None = None) \
        -> Any:
    """``fn`` over the leaves of ``tree`` and of the trees in ``rest``,
    which must hold their leaves in the same order (``is_leaf`` as in
    :func:`tree_flatten_with_path`)."""
    flat = [tree_leaves(t, is_leaf) for t in (tree, *rest)]
    assert all(len(f) == len(flat[0]) for f in flat), \
        [len(f) for f in flat]
    return tree_unflatten(tree, [fn(*xs) for xs in zip(*flat)], is_leaf)


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return torch.empty((), dtype=dtype).element_size()
    return np.dtype(dtype).itemsize


def tree_bytes(tree) -> int:
    """Total bytes of all array leaves in a tree."""
    return sum(int(np.prod(x.shape)) * _itemsize(x.dtype)
               for x in tree_leaves(tree)
               if hasattr(x, "dtype") and hasattr(x, "shape"))


def _is_float(x) -> bool:
    if isinstance(x, torch.Tensor):
        return x.is_floating_point()
    return hasattr(x, "dtype") and np.issubdtype(x.dtype, np.inexact)


def tree_cast(tree, dtype):
    """Cast all float leaves of a tree to ``dtype`` (a torch dtype for
    tensors, a numpy one for arrays)."""
    def cast(x):
        if not _is_float(x):
            return x
        return x.to(dtype) if isinstance(x, torch.Tensor) else \
            x.astype(dtype)
    return tree_map(cast, tree)


def tree_zeros_like(tree):
    return tree_map(lambda x: torch.zeros_like(x) if isinstance(
        x, torch.Tensor) else np.zeros_like(x), tree)


def tree_count_params(tree) -> int:
    return sum(int(np.prod(x.shape)) for x in tree_leaves(tree)
               if hasattr(x, "shape"))
