"""Nested NamedTuple states to and from flat numpy dictionaries.

The same layout serves both packages: a state of the JAX package, flattened
here, rebuilds as the port's state of the same class name, and back, so a
sequence started in one package can continue in the other. Keys are field
paths with nested tuples flattened ("db.rot", "filter.cov").
"""

from __future__ import annotations

import typing
from typing import Iterator, Mapping

import numpy as np
import torch


def _flat_fields(nt, prefix: str = ""):
    for name in nt._fields:
        value = getattr(nt, name)
        if hasattr(value, "_fields"):
            yield from _flat_fields(value, f"{prefix}{name}.")
        else:
            yield f"{prefix}{name}", value


def tree_to_numpy(state) -> dict:
    """A NamedTuple state (this package's or the JAX package's) as numpy
    arrays keyed by field path. The arrays are copies: the port updates its
    stores in place."""
    out = {}
    for key, value in _flat_fields(state):
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu()
        out[key] = np.array(value)
    return out


def tree_leaves(tree) -> list:
    """The leaves of a tree of tuples and NamedTuples in JAX's flatten
    order: field order, depth first, None dropped."""
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for item in tree for leaf in tree_leaves(item)]
    return [tree]


def tree_replace_leaves(tree, leaves: Iterator):
    """`tree` with its leaves, in `tree_leaves` order, taken from `leaves`."""
    if tree is None:
        return None
    if isinstance(tree, tuple):
        items = [tree_replace_leaves(item, leaves) for item in tree]
        return type(tree)(*items) if hasattr(tree, "_fields") else tuple(items)
    return next(leaves)


def tree_map(fn, tree):
    """`tree` with fn applied to each leaf."""
    return tree_replace_leaves(tree, iter([fn(leaf) for leaf in tree_leaves(tree)]))


def tree_stack(trees):
    """B trees of one structure as one tree whose leaves lead with [B] (the
    counterpart of `jtu.tree_map(jnp.stack, ...)`); the leaves are new
    contiguous tensors."""
    stacked = [torch.stack(leaves) for leaves in zip(*(tree_leaves(t) for t in trees))]
    return tree_replace_leaves(trees[0], iter(stacked))


def tree_index(tree, b):
    """Instance b of a tree whose leaves lead with [B] (views: the
    instance's stores are the batch's)."""
    return tree_map(lambda leaf: leaf[b], tree)


def tree_from_numpy(cls, arrays: Mapping, device, prefix: str = ""):
    """An instance of the NamedTuple `cls` on `device` from `tree_to_numpy`'s
    layout, with the same shapes and dtypes (writable copies). Fields whose
    annotation is itself a NamedTuple are rebuilt recursively."""
    hints = typing.get_type_hints(cls)
    fields = {}
    for name in cls._fields:
        sub = hints.get(name)
        key = f"{prefix}{name}"
        if isinstance(sub, type) and issubclass(sub, tuple) and hasattr(sub, "_fields"):
            fields[name] = tree_from_numpy(sub, arrays, device, key + ".")
        else:
            fields[name] = torch.tensor(np.array(arrays[key]), device=device)
    return cls(**fields)
