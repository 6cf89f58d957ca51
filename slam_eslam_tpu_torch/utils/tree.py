"""Field-wise maps over the port's state dataclasses.

The JAX package gets these from pytrees (``jax.tree_util.tree_map``,
``lax.cond`` over whole states).  Here a state is a plain dataclass
whose fields are tensors, nested state dataclasses, or static values
(Python scalars, a ``torch.Generator``); the maps below visit the
tensor fields and carry every static field over from the first
argument.
"""

from __future__ import annotations

import dataclasses

import torch


def tree_map(fn, tree, *rest):
    """Apply ``fn`` to corresponding tensor fields of ``tree`` and
    ``rest`` (dataclasses of one type), recursing into nested
    dataclasses.  Non-tensor fields are taken from ``tree``."""
    if isinstance(tree, torch.Tensor):
        return fn(tree, *rest)
    if dataclasses.is_dataclass(tree):
        out = {}
        for f in dataclasses.fields(tree):
            val = getattr(tree, f.name)
            if isinstance(val, torch.Tensor) or dataclasses.is_dataclass(val):
                val = tree_map(fn, val, *(getattr(r, f.name) for r in rest))
            out[f.name] = val
        return dataclasses.replace(tree, **out)
    return tree


def where(cond, a, b):
    """Device-side select between two states: ``torch.where(cond, a_f,
    b_f)`` on every tensor field (``cond`` a 0-d bool tensor)."""
    return tree_map(lambda x, y: torch.where(cond, x, y), a, b)


def to(tree, device):
    """Move every tensor field to ``device``."""
    return tree_map(lambda x: x.to(device), tree)


def stack(trees):
    """Stack a sequence of same-shaped states along a new leading axis
    (the port's counterpart of stacking a per-step input pytree)."""
    return tree_map(lambda *xs: torch.stack(xs), trees[0], *trees[1:])


def index(tree, i):
    """Select entry ``i`` along the leading axis of every tensor field."""
    return tree_map(lambda x: x[i], tree)
