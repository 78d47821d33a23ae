"""Frozen dataclasses registered as JAX pytrees.

Every field is a pytree child, so states pass through ``jit`` and
donation as-is; an ``Optional`` field left at ``None`` is an empty
subtree.  ``.replace(**changes)`` returns an updated copy.
"""

from __future__ import annotations

import dataclasses

import jax


def pytree_dataclass(cls):
    """Decorator: ``cls`` as a frozen dataclass and a JAX pytree node."""
    cls = dataclasses.dataclass(frozen=True)(cls)
    cls.replace = dataclasses.replace
    return jax.tree_util.register_dataclass(cls)
