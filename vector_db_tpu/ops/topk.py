"""Masked top-k helpers — the array replacement for the reference's heaps.

The reference keeps `PriorityQueue` beams (index/HnswIndex.java:557-644) and
`std::partial_sort` result sets (native/index/PQIndex.cpp:200-205).  Here the
same role is played by fixed-size sorted arrays merged with `jax.lax.top_k`.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

Array = jax.Array


def smallest_k(dists: Array, k: int, idx: Array | None = None) -> tuple[Array, Array]:
    """Top-k smallest along the last axis. Returns (dists, indices) ascending.

    If ``idx`` is given it is gathered instead of positional indices.
    """
    neg, arg = jax.lax.top_k(-dists, k)
    if idx is not None:
        out_idx = jnp.take_along_axis(idx, arg, axis=-1)
    else:
        out_idx = arg.astype(jnp.int32)
    out_idx = jnp.where(jnp.isfinite(-neg), out_idx, -1)
    return -neg, out_idx


def merge_topk(
    d_a: Array, i_a: Array, d_b: Array, i_b: Array, k: int
) -> tuple[Array, Array]:
    """Merge two (dist, idx) top-k sets along last axis into one top-k set."""
    cat_d = jnp.concatenate([d_a, d_b], axis=-1)
    cat_i = jnp.concatenate([i_a, i_b], axis=-1)
    return smallest_k(cat_d, k, cat_i)


def unique_smallest_k(dists: Array, ids: Array, k: int) -> tuple[Array, Array]:
    """Top-k smallest with duplicate-id suppression (keeps first/lowest dist).

    Used when candidate pools from multiple probes/tables/trees overlap
    (reference unions Sets: index/LshIndex.java:245-258, AnnoyIndex.java:456-493).
    Operates on 1-D inputs. ids must be >= -1; -1 marks invalid entries.
    """
    # lexsort by (id, dist): equal ids become adjacent, best-dist first
    n = ids.shape[0]
    order = jnp.lexsort((dists, ids))
    s_ids = ids[order]
    s_d = dists[order]
    dup = jnp.concatenate([jnp.zeros((1,), bool), s_ids[1:] == s_ids[:-1]])
    bad = dup | (s_ids < 0)
    s_d = jnp.where(bad, jnp.inf, s_d)
    return smallest_k(s_d, k, s_ids)
