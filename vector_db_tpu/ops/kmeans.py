"""On-device k-means — the training primitive behind PQ, IVF and HNSW+PQ.

Replacement for the reference's scalar k-means loops (reference:
index/HnswPqIndex.java:194-293 per-subspace k-means with k-means++ seeding,
seed 42+subspace; native/index/HNSWPQIndex.cpp:127-244; IVFIndex.cpp:21-81).

Design (SURVEY.md §7.0): assignment = argmin over a distance matmul;
update = one-hot matmul segment-sum; the pqM subspaces train together
under one vmap.  Determinism comes from fixed jax.random keys, mirroring the
reference's fixed seeds (SURVEY.md §4.5).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .distance import pairwise_sq_l2

Array = jax.Array


def _assign(data: Array, centroids: Array, data_norms: Array) -> Array:
    """Nearest-centroid assignment [n] via one distance matmul."""
    d = pairwise_sq_l2(data, centroids, data_norms)
    return jnp.argmin(d, axis=1).astype(jnp.int32)


def kmeans_plus_plus_init(
    key: Array, data: Array, k: int, n_valid: Array | None = None
) -> Array:
    """k-means++ seeding (reference: index/HnswPqIndex.java:256-293 —
    first centroid uniform, then sample proportional to squared distance).

    data: [n, d]. Returns [k, d] centroids. ``n_valid`` masks trailing padding
    rows out of the sampling distribution.
    """
    n = data.shape[0]
    if n_valid is None:
        n_valid = jnp.asarray(n, jnp.int32)
    row_valid = jnp.arange(n) < n_valid

    k0, key = jax.random.split(key)
    first = jax.random.randint(k0, (), 0, jnp.maximum(n_valid, 1))
    centroids0 = jnp.zeros((k, data.shape[1]), data.dtype).at[0].set(data[first])
    min_d0 = jnp.where(row_valid, jnp.sum((data - data[first]) ** 2, axis=1), 0.0)

    def body(i, carry):
        centroids, min_d, key = carry
        key, sub = jax.random.split(key)
        # sample next centroid ∝ D^2 (guard against all-zero weights)
        weights = jnp.where(row_valid, min_d, 0.0)
        total = jnp.sum(weights)
        probs = jnp.where(
            total > 0, weights / jnp.maximum(total, 1e-30), row_valid / jnp.maximum(n_valid, 1)
        )
        choice = jax.random.choice(sub, n, p=probs)
        c = data[choice]
        centroids = centroids.at[i].set(c)
        d_new = jnp.where(row_valid, jnp.sum((data - c) ** 2, axis=1), 0.0)
        return centroids, jnp.minimum(min_d, d_new), key

    centroids, _, _ = jax.lax.fori_loop(1, k, body, (centroids0, min_d0, key))
    return centroids


def lloyd_iteration(
    data: Array, centroids: Array, data_norms: Array, row_valid: Array
) -> tuple[Array, Array]:
    """One Lloyd step: assign + one-hot matmul update.  Empty clusters keep
    their previous centroid (reference keeps them too,
    HnswPqIndex.java:232-243).  Returns (new_centroids, assignments)."""
    k = centroids.shape[0]
    assign = _assign(data, centroids, data_norms)
    onehot = (
        jax.nn.one_hot(assign, k, dtype=data.dtype) * row_valid[:, None].astype(data.dtype)
    )  # [n, k]
    counts = jnp.sum(onehot, axis=0)  # [k]
    sums = jax.lax.dot_general(
        onehot, data, (((0,), (0,)), ((), ())), preferred_element_type=jnp.float32
    )  # [k, d]
    new_c = jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1), centroids)
    return new_c, assign


@functools.partial(jax.jit, static_argnames=("k", "iters", "plus_plus"))
def kmeans_fit(
    key: Array,
    data: Array,
    k: int,
    iters: int = 25,
    n_valid: Array | None = None,
    plus_plus: bool = True,
) -> tuple[Array, Array]:
    """Full k-means: seeding + ``iters`` Lloyd steps, early-stable by design
    (fixed trip count keeps the program static; the reference's early-stop on
    unchanged assignments, HnswPqIndex.java:245, trades the same work).

    Returns (centroids [k, d], assignments [n]).
    """
    n = data.shape[0]
    if n_valid is None:
        n_valid = jnp.asarray(n, jnp.int32)
    row_valid = jnp.arange(n) < n_valid
    data = jnp.where(row_valid[:, None], data, 0.0)
    data_norms = jnp.sum(data * data, axis=1)

    if plus_plus:
        centroids = kmeans_plus_plus_init(key, data, k, n_valid)
    else:
        # random-init path (reference: index/PqIndex.java:384-487 random init)
        idx = jax.random.randint(key, (k,), 0, jnp.maximum(n_valid, 1))
        centroids = data[idx]

    def body(_, carry):
        centroids, _ = carry
        return lloyd_iteration(data, centroids, data_norms, row_valid)

    init_assign = jnp.zeros((n,), jnp.int32)
    centroids, assign = jax.lax.fori_loop(0, iters, body, (centroids, init_assign))
    # final assignment against the final centroids
    assign = _assign(data, centroids, data_norms)
    return centroids, assign


def subspace_kmeans_fit(
    key: Array,
    data: Array,
    num_subspaces: int,
    k: int = 256,
    iters: int = 25,
    n_valid: Array | None = None,
    plus_plus: bool = True,
) -> Array:
    """Train one codebook per PQ subspace, all subspaces in a single vmap.

    data: [n, dim] with dim % num_subspaces == 0.
    Returns codebooks [num_subspaces, k, sub_dim].
    Per-subspace keys mirror the reference's `seed 42 + subspace`
    (HnswPqIndex.java:256, HNSWPQIndex.cpp:151).
    """
    n, dim = data.shape
    if dim % num_subspaces != 0:
        raise ValueError(f"dim {dim} not divisible by {num_subspaces} subspaces")
    sub_dim = dim // num_subspaces
    sub_data = data.reshape(n, num_subspaces, sub_dim).transpose(1, 0, 2)  # [S, n, sd]
    keys = jax.random.split(key, num_subspaces)

    fit = functools.partial(kmeans_fit, k=k, iters=iters, plus_plus=plus_plus)
    if n_valid is not None:
        codebooks, _ = jax.vmap(lambda kk, dd: fit(kk, dd, n_valid=n_valid))(keys, sub_data)
    else:
        codebooks, _ = jax.vmap(fit)(keys, sub_data)
    return codebooks


@functools.partial(jax.jit, static_argnames=("k", "iters", "chunk"))
def kmeans_fit_blocked(
    key: Array,
    data: Array,
    k: int,
    iters: int = 10,
    chunk: int = 8192,
) -> Array:
    """Row-blocked Lloyd for large n*k (the scan_ivf coarse quantizer:
    nlist reaches thousands, where `kmeans_fit`'s [n, k] one-hot update
    materializes tens of GB — 24 GB at the 10M tier's auto nlist).

    Each Lloyd step streams the rows in [chunk, k] blocks and accumulates
    (sums, counts) — peak transient is one [chunk, k] score block.  Random
    init only: ++ seeding is a sequential k-step loop, and at the scales
    that need blocking random init + full-sample Lloyd converges (the
    coarse quantizer already opts out of ++, index/hnsw_pq.py train()).

    Requires n % chunk == 0 (callers round their SAMPLE — never pad the
    corpus).  Returns centroids [k, d] only (scan_ivf derives memberships
    from its own balanced top-A pass, ops/ivf_scan.coarse_choices).

    Reference analog: the coarse k-means of HnswPqIndex.java:232-245,
    restructured as a streamed accumulation for fixed device memory.
    """
    n, d = data.shape
    assert n % chunk == 0, (n, chunk)
    idx = jax.random.randint(key, (k,), 0, n)
    centroids = data[idx]

    def lloyd(_, cents):
        def body(ci, carry):
            sums, counts = carry
            blk = jax.lax.dynamic_slice_in_dim(data, ci * chunk, chunk, 0)
            dd = pairwise_sq_l2(blk, cents)
            oh = jax.nn.one_hot(
                jnp.argmin(dd, axis=1), k, dtype=jnp.float32)
            sums = sums + jax.lax.dot_general(
                oh, blk, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32)
            return sums, counts + jnp.sum(oh, axis=0)

        sums, counts = jax.lax.fori_loop(
            0, n // chunk, body,
            (jnp.zeros((k, d), jnp.float32), jnp.zeros((k,), jnp.float32)))
        return jnp.where(counts[:, None] > 0,
                         sums / jnp.maximum(counts[:, None], 1.0), cents)

    return jax.lax.fori_loop(0, iters, lloyd, centroids)
