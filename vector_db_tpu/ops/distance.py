"""Pairwise distance kernels — the matmul floor of the framework.

Replacement for the reference's SIMD/BLAS distance stack
(reference: native/compute/DistanceAVX2.cpp:9-89, DistanceScalar.cpp:7-38,
BatchDistance.cpp:20-147).  The reference computes batched L2 via the
``||q||^2 + ||v||^2 - 2 q.v`` identity with cblas_sgemm; here the same identity
is expressed as a blocked query x base matmul that XLA hands to the GPU's
matrix units,
with norms precomputed once per corpus (reference: native/core/VectorStore.cpp:98-104
caches squared norms the same way).

All distances are **squared L2** or **cosine distance** (1 - cos similarity).
Squared L2 is the internal currency everywhere (matching the reference flagship,
index/HnswPqIndex.java:27-32); sqrt happens only at the API result boundary.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

Array = jax.Array

#: metrics supported across every index type
METRIC_L2 = "l2"
METRIC_COSINE = "cosine"
VALID_METRICS = (METRIC_L2, METRIC_COSINE)

#: operand dtype of the quantized-row and packed-row scans on every backend:
#: bf16 operands, f32 accumulation (see `scan_einsum`)
SCAN_DTYPE = jnp.bfloat16


def scan_einsum(spec: str, a: Array, b: Array, dtype=SCAN_DTYPE) -> Array:
    """``einsum(spec, a, b)`` with ``dtype`` operands and f32 accumulation.

    For bf16 operands XLA's CPU runtime lacks the bf16 x bf16 -> f32 dot for
    some operand layouts, so on the CPU the same bf16-rounded values are
    multiplied in f32.  A product of two bf16 values is exact in f32, so
    both forms compute the same sums, only in another order: the CPU tests
    see the scans' bf16 numerics."""
    a, b = a.astype(dtype), b.astype(dtype)
    if dtype == jnp.float32:
        return jnp.einsum(spec, a, b, preferred_element_type=jnp.float32)

    def native(a, b):
        return jnp.einsum(spec, a, b, preferred_element_type=jnp.float32)

    def widened(a, b):
        return jnp.einsum(spec, a.astype(jnp.float32), b.astype(jnp.float32),
                          precision=jax.lax.Precision.HIGHEST,
                          preferred_element_type=jnp.float32)

    return jax.lax.platform_dependent(a, b, cpu=widened, default=native)


def sq_norms(x: Array) -> Array:
    """Row-wise squared L2 norms. [N, d] -> [N]."""
    return jnp.sum(x * x, axis=-1)


def normalize_rows(x, eps: float = 1e-12):
    """Rows scaled to unit L2 norm (the cosine "sphere contract": quantized/
    proxy spaces hold normalized rows so L2 ranking equals cosine ranking).
    Works on jnp and np arrays alike."""
    n = jnp.sqrt(jnp.maximum(jnp.sum(x * x, axis=-1, keepdims=True), eps))
    return x / n


def sq_l2(a: Array, b: Array) -> Array:
    """Squared L2 between two vectors [d],[d] -> scalar (scalar fallback path)."""
    diff = a - b
    return jnp.dot(diff, diff)


def cosine_similarity(a: Array, b: Array, eps: float = 1e-12) -> Array:
    """Cosine similarity between two vectors (reference: core/Vector.java:77-88)."""
    denom = jnp.sqrt(jnp.dot(a, a) * jnp.dot(b, b))
    return jnp.dot(a, b) / jnp.maximum(denom, eps)


def pairwise_sq_l2(
    q: Array,
    base: Array,
    q_norms: Optional[Array] = None,
    b_norms: Optional[Array] = None,
) -> Array:
    """Full pairwise squared-L2 distance matrix [Q, N] via the norm identity.

    This is the reference's BatchDistance::batchEuclideanDistanceMultiQuery
    (native/compute/BatchDistance.cpp:121-147) as one matmul.
    """
    if q_norms is None:
        q_norms = sq_norms(q)
    if b_norms is None:
        b_norms = sq_norms(base)
    # -2 Q B^T; keep f32 accumulation for exactness (GT oracle path).
    cross = jax.lax.dot_general(
        q, base, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    d = q_norms[:, None] + b_norms[None, :] - 2.0 * cross
    # numerical floor: exact distances are >= 0
    return jnp.maximum(d, 0.0)


def pairwise_cosine_dist(
    q: Array,
    base: Array,
    q_norms: Optional[Array] = None,
    b_norms: Optional[Array] = None,
    eps: float = 1e-12,
) -> Array:
    """Pairwise cosine distance (1 - cosine similarity) [Q, N]."""
    if q_norms is None:
        q_norms = sq_norms(q)
    if b_norms is None:
        b_norms = sq_norms(base)
    cross = jax.lax.dot_general(
        q, base, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )
    denom = jnp.sqrt(jnp.maximum(q_norms[:, None] * b_norms[None, :], eps))
    return 1.0 - cross / denom


def pairwise_dist(
    q: Array,
    base: Array,
    metric: str = METRIC_L2,
    q_norms: Optional[Array] = None,
    b_norms: Optional[Array] = None,
) -> Array:
    """Metric-dispatching pairwise distance [Q, N].

    The kernel-provider seam: the analog of the reference's SIMDDispatcher
    function-pointer getters (native/compute/SIMDDispatcher.cpp:74-121) — a
    single place where metric/backend selection happens.
    """
    if metric == METRIC_L2:
        return pairwise_sq_l2(q, base, q_norms, b_norms)
    if metric == METRIC_COSINE:
        return pairwise_cosine_dist(q, base, q_norms, b_norms)
    raise ValueError(f"unknown metric {metric!r}; expected one of {VALID_METRICS}")


@functools.partial(jax.jit, static_argnames=("k", "metric", "block_n"))
def blocked_knn(
    q: Array,
    base: Array,
    valid: Array,
    k: int,
    metric: str = METRIC_L2,
    b_norms: Optional[Array] = None,
    block_n: int = 8192,
) -> tuple[Array, Array]:
    """Exact k-NN: blocked scan over the base with a running top-k merge.

    Streams the base matrix in blocks of ``block_n`` rows so an arbitrarily
    large corpus never materialises a [Q, N] matrix (the analog of the
    reference's blocked exhaustive scans, native/index/PQIndex.cpp:165-198).

    Args:
      q:      [Q, d] float32 queries.
      base:   [N, d] float32 corpus (N is the static capacity).
      valid:  [N] bool mask of live slots (tombstone deletes are False).
      k:      neighbours to return.
      metric: "l2" (squared) or "cosine".
      b_norms: optional precomputed [N] squared norms of base.
    Returns:
      (dists [Q, k], slot_idx [Q, k]) sorted ascending by distance; empty slots
      padded with +inf / -1.
    """
    qn, n, d = q.shape[0], base.shape[0], base.shape[1]
    if b_norms is None:
        b_norms = sq_norms(base)
    q_norms = sq_norms(q)

    n_pad = (-n) % block_n
    if n_pad:
        base = jnp.pad(base, ((0, n_pad), (0, 0)))
        valid = jnp.pad(valid, (0, n_pad))
        b_norms = jnp.pad(b_norms, (0, n_pad))
    n_total = n + n_pad
    num_blocks = n_total // block_n

    init_d = jnp.full((qn, k), jnp.inf, dtype=jnp.float32)
    init_i = jnp.full((qn, k), -1, dtype=jnp.int32)

    def body(carry, blk):
        top_d, top_i = carry
        start = blk * block_n
        b_blk = jax.lax.dynamic_slice_in_dim(base, start, block_n, axis=0)
        v_blk = jax.lax.dynamic_slice_in_dim(valid, start, block_n, axis=0)
        n_blk = jax.lax.dynamic_slice_in_dim(b_norms, start, block_n, axis=0)
        d_blk = pairwise_dist(q, b_blk, metric, q_norms, n_blk)
        d_blk = jnp.where(v_blk[None, :], d_blk, jnp.inf)
        i_blk = start + jax.lax.broadcasted_iota(jnp.int32, (qn, block_n), 1)
        # merge running top-k with this block
        cat_d = jnp.concatenate([top_d, d_blk], axis=1)
        cat_i = jnp.concatenate([top_i, i_blk], axis=1)
        neg_top, arg = jax.lax.top_k(-cat_d, k)
        new_i = jnp.take_along_axis(cat_i, arg, axis=1)
        return (-neg_top, new_i), None

    (top_d, top_i), _ = jax.lax.scan(
        body, (init_d, init_i), jnp.arange(num_blocks, dtype=jnp.int32)
    )
    top_i = jnp.where(jnp.isfinite(top_d), top_i, -1)
    return top_d, top_i


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "block_n", "recall_target")
)
def blocked_knn_fast(
    q: Array,
    base: Array,
    valid: Array,
    k: int,
    metric: str = METRIC_L2,
    b_norms: Optional[Array] = None,
    block_n: int = 32768,
    recall_target: float = 0.99,
) -> tuple[Array, Array]:
    """Exact-scan kNN with per-block `approx_max_k`.

    Same contract as :func:`blocked_knn`: each base block is reduced with
    `approx_max_k` and the per-block winners are merged exactly.  On the GPU
    and the CPU `approx_max_k` lowers as an exact sort-based top-k, so this
    is exact there; its cost on the H100 is not measured (ROADMAP A3).  Set
    recall_target=1.0 for the exact reduction everywhere.
    """
    qn, n = q.shape[0], base.shape[0]
    if b_norms is None:
        b_norms = sq_norms(base)
    q_norms = sq_norms(q)

    # full-row path: one distance matmul + ONE approx_max_k over the whole
    # row while the [Q, N] matrix fits comfortably (no per-block reductions
    # and merges); exact requests use the blocked scan below.  Where the
    # crossover lies on the H100 is not measured (ROADMAP A5)
    if recall_target < 1.0 and qn * n * 4 <= 512 * 1024 * 1024:
        d = pairwise_dist(q, base, metric, q_norms, b_norms)
        d = jnp.where(valid[None, :], d, jnp.inf)
        neg, idx = jax.lax.approx_max_k(-d, k, recall_target=recall_target)
        idx = jnp.where(jnp.isfinite(-neg), idx, -1)
        return -neg, idx.astype(jnp.int32)

    n_pad = (-n) % block_n
    if n_pad:
        base = jnp.pad(base, ((0, n_pad), (0, 0)))
        valid = jnp.pad(valid, (0, n_pad))
        b_norms = jnp.pad(b_norms, (0, n_pad))
    num_blocks = (n + n_pad) // block_n

    def body(carry, blk):
        top_d, top_i = carry
        start = blk * block_n
        b_blk = jax.lax.dynamic_slice_in_dim(base, start, block_n, axis=0)
        v_blk = jax.lax.dynamic_slice_in_dim(valid, start, block_n, axis=0)
        n_blk = jax.lax.dynamic_slice_in_dim(b_norms, start, block_n, axis=0)
        d_blk = pairwise_dist(q, b_blk, metric, q_norms, n_blk)
        d_blk = jnp.where(v_blk[None, :], d_blk, jnp.inf)
        if recall_target >= 1.0:
            neg, idx = jax.lax.top_k(-d_blk, k)
        else:
            neg, idx = jax.lax.approx_max_k(-d_blk, k, recall_target=recall_target)
        idx = idx + start
        cat_d = jnp.concatenate([top_d, -neg], axis=1)
        cat_i = jnp.concatenate([top_i, idx], axis=1)
        neg2, arg = jax.lax.top_k(-cat_d, k)
        return ((-neg2), jnp.take_along_axis(cat_i, arg, axis=1)), None

    init = (
        jnp.full((qn, k), jnp.inf, jnp.float32),
        jnp.full((qn, k), -1, jnp.int32),
    )
    (top_d, top_i), _ = jax.lax.scan(
        body, init, jnp.arange(num_blocks, dtype=jnp.int32)
    )
    top_i = jnp.where(jnp.isfinite(top_d), top_i, -1)
    return top_d, top_i


@functools.partial(
    jax.jit, static_argnames=("pool", "metric", "block_n", "recall_target")
)
def bf16_pool_scan(
    q: Array,
    base: Array,
    valid: Array,
    pool: int,
    metric: str = METRIC_L2,
    b_norms: Optional[Array] = None,
    block_n: int = 0,
    recall_target: float = 0.95,
) -> Array:
    """Candidate-pool selection over a bf16 [Q, block] score buffer.

    The [Q, N] distance buffer of the exact f32 scan does not fuse into the
    top-k selection, so it round-trips device memory in f32 — at
    1M x 512 x Q=1024 that is 8 GB of the ~12 GB total traffic.  Writing
    the SELECTION scores in bf16 halves it.  Two precision moves make bf16
    ranking safe:

      * every large common-mode component is cancelled IN F32 before the
        bf16 cast.  On a mean-offset corpus (real embedding spaces: v =
        mu + v_hat) the raw sq-L2 score ||v||^2 - 2 q.v sits at ~|mu|^2
        magnitude where one bf16 ULP exceeds near-neighbor gaps (measured
        31% pool recall at |mu| ~ 10 x noise).  Queries are therefore
        centered by an estimated corpus mean (q - mu rides the matmul; mu
        itself rides as one extra query row so mu.v is free), and the
        score is assembled as the well-conditioned
        ``(||v - mu||^2 - E||v - mu||^2) - 2 (q - mu).v_hat``;
      * the caller exactly re-ranks the pool in f32
        (:func:`blocked_rerank`), so bf16 only has to CONTAIN the true
        top-k, not order it.

    ``block_n=0`` selects the one-shot full-row path (the [Q, N] bf16
    buffer must fit); otherwise blocks stream with per-block approx pools
    merged exactly (per-query constants are global, so merged values stay
    comparable across blocks).  Returns slot indices [Q, pool], -1-padded;
    score values are deliberately not returned (bf16 selection scores are
    not distances).
    """
    qn, n = q.shape[0], base.shape[0]
    if b_norms is None:
        b_norms = sq_norms(base)
    if metric == METRIC_COSINE:
        q = normalize_rows(q)

    # corpus-mean estimate from a valid-weighted prefix window: any vector
    # near the data mean conditions the cast; exactness is not required
    m = min(4096, n)
    pref = jax.lax.dynamic_slice_in_dim(base, 0, m, axis=0)
    w = jax.lax.dynamic_slice_in_dim(valid, 0, m).astype(jnp.float32)
    mu = jnp.sum(pref * w[:, None], axis=0) / jnp.maximum(jnp.sum(w), 1.0)
    musq = jnp.sum(mu * mu)

    if metric == METRIC_COSINE:
        # queries are unit vectors, so center by the unit mean DIRECTION
        # (centering by raw mu would blow |q - c| back up to |mu|); the
        # per-candidate common mode cos(v, mu_hat) is centered by its
        # prefix-sample mean c0 (a global scalar, so blocked merges stay
        # comparable)
        c = mu * jax.lax.rsqrt(jnp.maximum(musq, 1e-12))
        pn = jnp.sqrt(jnp.maximum(jnp.sum(pref * pref, axis=1), 1e-12))
        c0 = jnp.sum((pref @ c) / pn * w) / jnp.maximum(jnp.sum(w), 1.0)
    else:
        c = mu
        live = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)
        mean_norm = jnp.sum(jnp.where(valid, b_norms, 0.0)) / live
        # E||v - mu||^2 = E||v||^2 - ||mu||^2 (since E[mu.v] = ||mu||^2)
        center = mean_norm - musq

    qc = q - c[None, :]
    # c rides as TWO bf16 rows (hi + residual): a single-bf16 c.v carries
    # absolute error ~|c||v| 2^-9 sqrt(d), which drowns the near-neighbor
    # signal once the common mode is large (the exact case this centering
    # exists for); the hi/lo split drops it ~2^-8 x for one extra row.
    # Rows pad to a multiple of 8 so the [Q+, N] cross matrix keeps an
    # aligned row count and the cross[:qn] prefix slice stays cheap
    c_hi = c.astype(jnp.bfloat16).astype(jnp.float32)
    extra = jnp.zeros(((-qn - 2) % 8, q.shape[1]), jnp.float32)
    qaug = jnp.concatenate(
        [qc, c_hi[None, :], (c - c_hi)[None, :], extra]).astype(jnp.bfloat16)
    qmu = qc @ c  # [Q] f32 per-query constants (row offsets, L2 only)

    def block_scores(b_blk, n_blk, v_blk):
        cross = jax.lax.dot_general(
            qaug, b_blk.astype(jnp.bfloat16), (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        cv = cross[qn] + cross[qn + 1]  # c.v per candidate (hi + lo)
        if metric == METRIC_COSINE:
            # cos(q, v) = (qc.v + mu_hat.v) / |v|, centered by the mean
            # corpus cosine c0 — every term is O(cosine spread) at the cast
            iv = jax.lax.rsqrt(jnp.maximum(n_blk, 1e-12))
            s = -((cross[:qn] + cv[None, :]) * iv[None, :] - c0)
        else:
            # ||v_hat||^2 - E||v_hat||^2 - 2 (q - mu).v_hat   (all O(noise))
            vhat_sq = n_blk + musq - 2.0 * cv - center
            s = vhat_sq[None, :] - 2.0 * (cross[:qn] - qmu[:, None])
        return jnp.where(v_blk[None, :], s.astype(jnp.bfloat16),
                         jnp.asarray(jnp.inf, jnp.bfloat16))

    if block_n <= 0 or block_n >= n:
        sel = block_scores(base, b_norms, valid)
        vals, cand = jax.lax.approx_max_k(
            -sel, pool, recall_target=recall_target)
        return jnp.where(jnp.isfinite(vals.astype(jnp.float32)),
                         cand.astype(jnp.int32), -1)

    # clamped ragged last chunk, not padding (jnp.pad would copy the corpus)
    num_blocks = -(-n // block_n)
    starts = jnp.minimum(
        jnp.arange(0, num_blocks * block_n, block_n, dtype=jnp.int32),
        n - block_n,
    )
    covered = jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32),
         jnp.arange(1, num_blocks, dtype=jnp.int32) * block_n]
    )

    def body(carry, args):
        start, cov = args
        top_v, top_i = carry
        b_blk = jax.lax.dynamic_slice_in_dim(base, start, block_n, axis=0)
        v_blk = jax.lax.dynamic_slice_in_dim(valid, start, block_n)
        n_blk = jax.lax.dynamic_slice_in_dim(b_norms, start, block_n)
        idx_blk = start + jnp.arange(block_n, dtype=jnp.int32)
        v_blk = v_blk & (idx_blk >= cov)
        sel = block_scores(b_blk, n_blk, v_blk)
        vals, idx = jax.lax.approx_max_k(
            -sel, pool, recall_target=recall_target)
        cat_v = jnp.concatenate([top_v, vals.astype(jnp.float32)], axis=1)
        cat_i = jnp.concatenate([top_i, idx.astype(jnp.int32) + start], axis=1)
        v2, arg = jax.lax.top_k(cat_v, pool)
        return (v2, jnp.take_along_axis(cat_i, arg, axis=1)), None

    init = (
        jnp.full((qn, pool), -jnp.inf, jnp.float32),
        jnp.full((qn, pool), -1, jnp.int32),
    )
    (top_v, top_i), _ = jax.lax.scan(body, init, (starts, covered))
    return jnp.where(jnp.isfinite(top_v), top_i, -1)


def blocked_rerank(
    q: Array,
    base: Array,
    cand: Array,
    k: int,
    metric: str = METRIC_L2,
    rb: int = 512,
) -> tuple[Array, Array]:
    """Exact re-rank of [Q, R] candidate slots in blocks of ``rb`` with a
    running top-k merge — never materialises the full [Q, R, d] gather
    (at R=8192, Q=1024, d=512 that is a 16 GB allocation).

    The analog of the reference flagship's exact re-rank stage
    (HnswPqIndex.java:647-664); -1 candidates are ignored.
    Returns (dists [Q, k], slots [Q, k]) ascending.
    """
    q_n, r = cand.shape
    # never let block padding inflate the gather (see blocked_rerank_packed)
    rb = min(rb, max(128, -(-r // 128) * 128))
    r_pad = (-r) % rb
    if r_pad:
        cand = jnp.pad(cand, ((0, 0), (0, r_pad)), constant_values=-1)
    n_blocks = (r + r_pad) // rb
    q_norms = jnp.sum(q * q, axis=1)

    def body(carry, blk):
        top_d, top_i = carry
        cnd = jax.lax.dynamic_slice_in_dim(cand, blk * rb, rb, axis=1)
        safe = jnp.maximum(cnd, 0)
        vecs = base[safe]                                  # [Q, rb, d]
        if metric == METRIC_L2:
            dots = jnp.einsum("qd,qrd->qr", q, vecs,
                              preferred_element_type=jnp.float32)
            vn = jnp.sum(vecs * vecs, axis=2)
            d = jnp.maximum(q_norms[:, None] + vn - 2.0 * dots, 0.0)
        else:
            qn = jnp.sqrt(jnp.maximum(q_norms, 1e-12))[:, None]
            vn = jnp.linalg.norm(vecs, axis=2)
            dots = jnp.einsum("qd,qrd->qr", q, vecs)
            d = 1.0 - dots / jnp.maximum(qn * vn, 1e-12)
        d = jnp.where(cnd >= 0, d, jnp.inf)
        cat_d = jnp.concatenate([top_d, d], axis=1)
        cat_i = jnp.concatenate([top_i, cnd], axis=1)
        neg, arg = jax.lax.top_k(-cat_d, k)
        return ((-neg), jnp.take_along_axis(cat_i, arg, 1)), None

    init = (jnp.full((q_n, k), jnp.inf), jnp.full((q_n, k), -1, jnp.int32))
    (d, slots), _ = jax.lax.scan(body, init, jnp.arange(n_blocks, dtype=jnp.int32))
    return d, slots


def pack_bf16_rows(base: Array) -> Array:
    """[N, d] f32 -> [N, d/2] f32-TYPED array holding bf16 pairs.

    The bf16 refine store is bit-packed into f32 words: the gather moves
    half the bytes of f32 rows as f32-typed words, and the block bitcasts
    back to bf16 for the distance math.  (The layout was chosen for an
    earlier accelerator's gather; on the H100 it is not measured.)
    """
    n, d = base.shape
    b16 = base.astype(jnp.bfloat16)
    return jax.lax.bitcast_convert_type(b16.reshape(n, d // 2, 2),
                                        jnp.float32)


def blocked_rerank_packed(
    q: Array,
    packed: Array,
    cand: Array,
    k: int,
    metric: str = METRIC_L2,
    rb: int = 512,
) -> tuple[Array, Array]:
    """`blocked_rerank` against a bf16-packed refine store (see
    pack_bf16_rows).  Distance error vs f32 rows is ~0.03% — far below
    neighbor-gap scale — while refine traffic halves."""
    q_n, r = cand.shape
    d = packed.shape[1] * 2
    # never let block padding inflate the gather: a 128-candidate pool in a
    # 512-block would fetch and score 4x too many rows
    rb = min(rb, max(128, -(-r // 128) * 128))
    r_pad = (-r) % rb
    if r_pad:
        cand = jnp.pad(cand, ((0, 0), (0, r_pad)), constant_values=-1)
    n_blocks = (r + r_pad) // rb
    q_norms = jnp.sum(q * q, axis=1)

    def body(carry, blk):
        top_d, top_i = carry
        cnd = jax.lax.dynamic_slice_in_dim(cand, blk * rb, rb, axis=1)
        safe = jnp.maximum(cnd, 0)
        vp = packed[safe]                                  # [Q, rb, d/2] f32
        v16 = jax.lax.bitcast_convert_type(vp, jnp.bfloat16).reshape(
            q_n, rb, d
        )
        dots = scan_einsum("qd,qrd->qr", q, v16)
        v32 = v16.astype(jnp.float32)
        vn = jnp.sum(v32 * v32, axis=2)
        if metric == METRIC_L2:
            dd = jnp.maximum(q_norms[:, None] + vn - 2.0 * dots, 0.0)
        else:
            qn_ = jnp.sqrt(jnp.maximum(q_norms, 1e-12))[:, None]
            dd = 1.0 - dots / jnp.maximum(qn_ * jnp.sqrt(vn), 1e-12)
        dd = jnp.where(cnd >= 0, dd, jnp.inf)
        cat_d = jnp.concatenate([top_d, dd], axis=1)
        cat_i = jnp.concatenate([top_i, cnd], axis=1)
        neg, arg = jax.lax.top_k(-cat_d, k)
        return ((-neg), jnp.take_along_axis(cat_i, arg, 1)), None

    init = (jnp.full((q_n, k), jnp.inf), jnp.full((q_n, k), -1, jnp.int32))
    (dd, slots), _ = jax.lax.scan(body, init,
                                  jnp.arange(n_blocks, dtype=jnp.int32))
    return dd, slots


def knn_full(
    q: Array,
    base: Array,
    valid: Array,
    k: int,
    metric: str = METRIC_L2,
    b_norms: Optional[Array] = None,
) -> tuple[Array, Array]:
    """Exact k-NN materialising the full [Q, N] matrix — fastest for small N."""
    d = pairwise_dist(q, base, metric, None, b_norms)
    d = jnp.where(valid[None, :], d, jnp.inf)
    neg, idx = jax.lax.top_k(-d, k)
    idx = jnp.where(jnp.isfinite(-neg), idx, -1)
    return -neg, idx.astype(jnp.int32)


def pack_int8_rows(base: Array) -> tuple[Array, Array]:
    """[N, d] f32 -> (int32-packed int8 rows [N, d/4], per-row scales [N]).

    Symmetric per-row quantization: row_q = round(127 * v / max|v|),
    v ~ scale * row_q with |error| <= scale/2 per element (~0.4% relative).
    The 4x-smaller refine store for corpora whose RAW f32 rows do not fit
    HBM (at 10M x 512: 5.1 GB vs 20 GB) — see blocked_rerank_int8.

    Rows are BIT-PACKED four int8 per int32 word for the same reason the
    bf16 store packs pairs into f32 (pack_bf16_rows): sub-word gathers run
    far below word-width gather bandwidth on this chip; the int32 gather
    moves identical bytes at full efficiency and the refine block bitcasts
    back to int8.  Requires d % 4 == 0 (every supported config; pad dims
    otherwise).
    """
    n, d = base.shape
    amax = jnp.max(jnp.abs(base), axis=1)
    scale = jnp.maximum(amax, 1e-30) / 127.0
    q = jnp.clip(jnp.round(base / scale[:, None]), -127, 127).astype(jnp.int8)
    packed = jax.lax.bitcast_convert_type(q.reshape(n, d // 4, 4), jnp.int32)
    return packed, scale


@jax.jit
def pack_int8_residual(base: Array, packed: Array,
                       scales: Array) -> tuple[Array, Array]:
    """Second-level int8 quantization of the rows' quantization RESIDUAL
    (base - dequant(packed)): returns (resid_packed [N, d/4] i32,
    rscales [N]).

    Two-level int8 reaches ~16-bit effective precision (the residual's
    range is ~scale/2, so its own scale is ~1/254 of the primary's:
    combined per-element error ~2e-5 of max|v|) at HALF the bytes of f32
    — and, unlike a single bf16 row store at the SAME total bytes, the
    first level stays s8 for the int8 pool scans.  Measured: with a
    perfectly-contained candidate pool the int8 refine scores 99.3%
    Recall@10 where int8+residual is EXACT (at 50k-200k x 512); this is
    the compressed tier's answer to the refine-precision recall ceiling.
    """
    resid = base - unpack_int8_rows(packed, scales)
    return pack_int8_rows(resid)


def blocked_rerank_int8(
    q: Array,
    packed: Array,
    scales: Array,
    cand: Array,
    k: int,
    metric: str = METRIC_L2,
    rb: int = 512,
    b_norms: Optional[Array] = None,
    resid: Optional[Array] = None,
    rscales: Optional[Array] = None,
) -> tuple[Array, Array]:
    """`blocked_rerank` against an int8 row store (see pack_int8_rows).

    The refine gather moves 1/4 the bytes of f32 (1/2 of the bf16-packed
    store); per-element quantization error ~0.4% relative — well under
    neighbor-gap scale for ranking a few hundred candidates.  Used when the
    raw corpus cannot be HBM-resident at all (10M x 512 = 20 GB raw).

    ``b_norms`` ([N] EXACT squared norms captured at write time — the
    compressed VectorStore keeps them) replaces the ‖v‖² term re-derived
    from the quantized rows, so the only quantization error left is the
    cross term (same contract as blocked_knn_int8); the extra gather is 4
    bytes/row against the 128+ of the packed row itself.  L2 ONLY: under
    cosine, dividing the quantized dot by the quantized row's OWN norm
    gives the exact cosine to the quantized direction (radial quantization
    error projects out), whereas the exact pre-quantization norm leaks it
    into the score — so cosine always re-derives ‖v̂‖ (measured: the
    exact-norm variant costs ~1pt recall on offset cosine corpora).

    ``resid``/``rscales`` (pack_int8_residual) add the second-level int8
    residual to the cross term: ~16-bit effective row precision, which
    removes the refine-ordering recall ceiling entirely (ranking a
    perfectly-contained pool goes 99.3% -> 100% Recall@10 at 512d).  The
    residual path computes its dots in f32 — a bf16 query would round at
    ~1e-4 relative, swamping the ~4e-5 residual error it buys.  Gathers
    double (still half the bytes of an f32 row store).
    """
    q_n, r = cand.shape
    d = packed.shape[1] * 4
    rb = min(rb, max(128, -(-r // 128) * 128))
    r_pad = (-r) % rb
    if r_pad:
        cand = jnp.pad(cand, ((0, 0), (0, r_pad)), constant_values=-1)
    n_blocks = (r + r_pad) // rb
    q_norms = jnp.sum(q * q, axis=1)
    dt = SCAN_DTYPE if resid is None else jnp.float32

    def body(carry, blk):
        top_d, top_i = carry
        cnd = jax.lax.dynamic_slice_in_dim(cand, blk * rb, rb, axis=1)
        safe = jnp.maximum(cnd, 0)
        vp = packed[safe]                                  # [Q, rb, d/4] i32
        v8 = jax.lax.bitcast_convert_type(vp, jnp.int8).reshape(q_n, rb, d)
        sc = scales[safe]                                  # [Q, rb]
        dots = scan_einsum("qd,qrd->qr", q, v8, dt) * sc
        if resid is not None:
            r8 = jax.lax.bitcast_convert_type(
                resid[safe], jnp.int8).reshape(q_n, rb, d)
            rsc = rscales[safe]                            # [Q, rb]
            dots = dots + scan_einsum("qd,qrd->qr", q, r8, dt) * rsc
        if b_norms is not None and metric == METRIC_L2:
            vn = b_norms[safe]
        elif resid is not None:
            # cosine + residual: the two-level row's own norm (the
            # quantized-direction contract at ~16-bit precision)
            deq = (v8.astype(jnp.float32) * sc[:, :, None]
                   + r8.astype(jnp.float32) * rsc[:, :, None])
            vn = jnp.sum(deq * deq, axis=2)
        else:
            vn = jnp.sum(v8.astype(jnp.float32) ** 2, axis=2) * (sc * sc)
        if metric == METRIC_L2:
            dd = jnp.maximum(q_norms[:, None] + vn - 2.0 * dots, 0.0)
        else:
            qn_ = jnp.sqrt(jnp.maximum(q_norms, 1e-12))[:, None]
            dd = 1.0 - dots / jnp.maximum(qn_ * jnp.sqrt(vn), 1e-12)
        dd = jnp.where(cnd >= 0, dd, jnp.inf)
        cat_d = jnp.concatenate([top_d, dd], axis=1)
        cat_i = jnp.concatenate([top_i, cnd], axis=1)
        neg, arg = jax.lax.top_k(-cat_d, k)
        return ((-neg), jnp.take_along_axis(cat_i, arg, 1)), None

    init = (jnp.full((q_n, k), jnp.inf), jnp.full((q_n, k), -1, jnp.int32))
    (dd, slots), _ = jax.lax.scan(body, init,
                                  jnp.arange(n_blocks, dtype=jnp.int32))
    return dd, slots


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "block_n", "recall_target")
)
def blocked_knn_int8(
    q: Array,
    packed: Array,
    scales: Array,
    valid: Array,
    k: int,
    metric: str = METRIC_L2,
    b_norms: Optional[Array] = None,
    block_n: int = 262144,
    recall_target: float = 0.95,
    resid: Optional[Array] = None,
    rscales: Optional[Array] = None,
) -> tuple[Array, Array]:
    """`blocked_knn_fast` against an int8 row store (see pack_int8_rows) —
    the exhaustive-scan path for corpora whose raw f32 rows cannot be
    HBM-resident (the compressed VectorStore regime; at 10M x 512 the scan
    streams 5.1 GB instead of 20 GB).

    Distances use the norm identity with the EXACT squared norms captured at
    write time (``b_norms``), so the only quantization error is in the cross
    term (scale * q . row8, ~0.4% relative): ranking is near-exact and the
    returned distance values are exact in the norm terms.  Falls back to
    decoded norms when ``b_norms`` is None — and ALWAYS under cosine, where
    the quantized row's own norm is the better denominator (it yields the
    exact cosine to the quantized direction; the exact pre-quantization
    norm would leak the radial quantization error into the score).

    q [Q, d] f32; packed [N, d/4] int32; scales [N] f32; valid [N] bool.
    Returns (dists [Q, k], slot idx [Q, k]) ascending; +inf / -1 padded.
    """
    qn, n = q.shape[0], packed.shape[0]
    d = packed.shape[1] * 4
    q_norms = sq_norms(q)
    # the residual's ~4e-5 precision needs f32 dots (bf16 query rounding
    # is 1e-4 — see blocked_rerank_int8); this mode trades scan rate for an
    # effectively exact exhaustive scorer
    dt = SCAN_DTYPE if resid is None else jnp.float32

    # clamped ragged last chunk, not padding: jnp.pad would transiently copy
    # the whole packed store (5+ GB at 10M) — the final chunk re-slices
    # [n - block_n, n) and masks rows previous chunks already covered
    block_n = min(block_n, n)
    num_blocks = -(-n // block_n)
    starts = jnp.minimum(
        jnp.arange(0, num_blocks * block_n, block_n, dtype=jnp.int32),
        n - block_n,
    )
    covered = jnp.concatenate(
        [jnp.full((1,), -1, jnp.int32),
         jnp.arange(1, num_blocks, dtype=jnp.int32) * block_n]
    )

    def body(carry, args):
        start, cov = args
        top_d, top_i = carry
        p_blk = jax.lax.dynamic_slice_in_dim(packed, start, block_n, axis=0)
        s_blk = jax.lax.dynamic_slice_in_dim(scales, start, block_n)
        v_blk = jax.lax.dynamic_slice_in_dim(valid, start, block_n)
        idx_blk = start + jnp.arange(block_n, dtype=jnp.int32)
        v_blk = v_blk & (idx_blk >= cov)
        v8 = jax.lax.bitcast_convert_type(p_blk, jnp.int8).reshape(
            block_n, d
        )
        dots = scan_einsum("qd,nd->qn", q, v8, dt) * s_blk[None, :]
        if resid is not None:
            rp_blk = jax.lax.dynamic_slice_in_dim(resid, start, block_n,
                                                  axis=0)
            rs_blk = jax.lax.dynamic_slice_in_dim(rscales, start, block_n)
            r8 = jax.lax.bitcast_convert_type(rp_blk, jnp.int8).reshape(
                block_n, d)
            dots = dots + scan_einsum("qd,nd->qn", q, r8, dt) * rs_blk[None, :]
        if b_norms is not None and metric == METRIC_L2:
            vn = jax.lax.dynamic_slice_in_dim(b_norms, start, block_n)
        elif resid is not None:
            # cosine + residual: the denominator is the TWO-level row's
            # own norm (quantized-direction contract at 16-bit precision)
            deq = (v8.astype(jnp.float32) * s_blk[:, None]
                   + r8.astype(jnp.float32) * rs_blk[:, None])
            vn = jnp.sum(deq * deq, axis=1)
        else:
            vn = jnp.sum(v8.astype(jnp.float32) ** 2, axis=1) * (s_blk * s_blk)
        if metric == METRIC_L2:
            d_blk = jnp.maximum(q_norms[:, None] + vn[None, :] - 2.0 * dots, 0.0)
        else:
            qn_ = jnp.sqrt(jnp.maximum(q_norms, 1e-12))[:, None]
            d_blk = 1.0 - dots / jnp.maximum(qn_ * jnp.sqrt(vn)[None, :], 1e-12)
        d_blk = jnp.where(v_blk[None, :], d_blk, jnp.inf)
        if recall_target >= 1.0:
            neg, idx = jax.lax.top_k(-d_blk, k)
        else:
            neg, idx = jax.lax.approx_max_k(-d_blk, k, recall_target=recall_target)
        cat_d = jnp.concatenate([top_d, -neg], axis=1)
        cat_i = jnp.concatenate([top_i, idx.astype(jnp.int32) + start], axis=1)
        neg2, arg = jax.lax.top_k(-cat_d, k)
        return ((-neg2), jnp.take_along_axis(cat_i, arg, axis=1)), None

    init = (
        jnp.full((qn, k), jnp.inf, jnp.float32),
        jnp.full((qn, k), -1, jnp.int32),
    )
    (top_d, top_i), _ = jax.lax.scan(body, init, (starts, covered))
    top_i = jnp.where(jnp.isfinite(top_d), top_i, -1)
    return top_d, top_i


def unpack_int8_rows(packed: Array, scales: Array) -> Array:
    """Inverse of pack_int8_rows (up to quantization): [N, d/4] int32 +
    [N] scales -> [N, d] f32 dequantized rows."""
    n = packed.shape[0]
    d = packed.shape[1] * 4
    v8 = jax.lax.bitcast_convert_type(packed, jnp.int8).reshape(n, d)
    return v8.astype(jnp.float32) * scales[:, None]
