"""ADC (asymmetric distance computation) kernels for Product Quantization.

Replacement for the reference's ADC stack (reference:
native/compute/ADCUtils.cpp:11-147 AVX2 lookup-table accumulation;
index/PqIndex.java:306-330 distance-table build; :273-293 full scan;
index/HnswPqIndex.java:371-386 computePQDistance).

Design (SURVEY.md §7.0): the per-query distance table is a small matmul; the
code scan streams the device-resident uint8 code matrix in blocks and
reduces either by XLA gather or by a one-hot matmul (both provided — the
kernel-provider seam, selectable per call; the scan is memory-bound on the
[N, S] code bytes so both are near speed-of-light for realistic shapes).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp

from .distance import SCAN_DTYPE, scan_einsum

Array = jax.Array


@jax.jit
def pq_encode(data: Array, codebooks: Array) -> Array:
    """Encode vectors to PQ codes (reference: HnswPqIndex.encodeVector :355-366).

    data: [n, dim]; codebooks: [S, K, sub_dim] -> codes [n, S] uint8.
    Per-subspace nearest-centroid argmin via one batched matmul (the vmapped
    analog of the reference's 4-thread parallel encode, PQIndex.cpp:227-245).
    """
    n, dim = data.shape
    s, k, sub_dim = codebooks.shape
    sub = data.reshape(n, s, sub_dim).transpose(1, 0, 2)  # [S, n, sd]

    def one(sub_data, cb):
        d = (
            jnp.sum(sub_data * sub_data, axis=1)[:, None]
            + jnp.sum(cb * cb, axis=1)[None, :]
            - 2.0
            * jax.lax.dot_general(
                sub_data, cb, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
            )
        )
        return jnp.argmin(d, axis=1)

    codes = jax.vmap(one)(sub, codebooks)  # [S, n]
    return codes.T.astype(jnp.uint8)


@jax.jit
def build_distance_tables(queries: Array, codebooks: Array) -> Array:
    """Per-query subspace distance tables (reference: PqIndex.java:306-330).

    queries: [Q, dim]; codebooks: [S, K, sub_dim] -> tables [Q, S, K] float32
    where tables[q, s, c] = ||q_sub[s] - codebooks[s, c]||^2.
    """
    q_n, dim = queries.shape
    s, k, sub_dim = codebooks.shape
    q_sub = queries.reshape(q_n, s, sub_dim)  # [Q, S, sd]
    cb_norms = jnp.sum(codebooks * codebooks, axis=2)  # [S, K]
    q_norms = jnp.sum(q_sub * q_sub, axis=2)  # [Q, S]
    # cross[q, s, c] = q_sub[q, s] . codebooks[s, c]
    cross = jnp.einsum(
        "qsd,skd->qsk", q_sub, codebooks, preferred_element_type=jnp.float32
    )
    return q_norms[:, :, None] + cb_norms[None, :, :] - 2.0 * cross


def _adc_block_gather(tables: Array, codes_blk: Array) -> Array:
    """Distances for one code block via gather. tables [Q,S,K], codes [B,S]
    -> [Q, B]."""
    idx = codes_blk.astype(jnp.int32).T[None, :, :]  # [1, S, B]
    gathered = jnp.take_along_axis(tables, idx, axis=2)  # [Q, S, B]
    return jnp.sum(gathered, axis=1)


def _adc_block_onehot(tables: Array, codes_blk: Array) -> Array:
    """Distances for one code block via one one-hot matmul.
    tables [Q,S,K], codes [B,S] -> [Q, B]."""
    q_n, s, k = tables.shape
    b = codes_blk.shape[0]
    onehot = jax.nn.one_hot(codes_blk.astype(jnp.int32), k, dtype=jnp.bfloat16)  # [B,S,K]
    flat_t = tables.reshape(q_n, s * k).astype(jnp.bfloat16)
    flat_o = onehot.reshape(b, s * k)
    return jax.lax.dot_general(
        flat_t, flat_o, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
    )


@functools.partial(jax.jit, static_argnames=("k", "block_n", "impl"))
def adc_scan_topk(
    tables: Array,
    codes: Array,
    valid: Array,
    k: int,
    block_n: int = 4096,
    impl: str = "gather",
) -> tuple[Array, Array]:
    """Exhaustive ADC scan with running top-k (the batched answer to the
    reference's 8-way-unrolled blocked scan, PQIndex.cpp:165-198).

    tables: [Q, S, K]; codes: [N, S] uint8; valid: [N] bool.
    Returns (dists [Q, k], slot_idx [Q, k]) ascending; -1/inf padded.
    """
    q_n = tables.shape[0]
    n = codes.shape[0]
    block_fn = _adc_block_gather if impl == "gather" else _adc_block_onehot

    n_pad = (-n) % block_n
    if n_pad:
        codes = jnp.pad(codes, ((0, n_pad), (0, 0)))
        valid = jnp.pad(valid, (0, n_pad))
    num_blocks = (n + n_pad) // block_n

    init_d = jnp.full((q_n, k), jnp.inf, jnp.float32)
    init_i = jnp.full((q_n, k), -1, jnp.int32)

    def body(carry, blk):
        top_d, top_i = carry
        start = blk * block_n
        c_blk = jax.lax.dynamic_slice_in_dim(codes, start, block_n, axis=0)
        v_blk = jax.lax.dynamic_slice_in_dim(valid, start, block_n, axis=0)
        d_blk = block_fn(tables, c_blk)
        d_blk = jnp.where(v_blk[None, :], d_blk, jnp.inf)
        i_blk = start + jax.lax.broadcasted_iota(jnp.int32, (q_n, block_n), 1)
        cat_d = jnp.concatenate([top_d, d_blk], axis=1)
        cat_i = jnp.concatenate([top_i, i_blk], axis=1)
        neg, arg = jax.lax.top_k(-cat_d, k)
        return ((-neg), jnp.take_along_axis(cat_i, arg, axis=1)), None

    (top_d, top_i), _ = jax.lax.scan(
        body, (init_d, init_i), jnp.arange(num_blocks, dtype=jnp.int32)
    )
    top_i = jnp.where(jnp.isfinite(top_d), top_i, -1)
    return top_d, top_i


def adc_distances(tables: Array, codes: Array) -> Array:
    """Full [Q, N] ADC distance matrix (small-N path / single-pair use —
    the analog of ADCUtils::computeADCDistance, ADCUtils.cpp:11-17)."""
    return _adc_block_gather(tables, codes)


# ---------------------------------------------------------------------------
# fast memory-bound mode: decode-kernel scan + unranked pool + exact refine
# ---------------------------------------------------------------------------

@jax.jit
def pq_decode_recon_t(codes_t: Array, cbt: Array) -> Array:
    """Decode PQ codes to reconstructed vectors, transposed.

    codes_t: [S, N] integer codes; cbt: [S*sd, K] f32 with
    cbt[s*sd + j, c] = codebooks[s, c, j].  Returns reconT [S*sd, N] bf16
    with reconT[s*sd + j, n] = codebooks[s, codes[n, s], j]: one gather
    from the table, fused with the bf16 convert.

    ADC distance EQUALS the exact distance to the reconstruction, so the
    decode is query-independent: decode once, then one matmul scores every
    query against it (the reference's per-query AVX2 table lookups,
    native/compute/ADCUtils.cpp:21-134, become O(N*d) gathers).
    """
    s = codes_t.shape[0]
    sd = cbt.shape[0] // s
    idx = jnp.repeat(codes_t.astype(jnp.int32), sd, axis=0)       # [d, N]
    return jnp.take_along_axis(cbt, idx, axis=1).astype(jnp.bfloat16)


def codebooks_to_cbt(codebooks: Array) -> Array:
    """[S, K, sd] -> the decode kernel's [S*sd, K] gather layout."""
    s, k, sd = codebooks.shape
    return jnp.transpose(codebooks, (0, 2, 1)).reshape(s * sd, k)


def balanced_subspace_perm(variances, num_subspaces: int):
    """Variance-balanced dimension permutation for PQ subspaces.

    PQ slices consecutive dims into subspaces, which is catastrophic on
    corpora with decaying spectra (real embeddings): the first subspace gets
    all the variance, the last gets noise, yet both spend 8 bits.  This
    assigns dims greedily (descending variance -> least-loaded subspace with
    free capacity), equalising per-subspace variance.  L2 is permutation-
    invariant, so quantized distances are unchanged in meaning — only the
    cells get uniformly tighter.  (The cheap, deterministic cousin of OPQ's
    learned rotation; tests/test_adc_fast.py checks the recall gain on a
    power-law spectrum.)

    Returns perm [d] int — position j of the permuted vector takes original
    dim perm[j]; subspace s owns positions [s*sd, (s+1)*sd).
    """
    import numpy as np

    v = np.asarray(variances, np.float64)
    d = v.shape[0]
    sd = d // num_subspaces
    order = np.argsort(-v, kind="stable")
    totals = np.zeros(num_subspaces)
    members: list[list[int]] = [[] for _ in range(num_subspaces)]
    for dim in order:
        open_s = [s for s in range(num_subspaces) if len(members[s]) < sd]
        s = min(open_s, key=lambda s: (totals[s], s))
        members[s].append(int(dim))
        totals[s] += v[dim]
    return np.concatenate([np.asarray(m, np.int64) for m in members])


@functools.partial(
    jax.jit,
    static_argnames=("k", "bucket", "winners", "metric", "rerank_block",
                     "chunk_n", "pool_mode", "select_r"),
)
def adc_fast_search(
    queries: Array,
    codes_t: Array,
    cbt: Array,
    valid: Array,
    base: Array,
    ids: Array,
    k: int,
    bucket: int = 32,
    winners: int = 1,
    metric: str = "l2",
    rerank_block: int = 512,
    chunk_n: int = 0,
    pool_mode: str = "bucket",
    code_norms: Optional[Array] = None,
    perm: Optional[Array] = None,
    packed_base: Optional[Array] = None,
    select_r: int = 0,
    int8_base: Optional[Array] = None,
    int8_scales: Optional[Array] = None,
    int8_norms: Optional[Array] = None,
    int8_resid: Optional[Array] = None,
    int8_rscales: Optional[Array] = None,
) -> tuple[Array, Array]:
    """The fast codes-only scoring pipeline, ONE device program:

      1. decode codes -> reconstructed vectors (`pq_decode_recon_t`, one
         gather; ADC distance == exact distance to the reconstruction, so
         the scan below is *exactly* the ADC scan, as one matmul)
      2. one [Q, d] x [d, N] bf16 matmul -> quantized distances
      3. UNRANKED candidate pool: the best `winners` per `bucket` lanes
         (a reshape-min, one pass) — no giant top-R sort.  A ranked pool is
         unnecessary: the exact re-rank orders everything that matters, so
         selection only has to *contain* the true neighbors.  This is what
         makes the stage cheap: a ranked select at R=2048..8192 is a sort
         of the [Q, N] distances, while the reshape-min is one pass.
      4. blocked exact re-rank of the pool (raw vectors touched ONLY here,
         like the reference's refine, HnswPqIndex.java:647-664).

    Candidate scoring reads only `codes_t` + `cbt` (+ a transient [d, N]
    bf16 reconstruction buffer that never persists).  Pool size = winners *
    N / bucket; recall/QPS tradeoff comes from `bucket`/`winners`.

    queries [Q, d] f32; codes_t [S, N] uint8; cbt [S*sd, K] f32;
    valid [N] bool; base [N, d] f32 raw store; ids [N] external ids.
    Returns (dists [Q, k], external ids [Q, k]) ascending.
    """
    from .distance import blocked_rerank

    q_n, d = queries.shape
    n = codes_t.shape[1]
    # the scan runs in PQ space (optionally dimension-permuted, see
    # balanced_subspace_perm — L2 is permutation-invariant so the refine
    # below still uses the raw queries/store).  For cosine the codes hold
    # NORMALIZED vectors (the index encodes the unit sphere), so the query
    # normalizes too: L2 ranking on the sphere == cosine ranking; the exact
    # refine is scale-invariant in q either way.
    from .distance import normalize_rows

    q_scan = normalize_rows(queries) if metric == "cosine" else queries
    if perm is not None:
        q_scan = q_scan[:, perm]
    qb = q_scan.astype(SCAN_DTYPE)
    # validity rides in the norms: +inf at dead slots (saves a [Q, N] where)
    masked_norms = code_norms_from_codes(codes_t, cbt, valid, code_norms)

    if chunk_n <= 0 or chunk_n >= n:
        if pool_mode == "approx" and select_r > 0:
            # the approx pool is already RANKED, so a separate narrowing
            # pass would be redundant work: ask approx_max_k for the
            # top-select_r directly
            bucket = max(1, -(-n * winners // select_r))
        pool_vals, pool = _score_pool_chunk(qb, codes_t, cbt, masked_norms,
                                            bucket, winners, pool_mode)
    else:
        # large-N path: stream the corpus in chunks so peak memory is the
        # per-chunk [d, chunk] reconstruction + [Q, chunk] distances, never
        # [Q, N] (the adc_fast analog of the blocked/fused large-N scans)
        if pool_mode == "approx" and select_r > 0:
            # per-chunk ranked pools capped at 4x the expected per-chunk
            # share of the global top-select_r (floor 128), then ONE
            # cross-chunk select below — approx_max_k cost grows steeply
            # with k, so per-chunk top-select_r wastes most of the scan
            # (measured at 10M/19 chunks: per-chunk 512 ~4x slower than
            # per-chunk 128 + final select, same recall)
            n_chunks_est = max(1, -(-n // chunk_n))
            r_chunk = min(select_r,
                          max(128, -(-4 * select_r // n_chunks_est)))
            bucket = max(1, -(-chunk_n * winners // r_chunk))
        chunk_n = min(chunk_n, n)
        num_chunks = -(-n // chunk_n)
        # clamped ragged last chunk, not padding: jnp.pad would copy the
        # whole [S, N] code matrix (640 MB at 10M) to align the tail; the
        # final chunk re-slices [n - chunk_n, n) and masks rows previous
        # chunks already covered
        starts = jnp.minimum(
            jnp.arange(0, num_chunks * chunk_n, chunk_n, dtype=jnp.int32),
            n - chunk_n,
        )
        covered = jnp.concatenate(
            [jnp.full((1,), -1, jnp.int32),
             jnp.arange(1, num_chunks, dtype=jnp.int32) * chunk_n]
        )

        def one_chunk(args):
            start, cov = args
            ct_blk = jax.lax.dynamic_slice_in_dim(codes_t, start, chunk_n,
                                                  axis=1)
            mn_blk = jax.lax.dynamic_slice_in_dim(masked_norms, start,
                                                  chunk_n)
            idx = start + jnp.arange(chunk_n, dtype=jnp.int32)
            mn_blk = jnp.where(idx < cov, jnp.inf, mn_blk)
            lv, local = _score_pool_chunk(qb, ct_blk, cbt, mn_blk, bucket,
                                          winners, pool_mode)
            return lv, jnp.where(local >= 0, local + start, -1)

        pvals, pools = jax.lax.map(one_chunk, (starts, covered))  # [C, Q, w]
        pool = jnp.moveaxis(pools, 0, 1).reshape(q_n, -1)
        pool_vals = jnp.moveaxis(pvals, 0, 1).reshape(q_n, -1)
    pool = jnp.where(pool < n, pool, -1)
    if 0 < select_r < pool.shape[1]:
        # narrow the wide cheap pool with a tiny ranked select before the
        # refine gathers (approx_max_k over the pool VALUES — [Q, W] is
        # hundreds of times smaller than [Q, N], so this select is far
        # cheaper than ranked selection over the full distances)
        pv = jnp.where(pool >= 0, pool_vals, jnp.inf)
        _, sel = jax.lax.approx_max_k(-pv, select_r, recall_target=0.99)
        pool = jnp.take_along_axis(pool, sel, axis=1)

    # exact re-rank (the only stage that reads raw vectors); with a
    # bf16-packed refine store the gather moves half the bytes (see
    # ops/distance.pack_bf16_rows); with an int8 store (the >HBM compressed
    # regime — no raw f32 rows exist at all) a quarter
    if int8_base is not None:
        from .distance import blocked_rerank_int8

        out_d, slots = blocked_rerank_int8(queries, int8_base, int8_scales,
                                           pool, k, metric, rb=rerank_block,
                                           b_norms=int8_norms,
                                           resid=int8_resid,
                                           rscales=int8_rscales)
    elif packed_base is not None:
        from .distance import blocked_rerank_packed

        out_d, slots = blocked_rerank_packed(queries, packed_base, pool, k,
                                             metric, rb=rerank_block)
    else:
        out_d, slots = blocked_rerank(queries, base, pool, k, metric,
                                      rb=rerank_block)
    ext = jnp.where(jnp.isfinite(out_d), ids[jnp.maximum(slots, 0)], -1)
    return out_d, ext


@functools.partial(jax.jit, static_argnames=("k", "recall_target"))
def adc_decode_topk(
    queries: Array,
    codes_t: Array,
    cbt: Array,
    valid: Array,
    k: int,
    code_norms: Optional[Array] = None,
    recall_target: float = 0.95,
    perm: Optional[Array] = None,
) -> tuple[Array, Array]:
    """Ranked ADC top-k via the decode kernel: decode -> one bf16 matmul ->
    approx_max_k.  Returns TRUE ADC distance values (|q - recon|^2, with the
    query norm added back), ascending; -1/inf padded.

    This replaces the gather/one-hot table scans whenever ranked quantized
    distances are wanted directly (flat PQ search): same distances as
    `adc_scan_topk` up to bf16 rounding, as one matmul instead of per-code
    table gathers.
    """
    masked = code_norms_from_codes(codes_t, cbt, valid, code_norms)
    if perm is not None:
        queries = queries[:, perm]
    cross = _decode_cross(queries.astype(SCAN_DTYPE), codes_t, cbt)
    q_norms = jnp.sum(queries * queries, axis=1)
    dist = q_norms[:, None] + masked[None, :] - 2.0 * cross
    neg, idx = jax.lax.approx_max_k(-dist, k, recall_target=recall_target)
    idx = jnp.where(jnp.isfinite(-neg), idx.astype(jnp.int32), -1)
    return jnp.maximum(-neg, 0.0), idx


def code_norms_from_codes(
    codes_t: Array, cbt: Array, valid: Array,
    code_norms: Optional[Array] = None,
) -> Array:
    """[N] squared reconstruction norms with +inf at dead slots.  Pass a
    cached `code_norms` (no inf folding) to skip the decode pass — the index
    layer caches it per encode generation (the C2 norms-cache analog)."""
    if code_norms is None:
        r32 = pq_decode_recon_t(codes_t, cbt).astype(jnp.float32)
        code_norms = jnp.sum(r32 * r32, axis=0)
    return jnp.where(valid, code_norms, jnp.inf)


def _decode_cross(qb: Array, codes_t: Array, cbt: Array) -> Array:
    """q . reconstruction cross terms [Q, n] f32: the PQ decode + one
    matmul with bf16 operands and f32 accumulation (`scan_einsum`).  The
    index layer passes its 128-aligned capacity as n."""
    recon_t = pq_decode_recon_t(codes_t, cbt)                   # [d, n] bf16
    return scan_einsum("qd,dn->qn", qb, recon_t)


def _score_pool_chunk(
    qb: Array, codes_t: Array, cbt: Array, masked_norms: Array,
    bucket: int, winners: int, pool_mode: str = "bucket",
) -> Array:
    """Score one corpus (chunk) from its codes and return the UNRANKED
    candidate pool of local slot indices (-1 padded).

    PQ decode -> one bf16 matmul -> pool selection:

      * pool_mode="bucket": best `winners` per STRIDED bucket (slot i joins
        bucket i % nb), one reshape-argmin pass, pool = winners*ceil(n/
        bucket).  Strided, not contiguous: real corpora are insertion-order
        correlated (clusters arrive together), and contiguous buckets would
        cap a dense true-neighbor run at `winners` survivors (measured: 31%
        recall on a cluster-ordered corpus vs 97% strided).  Any bucketed
        reduction loses quantized-rank-r candidates at ~exp(-(bucket-1)r/n),
        so this mode fits corpora where true neighbors have LOW quantized
        rank (i.e. anything with structure).
      * pool_mode="approx": jax.lax.approx_max_k with k = winners*ceil(n/
        bucket) — a RANKED top-R (an exact sort-based top-k on the GPU and
        the CPU; slower than the bucket pass) that keeps deep-rank
        candidates, which isotropic (structureless) corpora need.
    """
    if pool_mode not in ("bucket", "approx"):
        raise ValueError(f"pool_mode={pool_mode!r} (bucket | approx)")
    q_n = qb.shape[0]
    n = codes_t.shape[1]
    cross = _decode_cross(qb, codes_t, cbt)                     # [Q, n]
    dist = masked_norms[None, :] - 2.0 * cross  # + ||q||^2 == const per row

    n_pad = (-n) % bucket
    nb = (n + n_pad) // bucket
    if pool_mode == "approx":
        r = min(winners * nb, n)
        neg, idx = jax.lax.approx_max_k(-dist, r, recall_target=0.95)
        return -neg, jnp.where(jnp.isfinite(-neg), idx.astype(jnp.int32), -1)
    if n_pad:
        dist = jnp.pad(dist, ((0, 0), (0, n_pad)), constant_values=jnp.inf)
    d3 = dist.reshape(q_n, bucket, nb)                          # strided sets
    col = jax.lax.broadcasted_iota(jnp.int32, (q_n, nb), 1)
    pools, pvals = [], []
    for _ in range(winners):
        val = jnp.min(d3, axis=1)
        arg = jnp.argmin(d3, axis=1).astype(jnp.int32)          # [Q, nb]
        pools.append(jnp.where(jnp.isfinite(val), arg * nb + col, -1))
        pvals.append(val)
        if winners > 1:
            row = jax.lax.broadcasted_iota(jnp.int32, d3.shape, 1)
            d3 = jnp.where(row == arg[:, None, :], jnp.inf, d3)
    return (jnp.concatenate(pvals, axis=1),
            jnp.concatenate(pools, axis=1))                     # [Q, W]
