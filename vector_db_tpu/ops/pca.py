"""PCA-proxy filtering: a truncated-PCA first stage for k-NN search.

Multi-stage re-rank design (the pattern of pHNSW / AQR-style pipelines —
PAPERS.md): scan a [p << d]-dimensional PCA projection of the corpus with
one tiny matmul, keep the ranked top-R by proxy distance, then exact-
re-rank only those R rows.  The proxy is 64 B/vector at p=32 (bf16) — the
same index-memory class as 32x PQ codes — and on decaying-spectrum corpora
its top-R containment of the true top-10 is measured at 97.0% (p=32,
R=256) / 99.05% (p=64, R=128) at 512d x 100k, so the exact refine restores
near-perfect recall.

Compared to the ADC decode scan (ops/adc.adc_fast_search), the proxy scan
needs no decode pass: scoring is ONE [Q, p] x [p, N] matmul, so the stage
cost scales with p/d (~16x fewer FLOPs at p=32, d=512) and there is no
gather.  Beyond ~6 GB of [Q, N] distances the scan switches to
a chunked pool + one final select (see pca_proxy_search), so 10M+ corpora
never materialise [Q, N].
The tradeoff is distribution-dependence: truncated PCA needs a decaying
eigenspectrum (real embeddings have one; isotropic noise does not — there
PQ and PCA both lose).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np

Array = jax.Array


def pca_fit(sample: np.ndarray, p: int) -> tuple[np.ndarray, np.ndarray]:
    """Fit a truncated-PCA basis on a host-side sample.

    sample [m, d] float32 -> (mean [d], basis [d, p]), eigenvectors of the
    sample covariance for the p largest eigenvalues.  d x d eigh on the host
    is microseconds at d<=4096; only the [d, p] basis ships to the device.
    """
    sample = np.asarray(sample, np.float64)
    mu = sample.mean(axis=0)
    cov = np.cov((sample - mu).T)
    w, v = np.linalg.eigh(cov)
    order = np.argsort(-w)[:p]
    return mu.astype(np.float32), v[:, order].astype(np.float32)


@jax.jit
def project_rows(vectors: Array, mean: Array, basis: Array) -> Array:
    """[N, d] rows -> centered projections [N, p] bf16 (the proxy store)."""
    return ((vectors - mean[None, :]) @ basis).astype(jnp.bfloat16)


@functools.partial(
    jax.jit, static_argnames=("k", "select_r", "metric", "rerank_block",
                              "block_n", "force_chunked")
)
def pca_proxy_search(
    queries: Array,
    mean: Array,
    basis: Array,
    proxy: Array,
    proxy_norms: Array,
    valid: Array,
    base: Array,
    ids: Array,
    k: int,
    select_r: int = 256,
    metric: str = "l2",
    rerank_block: int = 512,
    packed_base: Optional[Array] = None,
    block_n: int = 131072,
    force_chunked: bool = False,
    int8_base: Optional[Array] = None,
    int8_scales: Optional[Array] = None,
    int8_norms: Optional[Array] = None,
    int8_resid: Optional[Array] = None,
    int8_rscales: Optional[Array] = None,
) -> tuple[Array, Array]:
    """Proxy scan + ranked top-R + blocked exact refine, ONE device program.

    queries [Q, d] f32; proxy [N, p] bf16 (project_rows); proxy_norms [N]
    f32 (squared norms of the projections, un-masked); valid [N];
    base [N, d] raw store; ids [N] external ids.
    Returns (exact dists [Q, k], external ids [Q, k]) ascending.

    The proxy ranking is squared-L2 in PCA space.  For `metric="cosine"` the
    proxy MUST hold projections of row-normalized vectors (the index layer
    guarantees this) and the query is normalized before projection — L2 on
    the unit sphere is rank-equivalent to cosine, so the ranked pool is
    correct; with raw (varied-norm) projections it is not (measured: 55%
    vs 99% Recall@10).

    Selection strategy: one full-row selection over the [Q, N] proxy
    distances rather than a running blocked merge of per-block top-k at
    k=256 (its cost on the H100 is not measured; see ROADMAP A3).  So: one
    full-row pass while [Q, N] f32 fits comfortably (<= 6 GB), else chunked
    per-chunk approx pools + ONE final ranked select over the concatenated
    winners (the adc_fast large-N pattern; never a per-block top_k merge).
    """
    from .distance import (
        blocked_rerank, blocked_rerank_int8, blocked_rerank_packed,
    )

    # cosine contract: the proxy must hold projections of NORMALIZED rows
    # (the index layer does this); normalizing the query then makes the L2
    # proxy ranking rank-equivalent to cosine.  The exact refine uses the
    # raw queries either way (cosine distance is scale-invariant in q).
    from .distance import normalize_rows

    q_scan = normalize_rows(queries) if metric == "cosine" else queries
    qp = ((q_scan - mean[None, :]) @ basis).astype(proxy.dtype)    # [Q, p]
    q_n = queries.shape[0]
    n = proxy.shape[0]
    r = min(select_r, n)
    masked = jnp.where(valid, proxy_norms, jnp.inf)

    def chunk_pool(pt_blk, mn_blk, rk):
        cross = jax.lax.dot_general(
            qp, pt_blk, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32,
        )
        dist = mn_blk[None, :] - 2.0 * cross     # + ||q_p||^2 == const/row
        # bf16 distances into the selection: the [Q, chunk] buffer is the
        # scan's dominant memory traffic (40 GB f32 at 10M; bf16 halves
        # it), and selection only needs proxy-RANKING precision
        # — the refine below re-scores everything exactly
        dist = dist.astype(jnp.bfloat16)
        neg, sel = jax.lax.approx_max_k(-dist, min(rk, pt_blk.shape[0]),
                                        recall_target=0.95)
        return (-neg).astype(jnp.float32), jnp.where(
            jnp.isfinite(-neg.astype(jnp.float32)),
            sel.astype(jnp.int32), -1)

    if q_n * n * 4 <= 6 * 1024 ** 3 and not force_chunked:
        _, pool = chunk_pool(proxy, masked, r)
    else:
        block_n = min(block_n, n)
        num_chunks = -(-n // block_n)
        # CLAMPED ragged last chunk, not padding: jnp.pad would copy the
        # whole [N, p] proxy (1.27 GB at 10M) just to align the tail — the
        # final chunk instead re-slices [n - block_n, n) and masks the rows
        # the previous chunk already covered
        starts = jnp.minimum(
            jnp.arange(0, num_chunks * block_n, block_n, dtype=jnp.int32),
            n - block_n,
        )
        covered = jnp.concatenate(
            [jnp.full((1,), -1, jnp.int32),
             jnp.arange(1, num_chunks, dtype=jnp.int32) * block_n]
        )  # rows below this index were scanned by earlier chunks
        # per-chunk pools keep 4x the expected per-chunk share of the final
        # top-r (floor 128): selection cost grows with k, and a chunk
        # holding > 4r/C of the global top-r is vanishingly unlikely
        r_chunk = min(r, max(128, -(-4 * r // max(num_chunks, 1))))

        def one(args):
            start, cov = args
            mn_blk = jax.lax.dynamic_slice_in_dim(masked, start, block_n)
            idx = start + jnp.arange(block_n, dtype=jnp.int32)
            mn_blk = jnp.where(idx < cov, jnp.inf, mn_blk)
            pv, loc = chunk_pool(
                jax.lax.dynamic_slice_in_dim(proxy, start, block_n, axis=0),
                mn_blk,
                r_chunk,
            )
            return pv, jnp.where(loc >= 0, loc + start, -1)

        pvals, pools = jax.lax.map(one, (starts, covered))  # [C, Q, r]
        cand = jnp.moveaxis(pools, 0, 1).reshape(q_n, -1)
        cvals = jnp.moveaxis(pvals, 0, 1).reshape(q_n, -1)
        cvals = jnp.where(cand >= 0, cvals, jnp.inf)
        _, sel = jax.lax.approx_max_k(-cvals, r, recall_target=0.99)
        pool = jnp.take_along_axis(cand, sel, axis=1)
        pool = jnp.where(pool < n, pool, -1)

    if int8_base is not None:
        # int8 refine store: the only exact(-ish) stage left when raw f32
        # cannot be device-resident at all (10M x 512 = 20 GB raw; int8 =
        # 5 GB)
        out_d, slots = blocked_rerank_int8(queries, int8_base, int8_scales,
                                           pool, k, metric, rb=rerank_block,
                                           b_norms=int8_norms,
                                           resid=int8_resid,
                                           rscales=int8_rscales)
    elif packed_base is not None:
        out_d, slots = blocked_rerank_packed(queries, packed_base, pool, k,
                                             metric, rb=rerank_block)
    else:
        out_d, slots = blocked_rerank(queries, base, pool, k, metric,
                                      rb=rerank_block)
    ext = jnp.where(jnp.isfinite(out_d), ids[jnp.maximum(slots, 0)], -1)
    return out_d, ext
