"""Multi-device scale-out: corpus sharding over a device mesh.

The reference is explicitly single-node (SURVEY.md §2.3, §5.8 — its only
parallelism is std::async query fanout, HNSWIndex.cpp:543-571).  The
scale-out axes are:

  * **corpus sharding** — base vectors / PQ codes split across devices on
    a 1-D mesh axis; each device computes local top-k over its shard; the
    per-shard results meet in one all_gather and a tiny merge.
  * **query sharding (DP)** — queries split across devices, corpus
    replicated.
  * **sharded k-means training** — data sharded, centroids replicated;
    per-shard one-hot partial sums reduce with psum (the classic
    data-parallel training step).

Everything is expressed with `shard_map` over a `jax.sharding.Mesh` and
`jax.lax` collectives; XLA hands the collectives to NCCL on GPUs.  The mesh
is 1-D, which suits cards joined all to all (four H100s over NVLink).  On
GPUs each shard's pool scan is the one Triton kernel of ops/pool_scan;
every other per-shard program is plain XLA.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import threading

import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

Array = jax.Array

from ..utils.locks import RWLock

AXIS = "shard"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """1-D mesh over the corpus-shard axis."""
    if devices is None:
        devices = jax.devices()
        if n_devices is not None:
            devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (AXIS,))


def shard_corpus(mesh: Mesh, *arrays: Array) -> tuple[Array, ...]:
    """Place arrays with their leading axis sharded across the mesh."""
    out = []
    for a in arrays:
        spec = P(AXIS, *([None] * (a.ndim - 1)))
        out.append(jax.device_put(a, NamedSharding(mesh, spec)))
    return tuple(out)


def replicate(mesh: Mesh, *arrays: Array) -> tuple[Array, ...]:
    out = []
    for a in arrays:
        out.append(jax.device_put(a, NamedSharding(mesh, P())))
    return tuple(out)


# --------------------------------------------------------------------------
# corpus-sharded exact kNN
# --------------------------------------------------------------------------

def sharded_knn(mesh: Mesh, k: int, metric: str = "l2"):
    """Build a jitted corpus-sharded exact kNN: queries replicated, base
    sharded on the mesh axis; local top-k per shard, all_gather + merge.

    Returned fn: (q [Q,d], base [N,d], valid [N], norms [N]) -> (d, global idx).
    """

    def local_knn(q, base_s, valid_s, norms_s):
        # base_s: [N/S, d] local shard
        cross = jax.lax.dot_general(
            q, base_s, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
        )
        if metric == "cosine":
            qn = jnp.sqrt(jnp.maximum(jnp.sum(q * q, axis=1), 1e-12))
            d = 1.0 - cross / jnp.maximum(
                qn[:, None] * jnp.sqrt(jnp.maximum(norms_s, 1e-12))[None, :],
                1e-12)
        else:
            d = (jnp.sum(q * q, axis=1)[:, None] + norms_s[None, :]
                 - 2.0 * cross)
            d = jnp.maximum(d, 0.0)
        d = jnp.where(valid_s[None, :], d, jnp.inf)
        neg, idx = jax.lax.top_k(-d, k)
        # local -> global slot ids
        shard = jax.lax.axis_index(AXIS)
        idx = idx + shard * base_s.shape[0]
        # gather per-shard top-k everywhere, merge
        d_all = jax.lax.all_gather(-neg, AXIS)          # [S, Q, k]
        i_all = jax.lax.all_gather(idx, AXIS)           # [S, Q, k]
        s, qn, _ = d_all.shape
        d_flat = jnp.moveaxis(d_all, 0, 1).reshape(qn, s * k)
        i_flat = jnp.moveaxis(i_all, 0, 1).reshape(qn, s * k)
        neg2, arg = jax.lax.top_k(-d_flat, k)
        out_i = jnp.take_along_axis(i_flat, arg, 1)
        out_i = jnp.where(jnp.isfinite(-neg2), out_i, -1)
        return -neg2, out_i

    fn = jax.jit(
        jax.shard_map(
            local_knn,
            mesh=mesh,
            in_specs=(P(), P(AXIS, None), P(AXIS), P(AXIS)),
            out_specs=(P(), P()),
            check_vma=False,  # outputs are replicated by the all_gather+merge
        )
    )
    return fn


# --------------------------------------------------------------------------
# query-sharded (data-parallel) exact kNN
# --------------------------------------------------------------------------

def dp_knn(mesh: Mesh, k: int, metric: str = "l2"):
    """Queries sharded across chips, corpus replicated — the DP axis."""

    def local(q_s, base, valid, norms):
        cross = jax.lax.dot_general(
            q_s, base, (((1,), (1,)), ((), ())), preferred_element_type=jnp.float32
        )
        if metric == "cosine":
            qn = jnp.sqrt(jnp.maximum(jnp.sum(q_s * q_s, axis=1), 1e-12))
            d = 1.0 - cross / jnp.maximum(
                qn[:, None] * jnp.sqrt(jnp.maximum(norms, 1e-12))[None, :],
                1e-12)
        else:
            d = (jnp.sum(q_s * q_s, axis=1)[:, None] + norms[None, :]
                 - 2.0 * cross)
            d = jnp.maximum(d, 0.0)
        d = jnp.where(valid[None, :], d, jnp.inf)
        neg, idx = jax.lax.top_k(-d, k)
        idx = jnp.where(jnp.isfinite(-neg), idx, -1)
        return -neg, idx

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(), P(), P()),
            out_specs=(P(AXIS, None), P(AXIS, None)),
        )
    )


# --------------------------------------------------------------------------
# corpus-sharded flagship (ADC scan + exact refine)
# --------------------------------------------------------------------------

def sharded_flagship(mesh: Mesh, k: int, refine: int, metric: str = "l2"):
    """Corpus-sharded HNSW+PQ scan path: codes and raw vectors sharded;
    per-device ADC top-R (PQ decode + one matmul) + local blocked exact
    re-rank, then one all_gather + merge.

    Returned fn: (q, codebooks, codes [N,S], valid [N], base [N,d],
    ids [N], perm [d]) -> (dists [Q,k], external ids [Q,k]).
    """

    def local(q, codebooks, codes_s, valid_s, base_s, ids_s, perm):
        from ..ops import adc
        from ..ops.distance import blocked_rerank

        r = min(refine, codes_s.shape[0])
        ct = jnp.transpose(codes_s, (1, 0))
        cbt = adc.codebooks_to_cbt(codebooks)
        from ..ops.distance import normalize_rows

        q_scan = normalize_rows(q) if metric == "cosine" else q
        _, cand = adc.adc_decode_topk(q_scan, ct, cbt, valid_s, r, perm=perm)
        # blocked exact re-rank: same OOM-safety as the single-chip path
        # (a naive [Q, R, d] gather is 16 GB at R=8192, Q=1024, d=512)
        negd, loc = blocked_rerank(q, base_s, cand, min(k, r), metric,
                                   rb=min(512, r))
        negl = -negd
        ext = jnp.where(jnp.isfinite(negd), ids_s[jnp.maximum(loc, 0)], -1)
        # merge shard-local results
        d_all = jax.lax.all_gather(-negl, AXIS)
        e_all = jax.lax.all_gather(ext, AXIS)
        s, qn, kk = d_all.shape
        d_flat = jnp.moveaxis(d_all, 0, 1).reshape(qn, s * kk)
        e_flat = jnp.moveaxis(e_all, 0, 1).reshape(qn, s * kk)
        neg2, arg = jax.lax.top_k(-d_flat, k)
        out_e = jnp.take_along_axis(e_flat, arg, 1)
        out_e = jnp.where(jnp.isfinite(-neg2), out_e, -1)
        return -neg2, out_e

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(), P(AXIS, None), P(AXIS), P(AXIS, None), P(AXIS),
                      P()),
            out_specs=(P(), P()),
            check_vma=False,  # outputs are replicated by the all_gather+merge
        )
    )


def _merge_topk(local_d, local_e, k):
    """Shared winners-only merge: all_gather per-shard [Q, k'] results, one
    top-k.  Merge bandwidth is S*Q*k'*8 bytes — independent of N."""
    d_all = jax.lax.all_gather(local_d, AXIS)
    e_all = jax.lax.all_gather(local_e, AXIS)
    s, qn, kk = d_all.shape
    d_flat = jnp.moveaxis(d_all, 0, 1).reshape(qn, s * kk)
    e_flat = jnp.moveaxis(e_all, 0, 1).reshape(qn, s * kk)
    neg2, arg = jax.lax.top_k(-d_flat, k)
    out_e = jnp.take_along_axis(e_flat, arg, 1)
    return -neg2, jnp.where(jnp.isfinite(-neg2), out_e, -1)


# --------------------------------------------------------------------------
# corpus-sharded int8 programs (the compressed tier)
# --------------------------------------------------------------------------

def sharded_knn_int8(mesh: Mesh, k: int, metric: str = "l2",
                     residual: bool = False):
    """Corpus-sharded near-exact scan over int8-packed rows (the multi-chip
    analog of ops/distance.blocked_knn_int8): per chip one dequantizing
    matmul against its shard with write-time-exact norms, then the standard
    winners-only merge.  Returns GLOBAL slot ids.

    fn: (q [Q,d], packed [N,d/4] i32, scales [N], valid [N], norms [N]
         [, resid [N,d/4] i32, rscales [N]]) -> (dists [Q,k], global idx
         [Q,k]).  ``residual=True`` scans both int8 levels — the
    effectively-exact exhaustive mode (2x scan bytes).
    """

    def local(q, p_s, sc_s, valid_s, norms_s, rp_s=None, rsc_s=None):
        from ..ops.distance import blocked_knn_int8

        n_s = p_s.shape[0]
        # shard-local scan is BLOCKED (running top-k over <=262144-row
        # tiles): at the tier's design point of ~10M compressed rows per
        # chip an unblocked [Q, n_shard] f32 distance matrix would be
        # 40 GB at Q=1024
        d, idx = blocked_knn_int8(
            q, p_s, sc_s, valid_s, k, metric=metric, b_norms=norms_s,
            block_n=min(262144, n_s), recall_target=1.0,
            resid=rp_s, rscales=rsc_s,
        )
        idx = jnp.where(idx >= 0, idx + jax.lax.axis_index(AXIS) * n_s, -1)
        return _merge_topk(d, idx, k)

    specs = (P(), P(AXIS, None), P(AXIS), P(AXIS), P(AXIS))
    if residual:
        specs = specs + (P(AXIS, None), P(AXIS))
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=specs,
            out_specs=(P(), P()),
            check_vma=False,  # outputs are replicated by the all_gather+merge
        )
    )


def sharded_cond_int8(mesh: Mesh, metric: str = "l2"):
    """Per-shard conditioning vectors for the fused packed scan
    (index/hnsw_pq._build_scan8p_shadow run shard-locally): each chip
    derives (off, sel_scale, center) from ITS shard — centering is
    shard-local, which is sound because selection only ranks within a
    shard and the merge compares refined (near-exact) distances.

    fn: (packed [N,d/4] i32, scales [N], norms [N], valid [N])
        -> (off [N], sel_scale [N], center [S, d] one row per shard).
    """

    def local(p_s, sc_s, norms_s, valid_s):
        from ..index.hnsw_pq import _build_scan8p_shadow

        off, ssc, cvec = _build_scan8p_shadow(p_s, sc_s, norms_s, valid_s,
                                              metric)
        return off, ssc, cvec[None, :]

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS), P(AXIS), P(AXIS, None)),
            check_vma=False,
        )
    )


def sharded_cond_raw8(mesh: Mesh, metric: str = "l2"):
    """Per-shard int8 scan shadow for the RAW tier's fused scan
    (index/hnsw_pq._build_scan8_shadow run shard-locally): each chip keeps
    a quarter-width quantized copy of its f32 shard (+ conditioning rows).

    fn: (vectors [N,d], norms [N], valid [N])
        -> (base8 [N,d] i8, off [N], sel_scale [N], center [S, d]).
    """

    def local(v_s, norms_s, valid_s):
        from ..index.hnsw_pq import _build_scan8_shadow

        base8, off, ssc, cvec, _aux = _build_scan8_shadow(
            v_s, norms_s, valid_s, metric, 128)
        return base8, off, ssc, cvec[None, :]

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS, None), P(AXIS), P(AXIS), P(AXIS, None)),
            check_vma=False,
        )
    )


def sharded_fused_raw8(mesh: Mesh, k: int, pool: int, w: int,
                       metric: str = "l2"):
    """Raw-tier corpus-sharded s8 x s8 pool scan: per device the int8 pool
    scan (ops/pool_scan.int8_pool_scan) streams that shard's quantized
    shadow, the exact f32 refine re-scores against the raw shard, and the
    winners-only merge combines devices.  The multi-device
    analog of the raw tier's `search_mode="scan_pallas_int8"` (auto's
    >=700k-rows-per-shard choice on one chip).

    fn: (q [Q,d], base [N,d] f32, base8 [N,d] i8, off [N], sel_scale [N],
         center [S,d]) -> (dists [Q,k], global slot idx [Q,k]).
    """

    def local(q, v_s, b8_s, off_s, ssc_s, cvec_s):
        from ..ops.distance import blocked_rerank, normalize_rows
        from ..ops.pool_scan import int8_pool_scan

        qq = normalize_rows(q) if metric == "cosine" else q
        qc = qq - cvec_s[0][None, :]
        vals, idx = int8_pool_scan(qc, b8_s, off_s, ssc_s, w)
        nv, sel = jax.lax.approx_max_k(-vals, pool, recall_target=0.95)
        cand = jnp.take_along_axis(idx, sel, axis=1)
        cand = jnp.where(jnp.isfinite(nv), cand, -1)
        d, slots = blocked_rerank(q, v_s, cand, k, metric, rb=pool)
        gslots = jnp.where(
            slots >= 0, slots + jax.lax.axis_index(AXIS) * v_s.shape[0], -1)
        return _merge_topk(d, gslots, k)

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(AXIS, None), P(AXIS, None), P(AXIS), P(AXIS),
                      P(AXIS, None)),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )


def sharded_cond_raw8g(mesh: Mesh, metric: str = "l2"):
    """Per-shard GLOBAL-scale int8 shadow for the raw tier's
    integer-epilogue fused scan (index/hnsw_pq._build_scan8g_shadow run
    shard-locally): each chip calibrates ONE quantization scale over its
    own shard — shards may differ, which is fine because the cross-shard
    merge happens on exact f32 refined distances.

    fn: (vectors [N,d], norms [N], valid [N])
        -> (base8 [N,d] i8, off [N], sv [n_shards], center [S, d]).
    """

    def local(v_s, norms_s, valid_s):
        from ..index.hnsw_pq import _build_scan8g_shadow

        base8, off, sv, _sgn, cvec, _aux = _build_scan8g_shadow(
            v_s, norms_s, valid_s, metric, 128)
        return base8, off, sv[None], cvec[None, :]

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(AXIS), P(AXIS)),
            out_specs=(P(AXIS, None), P(AXIS), P(AXIS), P(AXIS, None)),
            check_vma=False,
        )
    )


def sharded_fused_raw8g(mesh: Mesh, k: int, pool: int, w: int,
                        metric: str = "l2"):
    """Integer-epilogue variant of `sharded_fused_raw8` (the multi-chip
    analog of HnswPqConfig.int8_epilogue="global"): per chip the
    global-scale pool scan (ops/pool_scan.int8g_pool_scan) ranks its
    shard in raw i32, then the exact f32 refine and the winners-only merge
    are identical to the per-row route.

    fn: (q [Q,d], base [N,d] f32, base8 [N,d] i8, off [N],
         sv [n_shards], center [S,d]) -> (dists [Q,k], global slots).
    """
    sgn = 2.0 if metric == "l2" else 1.0

    def local(q, v_s, b8_s, off_s, sv_s, cvec_s):
        from ..ops.distance import blocked_rerank, normalize_rows
        from ..ops.pool_scan import int8g_pool_scan

        qq = normalize_rows(q) if metric == "cosine" else q
        qc = qq - cvec_s[0][None, :]
        vals, idx = int8g_pool_scan(qc, b8_s, off_s, sv_s[0], sgn, w)
        nv, sel = jax.lax.approx_max_k(-vals, pool, recall_target=0.95)
        cand = jnp.take_along_axis(idx, sel, axis=1)
        cand = jnp.where(jnp.isfinite(nv), cand, -1)
        d, slots = blocked_rerank(q, v_s, cand, k, metric, rb=pool)
        gslots = jnp.where(
            slots >= 0, slots + jax.lax.axis_index(AXIS) * v_s.shape[0], -1)
        return _merge_topk(d, gslots, k)

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(AXIS, None), P(AXIS, None), P(AXIS), P(AXIS),
                      P(AXIS, None)),
            out_specs=(P(), P()),
            check_vma=False,
        )
    )


def sharded_fused_int8(mesh: Mesh, k: int, pool: int, w: int,
                       metric: str = "l2", residual: bool = False):
    """Corpus-sharded s8 x s8 pool scan over the compressed tier: per
    device the packed pool scan (ops/pool_scan.packed_pool_scan) streams
    the shard's own int8 rows, a tiny select ranks the bucket winners, the
    int8 refine re-scores with exact write-time norms, and the
    winners-only merge combines shards.
    The multi-chip analog of search_mode="scan_pallas_int8".

    fn: (q [Q,d], packed [N,d/4] i32, scales [N], norms [N], off [N],
         sel_scale [N], center [S,d][, resid [N,d/4] i32, rscales [N]]) ->
         (dists [Q,k], global slot idx [Q,k]).  ``norms`` are the store's
         EXACT write-time squared norms: the refine's only quantization
         error is the cross term.  With ``residual=True`` the trailing
         second-level rows make the refine effectively exact (~16-bit; the
         multi-chip HnswPqConfig.refine_residual analog).
    """

    def local(q, p_s, sc_s, nrm_s, off_s, ssc_s, cvec_s,
              rp_s=None, rsc_s=None):
        from ..ops.distance import blocked_rerank_int8, normalize_rows
        from ..ops.pool_scan import packed_pool_scan

        qq = normalize_rows(q) if metric == "cosine" else q
        qc = qq - cvec_s[0][None, :]
        vals, idx = packed_pool_scan(qc, p_s, off_s, ssc_s, w)
        nv, sel = jax.lax.approx_max_k(-vals, pool, recall_target=0.95)
        cand = jnp.take_along_axis(idx, sel, axis=1)
        cand = jnp.where(jnp.isfinite(nv), cand, -1)
        d, slots = blocked_rerank_int8(q, p_s, sc_s, cand, k, metric,
                                       rb=pool, b_norms=nrm_s,
                                       resid=rp_s, rscales=rsc_s)
        gslots = jnp.where(
            slots >= 0, slots + jax.lax.axis_index(AXIS) * p_s.shape[0], -1)
        return _merge_topk(d, gslots, k)

    specs = (P(), P(AXIS, None), P(AXIS), P(AXIS), P(AXIS), P(AXIS),
             P(AXIS, None))
    if residual:
        specs = specs + (P(AXIS, None), P(AXIS))
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=specs,
            out_specs=(P(), P()),
            check_vma=False,
        )
    )


def sharded_flagship_int8(mesh: Mesh, k: int, refine: int,
                          metric: str = "l2", residual: bool = False):
    """Corpus-sharded flagship for the compressed tier: per-chip ADC top-R
    over the code shard (PQ decode + one matmul), then a blocked INT8
    refine against the packed row shard — no raw f32 rows exist anywhere —
    and the winners-only merge.

    fn: (q, codebooks, codes [N,S] u8, valid [N], packed [N,d/4] i32,
         scales [N], norms [N], ids [N], perm [d]) -> (dists [Q,k],
         external ids).  ``norms`` = exact write-time squared norms for the
         int8 refine (cross-term-only quantization error).
    """

    def local(q, codebooks, codes_s, valid_s, p_s, sc_s, nrm_s, ids_s, perm,
              rp_s=None, rsc_s=None):
        from ..ops import adc
        from ..ops.distance import blocked_rerank_int8, normalize_rows

        r = min(refine, codes_s.shape[0])
        ct = jnp.transpose(codes_s, (1, 0))
        cbt = adc.codebooks_to_cbt(codebooks)
        q_scan = normalize_rows(q) if metric == "cosine" else q
        _, cand = adc.adc_decode_topk(q_scan, ct, cbt, valid_s, r, perm=perm)
        negd, loc = blocked_rerank_int8(q, p_s, sc_s, cand, min(k, r),
                                        metric, rb=min(512, r),
                                        b_norms=nrm_s,
                                        resid=rp_s, rscales=rsc_s)
        ext = jnp.where(jnp.isfinite(negd), ids_s[jnp.maximum(loc, 0)], -1)
        return _merge_topk(negd, ext, k)

    specs = (P(), P(), P(AXIS, None), P(AXIS), P(AXIS, None),
             P(AXIS), P(AXIS), P(AXIS), P())
    if residual:
        specs = specs + (P(AXIS, None), P(AXIS))
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=specs,
            out_specs=(P(), P()),
            check_vma=False,  # outputs are replicated by the all_gather+merge
        )
    )


# --------------------------------------------------------------------------
# corpus-sharded PCA-proxy search (proxy scan + exact refine)
# --------------------------------------------------------------------------

def sharded_pca_search(mesh: Mesh, k: int, select_r: int,
                       metric: str = "l2"):
    """Corpus-sharded PCA-proxy path (ops/pca): proxy rows, raw store and
    ids sharded; mean/basis replicated.  Per chip: query projection (tiny,
    replicated math) -> local proxy top-R (one matmul + approx_max_k) ->
    local blocked exact refine, then one all_gather + merge — the
    same collective shape as `sharded_flagship` (per-chip [Q, k] results,
    merge bandwidth independent of N).

    Returned fn: (q, mean [d], basis [d,p], proxy [N,p] bf16, pnorms [N],
    valid [N], base [N,d], ids [N]) -> (dists [Q,k], external ids [Q,k]).
    """

    def local(q, mean, basis, proxy_s, pnorms_s, valid_s, base_s, ids_s):
        from ..ops.distance import blocked_rerank

        cand, r = _pca_pool_local(q, mean, basis, proxy_s, pnorms_s,
                                  valid_s, select_r, metric)
        negd, loc = blocked_rerank(q, base_s, cand, min(k, r), metric,
                                   rb=min(512, r))
        ext = jnp.where(jnp.isfinite(negd), ids_s[jnp.maximum(loc, 0)], -1)
        return _merge_topk(negd, ext, k)

    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=(P(), P(), P(), P(AXIS, None), P(AXIS), P(AXIS),
                      P(AXIS, None), P(AXIS)),
            out_specs=(P(), P()),
            check_vma=False,  # outputs are replicated by the all_gather+merge
        )
    )


def _pca_pool_local(q, mean, basis, proxy_s, pnorms_s, valid_s, select_r,
                    metric):
    """Shared shard-local head of the sharded PCA programs: project the
    query, rank the shard's proxy rows, return (candidate slots [Q, r], r).
    Selection runs on bf16 proxy distances (ranking precision suffices —
    the refine re-scores)."""
    from ..ops.distance import normalize_rows

    q_scan = normalize_rows(q) if metric == "cosine" else q
    qp = ((q_scan - mean[None, :]) @ basis).astype(proxy_s.dtype)
    cross = jax.lax.dot_general(
        qp, proxy_s, (((1,), (1,)), ((), ())),
        preferred_element_type=jnp.float32,
    )
    masked = jnp.where(valid_s, pnorms_s, jnp.inf)
    dist = (masked[None, :] - 2.0 * cross).astype(jnp.bfloat16)
    r = min(select_r, proxy_s.shape[0])
    neg, sel = jax.lax.approx_max_k(-dist, r, recall_target=0.95)
    cand = jnp.where(jnp.isfinite(-neg.astype(jnp.float32)),
                     sel.astype(jnp.int32), -1)
    return cand, r


def sharded_pca_search_int8(mesh: Mesh, k: int, select_r: int,
                            metric: str = "l2", residual: bool = False):
    """`sharded_pca_search` for the COMPRESSED tier: the local refine reads
    the shard's int8-packed rows with exact write-time norms (and, with
    ``residual=True``, the second int8 level — effectively exact ordering).
    The proxy itself is derived from dequantized rows by the caller's
    shard-local projection program.

    fn: (q, mean [d], basis [d,p], proxy [N,p] bf16, pnorms [N], valid [N],
    packed [N,d/4] i32, scales [N], norms [N], ids [N][, resid, rscales])
    -> (dists [Q,k], external ids [Q,k]).
    """

    def local(q, mean, basis, proxy_s, pnorms_s, valid_s, p_s, sc_s, nrm_s,
              ids_s, rp_s=None, rsc_s=None):
        from ..ops.distance import blocked_rerank_int8

        cand, r = _pca_pool_local(q, mean, basis, proxy_s, pnorms_s,
                                  valid_s, select_r, metric)
        negd, loc = blocked_rerank_int8(q, p_s, sc_s, cand, min(k, r),
                                        metric, rb=min(512, r),
                                        b_norms=nrm_s,
                                        resid=rp_s, rscales=rsc_s)
        ext = jnp.where(jnp.isfinite(negd), ids_s[jnp.maximum(loc, 0)], -1)
        return _merge_topk(negd, ext, k)

    specs = (P(), P(), P(), P(AXIS, None), P(AXIS), P(AXIS),
             P(AXIS, None), P(AXIS), P(AXIS), P(AXIS))
    if residual:
        specs = specs + (P(AXIS, None), P(AXIS))
    return jax.jit(
        jax.shard_map(
            local,
            mesh=mesh,
            in_specs=specs,
            out_specs=(P(), P()),
            check_vma=False,  # outputs are replicated by the all_gather+merge
        )
    )


# --------------------------------------------------------------------------
# sharded k-means training step (the distributed "training step")
# --------------------------------------------------------------------------

def sharded_kmeans_step(mesh: Mesh):
    """One data-parallel Lloyd iteration: data sharded, centroids replicated;
    per-shard one-hot partial sums are psum-reduced across the mesh —
    the canonical DP training step expressed in shard_map.

    Returned fn: (data_s [N,d], centroids [K,d]) -> new centroids [K,d].
    """

    def step(data_s, centroids):
        d = (
            jnp.sum(data_s * data_s, axis=1)[:, None]
            + jnp.sum(centroids * centroids, axis=1)[None, :]
            - 2.0
            * jax.lax.dot_general(
                data_s, centroids, (((1,), (1,)), ((), ())),
                preferred_element_type=jnp.float32,
            )
        )
        assign = jnp.argmin(d, axis=1)
        onehot = jax.nn.one_hot(assign, centroids.shape[0], dtype=jnp.float32)
        counts = jax.lax.psum(jnp.sum(onehot, axis=0), AXIS)        # [K]
        sums = jax.lax.psum(
            jax.lax.dot_general(
                onehot, data_s, (((0,), (0,)), ((), ())),
                preferred_element_type=jnp.float32,
            ),
            AXIS,
        )                                                            # [K, d]
        return jnp.where(counts[:, None] > 0, sums / jnp.maximum(counts[:, None], 1), centroids)

    return jax.jit(
        jax.shard_map(
            step,
            mesh=mesh,
            in_specs=(P(AXIS, None), P()),
            out_specs=P(),
            check_vma=False,  # psum makes the output replicated
        )
    )


# --------------------------------------------------------------------------
# sharded end-to-end PQ training + encode (the distributed build pipeline)
# --------------------------------------------------------------------------

def sharded_subspace_kmeans(mesh: Mesh, num_subspaces: int, iters: int,
                            norm_rows: bool = False):
    """Full data-parallel per-subspace PQ training as ONE device program.

    Data stays sharded on the mesh axis; all subspace codebooks train
    simultaneously (the vmapped analog of the reference's per-subspace loop,
    HnswPqIndex.java:194-293): assign = argmin over a batched distance
    einsum, update = psum-reduced one-hot sums, `iters` Lloyd iterations
    under one `lax.scan`.

    Returned fn: (data_s [N,d] sharded, init_cb [S,K,sd] replicated,
    w_s [N] sharded validity weights) -> codebooks [S,K,sd] replicated.
    """

    def fit(data_s, init_cb, w_s, perm):
        n_s, d = data_s.shape
        s, kc, sd = init_cb.shape
        if norm_rows:  # cosine sphere contract (see index/hnsw_pq._pq_space)
            from ..ops.distance import normalize_rows as _nr

            data_s = _nr(data_s)
        data_s = data_s[:, perm]
        sub = data_s.reshape(n_s, s, sd).transpose(1, 0, 2)      # [S, n, sd]
        sub_n = jnp.sum(sub * sub, axis=2)                       # [S, n]

        def one_iter(cb, _):
            cb_n = jnp.sum(cb * cb, axis=2)                      # [S, K]
            cross = jnp.einsum("snd,skd->snk", sub, cb,
                               preferred_element_type=jnp.float32)
            dist = sub_n[:, :, None] + cb_n[:, None, :] - 2.0 * cross
            assign = jnp.argmin(dist, axis=2)                    # [S, n]
            onehot = jax.nn.one_hot(assign, kc, dtype=jnp.float32)
            onehot = onehot * w_s[None, :, None]                 # mask dead rows
            counts = jax.lax.psum(jnp.sum(onehot, axis=1), AXIS)  # [S, K]
            sums = jax.lax.psum(
                jnp.einsum("snk,snd->skd", onehot, sub,
                           preferred_element_type=jnp.float32),
                AXIS,
            )
            new = jnp.where(counts[:, :, None] > 0,
                            sums / jnp.maximum(counts[:, :, None], 1.0), cb)
            return new, None

        cb, _ = jax.lax.scan(one_iter, init_cb, None, length=iters)
        return cb

    return jax.jit(
        jax.shard_map(
            fit,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(), P(AXIS), P()),
            out_specs=P(),
            check_vma=False,  # psum makes the output replicated
        )
    )


def sharded_encode(mesh: Mesh, norm_rows: bool = False):
    """Shard-local PQ encode: vectors sharded, codebooks replicated ->
    codes sharded (the DP analog of the reference's 4-thread parallel
    encode, PQIndex.cpp:227-245)."""
    from ..ops import adc

    def enc(v_s, cb, perm):
        if norm_rows:  # cosine sphere contract
            from ..ops.distance import normalize_rows as _nr

            v_s = _nr(v_s)
        return adc.pq_encode(v_s[:, perm], cb)

    return jax.jit(
        jax.shard_map(
            enc,
            mesh=mesh,
            in_specs=(P(AXIS, None), P(), P()),
            out_specs=P(AXIS, None),
        )
    )


def _pack_rows_np(v: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side int8 row packing, byte-order-compatible with the device
    ops/distance.pack_int8_rows (verified by test: numpy .view(int8) of the
    int32 words reproduces the device dequantization exactly)."""
    amax = np.abs(v).max(axis=1)
    scale = (np.maximum(amax, 1e-30) / 127.0).astype(np.float32)
    q = np.clip(np.round(v / scale[:, None]), -127, 127).astype(np.int8)
    packed = q.reshape(len(v), -1, 4).view(np.int32)[..., 0]
    return packed, scale


def _pack_resid_np(v: np.ndarray, packed: np.ndarray,
                   scale: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Host-side second-level int8 pack of the quantization residual (the
    numpy analog of ops/distance.pack_int8_residual)."""
    deq = (packed.view(np.int8).reshape(len(v), -1).astype(np.float32)
           * scale[:, None])
    return _pack_rows_np(v - deq)



@functools.partial(jax.jit, donate_argnums=(0,))
def _piece_scatter(piece, idx, rows):
    """In-place row scatter into one shard's device-resident payload piece
    (host_mirror=False).  Donation reuses the piece's buffer when nothing
    else references it; a live assembled global array forces a copy (the
    caller invalidates the global first)."""
    return piece.at[idx].set(rows)


@jax.jit
def _piece_gather(piece, idx):
    """Row gather from one shard's device piece (host_mirror=False reads)."""
    return piece[idx]


def _reads(fn):
    """Concurrent-reader facade method (same RWLock shape as
    api/database.py): searches run together, mutations are exclusive.
    Lazy device-piece refreshes inside readers additionally serialize on
    self._refresh_lock so two readers never assemble mixed-generation
    shard pieces."""
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._rw.read():
            return fn(self, *a, **k)
    return wrapper


def _writes(fn):
    import functools

    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._rw.write():
            return fn(self, *a, **k)
    return wrapper


class ShardedDatabase:
    """Multi-chip corpus-sharded database: CRUD + sharded build + search.

    The corpus lives block-sharded across the mesh's devices at a fixed
    per-shard capacity.  The host keeps numpy mirrors (the single-writer
    model); mutations mark their shard dirty and only dirty shards are
    re-transferred before the next search (`jax.make_array_from_single_
    device_arrays` reassembles the global sharded array without touching
    clean shards).  Training runs the data-parallel subspace k-means above;
    encoding is shard-local.  Searches are the corpus-sharded programs
    (all_gather top-k merges).
    """

    def __init__(self, mesh: Mesh, vectors: np.ndarray | None = None,
                 ids: np.ndarray | None = None,
                 valid: np.ndarray | None = None,
                 codes: np.ndarray | None = None,
                 codebooks: np.ndarray | None = None,
                 dim: int | None = None, capacity: int | None = None,
                 num_subspaces: int = 8, metric: str = "l2",
                 perm: np.ndarray | None = None,
                 raw_store: bool = True,
                 refine_residual: bool = False,
                 host_mirror: bool = True,
                 int8_epilogue: str = "per_row"):
        """`perm`: the variance-balancing dimension permutation the imported
        `codes`/`codebooks` were trained under.  Codebooks exported from a
        default-config single-chip index (HnswPqConfig/PqConfig default
        balance_dims=True) live in PERMUTED space — importing them without
        their `index.perm` silently scores unpermuted queries against
        permuted codebooks and collapses recall, so imports of externally
        trained codebooks must state their permutation explicitly (pass
        `np.arange(dim)` for codebooks trained without one)."""
        self.mesh = mesh
        self.metric = metric
        self.n_shards = int(mesh.devices.size)
        self._devices = list(mesh.devices.flat)
        if vectors is not None:
            n, dim = vectors.shape
            capacity = capacity or n
        if dim is None:
            raise ValueError("need either vectors or dim=")
        capacity = max(capacity or 1024, self.n_shards)
        self.per_shard = -(-capacity // self.n_shards)
        # lane-rounded shards: every per-shard kernel sees 128-aligned rows
        # (and search_fused's pool width has a 128-multiple to divide into)
        self.per_shard += (-self.per_shard) % 128
        self.capacity = self.per_shard * self.n_shards
        self.dim = dim
        self.num_subspaces = num_subspaces
        # the compressed (>HBM-per-chip) tier: int8-packed rows instead of
        # raw f32 — 4x smaller per chip AND per host mirror; search() runs
        # the near-exact int8 scan, search_flagship the codes + int8-refine
        # program.  See HnswPqConfig.raw_store for the single-chip analog.
        self.raw = raw_store
        if int8_epilogue not in ("per_row", "global"):
            raise ValueError(f"int8_epilogue={int8_epilogue!r}")
        # raw tier only: "global" routes search_fused through the
        # integer-epilogue kernel (sharded_fused_raw8g; the multi-chip
        # HnswPqConfig.int8_epilogue analog).  The compressed tier's packed
        # kernel has its own conditioning and ignores this knob.
        self.int8_epilogue = int8_epilogue
        if not raw_store and dim % 4 != 0:
            raise ValueError("raw_store=False requires dim % 4 == 0")
        if refine_residual and raw_store:
            raise ValueError("refine_residual=True needs the compressed "
                             "tier (raw_store=False)")
        # second-level int8 residual refine rows (the multi-chip analog of
        # HnswPqConfig.refine_residual): ~16-bit effective refine precision
        self.residual = bool(refine_residual)
        # host mirrors (single-writer).  host_mirror=False is the >host-RAM
        # diet: the BIG row payloads (raw f32 / int8-packed / residual) live
        # ONLY as per-shard device pieces, written in place by donated
        # scatter steps — the host keeps just the O(cap) metadata columns
        # (ids, valid, scales, norms, codes).  At 80M x 512 compressed this
        # is the difference between ~45 GB and ~6 GB of host RAM (the
        # single-chip analog is bulk_load_stream; the reference's zero-copy
        # ingest seam is jni/NativeIndex.java:153-179).
        self.host_mirror = bool(host_mirror)
        self._payload_fields = (
            ("vectors",) if raw_store
            else (("packed", "resid") if refine_residual else ("packed",)))
        if raw_store:
            if host_mirror:
                self._h_vec = np.zeros((self.capacity, dim), np.float32)
            else:
                # no f32 mirror to derive norms from at refresh time
                self._h_norms = np.zeros(self.capacity, np.float32)
        else:
            if host_mirror:
                self._h_packed = np.zeros((self.capacity, dim // 4), np.int32)
            self._h_scales = np.zeros(self.capacity, np.float32)
            self._h_norms = np.zeros(self.capacity, np.float32)
            if refine_residual:
                if host_mirror:
                    self._h_resid = np.zeros((self.capacity, dim // 4),
                                             np.int32)
                self._h_rscales = np.zeros(self.capacity, np.float32)
        self._h_ids = np.full(self.capacity, -1, np.int32)
        self._h_valid = np.zeros(self.capacity, bool)
        self._h_codes = np.zeros((self.capacity, num_subspaces), np.uint8)
        self._slot_of: dict[int, int] = {}
        self._fill = np.zeros(self.n_shards, np.int64)  # per-shard next-free
        self._free: list[list[int]] = [[] for _ in range(self.n_shards)]
        self._dirty: set[int] = set(range(self.n_shards))
        self._dev_pieces: dict[str, list] = {}
        if not host_mirror:
            # device-resident payload pieces (authoritative in this mode)
            z_wide = np.zeros(
                (self.per_shard,
                 dim if raw_store else dim // 4),
                np.float32 if raw_store else np.int32)
            for name in self._payload_fields:
                self._dev_pieces[name] = [
                    jax.device_put(z_wide, d) for d in self._devices]
        self.codebooks = None
        # variance-balanced PQ dim permutation (train_pq / imported)
        self.perm = None if perm is None else jnp.asarray(perm)
        self._knn_cache: dict = {}
        # facade RWLock + refresh mutex (see _reads/_writes): host mirrors
        # are mutated in place by writers, and readers lazily re-put dirty
        # shards — both need the single-chip facade's exclusion shape
        self._rw = RWLock()
        self._refresh_lock = threading.Lock()
        if codebooks is not None:
            self.num_subspaces = int(np.asarray(codebooks).shape[0])
            self._h_codes = np.zeros(
                (self.capacity, self.num_subspaces), np.uint8
            )
            (self.codebooks,) = replicate(mesh, jnp.asarray(codebooks))
        if vectors is not None:
            n = vectors.shape[0]
            ids = (np.arange(n, dtype=np.int32) if ids is None
                   else np.asarray(ids, np.int64))
            valid = np.ones(n, bool) if valid is None else np.asarray(valid)
            live = np.flatnonzero(valid)
            self.add_batch(ids[live], np.asarray(vectors, np.float32)[live])
            if codes is not None:
                # imported codes follow the slots just assigned; rows whose
                # id was rejected by add_batch (duplicates, capacity) are
                # skipped rather than raising KeyError mid-import
                codes = np.asarray(codes)
                pairs = [(i, self._slot_of[int(ids[i])]) for i in live
                         if int(ids[i]) in self._slot_of]
                if pairs:
                    rows_ok, slots_ok = map(np.asarray, zip(*pairs))
                    self._h_codes[slots_ok] = codes[rows_ok]

    # ----------------------------------------------------------- mutation
    @_writes
    def add_batch(self, ids, vectors) -> list[int]:
        """Vectorized batch insert: shard assignment is ONE water-filling
        pass over the S per-shard loads (S iterations, not N), slot writes
        are numpy fancy indexing — a 1M-row sharded ingest is host-bound
        only by the id-map dict update (~1 s), not a per-row Python loop
        with an O(S) argmin each (the reference batches its ingest over one
        DirectByteBuffer crossing the same way, jni/NativeIndex.java:153-179).
        Least-loaded-first placement keeps shards balanced; freed slots are
        reused before the fill pointer advances."""
        vectors = np.asarray(vectors, np.float32)
        ids_np = np.asarray(list(ids), np.int64)
        # reject duplicates (within the batch and vs the live set) + negatives
        take_rows: list[int] = []
        seen = self._slot_of
        batch_seen: set[int] = set()
        for row, ext_id in enumerate(ids_np.tolist()):
            if ext_id < 0 or ext_id in seen or ext_id in batch_seen:
                continue
            batch_seen.add(ext_id)
            take_rows.append(row)
        if not take_rows:
            return []
        rows = np.asarray(take_rows)
        load = self._fill - np.asarray([len(f) for f in self._free])
        avail = (self.per_shard - load).astype(np.int64)
        n_want = len(rows)
        remaining = min(n_want, int(avail.sum()))
        # water-filling by level: binary-search the smallest level W whose
        # fill sum(clip(W - load, 0, avail)) covers the batch, take every
        # shard to W-1, then spread the remainder ONE ROW PER SHARD across
        # shards still below W.  (An earlier cumsum-based variant dumped the
        # whole batch into the first shards whenever all candidates sat at
        # one load level — [64, 36, 0, 0] instead of [25, 25, 25, 25].)
        counts = np.zeros(self.n_shards, np.int64)
        if remaining > 0:
            lo_w = int(load.min())
            hi_w = int(load.max()) + remaining + 1
            while lo_w < hi_w:
                mid = (lo_w + hi_w) // 2
                if int(np.minimum(np.maximum(mid - load, 0),
                                  avail).sum()) >= remaining:
                    hi_w = mid
                else:
                    lo_w = mid + 1
            w = lo_w
            counts = np.minimum(np.maximum(w - 1 - load, 0), avail)
            short = remaining - int(counts.sum())
            can = np.flatnonzero((counts < avail) & (load + counts < w))
            counts[can[:short]] += 1
        rows = rows[: int(counts.sum())]
        if rows.size == 0:
            return []
        # materialise slot arrays per shard: freed slots first, then the
        # contiguous fill range
        slot_parts: list[np.ndarray] = []
        for shard in np.flatnonzero(counts):
            c = int(counts[shard])
            from_free = min(c, len(self._free[shard]))
            part = []
            if from_free:
                part.append(np.asarray(
                    [self._free[shard].pop() for _ in range(from_free)],
                    np.int64))
            fresh = c - from_free
            if fresh:
                base = shard * self.per_shard + int(self._fill[shard])
                part.append(np.arange(base, base + fresh, dtype=np.int64))
                self._fill[shard] += fresh
            slot_parts.append(np.concatenate(part))
            self._dirty.add(int(shard))
        slots = (np.concatenate(slot_parts) if slot_parts
                 else np.empty(0, np.int64))
        acc_ids = ids_np[rows]
        if self.raw:
            if self.host_mirror:
                self._h_vec[slots] = vectors[rows]
            else:
                self._scatter_rows("vectors", slots, vectors[rows])
                self._h_norms[slots] = (vectors[rows] ** 2).sum(
                    1, dtype=np.float32)
        else:
            packed, scales = _pack_rows_np(vectors[rows])
            if self.host_mirror:
                self._h_packed[slots] = packed
            else:
                self._scatter_rows("packed", slots, packed)
            self._h_scales[slots] = scales
            # load() defers: it restores BOTH packed levels verbatim right
            # after the re-shard add, so packing the residual of a one-
            # level dequant here would be a wasted full-corpus pass
            if self.residual and not getattr(self, "_defer_resid_pack",
                                             False):
                rp, rs = _pack_resid_np(vectors[rows], packed, scales)
                if self.host_mirror:
                    self._h_resid[slots] = rp
                else:
                    self._scatter_rows("resid", slots, rp)
                self._h_rscales[slots] = rs
            # norms captured EXACTLY from the incoming f32 rows
            self._h_norms[slots] = (vectors[rows] ** 2).sum(
                1, dtype=np.float32)
        self._h_ids[slots] = acc_ids
        self._h_valid[slots] = True
        self._slot_of.update(
            zip(acc_ids.tolist(), slots.tolist())
        )
        if slots.size and self.codebooks is not None:
            self._encode_slots(slots)
        return acc_ids.tolist()

    def _resid_args(self) -> tuple:
        """Trailing (resid, rscales) device args for the residual-aware
        sharded programs — empty on the single-level tiers."""
        return (self.resid, self.rscales) if self.residual else ()

    def _rows_host(self, slots) -> np.ndarray:
        """Host f32 rows for the given slots — raw-mirror slices or int8
        dequantization (the compressed tier's only f32 view, ~0.4% error).
        The seam every row-value consumer (PQ/PCA training, incremental
        encode, save) goes through; with host_mirror=False the payload rows
        are fetched per shard from the device pieces."""
        slots = np.asarray(slots, np.int64)
        if not self.host_mirror:
            packed = self._gather_rows(
                "vectors" if self.raw else "packed", slots)
            if self.raw:
                return packed
            v8 = packed.view(np.int8).reshape(len(slots), self.dim)
            out = v8.astype(np.float32) * self._h_scales[slots][:, None]
            if self.residual:
                r8 = self._gather_rows("resid", slots).view(
                    np.int8).reshape(len(slots), self.dim)
                out = (out + r8.astype(np.float32)
                       * self._h_rscales[slots][:, None])
            return out
        if self.raw:
            return self._h_vec[slots]
        v8 = self._h_packed[slots].view(np.int8).reshape(len(slots), self.dim)
        out = v8.astype(np.float32) * self._h_scales[slots][:, None]
        if self.residual:
            r8 = self._h_resid[slots].view(np.int8).reshape(
                len(slots), self.dim)
            out = out + r8.astype(np.float32) * self._h_rscales[slots][:, None]
        return out

    # ------------------------------------------- device-payload primitives
    @staticmethod
    def _pow2_pad(n: int) -> int:
        return max(8, 1 << max(0, int(n - 1).bit_length()))

    def _scatter_rows(self, name: str, slots: np.ndarray,
                      rows: np.ndarray) -> None:
        """Write payload rows into the per-shard device pieces in place
        (host_mirror=False).  Slot/row counts are pow2-padded by repeating
        the first entry (duplicate scatters write identical values)."""
        # drop the assembled global first so the donated scatter can reuse
        # the piece buffer instead of copying
        if getattr(self, name, None) is not None:
            setattr(self, name, None)
        slots = np.asarray(slots, np.int64)
        shard_ids = slots // self.per_shard
        pieces = self._dev_pieces[name]
        for shard in np.unique(shard_ids):
            m = shard_ids == shard
            local = (slots[m] - shard * self.per_shard).astype(np.int32)
            vals = np.ascontiguousarray(rows[m])
            pad = self._pow2_pad(local.size) - local.size
            if pad:
                local = np.concatenate([local, np.repeat(local[:1], pad)])
                vals = np.concatenate([vals, np.repeat(vals[:1], pad, 0)])
            dev = self._devices[int(shard)]
            pieces[int(shard)] = _piece_scatter(
                pieces[int(shard)],
                jax.device_put(local, dev), jax.device_put(vals, dev))

    def _gather_rows(self, name: str, slots: np.ndarray) -> np.ndarray:
        """Fetch payload rows from the device pieces (host_mirror=False),
        preserving the caller's slot order."""
        slots = np.asarray(slots, np.int64)
        out = None
        shard_ids = slots // self.per_shard
        pieces = self._dev_pieces[name]
        for shard in np.unique(shard_ids):
            m = shard_ids == shard
            local = (slots[m] - shard * self.per_shard).astype(np.int32)
            n_real = local.size
            # pow2-pad like _scatter_rows: every distinct gather size is a
            # fresh jit trace of _piece_gather, and remote compiles are
            # slow on this stack (round-4 review; CLAUDE.md "static shapes
            # everywhere")
            pad = self._pow2_pad(n_real) - n_real
            if pad:
                local = np.concatenate([local, np.repeat(local[:1], pad)])
            got = np.asarray(_piece_gather(pieces[int(shard)],
                                           jax.device_put(
                                               local,
                                               self._devices[int(shard)])))
            if out is None:
                out = np.empty((len(slots),) + got.shape[1:], got.dtype)
            out[m] = got[:n_real]
        if out is None:
            wide = self.dim if self.raw else self.dim // 4
            dt = np.float32 if self.raw else np.int32
            out = np.empty((0, wide), dt)
        return out

    @_writes
    def remove(self, ext_id: int) -> bool:
        slot = self._slot_of.pop(int(ext_id), None)
        if slot is None:
            return False
        self._h_valid[slot] = False
        self._h_ids[slot] = -1
        self._free[slot // self.per_shard].append(slot)
        self._dirty.add(slot // self.per_shard)
        return True

    def size(self) -> int:
        return int(self._h_valid.sum())

    # ----------------------------------------------------------- build
    @_writes
    def train_pq(self, num_centroids: int = 16, iters: int = 10,
                 seed: int = 42) -> None:
        """Sharded end-to-end PQ build: train codebooks with the
        data-parallel subspace k-means, then encode every shard locally."""
        s = self.num_subspaces
        sd = self.dim // s
        live = np.flatnonzero(self._h_valid)
        if live.size < num_centroids:
            raise ValueError("not enough live vectors to train")
        rng = np.random.default_rng(seed)
        from ..ops.adc import balanced_subspace_perm

        if not self.raw:
            # compressed tier: single-device fit on a dequantized host
            # sample (the same train-on-sample contract as the single-chip
            # index) — a sharded fit would need the raw row matrix the
            # tier exists to avoid
            from ..ops.kmeans import subspace_kmeans_fit

            sample = live
            if sample.size > 65536:
                sample = np.sort(rng.choice(sample, 65536, replace=False))
            rows_s = self._rows_host(sample)
            if self.metric == "cosine":
                rows_s = rows_s / np.maximum(
                    np.linalg.norm(rows_s, axis=1, keepdims=True), 1e-12)
            perm_np = balanced_subspace_perm(rows_s.var(axis=0), s)
            self.perm = jnp.asarray(perm_np)
            cb = subspace_kmeans_fit(
                jax.random.PRNGKey(seed), jnp.asarray(rows_s[:, perm_np]),
                s, k=num_centroids, iters=iters, plus_plus=True,
            )
            (self.codebooks,) = replicate(self.mesh, cb)
            self._encode_all()
            return

        sample = live
        if not self.host_mirror and sample.size > 65536:
            # device-payload mode: variance/seed sampling fetches rows from
            # the device pieces — bound the transfer like the compressed fit
            sample = np.sort(rng.choice(sample, 65536, replace=False))
        rows = self._rows_host(sample)
        if self.metric == "cosine":
            # seeds and variance must come from the SAME (normalized) space
            # k-means trains in, or off-sphere seeds win zero points and
            # stay frozen forever (measured: 1-3 of 64 centroids alive,
            # 56% vs 93% recall)
            rows = rows / np.maximum(
                np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)
        perm_np = balanced_subspace_perm(rows.var(axis=0), s)
        self.perm = jnp.asarray(perm_np)
        pick_rows = rows[np.sort(rng.choice(len(rows), size=num_centroids,
                                            replace=False))]
        init = pick_rows[:, perm_np].reshape(num_centroids, s, sd)
        init_cb = jnp.asarray(init.transpose(1, 0, 2))          # [S, K, sd]
        self._refresh()
        fit = self._knn_cache.get(("fit", s, iters))
        if fit is None:
            fit = sharded_subspace_kmeans(self.mesh, s, iters,
                                          norm_rows=self.metric == "cosine")
            self._knn_cache[("fit", s, iters)] = fit
        w = self.valid.astype(jnp.float32)
        (perm_rep,) = replicate(self.mesh, self.perm)
        cb = fit(self.vectors, init_cb, w, perm_rep)
        (self.codebooks,) = replicate(self.mesh, cb)
        self._encode_all()

    def bulk_load_stream(self, chunks, train: bool = True,
                         num_centroids: int = 16, iters: int = 10,
                         seed: int = 42) -> int:
        """Streamed sharded ingest — the multi-chip analog of
        HnswPqIndex.bulk_load_stream: ``chunks`` yields
        ``(ids, vectors)`` pairs; each chunk is water-filled across shards
        and written straight into the per-shard device pieces, so with
        ``host_mirror=False`` peak HOST memory is O(chunk) plus the O(cap)
        metadata columns — the raw corpus never exists in full anywhere.

        The FIRST chunk trains the PQ codebooks (``train=True`` and none
        imported) and should be a representative sample of >=
        ``num_centroids`` rows; codes are then encoded chunk by chunk.
        Requires an empty database.  Returns rows ingested.
        """
        if self.size() > 0:
            raise ValueError("bulk_load_stream requires an empty database")
        total = 0
        for ids, vecs in chunks:
            vecs = np.asarray(vecs, np.float32)
            if train and total == 0 and self.codebooks is None:
                self._fit_codebooks_from_rows(vecs, num_centroids, iters,
                                              seed)
            total += len(self.add_batch(ids, vecs))
        return total

    def _fit_codebooks_from_rows(self, rows: np.ndarray, num_centroids: int,
                                 iters: int, seed: int) -> None:
        """Single-device subspace-PQ fit on explicit sample rows (the
        streamed-ingest trainer; train_pq covers the post-hoc paths)."""
        from ..ops.adc import balanced_subspace_perm
        from ..ops.kmeans import subspace_kmeans_fit

        s = self.num_subspaces
        rows = np.asarray(rows, np.float32)
        if self.metric == "cosine":
            rows = rows / np.maximum(
                np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)
        if len(rows) < num_centroids:
            raise ValueError("first chunk too small to train "
                             f"({len(rows)} < {num_centroids} centroids)")
        perm_np = balanced_subspace_perm(rows.var(axis=0), s)
        self.perm = jnp.asarray(perm_np)
        cb = subspace_kmeans_fit(
            jax.random.PRNGKey(seed), jnp.asarray(rows[:, perm_np]),
            s, k=num_centroids, iters=iters, plus_plus=True,
        )
        (self.codebooks,) = replicate(self.mesh, cb)

    def _encode_all(self) -> None:
        if not self.raw:
            # compressed tier: encode from the dequantized host mirrors in
            # chunks (no device-resident f32 matrix exists to shard-encode)
            live = np.flatnonzero(self._h_valid)
            chunk = 1 << 17
            for s in range(0, live.size, chunk):
                self._encode_slots(live[s:s + chunk])
            self._dev_pieces.pop("codes", None)
            self._put_field("codes")
            return
        enc = self._knn_cache.get("encode")
        if enc is None:
            enc = sharded_encode(self.mesh,
                                 norm_rows=self.metric == "cosine")
            self._knn_cache["encode"] = enc
        self._refresh()
        (perm_rep,) = replicate(self.mesh, self.perm)
        codes = enc(self.vectors, self.codebooks, perm_rep)
        self._h_codes = np.array(codes)  # writable host mirror
        self._dev_pieces.pop("codes", None)
        self._put_field("codes")

    def _encode_slots(self, slots: np.ndarray) -> None:
        # encode ONLY the newly accepted rows (not whole dirty shards — a
        # one-row add must not re-encode per_shard rows) with a host-cached
        # copy of the codebooks (fetched once per training generation)
        from ..ops import adc

        if getattr(self, "_cb_host_gen", None) is not self.codebooks:
            self._cb_host = jax.device_get(self.codebooks)
            self._cb_host_gen = self.codebooks
        perm_np = (np.arange(self.dim) if self.perm is None
                   else np.asarray(self.perm))
        rows = self._rows_host(slots)
        if self.metric == "cosine":  # cosine sphere contract
            rows = rows / np.maximum(
                np.linalg.norm(rows, axis=1, keepdims=True), 1e-12)
        enc = adc.pq_encode(
            jnp.asarray(rows[:, perm_np]),
            jnp.asarray(self._cb_host),
        )
        self._h_codes[slots] = np.asarray(enc)

    # ----------------------------------------------------------- transfer
    def _put_field(self, name: str) -> None:
        # host_fn computes only the requested [lo:hi] slice: refreshing one
        # dirty shard must not recompute (or even touch) the full-capacity
        # mirrors — the norms row in particular was an O(cap*dim) host pass
        # per refresh before this was sliced
        host_fn = {
            "vectors": lambda lo, hi: self._h_vec[lo:hi],
            "ids": lambda lo, hi: self._h_ids[lo:hi],
            "valid": lambda lo, hi: self._h_valid[lo:hi],
            # raw tier derives norms from the rows; compressed (and the
            # mirror-less device-payload mode) keeps an exact-norms mirror
            "norms": lambda lo, hi: (
                (self._h_vec[lo:hi] ** 2).sum(1, dtype=np.float32)
                if self.raw and self.host_mirror else self._h_norms[lo:hi]),
            "codes": lambda lo, hi: self._h_codes[lo:hi],
            "packed": lambda lo, hi: self._h_packed[lo:hi],
            "scales": lambda lo, hi: self._h_scales[lo:hi],
            "resid": lambda lo, hi: self._h_resid[lo:hi],
            "rscales": lambda lo, hi: self._h_rscales[lo:hi],
        }[name]
        shapes = {
            "vectors": (self.capacity, self.dim),
            "ids": (self.capacity,),
            "valid": (self.capacity,),
            "norms": (self.capacity,),
            "codes": (self.capacity, self._h_codes.shape[1]),
            "packed": (self.capacity, self.dim // 4),
            "scales": (self.capacity,),
            "resid": (self.capacity, self.dim // 4),
            "rscales": (self.capacity,),
        }
        shape = shapes[name]
        spec = P(AXIS, *([None] * (len(shape) - 1)))
        sharding = NamedSharding(self.mesh, spec)
        pieces = self._dev_pieces.get(name)
        if not self.host_mirror and name in self._payload_fields:
            # device-payload mode: the pieces ARE the source of truth —
            # mutations scattered into them in place; nothing to transfer
            pass
        else:
            if pieces is None:
                pieces = [None] * self.n_shards
                dirty = range(self.n_shards)
            else:
                dirty = sorted(self._dirty)
            for shard in dirty:
                lo, hi = shard * self.per_shard, (shard + 1) * self.per_shard
                pieces[shard] = jax.device_put(
                    np.ascontiguousarray(host_fn(lo, hi)),
                    self._devices[shard]
                )
            self._dev_pieces[name] = pieces
        arr = jax.make_array_from_single_device_arrays(
            shape, sharding, pieces
        )
        setattr(self, name, arr)

    def _refresh(self) -> None:
        with self._refresh_lock:
            if not self._dirty and self._dev_pieces:
                return
            fields = (("vectors",) if self.raw else ("packed", "scales"))
            if not self.raw and self.residual:
                fields = fields + ("resid", "rscales")
            for name in fields + ("ids", "valid", "norms", "codes"):
                self._put_field(name)
            self._dirty.clear()

    # auto crossover: from this many live rows per shard search() takes
    # the int8 pool scan (the same threshold as the single-device
    # hnsw_pq._auto_scan_mode; not measured on the H100; see ROADMAP A5)
    fused_threshold = 700_000

    # ----------------------------------------------------------- search
    @_reads
    def search(self, queries: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
        """Corpus-sharded search -> (external ids, dists).  Below
        ~fused_threshold live rows per shard this is the exact scan (raw
        tier) / near-exact int8 scan (compressed tier); above it, it
        routes to `search_fused` — the same measured crossover as the
        single-chip auto mode (pin by calling search_fused or the exact
        programs directly if a fixed path is required)."""
        if len(self._slot_of) >= self.fused_threshold * self.n_shards:
            # the undecorated body: search() already holds the read lock,
            # and a nested read() would deadlock against a waiting writer
            # (writer-preferring RWLock)
            return self._search_fused_impl(queries, k)
        self._refresh()
        if self.raw:
            fn = self._knn_cache.get(("exact", k))
            if fn is None:
                fn = sharded_knn(self.mesh, k, metric=self.metric)
                self._knn_cache[("exact", k)] = fn
            d, idx = fn(jnp.asarray(queries, jnp.float32), self.vectors,
                        self.valid, self.norms)
        else:
            key = ("exact8", k, self.residual)
            fn = self._knn_cache.get(key)
            if fn is None:
                fn = sharded_knn_int8(self.mesh, k, metric=self.metric,
                                      residual=self.residual)
                self._knn_cache[key] = fn
            extra = self._resid_args()
            d, idx = fn(jnp.asarray(queries, jnp.float32), self.packed,
                        self.scales, self.valid, self.norms, *extra)
        idx_np = np.asarray(idx)
        ext = np.where(idx_np >= 0, self._h_ids[np.maximum(idx_np, 0)], -1)
        return ext, np.asarray(d)

    @_reads
    def search_fused(self, queries: np.ndarray, k: int, pool: int = 64
                     ) -> tuple[np.ndarray, np.ndarray]:
        return self._search_fused_impl(queries, k, pool)

    def _search_fused_impl(self, queries: np.ndarray, k: int, pool: int = 64
                           ) -> tuple[np.ndarray, np.ndarray]:
        """Multi-device s8 x s8 pool scan (the sharded analog of
        search_mode="scan_pallas_int8", auto's >=700k-rows choice on one
        device).  Compressed tier: the packed pool scan streams each
        shard's OWN int8 rows + int8 refine (sharded_fused_int8).  Raw
        tier: each chip keeps a quantized int8 shadow of its f32 shard and
        refines exactly in f32 (sharded_fused_raw8).  Per-shard
        conditioning is cached on the assembled device arrays, so
        clean-state searches pay zero conditioning cost."""
        self._refresh()
        rows = self.vectors if self.raw else self.packed
        cond = getattr(self, "_cond_cache", None)
        if cond is None or cond[0] is not rows or cond[1] is not self.valid:
            fn = self._knn_cache.get("cond8")
            if fn is None:
                if self.raw:
                    fn = (sharded_cond_raw8g(self.mesh, metric=self.metric)
                          if self.int8_epilogue == "global" else
                          sharded_cond_raw8(self.mesh, metric=self.metric))
                else:
                    fn = sharded_cond_int8(self.mesh, metric=self.metric)
                self._knn_cache["cond8"] = fn
            built = (fn(self.vectors, self.norms, self.valid) if self.raw
                     else fn(self.packed, self.scales, self.norms,
                             self.valid))
            self._cond_cache = cond = (rows, self.valid, built)
        # largest pool width dividing the (128-rounded) per-shard rows (the
        # packed pool scan refuses widths that do not divide them)
        from ..ops.pool_scan import preserved_pool_width

        w = preserved_pool_width(self.per_shard)
        key = ("fused8", k, pool, w, self.residual, self.int8_epilogue)
        fn = self._knn_cache.get(key)
        if fn is None:
            if self.raw:
                mk = (sharded_fused_raw8g
                      if self.int8_epilogue == "global" else
                      sharded_fused_raw8)
                fn = mk(self.mesh, k, pool=min(pool, w), w=w,
                        metric=self.metric)
            else:
                fn = sharded_fused_int8(self.mesh, k, pool=min(pool, w),
                                        w=w, metric=self.metric,
                                        residual=self.residual)
            self._knn_cache[key] = fn
        qj = jnp.asarray(queries, jnp.float32)
        if self.raw:
            base8, off, ssc, cvec = cond[2]
            d, idx = fn(qj, self.vectors, base8, off, ssc, cvec)
        else:
            off, ssc, cvec = cond[2]
            extra = self._resid_args()
            d, idx = fn(qj, self.packed, self.scales, self.norms, off, ssc,
                        cvec, *extra)
        idx_np = np.asarray(idx)
        ext = np.where(idx_np >= 0, self._h_ids[np.maximum(idx_np, 0)], -1)
        return ext, np.asarray(d)

    @_writes
    def fit_pca(self, p: int = 32, seed: int = 42) -> None:
        """Fit the PCA-proxy basis on a live-row sample (ops/pca).

        The sample is drawn with a seeded rng over the live rows (not the
        first-20000 in slot order: slot order tracks insertion order, so on
        clustered corpora a prefix sample fits a biased basis — the same
        contract as HnswPqIndex.train's sampling)."""
        from ..ops import pca as pca_ops

        live = np.flatnonzero(self._h_valid)
        if live.size > 20000:
            rng = np.random.default_rng(seed)
            live = np.sort(rng.choice(live, 20000, replace=False))
        # raw mirror slices, or int8 dequantization on the compressed tier
        # (quantization noise is far below the retained-variance scale the
        # basis fits)
        sample = self._rows_host(live)
        if len(sample) < 2:
            raise ValueError("need >= 2 live vectors to fit PCA")
        if self.metric == "cosine":  # cosine sphere contract
            sample = sample / np.maximum(
                np.linalg.norm(sample, axis=1, keepdims=True), 1e-12)
        mu, basis = pca_ops.pca_fit(sample, min(p, self.dim))
        self.pca_mean = jnp.asarray(mu)
        self.pca_basis = jnp.asarray(basis)
        self._proxy_gen = None  # invalidate the derived proxy

    @_reads
    def search_pca(self, queries: np.ndarray, k: int, select_r: int = 256
                   ) -> tuple[np.ndarray, np.ndarray]:
        """Corpus-sharded PCA-proxy search -> (external ids, dists).

        The sharded proxy is derived from the sharded row store (raw f32,
        or dequantized int8 on the compressed tier) by one shard-local
        projection matmul (cheap: [N, d] x [d, p]) and cached until the
        next mutation refresh.  On the compressed tier the refine reads
        the packed rows with exact norms (+ the residual level when
        enabled) — the multi-chip analog of the single-chip compressed
        `pca` mode.
        """
        if getattr(self, "pca_basis", None) is None:
            raise ValueError("no PCA basis: call fit_pca() first")
        from ..ops import pca as pca_ops

        self._refresh()
        rows_gen = self.vectors if self.raw else self.packed
        proj = self._knn_cache.get("pca_project")
        if proj is None:
            cos = self.metric == "cosine"
            raw = self.raw
            residual = self.residual

            def _maybe_norm(v):
                if cos:  # cosine sphere contract
                    from ..ops.distance import normalize_rows as _nr

                    v = _nr(v)
                return v

            def _proj(v_s, mu, b, sc_s=None, rp_s=None, rsc_s=None):
                if raw:
                    return pca_ops.project_rows(_maybe_norm(v_s), mu, b)
                # compressed tier: BLOCK the dequant+project over row
                # chunks — a full-shard f32 dequant is [N_shard, d] (20 GB
                # at the 10M x 512 per-chip design point) and is exactly
                # the matrix this tier exists to avoid.  Ragged tail:
                # clamped re-slice (duplicate rows project identically)
                from ..ops.distance import unpack_int8_rows as _ui8

                n_s = v_s.shape[0]
                bn = min(131072, n_s)
                num = -(-n_s // bn)
                # carry must match the body output's varying-axes type
                # (the body derives from the sharded v_s)
                out = jax.lax.pcast(
                    jnp.zeros((n_s, b.shape[1]), jnp.bfloat16), (AXIS,),
                    to="varying")

                def body(i, out):
                    start = jnp.minimum(i * bn, n_s - bn)
                    blk = jax.lax.dynamic_slice_in_dim(v_s, start, bn)
                    v = _ui8(blk, jax.lax.dynamic_slice_in_dim(
                        sc_s, start, bn))
                    if rp_s is not None:
                        v = v + _ui8(
                            jax.lax.dynamic_slice_in_dim(rp_s, start, bn),
                            jax.lax.dynamic_slice_in_dim(rsc_s, start, bn))
                    pr = pca_ops.project_rows(_maybe_norm(v), mu, b)
                    return jax.lax.dynamic_update_slice(out, pr, (start, 0))

                return jax.lax.fori_loop(0, num, body, out)

            specs = [P(AXIS, None), P(), P()]
            if not raw:
                specs.append(P(AXIS))
                if residual:
                    specs += [P(AXIS, None), P(AXIS)]
            proj = jax.jit(jax.shard_map(
                _proj,
                mesh=self.mesh,
                in_specs=tuple(specs),
                out_specs=P(AXIS, None),
            ))
            self._knn_cache["pca_project"] = proj
        if getattr(self, "_proxy_gen", None) is not rows_gen:
            pargs = () if self.raw else (
                (self.scales, self.resid, self.rscales) if self.residual
                else (self.scales,))
            self._proxy = proj(rows_gen, self.pca_mean, self.pca_basis,
                               *pargs)
            pn = jax.jit(jax.shard_map(
                lambda p_s: jnp.sum(p_s.astype(jnp.float32) ** 2, axis=1),
                mesh=self.mesh, in_specs=(P(AXIS, None),),
                out_specs=P(AXIS),
            ))(self._proxy)
            self._pnorms = pn
            self._proxy_gen = rows_gen
        if self.raw:
            fn = self._knn_cache.get(("pca", k, select_r))
            if fn is None:
                fn = sharded_pca_search(self.mesh, k, select_r,
                                        metric=self.metric)
                self._knn_cache[("pca", k, select_r)] = fn
            d, ext = fn(jnp.asarray(queries, jnp.float32), self.pca_mean,
                        self.pca_basis, self._proxy, self._pnorms,
                        self.valid, self.vectors, self.ids)
        else:
            key = ("pca8", k, select_r, self.residual)
            fn = self._knn_cache.get(key)
            if fn is None:
                fn = sharded_pca_search_int8(self.mesh, k, select_r,
                                             metric=self.metric,
                                             residual=self.residual)
                self._knn_cache[key] = fn
            extra = self._resid_args()
            d, ext = fn(jnp.asarray(queries, jnp.float32), self.pca_mean,
                        self.pca_basis, self._proxy, self._pnorms,
                        self.valid, self.packed, self.scales, self.norms,
                        self.ids, *extra)
        return np.asarray(ext), np.asarray(d)

    @_reads
    def search_flagship(self, queries: np.ndarray, k: int, refine: int = 1024
                        ) -> tuple[np.ndarray, np.ndarray]:
        """Corpus-sharded ADC scan + blocked refine -> (ids, dists).  The
        refine reads raw f32 rows on the raw tier, int8-packed rows on the
        compressed tier (sharded_flagship_int8)."""
        if self.codebooks is None:
            raise ValueError("no PQ codebooks: call train_pq() first")
        self._refresh()
        perm = (self.perm if self.perm is not None
                else jnp.arange(self.dim, dtype=jnp.int32))
        (perm_rep,) = replicate(self.mesh, perm)
        if self.raw:
            fn = self._knn_cache.get(("flag", k, refine))
            if fn is None:
                fn = sharded_flagship(self.mesh, k, refine,
                                      metric=self.metric)
                self._knn_cache[("flag", k, refine)] = fn
            d, ext = fn(jnp.asarray(queries, jnp.float32), self.codebooks,
                        self.codes, self.valid, self.vectors, self.ids,
                        perm_rep)
        else:
            key = ("flag8", k, refine, self.residual)
            fn = self._knn_cache.get(key)
            if fn is None:
                fn = sharded_flagship_int8(self.mesh, k, refine,
                                           metric=self.metric,
                                           residual=self.residual)
                self._knn_cache[key] = fn
            extra = self._resid_args()
            d, ext = fn(jnp.asarray(queries, jnp.float32), self.codebooks,
                        self.codes, self.valid, self.packed, self.scales,
                        self.norms, self.ids, perm_rep, *extra)
        return np.asarray(ext), np.asarray(d)

    # ----------------------------------------------------------- persistence
    @_reads
    def save(self, path: str) -> None:
        """Checkpoint the full sharded state (reference: every tier of the
        reference surface persists, storage/VectorStorage.java:176-206 —
        the multi-chip tier must too).  With host mirrors this is one
        atomic npz write with no device transfer (the mirrors ARE the
        source of truth); with ``host_mirror=False`` the payload is fetched
        and written ONE SHARD AT A TIME (save_checkpoint_streamed) so peak
        host memory stays O(per_shard)."""
        from ..storage import checkpoint as ckpt

        meta = {
            "format_version": 1,
            "kind": "sharded",
            "dim": self.dim,
            "capacity": self.capacity,
            "num_subspaces": self.num_subspaces,
            "metric": self.metric,
            "raw_store": self.raw,
            "refine_residual": self.residual,
            "size": self.size(),
        }
        arrays = {
            "ids": self._h_ids,
            "valid": self._h_valid,
        }
        if not self.raw:
            arrays["scales8"] = self._h_scales
            arrays["norms"] = self._h_norms
            if self.residual:
                arrays["rscales8"] = self._h_rscales
        if self.codebooks is not None:
            arrays["codes"] = self._h_codes
            arrays["codebooks"] = jax.device_get(self.codebooks)
        if self.perm is not None:
            arrays["perm"] = np.asarray(self.perm)
        if getattr(self, "pca_basis", None) is not None:
            arrays["pca_mean"] = np.asarray(self.pca_mean)
            arrays["pca_basis"] = np.asarray(self.pca_basis)
        if not self.host_mirror:
            # per-shard lazy payload entries: one device fetch per shard,
            # streamed straight into the zip
            meta["payload_sharded"] = True
            meta["writer_shards"] = self.n_shards
            meta["writer_per_shard"] = self.per_shard
            if self.raw:
                arrays["norms"] = self._h_norms
            key_of = {"vectors": "vectors", "packed": "packed8",
                      "resid": "resid8"}
            lazy = [
                (f"{key_of[name]}_shard{sh:05d}",
                 functools.partial(
                     lambda n, s: np.asarray(self._dev_pieces[n][s]),
                     name, sh))
                for name in self._payload_fields
                for sh in range(self.n_shards)
            ]
            ckpt.save_checkpoint_streamed(path, meta, arrays, lazy)
            return
        if self.raw:
            arrays["vectors"] = self._h_vec
        else:
            arrays["packed8"] = self._h_packed
            if self.residual:
                arrays["resid8"] = self._h_resid
        ckpt.save_checkpoint(path, meta, arrays)

    def _restore_packed_verbatim(self, slots, packed, scales,
                                 resid=None, rscales=None) -> None:
        """Write checkpointed packed levels verbatim to the given slots
        (re-packing a dequantized two-level row would perturb the level
        split), routed by mirror mode."""
        if self.host_mirror:
            self._h_packed[slots] = packed
        else:
            self._scatter_rows("packed", slots, packed)
        self._h_scales[slots] = scales
        if resid is not None:
            if self.host_mirror:
                self._h_resid[slots] = resid
            else:
                self._scatter_rows("resid", slots, resid)
            self._h_rscales[slots] = rscales

    @classmethod
    def load(cls, mesh: Mesh, path: str,
             host_mirror: bool = True) -> "ShardedDatabase":
        """Restore a checkpoint onto ``mesh`` — which may have a DIFFERENT
        device count than the writer's: live rows are re-sharded through the
        vectorized add_batch (slot layout is a runtime detail, not state),
        imported codes ride along, quantizer state restores exactly (no
        retrain).  Checkpoints written by a ``host_mirror=False`` database
        (``payload_sharded`` format) restore ONE WRITER SHARD AT A TIME, so
        peak host memory stays O(writer per_shard) regardless of corpus
        size; ``host_mirror`` picks the restored database's own mode for
        either format."""
        from ..storage import checkpoint as ckpt

        lazy = ckpt.open_checkpoint_lazy(path)
        if lazy is None:
            raise FileNotFoundError(f"no sharded checkpoint at {path}")
        meta, arrays = lazy
        try:
            if meta.get("kind") != "sharded":
                raise ValueError(
                    f"not a sharded checkpoint: {meta.get('kind')}")
            valid = np.asarray(arrays["valid"], bool)
            ids = np.asarray(arrays["ids"], np.int64)
            raw = bool(meta.get("raw_store", True))
            live = np.flatnonzero(valid)
            residual = bool(meta.get("refine_residual", False))
            db = cls(
                mesh,
                dim=int(meta["dim"]),
                capacity=int(meta["capacity"]),
                num_subspaces=int(meta["num_subspaces"]),
                metric=meta.get("metric", "l2"),
                raw_store=raw,
                refine_residual=residual,
                host_mirror=host_mirror,
            )
            dim = int(meta["dim"])

            def _shard_ranges():
                """(lo, hi, payload-key-suffix) chunks of the checkpoint:
                one per WRITER shard in the sharded-payload format, one
                global range in the dense format."""
                if meta.get("payload_sharded"):
                    wps = int(meta["writer_per_shard"])
                    for sh in range(int(meta["writer_shards"])):
                        yield sh * wps, (sh + 1) * wps, f"_shard{sh:05d}"
                else:
                    yield 0, int(meta["capacity"]), ""

            db._defer_resid_pack = True  # verbatim levels restore below
            n_acc = 0
            try:
                for lo, hi, suf in _shard_ranges():
                    live_c = live[(live >= lo) & (live < hi)]
                    if live_c.size == 0:
                        continue
                    rel = live_c - lo if suf else live_c
                    if raw:
                        key = "vectors" + suf
                        vec = np.asarray(arrays[key], np.float32)[rel]
                    else:
                        # dequantize for the re-shard add (requantizing a
                        # dequantized row reproduces identical codes — same
                        # per-row max); exact norms and verbatim levels
                        # restore below
                        p8 = np.asarray(arrays["packed8" + suf])[rel]
                        sc = np.asarray(arrays["scales8"])[live_c]
                        vec = (p8.view(np.int8).reshape(live_c.size, dim)
                               .astype(np.float32) * sc[:, None])
                    acc = db.add_batch(ids[live_c], vec)
                    n_acc += len(acc)
                    slots_c = np.asarray(
                        [db._slot_of[int(i)] for i in ids[live_c]], np.int64)
                    if not raw:
                        # exact write-time norms (the re-shard add computed
                        # them from dequantized rows — ~0.4% off)
                        db._h_norms[slots_c] = np.asarray(
                            arrays["norms"])[live_c]
                        if residual:
                            db._restore_packed_verbatim(
                                slots_c,
                                np.asarray(arrays["packed8" + suf])[rel],
                                np.asarray(arrays["scales8"])[live_c],
                                np.asarray(arrays["resid8" + suf])[rel],
                                np.asarray(arrays["rscales8"])[live_c],
                            )
            finally:
                db._defer_resid_pack = False
            if n_acc != live.size:
                raise ValueError(
                    f"mesh capacity lost rows on load: {n_acc} of "
                    f"{live.size}"
                )
            # quantizer state AFTER the bulk add: codebooks present during
            # add_batch would trigger a full redundant re-encode of rows
            # whose codes are imported verbatim below
            if "codebooks" in arrays:
                (db.codebooks,) = replicate(
                    mesh, jnp.asarray(arrays["codebooks"]))
            if "perm" in arrays:
                db.perm = jnp.asarray(arrays["perm"])
            if not raw:
                for sh_ in range(db.n_shards):
                    db._dirty.add(sh_)
            if "codes" in arrays:
                # imported codes follow the re-assigned slots — no re-encode
                slots = np.asarray(
                    [db._slot_of[int(i)] for i in ids[live]], np.int64)
                codes = np.asarray(arrays["codes"])
                db._h_codes[slots] = codes[live]
            if "pca_basis" in arrays:
                db.pca_mean = jnp.asarray(arrays["pca_mean"])
                db.pca_basis = jnp.asarray(arrays["pca_basis"])
                db._proxy_gen = None
            return db
        finally:
            close = getattr(arrays, "close", None)
            if close is not None:
                close()
