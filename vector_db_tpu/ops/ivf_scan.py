"""IVF-pruned scan: the cluster-pruned large-N tier (search_mode="scan_ivf").

The exhaustive pool scans (ops/pool_scan) read the whole corpus for every
batch; this tier prunes the work instead:

  1. a coarse k-means quantizer (the index's existing `nlist` machinery,
     seed 43) partitions the corpus;
  2. a BALANCED cluster-major layout (`build_balanced_layout`) places
     every live row at one position of a dense [nlist, cap] grid —
     k-means' natural skew is spilled to each row's next-best cluster so
     every cluster is one static [cap, d] matmul tile (no ragged lists);
  3. per batch, each query picks its `nprobe` nearest clusters (one
     small matmul + select), the (query, cluster) relation is INVERTED
     into per-cluster prober tiles (`invert_probers` — sort +
     segment-rank, all static shapes), and `ivf_cluster_pool` scores
     every probed cluster against its own prober tile;
  4. per-cluster pools are gathered back per query (`ivf_pool_candidates`),
     one select ranks the union, and the caller's exact/int8 refine
     finishes.

Compute: O(probed_clusters * p_cap * cap * d) ~= Q * nprobe/nlist * N *
(p_cap/mean_probers) * d.  On the GPU this tier runs as plain XLA: a
gather of the probed clusters' int8 rows and prober tiles, one batched
int8 einsum and a per-bucket winners pass.  A dedicated Hopper kernel for
it is future work; no speed of this tier has been measured on the H100.

Reference analog: the probe-then-scan IVF loops
(native/index/IVFIndex.cpp:120-210, IVFIndex.java search path) and the
ScaNN-style partition/score/re-rank pipeline the reference's
HNSWPQ+coarse path approximates; re-designed as dense balanced tiles so
every probed cluster is one dense matmul.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from .pool_scan import IVF_PW, LANES

Array = jax.Array


# ------------------------------------------------------------ host layout


def build_balanced_layout(
    choices: np.ndarray,
    slots: np.ndarray,
    nlist: int,
    cap: int,
) -> tuple[np.ndarray, int]:
    """Place live rows into a dense balanced [nlist, cap] grid (host).

    choices [M, A] int — each row's clusters in preference order (column
    0 = nearest); slots [M] — the store slots being placed.  Greedy
    vectorized rounds: round a places every still-unplaced row at its
    a-th choice while that cluster has room (first-come by slot order,
    deterministic).  Rows that exhaust all A choices fall into arbitrary
    free positions (they are only found when their host cluster happens
    to be probed — the returned `spilled` count lets callers size A/cap
    so this stays ~0).

    Returns (pos2slot [nlist*cap] int32, -1 at padding; spilled count).
    """
    m, a_n = choices.shape
    assert slots.shape == (m,)
    pos2slot = np.full(nlist * cap, -1, np.int32)
    counts = np.zeros(nlist, np.int64)
    remaining = np.arange(m)
    for a in range(a_n):
        if remaining.size == 0:
            break
        c = choices[remaining, a].astype(np.int64)
        order = np.argsort(c, kind="stable")
        c_sorted = c[order]
        r_sorted = remaining[order]
        uniq, start = np.unique(c_sorted, return_index=True)
        # rank within this round's cluster group
        rank = np.arange(c_sorted.size) - start[
            np.searchsorted(uniq, c_sorted)]
        fill = counts[c_sorted] + rank
        ok = fill < cap
        pos2slot[c_sorted[ok] * cap + fill[ok]] = slots[r_sorted[ok]]
        np.add.at(counts, c_sorted[ok], 1)
        remaining = r_sorted[~ok]
    spilled = int(remaining.size)
    if spilled:
        free = np.nonzero(pos2slot == -1)[0]
        pos2slot[free[:spilled]] = slots[remaining]
    return pos2slot, spilled


def auto_ivf_geometry(n_live: int, nlist: int = 0,
                      winners: int = 4) -> tuple[int, int]:
    """Pick (nlist, cap) for a corpus of `n_live` rows.

    cap must be a LANES multiple with winners * cap/LANES <= IVF_PW (the
    scan emits one [p_cap, IVF_PW] pool per cluster), and carries ~30%
    slack over the mean fill so balanced placement almost never spills
    past each row's top choices.  Target mean fill ~2048 rows/cluster:
    big enough that the per-cluster [p_cap, d] x [d, cap] matmul is a
    real matrix product, small enough that nprobe resolution stays
    useful.
    """
    cap_max = (IVF_PW // max(winners, 1)) * LANES
    if nlist <= 0:
        nlist = max(8, -(-n_live // 2048))
    cap = -(-int(n_live / nlist * 1.3) // LANES) * LANES
    cap = min(max(cap, LANES), cap_max)
    while nlist * cap < n_live + nlist:  # always room (pad >= 1/cluster)
        nlist += max(1, nlist // 8)
        cap = min(max(-(-int(n_live / nlist * 1.3) // LANES) * LANES,
                      LANES), cap_max)
    return nlist, cap


@functools.partial(jax.jit, static_argnames=("nlist", "cap"))
def balanced_layout_dev(choices: Array, valid: Array, nlist: int, cap: int
                        ) -> tuple[Array, Array, Array]:
    """Device twin of `build_balanced_layout` (at 10M rows the choices
    matrix should not cross to the host): same greedy vectorized
    rounds — per round, group still-unplaced rows by their a-th choice
    (stable sort + segment rank) and fill each cluster up to `cap`;
    exhausted rows spill to arbitrary free grid positions.

    choices [M, A] i32 per-slot cluster preferences; valid [M] bool.
    Returns (pos2slot [nlist*cap] i32 with -1 padding,
    slot2pos [M] i32 with -1 for invalid slots, spilled count i32).
    """
    m, a_n = choices.shape
    grid = nlist * cap
    placed = jnp.full((m,), -1, jnp.int32)
    counts = jnp.zeros((nlist,), jnp.int32)
    iota_m = jnp.arange(m, dtype=jnp.int32)
    for a in range(a_n):
        c = choices[:, a].astype(jnp.int32)
        active = valid & (placed < 0)
        key = jnp.where(active, c, nlist)          # inactive -> sentinel
        order = jnp.argsort(key, stable=True)
        key_s = key[order]
        first = jnp.searchsorted(key_s, key_s, side="left").astype(jnp.int32)
        rank = iota_m - first
        fill = counts[jnp.minimum(key_s, nlist - 1)] + rank
        ok = (key_s < nlist) & (fill < cap)
        placed = placed.at[order].set(
            jnp.where(ok, key_s * cap + fill, placed[order]))
        counts = counts + jnp.zeros((nlist,), jnp.int32).at[
            jnp.where(ok, key_s, nlist)].add(1, mode="drop")
    # spill: i-th still-unplaced valid row -> i-th free grid position
    # (geometry guarantees grid >= live rows, so free slots exist)
    un = valid & (placed < 0)
    occ = jnp.zeros((grid,), jnp.int32).at[
        jnp.where(placed >= 0, placed, grid)].set(1, mode="drop")
    free_order = jnp.argsort(occ, stable=True)     # free positions first
    un_rank = jnp.cumsum(un.astype(jnp.int32)) - 1
    placed = jnp.where(
        un, free_order[jnp.clip(un_rank, 0, grid - 1)], placed)
    pos2slot = jnp.full((grid,), -1, jnp.int32).at[
        jnp.where(placed >= 0, placed, grid)].set(iota_m, mode="drop")
    return pos2slot, placed, jnp.sum(un.astype(jnp.int32))


@functools.partial(
    jax.jit, static_argnames=("metric", "a_n", "chunk", "approx"))
def coarse_choices(src: Array, scales: Array | None, centroids: Array,
                   metric: str, a_n: int, chunk: int,
                   approx: bool) -> Array:
    """Top-`a_n` nearest centroids per corpus row, blocked (device only —
    the [M, A] result feeds `balanced_layout_dev` without a host
    round-trip).  src is the raw [M, d] f32 store or (with `scales`) the
    int32-packed int8 store; `chunk` must divide M and keep the
    [chunk, nlist] score block small.  `approx=True` uses approx_max_k
    (on the GPU and the CPU, JAX lowers it as the exact sort-based
    top-k); an occasional missed true-nearest just places the row at its
    2nd-best cluster, which probing absorbs."""
    from .distance import normalize_rows

    m = src.shape[0]
    nlist = centroids.shape[0]
    cn = jnp.sum(centroids * centroids, axis=1)

    def body(i, out):
        blk = jax.lax.dynamic_slice_in_dim(src, i * chunk, chunk, axis=0)
        if scales is not None:
            s = jax.lax.dynamic_slice_in_dim(scales, i * chunk, chunk, 0)
            d4 = blk.shape[1] * 4
            rows = jax.lax.bitcast_convert_type(blk, jnp.int8).reshape(
                chunk, d4).astype(jnp.float32) * s[:, None]
        else:
            rows = blk
        if metric == "cosine":
            rows = normalize_rows(rows)
        cd = cn[None, :] - 2.0 * jax.lax.dot_general(
            rows, centroids, (((1,), (1,)), ((), ())),
            preferred_element_type=jnp.float32)
        if approx:
            _, top = jax.lax.approx_max_k(-cd, a_n, recall_target=0.99)
        else:
            _, top = jax.lax.top_k(-cd, a_n)
        return jax.lax.dynamic_update_slice_in_dim(
            out, top.astype(jnp.int32), i * chunk, 0)

    return jax.lax.fori_loop(
        0, m // chunk, body, jnp.zeros((m, a_n), jnp.int32))


# ------------------------------------------------------------- inversion


@functools.partial(jax.jit, static_argnames=("nlist", "p_cap"))
def invert_probers(top_c: Array, nlist: int, p_cap: int
                   ) -> tuple[Array, Array]:
    """Invert the per-query probe lists [Q, nprobe] into per-cluster
    prober tiles.

    Returns (probers [nlist*p_cap] i32 query indices, 0-filled at empty
    slots — filler queries compute garbage nobody gathers; ppos [Q,
    nprobe] i32 = each (query, probe)'s slot within its cluster's tile,
    -1 where the tile overflowed and the probe was DROPPED — the query
    simply loses that cluster; size p_cap ~4x the mean occupancy so this
    only fires on pathologically hot clusters).

    All static shapes: stable sort by cluster, segment rank via
    searchsorted-first-occurrence, two scatters.
    """
    q_n, nprobe = top_c.shape
    e = q_n * nprobe
    flat_c = top_c.reshape(-1).astype(jnp.int32)
    order = jnp.argsort(flat_c, stable=True)            # [E]
    sorted_c = flat_c[order]
    first = jnp.searchsorted(sorted_c, sorted_c, side="left")
    rank = jnp.arange(e, dtype=jnp.int32) - first.astype(jnp.int32)
    keep = rank < p_cap
    tgt = jnp.where(keep, sorted_c * p_cap + rank, nlist * p_cap)
    probers = jnp.zeros((nlist * p_cap,), jnp.int32).at[tgt].set(
        (order // nprobe).astype(jnp.int32), mode="drop")
    ppos = jnp.full((e,), -1, jnp.int32).at[order].set(
        jnp.where(keep, rank, -1))
    return probers, ppos.reshape(q_n, nprobe)


def _unique_worklist(top_c: Array, nlist: int) -> Array:
    """Padded unique probed-cluster list [U] (U static = min(nlist,
    Q*nprobe)).  Pads with cluster 0 — the scan re-writes duplicate
    clusters with identical data, which is wasteful but harmless; when
    every cluster is probed anyway (large Q) this is just arange."""
    q_n, nprobe = top_c.shape
    u_n = min(nlist, q_n * nprobe)
    if u_n == nlist:
        return jnp.arange(nlist, dtype=jnp.int32)
    s = jnp.sort(top_c.reshape(-1).astype(jnp.int32))
    first = jnp.concatenate([jnp.ones((1,), bool), s[1:] != s[:-1]])
    key = jnp.where(first, s, jnp.int32(2**31 - 1))
    u = jnp.sort(key)[:u_n]
    return jnp.where(u == 2**31 - 1, 0, u)


# ---------------------------------------------------------------- search


def _pack_i8(q8: Array) -> Array:
    """[N, d] int8 -> [N, d/4] i32 (pack_int8_rows' bit layout)."""
    n, d = q8.shape
    return jax.lax.bitcast_convert_type(q8.reshape(n, d // 4, 4), jnp.int32)


# bound on one lax.map step's [clusters, p_cap, cap] score block
_IVF_CHUNK_BYTES = 1 << 28


@functools.partial(jax.jit,
                   static_argnames=("nlist", "cap", "p_cap", "winners"))
def ivf_cluster_pool(
    cluster_ids: Array,
    qsel_packed: Array,
    cm_packed: Array,
    sel_off: Array,
    sel_scale: Array,
    nlist: int,
    cap: int,
    p_cap: int,
    winners: int = 4,
) -> tuple[Array, Array]:
    """Score every probed cluster against its prober tile and keep the
    best `winners` rows of each 128-row bucket of the cluster.

    cluster_ids [U] i32 — the probed-cluster worklist (duplicates write
    identical rows, so callers pad with cluster 0).  qsel_packed
    [nlist*p_cap, d/4] i32 — per-cluster prober query rows, int8 with
    one global scale, packed (pack_int8_rows layout).  cm_packed
    [nlist*cap, d/4] i32 — balanced cluster-major corpus rows.
    sel_off / sel_scale [nlist*cap] f32 — per-POSITION selection
    conditioning (+inf off at padding/dead positions; the global query
    scale is pre-folded into sel_scale), so the score is
    ``off + (q8 . v8) * scale``.

    Returns (vals [nlist*p_cap, IVF_PW] f32, pos [nlist*p_cap, IVF_PW]
    i32 cluster-major positions, -1 at pads).  Rows of clusters NOT in
    `cluster_ids` hold +inf / -1; callers only gather probed rows.
    """
    dw = cm_packed.shape[1]
    d = dw * 4
    bpb = cap // LANES
    used = winners * bpb
    assert cap % LANES == 0 and used <= IVF_PW, (winners, cap)
    q8 = jax.lax.bitcast_convert_type(qsel_packed, jnp.int8).reshape(
        nlist, p_cap, d)
    v8 = jax.lax.bitcast_convert_type(cm_packed, jnp.int8).reshape(
        nlist, cap, d)
    off = sel_off.reshape(nlist, cap)
    sc = sel_scale.reshape(nlist, cap)

    def one_cluster(cid):
        cross = jnp.einsum("pd,cd->pc", q8[cid], v8[cid],
                           preferred_element_type=jnp.int32)
        dist = off[cid][None, :] + cross.astype(jnp.float32) * sc[cid][None, :]
        d3 = dist.reshape(p_cap, bpb, LANES)
        lane = jax.lax.broadcasted_iota(jnp.int32, d3.shape, 2)
        base = cid * cap + jax.lax.broadcasted_iota(
            jnp.int32, (p_cap, bpb), 1) * LANES
        vals, pos = [], []
        for t in range(winners):
            a = jnp.argmin(d3, axis=2).astype(jnp.int32)        # [P, bpb]
            vals.append(jnp.min(d3, axis=2))
            pos.append(base + a)
            if t + 1 < winners:
                d3 = jnp.where(lane == a[:, :, None], jnp.inf, d3)
        pad = IVF_PW - used
        vals.append(jnp.full((p_cap, pad), jnp.inf, jnp.float32))
        pos.append(jnp.full((p_cap, pad), -1, jnp.int32))
        return jnp.concatenate(vals, axis=1), jnp.concatenate(pos, axis=1)

    batch = max(1, _IVF_CHUNK_BYTES // (p_cap * cap * 4 * 2))
    vals_u, pos_u = jax.lax.map(one_cluster, cluster_ids, batch_size=batch)
    vals = jnp.full((nlist, p_cap, IVF_PW), jnp.inf, jnp.float32)
    pos = jnp.full((nlist, p_cap, IVF_PW), -1, jnp.int32)
    vals = vals.at[cluster_ids].set(vals_u).reshape(nlist * p_cap, IVF_PW)
    pos = pos.at[cluster_ids].set(pos_u).reshape(nlist * p_cap, IVF_PW)
    return vals, pos


def ivf_pool_candidates(
    queries: Array,
    centroids: Array,
    cm_packed: Array,
    off_cm: Array,
    sc_cm: Array,
    cvec: Array,
    pos2slot: Array,
    metric: str,
    nprobe: int,
    p_cap: int,
    pool: int,
    winners: int = 4,
) -> tuple[Array, Array]:
    """The IVF-pruned candidate stage (trace-time composable; callers jit
    the composition): probe -> invert -> gather prober queries -> cluster
    scan -> per-query merge -> (selection scores, store slots).

    queries [Q, d] f32 RAW (un-centered; normalization for cosine and the
    shadow centering happen here); centroids [nlist, d] in probe space
    (unit sphere under cosine).  cm/off/sc/cvec/pos2slot: the cluster-
    major layout (index/hnsw_pq._ivf_layout).  Returns (vals [Q, pool]
    selection-grade scores, slots [Q, pool] store slots, -1 at empties).
    """
    from .distance import normalize_rows

    nlist, d = centroids.shape
    nm_cap = cm_packed.shape[0]
    cap = nm_cap // nlist
    q = normalize_rows(queries) if metric == "cosine" else queries
    # --- probe: rank-equivalent centroid distances + approx select
    cn = jnp.sum(centroids * centroids, axis=1)
    cross = jax.lax.dot_general(q, centroids, (((1,), (1,)), ((), ())),
                                preferred_element_type=jnp.float32)
    cd = cn[None, :] - 2.0 * cross
    nprobe = min(nprobe, nlist)
    if nlist > 4 * nprobe and nlist > 256:
        _, top_c = jax.lax.approx_max_k(-cd, nprobe, recall_target=0.99)
    else:
        _, top_c = jax.lax.top_k(-cd, nprobe)
    # --- invert to per-cluster prober tiles
    probers, ppos = invert_probers(top_c, nlist, p_cap)
    # --- quantize queries once (global batch scale), pack, gather tiles
    qc = q - cvec[None, :]
    sq = jnp.maximum(jnp.max(jnp.abs(qc)), 1e-12) / 127.0
    q8 = jnp.clip(jnp.round(qc / sq), -127, 127).astype(jnp.int8)
    qsel = _pack_i8(q8)[probers]                        # [nlist*p_cap, dw]
    sc2 = sc_cm * sq
    # --- cluster scan over the probed worklist
    work = _unique_worklist(top_c, nlist)
    vals, pos = ivf_cluster_pool(work, qsel, cm_packed, off_cm, sc2,
                                 nlist, cap, p_cap, winners)
    # --- per-query merge: gather each query's (cluster, prober-slot)
    # pool rows, mask dropped probes, one approx select over the union
    rows = top_c * p_cap + ppos                          # [Q, nprobe]
    vals_g = vals[jnp.maximum(rows, 0)]                  # [Q, nprobe, PW]
    pos_g = pos[jnp.maximum(rows, 0)]
    live = ppos[:, :, None] >= 0
    vals_g = jnp.where(live, vals_g, jnp.inf).reshape(q.shape[0], -1)
    pos_g = jnp.where(live, pos_g, -1).reshape(q.shape[0], -1)
    pool = min(pool, vals_g.shape[1])
    neg, sel = jax.lax.approx_max_k(-vals_g, pool, recall_target=0.95)
    cand_pos = jnp.take_along_axis(pos_g, sel, axis=1)
    ok = jnp.isfinite(-neg) & (cand_pos >= 0)
    slots = jnp.where(ok, pos2slot[jnp.maximum(cand_pos, 0)], -1)
    return -neg, slots
