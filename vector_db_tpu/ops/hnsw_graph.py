"""HNSW graph engine — padded adjacency arrays + batched on-device traversal.

Array-program redesign of the reference's HNSW (reference:
index/HnswIndex.java — per-level Map adjacency :31, insert :178-236, beam
`searchLayer` :557-644, greedy `searchLayerClosest` :511-552, geometric level
assignment :678-690; native/index/HNSWIndex.cpp — searchLevel :171-308,
heuristic neighbor selection :322-469, connect+prune :471-515).

Array-program replacements (SURVEY.md §7.0):
  Map<Integer,List<Integer>> adjacency  ->  neighbors[L, cap, M] int32, -1 pad
  HashSet visited                       ->  [Q, cap] bool visited mask
  PriorityQueue beam                    ->  fixed-size sorted pool + expanded flags
  per-edge scalar distances             ->  gathered [Q, E*M, d] batched distance

Design notes:
  * The multi-level greedy descent is FUSED into one while_loop with a
    per-query level counter — one small compiled program instead of L
    unrolled loops.
  * Neighbor selection uses the diversity heuristic (keep c only if it is
    closer to the target than to any already-kept neighbor, then backfill
    with closest rejected), matching native HNSWIndex.cpp:322-469.  Simple
    nearest-M (the Java path) is a config switch.  The heuristic is what
    keeps the graph navigable: with nearest-M, low-in-degree nodes become
    unreachable (observed: 64/300 nodes orphaned at M=8).
  * Insertion runs in batched rounds against a frozen snapshot
    (SURVEY.md §7.3.1); batch-internal candidates are merged so batch
    members can link to each other; the connect phase is a sequential
    fori_loop inside the same jit.

Everything is jitted at the top level (search / insert); distance closures
are constructed inside the jitted functions.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass

Array = jax.Array


@pytree_dataclass
class HnswGraph:
    """Device-resident layered graph."""

    neighbors: Array    # [L, cap, M] int32 slot ids, -1 padded
    levels: Array       # [cap] int32 node top level, -1 for absent
    entry: Array        # () int32 entry point slot (-1 if empty)
    entry_level: Array  # () int32

    @property
    def max_level(self) -> int:
        return self.neighbors.shape[0]

    @property
    def capacity(self) -> int:
        return self.neighbors.shape[1]

    @property
    def m(self) -> int:
        return self.neighbors.shape[2]


def init_graph(capacity: int, m: int, max_level: int) -> HnswGraph:
    return HnswGraph(
        neighbors=jnp.full((max_level, capacity, m), -1, jnp.int32),
        levels=jnp.full((capacity,), -1, jnp.int32),
        entry=jnp.asarray(-1, jnp.int32),
        entry_level=jnp.asarray(-1, jnp.int32),
    )


def sample_levels(key: Array, n: int, m: int, max_level: int) -> Array:
    """Geometric level assignment, mL = 1/ln(M)
    (reference: HnswIndex.java:678-690 p=1/e; HNSWIndex.cpp:517-522 -ln(r)*mL)."""
    u = jax.random.uniform(key, (n,), minval=1e-12, maxval=1.0)
    ml = 1.0 / jnp.log(jnp.asarray(float(max(m, 2)), jnp.float32))
    lv = jnp.floor(-jnp.log(u) * ml).astype(jnp.int32)
    return jnp.clip(lv, 0, max_level - 1)


# --------------------------------------------------------------------------
# distance closures (built inside jitted callers)
# --------------------------------------------------------------------------

def _exact_dist(base: Array, norms: Array, q: Array, q_norms: Array):
    """dist(slots [Q, S]) -> [Q, S] exact squared L2; -1 slots -> +inf."""

    def dist(slots: Array) -> Array:
        safe = jnp.maximum(slots, 0)
        vecs = base[safe]                      # [Q, S, d]
        dots = jnp.einsum("qd,qsd->qs", q, vecs, preferred_element_type=jnp.float32)
        d = q_norms[:, None] + norms[safe] - 2.0 * dots
        return jnp.where(slots >= 0, jnp.maximum(d, 0.0), jnp.inf)

    return dist


def _adc_dist(codes: Array, tables: Array):
    """dist(slots [Q, S]) -> [Q, S] ADC distance from per-query tables
    (reference: HnswPqIndex.computePQDistance :371-386, batched)."""

    def dist(slots: Array) -> Array:
        safe = jnp.maximum(slots, 0)
        c = codes[safe].astype(jnp.int32)           # [Q, S, M_sub]
        c = jnp.swapaxes(c, 1, 2)                   # [Q, M_sub, S]
        g = jnp.take_along_axis(tables, c, axis=2)  # [Q, M_sub, S]
        d = jnp.sum(g, axis=1)                      # [Q, S]
        return jnp.where(slots >= 0, d, jnp.inf)

    return dist


# --------------------------------------------------------------------------
# fused multi-level greedy descent
# --------------------------------------------------------------------------

def _greedy_descent(neighbors, dist, entry, entry_d, start_level, stop_level):
    """Walk greedily from ``start_level`` down to ``stop_level`` (inclusive),
    per query, in ONE while_loop (reference: HnswIndex.searchLayerClosest
    :511-552 called per level — here the level counter lives in the loop).

    neighbors: [L, cap, M]; entry/entry_d: [Q]; start/stop_level: [Q] int32.
    Returns (cur [Q], cur_d [Q]) — the closest node found at stop_level.
    """
    q_n = entry.shape[0]

    def cond(state):
        cur, cur_d, lev = state
        return jnp.any(lev >= stop_level)

    def body(state):
        cur, cur_d, lev = state
        active = lev >= stop_level
        lev_c = jnp.clip(lev, 0, neighbors.shape[0] - 1)
        nbrs = neighbors[lev_c, jnp.maximum(cur, 0)]   # [Q, M] per-query level
        nbrs = jnp.where((cur >= 0)[:, None], nbrs, -1)
        d = dist(nbrs)
        best = jnp.argmin(d, axis=1)
        best_d = jnp.take_along_axis(d, best[:, None], 1)[:, 0]
        best_i = jnp.take_along_axis(nbrs, best[:, None], 1)[:, 0]
        better = active & (best_d < cur_d)
        cur = jnp.where(better, best_i, cur)
        cur_d = jnp.where(better, best_d, cur_d)
        # stuck at this level -> drop a level
        lev = jnp.where(better, lev, lev - 1)
        return cur, cur_d, lev

    cur, cur_d, _ = jax.lax.while_loop(cond, body, (entry, entry_d, start_level))
    return cur, cur_d


# --------------------------------------------------------------------------
# beam search on one level (level index may be traced)
# --------------------------------------------------------------------------

def _beam_level(neighbors, lev, dist, entry, entry_d, enabled, ef, max_iters, expand):
    """Best-first beam with visited masks (reference: HnswIndex.searchLayer
    :557-644).  ``lev`` may be a traced level index into neighbors [L,cap,M].
    ``enabled`` [Q] masks out queries that skip this level entirely.
    Returns (pool_d [Q, ef], pool_i [Q, ef]) ascending, -1 pad.
    """
    q_n = entry.shape[0]
    cap, m = neighbors.shape[1], neighbors.shape[2]
    e = expand

    pool_d = jnp.full((q_n, ef), jnp.inf).at[:, 0].set(entry_d)
    pool_i = jnp.full((q_n, ef), -1, jnp.int32).at[:, 0].set(entry)
    pool_x = jnp.zeros((q_n, ef), bool)
    visited = jnp.zeros((q_n, cap), bool)
    visited = visited.at[jnp.arange(q_n), jnp.maximum(entry, 0)].set(True)
    rows = jnp.arange(q_n)[:, None]

    def cond(state):
        _, _, _, _, alive, it = state
        return jnp.logical_and(jnp.any(alive), it < max_iters)

    def body(state):
        pool_d, pool_i, pool_x, visited, alive, it = state
        sel_d = jnp.where(pool_x | (pool_i < 0), jnp.inf, pool_d)
        neg, sel = jax.lax.top_k(-sel_d, e)               # [Q, E]
        sel_nodes = jnp.take_along_axis(pool_i, sel, 1)
        sel_ok = jnp.isfinite(-neg)

        worst = pool_d[:, -1]
        closest_unexp = -neg[:, 0]
        q_alive = alive & jnp.isfinite(closest_unexp) & (closest_unexp <= worst)

        pool_x = pool_x.at[rows, sel].set(
            pool_x[rows, sel] | (sel_ok & q_alive[:, None])
        )

        nbrs = neighbors[lev, jnp.maximum(sel_nodes, 0)]  # [Q, E, M]
        nbrs = jnp.where((sel_nodes >= 0)[:, :, None], nbrs, -1).reshape(q_n, e * m)
        safe = jnp.maximum(nbrs, 0)
        # dedup within the gathered frontier: two expanded candidates may
        # share a neighbor; both copies would pass the visited check and
        # pollute the pool with duplicates
        em = e * m
        first_occ = ~jnp.any(
            (nbrs[:, :, None] == nbrs[:, None, :])
            & (jnp.arange(em)[None, :] < jnp.arange(em)[:, None])[None],
            axis=2,
        )
        fresh = (nbrs >= 0) & first_occ & ~visited[rows, safe] & q_alive[:, None]
        # scatter-max (== OR): duplicate indices in one scatter must not let a
        # later False write erase an earlier True
        visited = visited.at[rows, safe].max(fresh)
        d = dist(jnp.where(fresh, nbrs, -1))

        cat_d = jnp.concatenate([pool_d, d], axis=1)
        cat_i = jnp.concatenate([pool_i, jnp.where(fresh, nbrs, -1)], axis=1)
        cat_x = jnp.concatenate([pool_x, jnp.zeros_like(fresh)], axis=1)
        neg2, arg = jax.lax.top_k(-cat_d, ef)
        return (
            -neg2,
            jnp.take_along_axis(cat_i, arg, 1),
            jnp.take_along_axis(cat_x, arg, 1),
            visited,
            q_alive,
            it + 1,
        )

    pool_d, pool_i, _, _, _, _ = jax.lax.while_loop(
        cond, body, (pool_d, pool_i, pool_x, visited, enabled, 0)
    )
    pool_i = jnp.where(jnp.isfinite(pool_d), pool_i, -1)
    return pool_d, pool_i


# --------------------------------------------------------------------------
# neighbor selection
# --------------------------------------------------------------------------

def _select_heuristic(cand_d, cand_i, pair_d, m):
    """Diversity-heuristic neighbor selection, batched over B targets
    (reference: native HNSWIndex.cpp:322-469 — keep a candidate only if it
    is closer to the target than to every already-kept neighbor; backfill
    remaining slots with the closest rejected candidates).

    cand_d: [B, C] distances target->candidate (inf for invalid)
    cand_i: [B, C] candidate slots (-1 invalid)
    pair_d: [B, C, C] candidate-candidate distances
    Returns (sel_d [B, m], sel_i [B, m]).
    """
    b, c = cand_d.shape
    order = jnp.argsort(cand_d, axis=1)                     # ascending
    s_d = jnp.take_along_axis(cand_d, order, 1)
    s_i = jnp.take_along_axis(cand_i, order, 1)
    p = jnp.take_along_axis(
        jnp.take_along_axis(pair_d, order[:, :, None], 1), order[:, None, :], 2
    )                                                        # sorted pairwise

    def body(i, keep):
        # conflict: candidate i is closer to some kept neighbor than to target
        conflict = jnp.any(keep & (p[:, i, :] < s_d[:, i, None]), axis=1)
        room = jnp.sum(keep, axis=1) < m
        ok = jnp.isfinite(s_d[:, i]) & (s_i[:, i] >= 0) & ~conflict & room
        return keep.at[:, i].set(ok)

    keep = jax.lax.fori_loop(0, c, body, jnp.zeros((b, c), bool))

    # kept first (by distance), then closest rejected as backfill
    rank = jnp.broadcast_to(jnp.arange(c)[None, :], (b, c))
    key = jnp.where(keep, rank, rank + c)
    key = jnp.where((s_i >= 0) & jnp.isfinite(s_d), key, 2 * c)
    sel = jnp.argsort(key, axis=1)[:, :m]
    sel_i = jnp.take_along_axis(s_i, sel, 1)
    sel_d = jnp.take_along_axis(s_d, sel, 1)
    good = jnp.take_along_axis(key, sel, 1) < 2 * c
    return jnp.where(good, sel_d, jnp.inf), jnp.where(good, sel_i, -1)


def _pairwise_among(base, norms, slots):
    """Pairwise squared-L2 among gathered slots. slots [B, C] -> [B, C, C]."""
    safe = jnp.maximum(slots, 0)
    v = base[safe]                                    # [B, C, d]
    n = norms[safe]                                   # [B, C]
    dots = jnp.einsum("bcd,bed->bce", v, v, preferred_element_type=jnp.float32)
    d = n[:, :, None] + n[:, None, :] - 2.0 * dots
    return jnp.maximum(d, 0.0)


# --------------------------------------------------------------------------
# full multi-level search (exact distances — plain HNSW)
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("k", "ef", "expand", "max_iters"))
def hnsw_search(
    graph: HnswGraph,
    base: Array,
    norms: Array,
    valid: Array,
    queries: Array,
    k: int,
    ef: int,
    expand: int = 4,
    max_iters: int = 0,
) -> tuple[Array, Array]:
    """Layered search: fused greedy descent to level 1, ef-beam on level 0,
    top-k.  (reference: HnswIndex.searchNearest :347-380.)  Deleted slots stay
    traversable (tombstones) but are filtered from results."""
    q_n = queries.shape[0]
    q_norms = jnp.sum(queries * queries, axis=1)
    dist = _exact_dist(base, norms, queries, q_norms)
    it = max_iters if max_iters > 0 else ef

    entry = jnp.broadcast_to(graph.entry, (q_n,))
    entry_d = dist(entry[:, None])[:, 0]
    start = jnp.broadcast_to(graph.entry_level, (q_n,))
    stop = jnp.ones((q_n,), jnp.int32)
    cur, cur_d = _greedy_descent(graph.neighbors, dist, entry, entry_d, start, stop)

    pool_d, pool_i = _beam_level(
        graph.neighbors, jnp.asarray(0), dist, cur, cur_d,
        jnp.ones((q_n,), bool), ef, it, expand,
    )
    ok = (pool_i >= 0) & valid[jnp.maximum(pool_i, 0)]
    pool_d = jnp.where(ok, pool_d, jnp.inf)
    neg, arg = jax.lax.top_k(-pool_d, k)
    out_i = jnp.take_along_axis(pool_i, arg, 1)
    out_i = jnp.where(jnp.isfinite(-neg), out_i, -1)
    return -neg, out_i


@functools.partial(jax.jit, static_argnames=("k", "ef", "expand", "max_iters"))
def hnsw_search_pending(
    graph: HnswGraph,
    base: Array,
    norms: Array,
    valid: Array,
    queries: Array,
    pending: Array,   # [P] slot ids not yet connected to the graph, -1 pad
    k: int,
    ef: int,
    expand: int = 4,
    max_iters: int = 0,
) -> tuple[Array, Array]:
    """hnsw_search + exact overlay over deferred (pending) slots.

    The defer insert policy (HnswConfig.insert_policy) buffers incremental
    adds outside the graph; this search merges the graph beam's pool with
    an exact scan over the pending rows so results never lag the store.
    Pending slots are disjoint from graph nodes, so the merge cannot
    duplicate ids."""
    d_g, i_g = hnsw_search(graph, base, norms, valid, queries, k=k, ef=ef,
                           expand=expand, max_iters=max_iters)
    safe = jnp.maximum(pending, 0)
    pv = base[safe]                                          # [P, d]
    pn = norms[safe]
    q_norms = jnp.sum(queries * queries, axis=1)
    d_p = (
        q_norms[:, None] + pn[None, :]
        - 2.0 * jax.lax.dot_general(queries, pv, (((1,), (1,)), ((), ())),
                                    preferred_element_type=jnp.float32)
    )
    ok = (pending >= 0) & valid[safe]
    d_p = jnp.where(ok[None, :], jnp.maximum(d_p, 0.0), jnp.inf)
    kp = min(k, d_p.shape[1])
    if d_p.shape[1] > 128:
        # the overlay pool tolerates an approximate reduction (the graph
        # pool still carries exact candidates); on the GPU and the CPU
        # approx_max_k lowers as an exact top-k
        negp, argp = jax.lax.approx_max_k(-d_p, kp, recall_target=0.99)
    else:
        negp, argp = jax.lax.top_k(-d_p, kp)
    i_p = jnp.where(jnp.isfinite(-negp), pending[argp], -1)
    cat_d = jnp.concatenate([d_g, -negp], axis=1)
    cat_i = jnp.concatenate([i_g, i_p], axis=1)
    neg, arg = jax.lax.top_k(-cat_d, k)
    out_i = jnp.take_along_axis(cat_i, arg, 1)
    return -neg, jnp.where(jnp.isfinite(-neg), out_i, -1)


# --------------------------------------------------------------------------
# batched insertion
# --------------------------------------------------------------------------

@functools.partial(jax.jit, static_argnames=("efc", "expand", "heuristic"))
def insert_batch(
    graph: HnswGraph,
    base: Array,
    norms: Array,
    new_slots: Array,   # [B] slot ids to insert (already written to the store)
    new_levels: Array,  # [B] sampled levels
    efc: int,
    expand: int = 4,
    heuristic: bool = True,
) -> HnswGraph:
    """Insert B nodes against a frozen snapshot, then connect sequentially.

    Graph must be non-empty (the host seeds the first node).  Reference
    analog: index/HnswIndex.java:178-236 / HNSWPQIndex.cpp:304-460 (4-phase
    add) with exact distances for graph quality ("Fix #4",
    HnswPqIndex.java:491-499).
    """
    b = new_slots.shape[0]
    L, cap, m = graph.neighbors.shape
    q = base[new_slots]
    q_norms = jnp.sum(q * q, axis=1)
    dist = _exact_dist(base, norms, q, q_norms)

    # batch-mate distances; exclude self AND duplicate slots (rounds are
    # padded by repeating the last slot)
    mate_d = jnp.maximum(
        q_norms[:, None] + q_norms[None, :]
        - 2.0 * jax.lax.dot_general(q, q, (((1,), (1,)), ((), ())),
                                    preferred_element_type=jnp.float32),
        0.0,
    )
    distinct = new_slots[None, :] != new_slots[:, None]

    levels = graph.levels.at[new_slots].set(new_levels)

    # ---- phase A: greedy descent through non-edge levels -------------------
    entry = jnp.broadcast_to(graph.entry, (b,))
    entry_d = dist(entry[:, None])[:, 0]
    start = jnp.broadcast_to(graph.entry_level, (b,))
    stop = jnp.minimum(new_levels, jnp.broadcast_to(graph.entry_level, (b,))) + 1
    cur, cur_d = _greedy_descent(graph.neighbors, dist, entry, entry_d, start, stop)

    # ---- phase B: per-level beam + neighbor selection (top -> 0) ----------
    c_sel = min(max(3 * m, m + 1), efc + b)  # heuristic candidate pool width

    def level_step(li, carry):
        cur, cur_d, selected = carry
        lev = L - 1 - li
        in_graph = lev <= graph.entry_level
        do_beam = in_graph & (new_levels >= lev)
        pool_d, pool_i = _beam_level(
            graph.neighbors, lev, dist, cur, cur_d, do_beam, efc, efc, expand
        )
        mate_ok = (new_levels[None, :] >= lev) & distinct
        md = jnp.where(mate_ok, mate_d, jnp.inf)
        cand_d = jnp.concatenate([pool_d, md], axis=1)
        cand_i = jnp.concatenate(
            [pool_i, jnp.broadcast_to(new_slots[None, :], (b, b))], axis=1
        )
        cand_d = jnp.where(cand_i >= 0, cand_d, jnp.inf)
        # a node must never select itself (it IS in the frozen graph when it
        # doubles as the seed, and padded rounds repeat slots)
        cand_d = jnp.where(cand_i == new_slots[:, None], jnp.inf, cand_d)
        # pre-trim to the heuristic pool width
        negc, argc = jax.lax.top_k(-cand_d, c_sel)
        c_d = -negc
        c_i = jnp.take_along_axis(cand_i, argc, 1)
        c_i = jnp.where(jnp.isfinite(c_d), c_i, -1)
        if heuristic:
            pair = _pairwise_among(base, norms, c_i)
            sel_d, sel_i = _select_heuristic(c_d, c_i, pair, m)
        else:
            sel_d, sel_i = c_d[:, :m], c_i[:, :m]
        take = do_beam[:, None]
        selected = selected.at[:, lev, :].set(
            jnp.where(take, sel_i, selected[:, lev, :])
        )
        cur = jnp.where(do_beam, pool_i[:, 0], cur)
        cur_d = jnp.where(do_beam, pool_d[:, 0], cur_d)
        return cur, cur_d, selected

    selected0 = jnp.full((b, L, m), -1, jnp.int32)
    _, _, selected = jax.lax.fori_loop(0, L, level_step, (cur, cur_d, selected0))

    # ---- phase C: connect (sequential over the batch) ---------------------
    def connect_one(i, nbrs_arr):
        slot_i = new_slots[i]
        my_norm = norms[slot_i]
        my_vec = base[slot_i]

        def level_body(lev, nbrs_arr):
            lev_on = new_levels[i] >= lev
            sel = jnp.where(lev_on, selected[i, lev], -1)
            # forward edges
            nbrs_arr = nbrs_arr.at[lev, slot_i].set(
                jnp.where(lev_on, sel, nbrs_arr[lev, slot_i])
            )
            # reverse edges with prune (reference: connectNeighbors +
            # pruneNeighbors, HNSWIndex.cpp:471-515)
            tgt = sel                                       # [M]
            safe_t = jnp.maximum(tgt, 0)
            cur_lists = nbrs_arr[lev, safe_t]               # [M, M]
            dup = cur_lists == slot_i
            cand = jnp.concatenate(
                [jnp.where(dup, -1, cur_lists),
                 jnp.full((m, 1), slot_i, jnp.int32)], axis=1
            )                                               # [M, M+1]
            c_safe = jnp.maximum(cand, 0)
            t_vecs = base[safe_t]
            c_vecs = base[c_safe]
            dd = (
                norms[safe_t][:, None]
                + norms[c_safe]
                - 2.0 * jnp.einsum("md,mcd->mc", t_vecs, c_vecs,
                                   preferred_element_type=jnp.float32)
            )
            dd = jnp.where(cand >= 0, jnp.maximum(dd, 0.0), jnp.inf)
            if heuristic:
                pair = _pairwise_among(base, norms, cand)
                _, new_lists = _select_heuristic(dd, cand, pair, m)
            else:
                negk, argk = jax.lax.top_k(-dd, m)
                new_lists = jnp.take_along_axis(cand, argk, 1)
                new_lists = jnp.where(jnp.isfinite(-negk), new_lists, -1)
            write = lev_on & (tgt >= 0)
            nbrs_arr = nbrs_arr.at[lev, safe_t].set(
                jnp.where(write[:, None], new_lists, cur_lists)
            )
            return nbrs_arr

        return jax.lax.fori_loop(0, L, level_body, nbrs_arr)

    neighbors = jax.lax.fori_loop(0, b, connect_one, graph.neighbors)

    # entry-point promotion
    batch_best = jnp.argmax(new_levels)
    promote = new_levels[batch_best] > graph.entry_level
    entry_new = jnp.where(promote, new_slots[batch_best], graph.entry)
    entry_level_new = jnp.maximum(graph.entry_level, new_levels[batch_best])

    return graph.replace(
        neighbors=neighbors,
        levels=levels,
        entry=entry_new.astype(jnp.int32),
        entry_level=entry_level_new.astype(jnp.int32),
    )


@functools.partial(jax.jit, static_argnames=("efc", "expand", "heuristic"))
def insert_rounds(
    graph: HnswGraph,
    base: Array,
    norms: Array,
    slots: Array,    # [R, B] — R rounds of B slots each
    levels: Array,   # [R, B]
    efc: int,
    expand: int = 4,
    heuristic: bool = True,
) -> HnswGraph:
    """Run R insert_batch rounds inside ONE device program (lax.scan).

    Host-side round loops pay one dispatch per round; a 100k build at B=64
    is ~1500 rounds.  Scanning the rounds on device makes the whole build
    one call.
    Rounds are padded by repeating slots — re-inserting an existing node just
    recomputes its edges against the current graph, which is a benign refresh.
    """

    def body(g, xs):
        s, lv = xs
        return (
            insert_batch.__wrapped__(g, base, norms, s, lv, efc, expand, heuristic),
            None,
        )

    graph, _ = jax.lax.scan(body, graph, (slots, levels))
    return graph


@functools.partial(jax.jit, static_argnames=("m", "heuristic", "k_cand"))
def _bulk_level_edges(
    member_vecs: Array,   # [Nl, d] gathered member vectors (padded rows ok)
    member_norms: Array,  # [Nl] (+inf on padding)
    member_slots: Array,  # [Nl] global slot ids (-1 padding)
    m: int,
    heuristic: bool = True,
    k_cand: int = 0,
) -> Array:
    """Exact-kNN bulk edge construction for ONE level.

    The array-program replacement for sequential insertion when building from
    scratch: one members x members distance matmul -> top-(2m) candidates ->
    diversity-heuristic prune -> sort-based reverse-edge pass -> final prune.
    Returns local adjacency [Nl, m] of LOCAL member indices (-1 padded);
    the caller maps local -> global slots.
    """
    nl = member_vecs.shape[0]
    c = k_cand if k_cand > 0 else min(2 * m + 1, nl)
    valid = member_slots >= 0

    # chunk the query axis so the [CQ, Nl] distance tile stays bounded
    # (a single [Nl, Nl] matrix is 40 GB at Nl=100k)
    cq = min(4096, nl)
    n_chunks = nl // cq

    def prune(cand_d, cand_i):
        m_eff = min(m, cand_i.shape[1])
        if heuristic:
            pair = _pairwise_among(member_vecs, member_norms, jnp.maximum(cand_i, 0))
            pair = jnp.where((cand_i >= 0)[:, :, None] & (cand_i >= 0)[:, None, :],
                             pair, jnp.inf)
            _, sel = _select_heuristic(cand_d, cand_i, pair, m_eff)
        else:
            neg, arg = jax.lax.top_k(-cand_d, m_eff)
            sel = jnp.take_along_axis(cand_i, arg, 1)
            sel = jnp.where(jnp.isfinite(-neg), sel, -1)
        if m_eff < m:  # tiny levels: fewer candidates than M slots
            sel = jnp.pad(sel, ((0, 0), (0, m - m_eff)), constant_values=-1)
        return sel

    def chunk_topc(start):
        qv = jax.lax.dynamic_slice_in_dim(member_vecs, start, cq, 0)
        qn = jnp.sum(qv * qv, axis=1)
        dists = (
            qn[:, None] + member_norms[None, :]
            - 2.0 * jax.lax.dot_general(qv, member_vecs, (((1,), (1,)), ((), ())),
                                        preferred_element_type=jnp.float32)
        )
        dists = jnp.where(valid[None, :], jnp.maximum(dists, 0.0), jnp.inf)
        if nl > 8192:
            # candidates tolerate an approximate reduction over wide rows
            # (an exact top-k on the GPU and the CPU)
            neg, idx = jax.lax.approx_max_k(-dists, c, recall_target=0.98)
        else:
            neg, idx = jax.lax.top_k(-dists, c)
        self_idx = start + jax.lax.broadcasted_iota(jnp.int32, (cq, c), 0)
        is_self = idx == self_idx
        d = jnp.where(is_self | (idx < 0), jnp.inf, -neg)
        idx = jnp.where(is_self | ~jnp.isfinite(d), -1, idx)
        return d, idx

    starts = jnp.arange(n_chunks, dtype=jnp.int32) * cq
    d_all, idx_all = jax.lax.map(chunk_topc, starts)        # [n_chunks, CQ, c]
    d = d_all.reshape(nl, c)
    idx = idx_all.reshape(nl, c)

    fwd = jax.lax.map(
        lambda s: prune(
            jax.lax.dynamic_slice_in_dim(d, s, cq, 0),
            jax.lax.dynamic_slice_in_dim(idx, s, cq, 0),
        ),
        starts,
    ).reshape(nl, m)                                        # [Nl, m]

    # ---- reverse pass: u -> v implies v should consider u -----------------
    tgt = fwd.reshape(-1)                                   # [Nl*m]
    src = jnp.repeat(jnp.arange(nl, dtype=jnp.int32), m)
    ok = tgt >= 0
    sort_key = jnp.where(ok, tgt, nl)
    order = jnp.argsort(sort_key)
    s_tgt = sort_key[order]
    s_src = jnp.where(ok[order], src[order], -1)
    # position within the equal-target run
    first = jnp.concatenate([jnp.ones(1, bool), s_tgt[1:] != s_tgt[:-1]])
    run_id = jnp.cumsum(first) - 1
    pos_global = jnp.arange(s_tgt.shape[0])
    run_start = jnp.zeros(s_tgt.shape[0], jnp.int32).at[run_id].max(
        jnp.where(first, pos_global, 0).astype(jnp.int32))
    pos = pos_global.astype(jnp.int32) - run_start[run_id]
    keep = (s_tgt < nl) & (pos < m) & (s_src >= 0)
    rev = jnp.full((nl, m), -1, jnp.int32)
    # dropped entries get an out-of-bounds row index -> mode="drop" skips them
    rev = rev.at[jnp.where(keep, s_tgt, nl), jnp.where(keep, pos, 0)].set(
        s_src, mode="drop"
    )

    # ---- final: prune(top-c kNN ∪ reverse sources), chunked ---------------
    def chunk_final(s):
        rv = jax.lax.dynamic_slice_in_dim(rev, s, cq, 0)
        dd = jax.lax.dynamic_slice_in_dim(d, s, cq, 0)
        ii = jax.lax.dynamic_slice_in_dim(idx, s, cq, 0)
        me = jax.lax.dynamic_slice_in_dim(member_vecs, s, cq, 0)
        rv_safe = jnp.maximum(rv, 0)
        diff = member_vecs[rv_safe] - me[:, None, :]
        rev_d = jnp.sum(diff * diff, axis=2)
        rev_d = jnp.where(rv >= 0, rev_d, jnp.inf)
        cand_d = jnp.concatenate([dd, rev_d], axis=1)
        cand_i = jnp.concatenate([ii, rv], axis=1)
        # dedup (a reverse source may already be a kNN candidate): sort by
        # id, mask adjacent duplicates
        ordc = jnp.argsort(jnp.where(cand_i >= 0, cand_i, nl + 1), axis=1)
        c_i = jnp.take_along_axis(cand_i, ordc, 1)
        c_d = jnp.take_along_axis(cand_d, ordc, 1)
        dup = jnp.concatenate(
            [jnp.zeros((cq, 1), bool), c_i[:, 1:] == c_i[:, :-1]], axis=1
        )
        c_d = jnp.where(dup | (c_i < 0), jnp.inf, c_d)
        c_i = jnp.where(dup, -1, c_i)
        return prune(c_d, c_i)

    final = jax.lax.map(chunk_final, starts).reshape(nl, m)
    return jnp.where(valid[:, None], final, -1)


def bulk_build(
    graph: HnswGraph,
    base: Array,
    norms: Array,
    slots,            # np.int32 [n] live slots
    levels,           # np.int32 [n] sampled levels
    m: int,
    heuristic: bool = True,
) -> HnswGraph:
    """Build the whole layered graph from scratch with exact-kNN construction
    (one distance matmul + batched prune per level) — replaces thousands of
    sequential insertion beams with a handful of device calls.  Per-level
    membership follows the geometric level assignment, like the reference's
    layered structure; edge quality matches or beats beam insertion because
    candidates are the TRUE nearest neighbors.
    """
    import numpy as np

    levels_np = np.asarray(levels)
    slots_np = np.asarray(slots, np.int32)
    L = graph.max_level
    new_levels = graph.levels.at[jnp.asarray(slots_np)].set(jnp.asarray(levels_np))
    neighbors = graph.neighbors

    for lev in range(L):
        members = slots_np[levels_np >= lev]
        if members.size == 0:
            break
        if members.size == 1:
            continue
        nl_pad = max(8, 1 << int(np.ceil(np.log2(members.size))))
        pad = nl_pad - members.size
        mem = np.concatenate([members, np.full(pad, -1, np.int32)])
        mem_j = jnp.asarray(mem)
        safe = jnp.maximum(mem_j, 0)
        vecs = base[safe]
        nrm = jnp.where(mem_j >= 0, norms[safe], jnp.inf)
        local = _bulk_level_edges(vecs, nrm, mem_j, m, heuristic)
        # local member indices -> global slots
        glob = jnp.where(local >= 0, mem_j[jnp.maximum(local, 0)], -1)
        # -1 pads dump out of bounds (mode="drop"): `.at[lev, safe]` would
        # map every pad to index 0 and the duplicate-index set is
        # last-wins, clobbering slot 0's fresh row with its stale copy
        # whenever slot 0 is a member and the level pads (round-4 review —
        # same bug as _delta_level_edges' forward scatter)
        cap_n = neighbors.shape[1]
        neighbors = neighbors.at[
            lev, jnp.where(mem_j >= 0, mem_j, cap_n)].set(glob, mode="drop")

    top = int(levels_np.max()) if levels_np.size else 0
    entries = slots_np[levels_np == top]
    entry = int(entries[0]) if entries.size else int(slots_np[0])
    return graph.replace(
        neighbors=neighbors,
        levels=new_levels,
        entry=jnp.asarray(entry, jnp.int32),
        entry_level=jnp.asarray(top, jnp.int32),
    )


def host_insert_stream(
    graph: HnswGraph,
    base: Array,
    norms: Array,
    slots,             # np.int32 [n]
    levels,            # np.int32 [n]
    batch: int,
    live_before: int,
    efc: int,
    expand: int = 4,
    heuristic: bool = True,
) -> HnswGraph:
    """Host orchestration of a full insertion stream.

    Phase 1 — growth schedule: while the graph is tiny, round size tracks the
    live graph size (1, 2, 4, ... up to `batch`) so early nodes keep links to
    each other (sequential-insertion candidate scarcity; see insert_batch).
    Phase 2 — all remaining full-size rounds run on device via insert_rounds,
    split into power-of-two chunks (binary decomposition) so each chunk
    compiles once per size and dispatch count is O(log rounds).
    """
    import numpy as np  # host-side

    n = len(slots)
    pos = 0
    live = max(live_before, 1)
    b = max(1, batch)

    def pad_round(chunk, chunk_lv, step):
        pad = step - len(chunk)
        if pad:
            chunk = np.concatenate([chunk, np.repeat(chunk[-1:], pad)])
            chunk_lv = np.concatenate([chunk_lv, np.repeat(chunk_lv[-1:], pad)])
        return chunk, chunk_lv

    # phase 1: growth rounds
    while pos < n and live < b:
        step = min(b, 1 << (max(live, 1).bit_length() - 1))
        chunk, chunk_lv = pad_round(slots[pos:pos + step], levels[pos:pos + step], step)
        pos += min(step, n - pos)
        live += step
        graph = insert_batch(
            graph, base, norms,
            jnp.asarray(chunk, jnp.int32), jnp.asarray(chunk_lv, jnp.int32),
            efc=efc, expand=expand, heuristic=heuristic,
        )

    # phase 2: full-size rounds, binary-decomposed device scans
    remaining = n - pos
    if remaining <= 0:
        return graph
    num_rounds = -(-remaining // b)
    # build the [num_rounds, b] matrices (last round padded by repetition)
    flat = slots[pos:]
    flat_lv = levels[pos:]
    pad = num_rounds * b - remaining
    if pad:
        flat = np.concatenate([flat, np.repeat(flat[-1:], pad)])
        flat_lv = np.concatenate([flat_lv, np.repeat(flat_lv[-1:], pad)])
    rounds = flat.reshape(num_rounds, b)
    rounds_lv = flat_lv.reshape(num_rounds, b)
    r0 = 0
    r = num_rounds
    while r > 0:
        chunk_r = 1 << (r.bit_length() - 1)  # largest pow2 <= r
        graph = insert_rounds(
            graph, base, norms,
            jnp.asarray(rounds[r0:r0 + chunk_r]),
            jnp.asarray(rounds_lv[r0:r0 + chunk_r]),
            efc=efc, expand=expand, heuristic=heuristic,
        )
        r0 += chunk_r
        r -= chunk_r
    return graph


# --------------------------------------------------------------------------
# exact-kNN delta insertion (deferred incremental adds)
# --------------------------------------------------------------------------

@functools.partial(
    jax.jit, static_argnames=("m", "heuristic", "c", "rev_inc", "block_n",
                              "rev_chunk")
)
def _delta_level_edges(
    nbrs_lev: Array,      # [cap, M] this level's adjacency
    base: Array,          # [cap, d]
    norms: Array,         # [cap]
    member_mask: Array,   # [cap] bool — nodes present at this level (old+new)
    new_slots: Array,     # [Nn] int32, -1 padded
    m: int,
    heuristic: bool,
    c: int,
    rev_inc: int,
    block_n: int,
    rev_chunk: int = 2048,
) -> Array:
    """One level of exact-kNN DELTA insertion: connect ``new_slots`` into an
    existing level graph without touching unaffected rows.

    The batched answer to incremental insertion (the reference native
    inserts sequentially, docs/OPTIMIZATION_SUMMARY.md:59): instead of
    per-node beam descents (gather- and dispatch-bound),
    ONE blocked matmul finds every new node's true top-c neighbors among
    the level's members, a batched diversity prune picks forward edges, and
    a grouped reverse pass re-prunes only the affected rows.  Edge quality
    matches bulk_build (candidates are the TRUE nearest neighbors) while
    cost scales as new x live matmul flops, not dispatch count.

    Like insert_batch, the delta connects against a frozen snapshot: new
    nodes see each other through the member mask (their levels are already
    scattered), so intra-batch edges form symmetrically.
    """
    from .distance import blocked_knn_fast

    cap = base.shape[0]
    nn = new_slots.shape[0]
    safe_new = jnp.maximum(new_slots, 0)
    qv = base[safe_new]                                     # [Nn, d]

    # ---- forward: true top-c among members, diversity prune ---------------
    d, idx = blocked_knn_fast(qv, base, member_mask, c, "l2",
                              b_norms=norms, block_n=block_n,
                              recall_target=0.99)
    drop = (idx == new_slots[:, None]) | (new_slots < 0)[:, None]
    d = jnp.where(drop, jnp.inf, d)
    idx = jnp.where(drop | ~jnp.isfinite(d), -1, idx)
    if heuristic:
        pair = _pairwise_among(base, norms, idx)
        pair = jnp.where((idx >= 0)[:, :, None] & (idx >= 0)[:, None, :],
                         pair, jnp.inf)
        sel_d, sel_i = _select_heuristic(d, idx, pair, m)
    else:
        neg, arg = jax.lax.top_k(-d, m)
        sel_i = jnp.take_along_axis(idx, arg, 1)
        sel_d = -neg
        sel_i = jnp.where(jnp.isfinite(sel_d), sel_i, -1)
    ok_new = new_slots >= 0
    # out-of-bounds dump index for -1 pads (mode="drop"), like the reverse
    # pass below: `.at[safe_new]` would map every pad to index 0, and a
    # duplicate-index set is last-wins — a batch containing store slot 0
    # had its freshly computed row clobbered by the pads' stale copy
    # (round-4 review finding, reproduced)
    nbrs_lev = nbrs_lev.at[jnp.where(ok_new, new_slots, cap)].set(
        sel_i, mode="drop")

    # ---- reverse: group (new u -> old v) edges by target, re-prune v ------
    # sort edges by (target, distance) so each target's closest incoming
    # sources sit in one run; the first-occurrence row of each run re-prunes
    # that target once with up to rev_inc incoming candidates.
    flat_t = sel_i.reshape(-1)                              # [T]
    flat_s = jnp.broadcast_to(new_slots[:, None], (nn, m)).reshape(-1)
    flat_d = sel_d.reshape(-1)
    t_tot = flat_t.shape[0]
    ok = (flat_t >= 0) & (flat_s >= 0)
    key_t = jnp.where(ok, flat_t, cap)
    order = jnp.lexsort((flat_d, key_t))
    s_t = key_t[order]
    s_s = jnp.where(ok[order], flat_s[order], -1)
    first = jnp.concatenate(
        [jnp.ones(1, bool), s_t[1:] != s_t[:-1]]) & (s_t < cap)
    # windowed incoming: row p sees sources p..p+rev_inc-1 of the same run
    s_s_pad = jnp.concatenate([s_s, jnp.full(rev_inc, -1, jnp.int32)])
    s_t_pad = jnp.concatenate([s_t, jnp.full(rev_inc, cap, jnp.int32)])
    inc = jnp.stack(
        [jnp.where(s_t_pad[j:j + t_tot] == s_t, s_s_pad[j:j + t_tot], -1)
         for j in range(rev_inc)], axis=1)                  # [T, rev_inc]

    # pad the T axis to the chunk size and re-prune in blocked passes
    t_pad = -(-t_tot // rev_chunk) * rev_chunk
    pad = t_pad - t_tot
    s_t = jnp.concatenate([s_t, jnp.full(pad, cap, jnp.int32)])
    first = jnp.concatenate([first, jnp.zeros(pad, bool)])
    inc = jnp.concatenate([inc, jnp.full((pad, rev_inc), -1, jnp.int32)])

    def chunk_body(nbrs_lev, s):
        tg = jax.lax.dynamic_slice_in_dim(s_t, s, rev_chunk, 0)
        fr = jax.lax.dynamic_slice_in_dim(first, s, rev_chunk, 0)
        ic = jax.lax.dynamic_slice_in_dim(inc, s, rev_chunk, 0)
        tg_safe = jnp.where(fr, tg, 0)
        cur = nbrs_lev[tg_safe]                             # [B, M]
        # dedup: an incoming source may already be an edge of the target
        dup_cur = jnp.any(
            (cur[:, :, None] == ic[:, None, :]) & (ic[:, None, :] >= 0),
            axis=2)
        cand = jnp.concatenate([jnp.where(dup_cur, -1, cur), ic], axis=1)
        c_safe = jnp.maximum(cand, 0)
        t_vecs = base[tg_safe]
        dd = (
            norms[tg_safe][:, None] + norms[c_safe]
            - 2.0 * jnp.einsum("bd,bcd->bc", t_vecs, base[c_safe],
                               preferred_element_type=jnp.float32)
        )
        dd = jnp.where(cand >= 0, jnp.maximum(dd, 0.0), jnp.inf)
        if heuristic:
            pairc = _pairwise_among(base, norms, cand)
            pairc = jnp.where(
                (cand >= 0)[:, :, None] & (cand >= 0)[:, None, :],
                pairc, jnp.inf)
            _, new_rows = _select_heuristic(dd, cand, pairc, m)
        else:
            negk, argk = jax.lax.top_k(-dd, m)
            new_rows = jnp.take_along_axis(cand, argk, 1)
            new_rows = jnp.where(jnp.isfinite(-negk), new_rows, -1)
        # out-of-bounds dump index for masked rows: a duplicate-index
        # scatter of stale row-0 values could otherwise clobber a genuine
        # row-0 update in the same chunk
        nbrs_lev = nbrs_lev.at[jnp.where(fr, tg, cap)].set(
            new_rows, mode="drop")
        return nbrs_lev, None

    starts = jnp.arange(t_pad // rev_chunk, dtype=jnp.int32) * rev_chunk
    nbrs_lev, _ = jax.lax.scan(chunk_body, nbrs_lev, starts)
    return nbrs_lev


def bulk_insert_delta(
    graph: HnswGraph,
    base: Array,
    norms: Array,
    valid: Array,
    slots,            # np.int32 [n] new slots (already written to the store)
    levels,           # np.int32 [n] sampled levels
    m: int,
    heuristic: bool = True,
) -> HnswGraph:
    """Connect a batch of new nodes into an EXISTING graph with exact-kNN
    delta construction — the flush step of the deferred-insert policy
    (index/hnsw.py, index/hnsw_pq.py): per level, one blocked matmul finds
    true neighbors, forward edges are diversity-pruned, and only affected
    reverse rows are re-pruned.  Unaffected rows are untouched, unlike
    bulk_build which rebuilds every edge.
    """
    import numpy as np

    levels_np = np.asarray(levels)
    slots_np = np.asarray(slots, np.int32)
    if slots_np.size == 0:
        return graph
    L = graph.max_level
    slots_j = jnp.asarray(slots_np)
    new_levels = graph.levels.at[slots_j].set(jnp.asarray(levels_np))
    member_base = valid & (new_levels >= 0)
    neighbors = graph.neighbors
    m_eff = graph.m
    cap = graph.capacity
    block_n = min(262144, cap)
    top_new = int(levels_np.max())

    for lev in range(min(int(top_new) + 1, L)):
        mine = slots_np[levels_np >= lev]
        if mine.size == 0:
            break
        nn_pad = max(8, 1 << int(np.ceil(np.log2(mine.size))))
        mem = np.concatenate(
            [mine, np.full(nn_pad - mine.size, -1, np.int32)])
        nbrs_lev = _delta_level_edges(
            neighbors[lev], base, norms,
            member_base & (new_levels >= lev), jnp.asarray(mem),
            m=m_eff, heuristic=heuristic, c=min(2 * m_eff + 2, cap),
            rev_inc=min(m_eff, 16), block_n=block_n,
        )
        neighbors = neighbors.at[lev].set(nbrs_lev)

    entry = graph.entry
    entry_level = graph.entry_level
    if top_new > int(graph.entry_level):
        best = slots_np[int(np.argmax(levels_np))]
        entry = jnp.asarray(int(best), jnp.int32)
        entry_level = jnp.asarray(top_new, jnp.int32)
    return graph.replace(
        neighbors=neighbors,
        levels=new_levels,
        entry=entry,
        entry_level=entry_level,
    )


@jax.jit
def seed_first(graph: HnswGraph, slot: Array, level: Array) -> HnswGraph:
    """Insert the very first node (host decides when the graph is empty)."""
    return graph.replace(
        levels=graph.levels.at[slot].set(level),
        entry=slot.astype(jnp.int32),
        entry_level=level.astype(jnp.int32),
    )


@jax.jit
def unlink_slot(graph: HnswGraph, slot: Array) -> HnswGraph:
    """Remove a node's edges and pointers to it (reference:
    HnswIndex.removeVector :254-318 unlinks all levels).  Entry-point fixup
    happens host-side."""
    neighbors = jnp.where(graph.neighbors == slot, -1, graph.neighbors)
    neighbors = neighbors.at[:, slot, :].set(-1)
    return graph.replace(neighbors=neighbors, levels=graph.levels.at[slot].set(-1))
