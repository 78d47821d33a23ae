"""Annoy-style index — forest of random-projection binary trees.

Analog of the reference's Annoy (reference: index/AnnoyIndex.java —
10 trees, split hyperplane = normalized difference of two random member
vectors, median threshold, leaves <= 10 :46-70, 563-642; lazy rebuild after
1000 pending inserts :32-38; candidate-union + exact re-rank search :456-493;
native/index/AnnoyIndex.cpp — explicit build(), candidate cap k*trees*2
:117-153).

Array design: trees are ARRAYS, not pointer structures —
``hyperplanes [T, nodes, d]``, ``thresholds [T, nodes]``, ``children
[T, nodes, 2]`` and fixed-width ``leaf_items [T, n_leaves, L]``.  Tree
construction is a host-orchestrated recursive split (deterministic, numpy);
descent runs on device as a while_loop of gather + dot per level for all
queries and all trees at once, then the union of reached leaves is exact
re-ranked in one batched distance computation.  Pending (un-built) vectors are
carried as an extra candidate set, so adds are visible before rebuild —
stronger than the reference, which may miss pending items in tree routing.
"""

from __future__ import annotations

import functools
import logging
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..api.config import AnnoyConfig
from ..core.store import VectorStore
from ..ops.distance import blocked_knn
from .base import VectorIndex, pad_queries_pow2, pow2

logger = logging.getLogger(__name__)

# Random-projection trees lose discrimination as dimension grows: measured
# honest Recall@10 (backfill off) is 98.3% at 128d x 10k but 36.6% at
# 512d x 100k even with the wide descent beam (benchmarks r5; the
# reference's Annoy has the same failure mode, just unmeasured).  Above
# this dim the index warns once and recommends HNSWPQ/LSH — mirroring
# _auto_scan_mode's honesty about regime boundaries.
HIGH_DIM_THRESHOLD = 256


@functools.partial(jax.jit, static_argnames=("max_depth", "beam"))
def _descend(queries, hyperplanes, thresholds, children, roots, max_depth, beam=4):
    """Margin-beam tree descent: [Q] queries x [T] trees, keeping the best
    ``beam`` branches per tree ranked by the minimum split margin along the
    path — the batched analog of Annoy's priority-queue both-sides search
    (reference: AnnoyIndex.java:651-680 explores both sides with p=0.5;
    native AnnoyIndex.cpp:117-153 walks both-sides-ordered).

    Returns leaf node indices [Q, T, beam] (-1 for unused beam slots).
    """
    q_n = queries.shape[0]
    t_n = hyperplanes.shape[0]
    b = beam
    node = jnp.full((q_n, t_n, b), -1, jnp.int32)
    node = node.at[:, :, 0].set(jnp.broadcast_to(roots[None, :], (q_n, t_n)))
    prio = jnp.full((q_n, t_n, b), -jnp.inf).at[:, :, 0].set(jnp.inf)
    t_idx = jnp.broadcast_to(jnp.arange(t_n)[None, :, None], (q_n, t_n, b))

    def body(_, state):
        node, prio = state
        safe = jnp.maximum(node, 0)
        live = node >= 0
        hp = hyperplanes[t_idx, safe]          # [Q, T, B, d]
        th = thresholds[t_idx, safe]           # [Q, T, B]
        proj = jnp.einsum("qd,qtbd->qtb", queries, hp,
                          preferred_element_type=jnp.float32)
        margin = jnp.abs(proj - th)
        go_right = proj > th
        ch = children[t_idx, safe]             # [Q, T, B, 2]
        is_leaf = ch[..., 0] < 0
        near = jnp.where(go_right, ch[..., 1], ch[..., 0])
        far = jnp.where(go_right, ch[..., 0], ch[..., 1])
        # near child inherits the path priority; far child's priority is the
        # min margin along its path (small margin -> worth exploring)
        near_n = jnp.where(is_leaf | ~live, node, near)
        near_p = jnp.where(live, prio, -jnp.inf)
        far_n = jnp.where(is_leaf | ~live, -1, far)
        far_p = jnp.where(live & ~is_leaf, jnp.minimum(prio, margin), -jnp.inf)
        cand_n = jnp.concatenate([near_n, far_n], axis=2)   # [Q, T, 2B]
        cand_p = jnp.concatenate([near_p, far_p], axis=2)
        top_p, arg = jax.lax.top_k(cand_p, b)
        new_n = jnp.take_along_axis(cand_n, arg, 2)
        new_n = jnp.where(jnp.isfinite(top_p) | (top_p == jnp.inf), new_n, -1)
        new_n = jnp.where(top_p == -jnp.inf, -1, new_n)
        return new_n, top_p

    node, _ = jax.lax.fori_loop(0, max_depth, body, (node, prio))
    return node


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _rerank(queries, base, norms, valid, cand, k, metric="l2"):
    """Exact re-rank of the candidate union with duplicate suppression.

    cand: [Q, C] slot ids (-1 pad, may contain duplicates across trees).
    """
    q_n, c = cand.shape
    # sort-based dedup (O(C log C), not O(C^2)): sort slots, drop adjacent
    # duplicates — order does not matter before a top-k re-rank
    cand = jnp.sort(cand, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((q_n, 1), bool), cand[:, 1:] == cand[:, :-1]], axis=1
    )
    cand = jnp.where(dup, -1, cand)
    safe = jnp.maximum(cand, 0)
    ok = (cand >= 0) & valid[safe]
    if c > 8192:
        # wide unions (high-dim auto beam 512 -> ~196k candidates at 12
        # trees): the one-shot [Q, C, d] gather and the full-row exact
        # top_k are both pathological at this width (CLAUDE.md) — stream
        # blocks with a running top-k merge instead
        from ..ops.distance import blocked_rerank

        return blocked_rerank(queries, base, jnp.where(ok, cand, -1), k,
                              metric, rb=2048)
    vecs = base[safe]
    q_norms = jnp.sum(queries * queries, axis=1)
    cross = jnp.einsum("qd,qcd->qc", queries, vecs,
                       preferred_element_type=jnp.float32)
    if metric == "l2":
        d = jnp.maximum(q_norms[:, None] + norms[safe] - 2.0 * cross, 0.0)
    else:  # cosine distance, same currency as every other index
        denom = jnp.sqrt(jnp.maximum(q_norms[:, None] * norms[safe], 1e-12))
        d = 1.0 - cross / denom
    d = jnp.where(ok, d, jnp.inf)
    neg, arg = jax.lax.top_k(-d, k)
    out = jnp.take_along_axis(cand, arg, 1)
    return -neg, jnp.where(jnp.isfinite(-neg), out, -1)


def _build_tree_levels(
    data, live, leaf, rng, max_nodes, n_leaves,
    hps, ths, ch, node_leaf, leaves,
) -> int:
    """Build ONE tree breadth-first, splitting every active node per depth
    in vectorized numpy (no per-node Python).  Writes into the caller's
    per-tree array views; returns the max depth reached.

    Per depth: group points by node (one argsort), pick two random members
    per node for the hyperplane (reference: AnnoyIndex.java:563-642 —
    normalized difference of two members), project ALL points against their
    node's hyperplane with one gathered row-dot, take per-node medians from
    a (group, proj) lexsort, split.  Degenerate splits (all projections on
    one side of the median) force halves by rank, like the recursive
    builder did."""
    n = data.shape[0]
    grp = np.zeros(n, np.int32)          # current node per point; -1 = done
    next_node = 1
    next_leaf = 0
    depth = 1
    while True:
        pts = np.flatnonzero(grp >= 0)
        if pts.size == 0:
            return depth
        order = pts[np.argsort(grp[pts], kind="stable")]
        sg = grp[order]
        n_act = order.size
        starts = np.flatnonzero(np.r_[True, sg[1:] != sg[:-1]])
        counts = np.diff(np.r_[starts, n_act])
        node_ids = sg[starts]
        room = max_nodes - next_node
        splittable = (counts > 2 * leaf) & (depth <= 40)
        # cap by remaining node budget (2 children per split)
        if int(splittable.sum()) * 2 > room:
            keep = np.flatnonzero(splittable)[: room // 2]
            splittable = np.zeros_like(splittable)
            splittable[keep] = True
        # finalize the rest as leaves, fully vectorized: each takes its
        # first 2*leaf members (contiguous in `order`); points of finalized
        # nodes leave the loop (grp = -1)
        fin = np.flatnonzero(~splittable)
        if fin.size:
            rows = next_leaf + np.arange(fin.size)
            ok = rows < n_leaves
            fin_w, rows = fin[ok], rows[ok]
            next_leaf += int(fin_w.size)
            width = 2 * leaf
            offs = starts[fin_w][:, None] + np.arange(width)[None, :]
            in_grp = offs < (starts[fin_w] + counts[fin_w])[:, None]
            vals = live[order[np.minimum(offs, n_act - 1)]]
            leaves[rows[:, None], np.arange(width)[None, :]] = np.where(
                in_grp, vals, -1
            )
            node_leaf[node_ids[fin_w]] = rows
        big = np.flatnonzero(splittable)
        if big.size == 0:
            return depth
        g_n = big.size
        cnt = counts[big]
        # two distinct random members per splitting node
        a_off = rng.integers(0, cnt)
        b_off = rng.integers(0, cnt - 1)
        b_off = np.where(b_off >= a_off, b_off + 1, b_off)
        pa = order[starts[big] + a_off]
        pb = order[starts[big] + b_off]
        hp = data[pa] - data[pb]                              # [G, d]
        nrm = np.linalg.norm(hp, axis=1)
        bad = nrm < 1e-9
        if bad.any():
            hp[bad] = rng.standard_normal(
                (int(bad.sum()), data.shape[1])).astype(np.float32)
            nrm[bad] = np.linalg.norm(hp[bad], axis=1)
        hp = (hp / nrm[:, None]).astype(np.float32)
        # dense local index per splitting node; non-splitting points -> -1
        gi_of_node = np.full(next_node, -1, np.int32)
        gi_of_node[node_ids[big]] = np.arange(g_n, dtype=np.int32)
        gi = np.where(grp >= 0, gi_of_node[np.maximum(grp, 0)], -1)
        act = np.flatnonzero(gi >= 0)         # points still in the loop
        proj = np.einsum("nd,nd->n", data[act], hp[gi[act]],
                         optimize=True).astype(np.float32)
        # per-node median + rank via one lexsort over (group, proj)
        ord2 = np.argsort(proj, kind="stable")
        ord2 = ord2[np.argsort(gi[act][ord2], kind="stable")]
        sp = act[ord2]                        # grouped by node, proj-sorted
        st2 = np.concatenate([[0], np.cumsum(cnt)[:-1]])
        # numpy-median parity: even counts average the two middles
        proj_sorted = np.empty(n, np.float32)
        proj_sorted[act] = proj
        thr = 0.5 * (proj_sorted[sp[st2 + (cnt - 1) // 2]]
                     + proj_sorted[sp[st2 + cnt // 2]])
        right_act = proj > thr[gi[act]]
        # degenerate nodes (ties collapse one side): force halves by rank
        rank = np.empty(n, np.int64)
        rank[sp] = np.arange(sp.size) - st2.repeat(cnt)
        n_right = np.zeros(g_n, np.int64)
        np.add.at(n_right, gi[act], right_act)
        degen = (n_right == 0) | (n_right == cnt)
        if degen.any():
            force = degen[gi[act]]
            right_act = np.where(force, rank[act] >= (cnt // 2)[gi[act]],
                                 right_act)
        l_ids = (next_node + 2 * np.arange(g_n)).astype(np.int32)
        r_ids = l_ids + 1
        hps[node_ids[big]] = hp
        ths[node_ids[big]] = thr
        ch[node_ids[big], 0] = l_ids
        ch[node_ids[big], 1] = r_ids
        next_node += 2 * g_n
        new_grp = np.full(n, -1, np.int32)
        new_grp[act] = np.where(right_act, r_ids[gi[act]], l_ids[gi[act]])
        grp = new_grp
        depth += 1


class AnnoyIndex(VectorIndex):
    kind = "annoy"

    def __init__(self, dim: int, capacity: int, metric: str = "l2", config: Optional[AnnoyConfig] = None):
        super().__init__(dim, capacity, metric)
        self.config = config or AnnoyConfig()
        self.store = VectorStore(capacity, dim)
        self.seed = 42
        self.rebuild_threshold = 1000  # reference: AnnoyIndex.java:32-38
        self._pending: list[int] = []  # slots not yet in the trees
        self._built = False
        self.hyperplanes: Optional[jnp.ndarray] = None  # [T, nodes, d]
        self.thresholds: Optional[jnp.ndarray] = None   # [T, nodes]
        self.children: Optional[jnp.ndarray] = None     # [T, nodes, 2]
        self.leaf_items: Optional[jnp.ndarray] = None   # [T, n_leaves, L]
        self.node_leaf: Optional[jnp.ndarray] = None    # [T, nodes] leaf row or -1
        self._max_depth = 1
        self._backfill_rows = 0
        self._backfill_queries = 0
        self._warned_high_dim = False

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors: np.ndarray) -> list[int]:
        accepted, slots = self.store.add_batch(ids, vectors)
        self._pending.extend(slots)
        if len(self._pending) >= self.rebuild_threshold:
            self.build()  # lazy rebuild (reference :194-331 splits leaves
            # incrementally; we rebuild the forest, which the reference also
            # does via rebuildTrees :512-555)
        return accepted

    def remove(self, vec_id: int) -> bool:
        slot = self.store.remove(vec_id)
        if slot is None:
            return False
        self._pending = [s for s in self._pending if s != slot]
        return True  # tombstone: trees keep the slot, re-rank filters it

    # --------------------------------------------------------------- build
    def build(self) -> None:
        """Rebuild the whole forest from live vectors (reference:
        AnnoyIndex.rebuildTrees :512-555, build hyperplane split :563-642).

        Level-synchronous vectorized construction: every node at a depth is
        split in ONE pass — a single gathered-hyperplane projection
        (``data * hp[group]`` row-dot, O(n*d)) plus one group-sort for the
        per-node medians — instead of a per-node Python recursion (~25k
        Python frames/tree at 100k rows; the recursive builder measured
        ~8 min at 512d x 100k x 10 trees, this one ~8 s)."""
        if self.dim > HIGH_DIM_THRESHOLD and not self._warned_high_dim:
            self._warned_high_dim = True
            logger.warning(
                "AnnoyIndex at dim=%d: random-projection trees lose "
                "discrimination at high dimension (measured honest "
                "Recall@10 at 512d x 100k: 37%% at beam 128; the auto "
                "default widens the descent beam to 512 for ~82%% at "
                "materially lower QPS) — prefer HNSWPQ or LSH for "
                "dim > %d", self.dim, HIGH_DIM_THRESHOLD)
        valid = np.asarray(self.store.state.valid)
        live = np.flatnonzero(valid)
        self._pending.clear()
        if live.size < 2:
            self._built = False
            return
        data = np.asarray(self.store.state.vectors)[live]  # [n, d]
        t = self.config.num_trees
        leaf = max(2, self.config.leaf_size)
        n = live.size
        max_nodes = 4 * (2 * n // leaf + 2)
        n_leaves = 2 * n // leaf + 2

        hps = np.zeros((t, max_nodes, self.dim), np.float32)
        ths = np.zeros((t, max_nodes), np.float32)
        ch = np.full((t, max_nodes, 2), -1, np.int32)
        node_leaf = np.full((t, max_nodes), -1, np.int32)
        leaves = np.full((t, n_leaves, 2 * leaf), -1, np.int32)
        depth_max = 1

        # sequential per-tree loop: a thread pool was tried and measured
        # SLOWER (80s vs 34s at 100k x 512 — the fancy-indexing that
        # dominates holds the GIL); per-tree seeded rngs keep the forest
        # deterministic either way
        for ti in range(t):
            depth_max = max(
                depth_max,
                _build_tree_levels(
                    data, live, leaf, np.random.default_rng(self.seed + ti),
                    max_nodes, n_leaves,
                    hps[ti], ths[ti], ch[ti], node_leaf[ti], leaves[ti],
                ),
            )

        self.hyperplanes = jnp.asarray(hps)
        self.thresholds = jnp.asarray(ths)
        self.children = jnp.asarray(ch)
        self.leaf_items = jnp.asarray(leaves)
        self.node_leaf = jnp.asarray(node_leaf)
        self._max_depth = depth_max + 1
        self._built = True

    # --------------------------------------------------------------- search
    def search_batch(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(f"expected [*, {self.dim}] queries, got {queries.shape}")
        st = self.store.state
        padded, q_n = pad_queries_pow2(queries)
        k_eff = min(k, st.capacity)
        k_pad = min(pow2(k_eff), st.capacity)
        n_live = self.store.size()

        if not self._built or n_live <= k:
            dists, slots = blocked_knn(
                jnp.asarray(padded), st.vectors, st.valid, k_pad,
                metric=self.metric, b_norms=st.norms,
                block_n=min(8192, st.capacity),
            )
        else:
            qj = jnp.asarray(padded)
            # wide beam: the reference's p=0.5 both-sides recursion visits
            # ~1.5^depth leaves per tree (AnnoyIndex.java:651-680) — a wide
            # margin-beam gives comparable coverage, and the exact re-rank
            # is one batched matmul.  Honest (no-backfill) Recall@10 at the
            # reference config (128d x 10k, 12 trees): beam 16 -> 41%,
            # 32 -> 60%, 64 -> 80.6%, 96 -> 97.4%, 128 -> 97.8%
            # (reference publishes 85% WITH its random-fill,
            # README.md:225-232).  The default must match AnnoyConfig's
            # documented 0 -> 128 (a 64 here once cost recall 97.8% ->
            # 80.6%).
            # High dim: trees lose discrimination, so the auto default
            # widens the beam (measured honest R@10 at 512d x 100k:
            # beam 128 -> 36.6%, 256 -> 57.7%, 512 -> 82.3% — r5); QPS
            # drops accordingly, and the build() warning still points at
            # HNSWPQ/LSH as the right tools there.
            auto_beam = 512 if self.dim > HIGH_DIM_THRESHOLD else 128
            beam = max(4, self.config.search_k or auto_beam)
            leaf_nodes = _descend(
                qj, self.hyperplanes, self.thresholds, self.children,
                jnp.zeros((self.config.num_trees,), jnp.int32),
                self._max_depth, beam,
            )                                   # [Q, T, B]
            t_idx = jnp.arange(self.config.num_trees)[None, :, None]
            rows = self.node_leaf[t_idx, jnp.maximum(leaf_nodes, 0)]  # [Q, T, B]
            rows = jnp.where(leaf_nodes >= 0, rows, -1)
            items = self.leaf_items[t_idx, jnp.maximum(rows, 0)]      # [Q, T, B, L]
            items = jnp.where((rows >= 0)[..., None], items, -1)
            cand = items.reshape(padded.shape[0], -1)
            # pending (not-yet-built) slots are always candidates
            if self._pending:
                pend = np.unique(np.asarray(self._pending, np.int32))
                cand = jnp.concatenate(
                    [cand, jnp.broadcast_to(jnp.asarray(pend)[None, :],
                                            (padded.shape[0], pend.size))], axis=1
                )
            dists, slots = _rerank(
                qj, st.vectors, st.norms, st.valid, cand, k_pad,
                metric=self.metric,
            )
            # backfill from exact scan if the forest came up short — counted
            # in stats and disableable (config.backfill) so tests can measure
            # honest forest-only recall
            miss = np.asarray(slots[:q_n, :k_eff] < 0)
            if miss.any():
                self._backfill_rows += int(miss.sum())
                self._backfill_queries += int(miss.any(axis=1).sum())
                if self.config.backfill:
                    fd, fs = blocked_knn(
                        qj, st.vectors, st.valid, k_pad,
                        metric=self.metric, b_norms=st.norms,
                        block_n=min(8192, st.capacity),
                    )
                    miss_all = np.asarray(slots) < 0
                    slots = jnp.where(jnp.asarray(miss_all), fs, slots)
                    dists = jnp.where(jnp.asarray(miss_all), fd, dists)
        slots_np = np.asarray(slots)[:q_n, :k_eff]
        ids_np = np.asarray(st.ids)
        ext = np.where(slots_np >= 0, ids_np[np.maximum(slots_np, 0)], -1)
        out_ids = np.full((q_n, k), -1, np.int32)
        out_d = np.full((q_n, k), np.inf, np.float32)
        out_ids[:, :k_eff] = ext
        out_d[:, :k_eff] = np.asarray(dists)[:q_n, :k_eff]
        return out_ids, out_d

    # ---------------------------------------------------------------- state
    def size(self) -> int:
        return self.store.size()

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        return self.store.get(vec_id)

    def stats(self) -> dict:
        s = super().stats()
        s.update(
            num_trees=self.config.num_trees,
            leaf_size=self.config.leaf_size,
            built=self._built,
            pending=len(self._pending),
            max_depth=self._max_depth,
            backfill_rows=self._backfill_rows,
            backfill_queries=self._backfill_queries,
            high_dim=self.dim > HIGH_DIM_THRESHOLD,
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        out = {
            "store": self.store.to_host(),
            "built": np.asarray([self._built]),
            "pending": np.asarray(self._pending or [-1], np.int32),
            "max_depth": np.asarray([self._max_depth]),
        }
        if self._built:
            out["trees"] = {
                "hyperplanes": np.asarray(self.hyperplanes),
                "thresholds": np.asarray(self.thresholds),
                "children": np.asarray(self.children),
                "leaf_items": np.asarray(self.leaf_items),
                "node_leaf": np.asarray(self.node_leaf),
            }
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        self.store = VectorStore.from_host(arrays["store"])
        self._built = bool(np.asarray(arrays["built"])[0])
        pend = np.asarray(arrays["pending"])
        self._pending = [int(s) for s in pend if s >= 0]
        self._max_depth = int(np.asarray(arrays["max_depth"])[0])
        if self._built and "trees" in arrays:
            t = arrays["trees"]
            self.hyperplanes = jnp.asarray(t["hyperplanes"])
            self.thresholds = jnp.asarray(t["thresholds"])
            self.children = jnp.asarray(t["children"])
            self.leaf_items = jnp.asarray(t["leaf_items"])
            self.node_leaf = jnp.asarray(t["node_leaf"])
