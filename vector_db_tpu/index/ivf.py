"""IVF (inverted-file) index — coarse k-means + nprobe cluster scan.

Analog of the reference's IVF (reference: index/IvfIndex.java —
nClusters=100 capped at N/10, nProbes=10 :41-57, brute-force fallback when
untrained/small :215-225, k-means++ build :335-399; native/index/IVFIndex.cpp
— flat k-means train :21-81, partial_sort centroids + scan nProbes lists
:110-159).

Design (SURVEY.md §7.1.4): cluster membership is a padded [nlist, maxlen]
slot-id table; search = one query x centroid matmul for probe selection, then
a gather of the probed clusters' members and a batched exact distance over the
gathered block — two matmuls per batch instead of per-element scans.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..api.config import IvfConfig
from ..core.store import VectorStore
from ..ops.distance import blocked_knn, blocked_rerank, pairwise_dist
from ..ops.topk import smallest_k
from .base import VectorIndex, pad_queries_pow2, pow2


@functools.partial(jax.jit, static_argnames=("nprobe", "k", "metric", "max_len"))
def _ivf_search(
    queries: jnp.ndarray,       # [Q, d]
    centroids: jnp.ndarray,     # [C, d]
    members: jnp.ndarray,       # [C, L] slot ids, -1 padded
    overflow: jnp.ndarray,      # [O] quota-spilled slots, -1 padded
    base: jnp.ndarray,          # [cap, d]
    valid: jnp.ndarray,         # [cap]
    fill_slots: jnp.ndarray,    # [F] random live slots for short rows
    nprobe: int,
    k: int,
    metric: str,
    max_len: int,
) -> tuple[jnp.ndarray, jnp.ndarray]:
    # 1. probe selection: query x centroid distance matmul
    cd = pairwise_dist(queries, centroids, metric)  # [Q, C]
    _, probes = jax.lax.top_k(-cd, nprobe)  # [Q, P]

    # 2. gather probed clusters' member slots -> [Q, P*L]; the shared
    #    overflow list (members beyond a cluster's quota) is always scanned,
    #    so quota capping is lossless (core/member_table.py)
    cand = members[probes].reshape(queries.shape[0], nprobe * max_len)
    cand = jnp.concatenate(
        [cand,
         jnp.broadcast_to(overflow[None, :],
                          (queries.shape[0], overflow.shape[0]))],
        axis=1,
    )
    # multi-assigned vectors can appear in several probed clusters: sort-dedup
    # so duplicates cannot crowd the top-k (adjacent after sort)
    cand = jnp.sort(cand, axis=1)
    dup = jnp.concatenate(
        [jnp.zeros((cand.shape[0], 1), bool), cand[:, 1:] == cand[:, :-1]],
        axis=1,
    )
    cand = jnp.where(dup, -1, cand)
    cand = jnp.where(valid[jnp.maximum(cand, 0)], cand, -1)

    # 3. exact distances, BLOCKED with a running top-k merge: the candidate
    #    row is nprobe*L + |overflow|, and the overflow list is unbounded on
    #    skewed corpora — a one-shot [Q, C, d] gather at the mega-cluster
    #    scale the quota exists for would be a ~100 GiB allocation
    #    (CLAUDE.md: always block re-ranks)
    top_d, top_i = blocked_rerank(queries, base, cand, k, metric)

    # 4. random-fill parity (reference: IvfIndex.java:246-257): rows the
    #    probed clusters could not fill get random live slots with their
    #    exact distances — no -1 rows whenever the corpus has >= k vectors.
    #    Fills never displace real hits: top_d is sorted ascending with inf
    #    tails, so positions past the real-hit count take fills in distance
    #    order.
    f_ok = (fill_slots >= 0) & valid[jnp.maximum(fill_slots, 0)]
    fv = base[jnp.maximum(fill_slots, 0)]                    # [F, d]
    fd = pairwise_dist(queries, fv, metric)                  # [Q, F]
    already = jnp.any(
        fill_slots[None, None, :] == top_i[:, :, None], axis=1
    )                                                        # [Q, F]
    fd = jnp.where(f_ok[None, :] & ~already, fd, jnp.inf)
    # fills carry exact distances, so they compete fairly in one final top-k
    # (the reference sorts the merged candidate list the same way)
    cat_d = jnp.concatenate([top_d, fd], axis=1)
    cat_i = jnp.concatenate(
        [top_i, jnp.broadcast_to(fill_slots[None, :], fd.shape)], axis=1
    )
    neg, arg = jax.lax.top_k(-cat_d, k)
    out_d = -neg
    out_i = jnp.take_along_axis(cat_i, arg, axis=1)
    return out_d, jnp.where(jnp.isfinite(out_d), out_i, -1)


class IvfIndex(VectorIndex):
    kind = "ivf"

    def __init__(self, dim: int, capacity: int, metric: str = "l2", config: Optional[IvfConfig] = None):
        super().__init__(dim, capacity, metric)
        self.config = config or IvfConfig()
        self.store = VectorStore(capacity, dim)
        self.centroids: Optional[jax.Array] = None  # [C, d]
        # slot -> its top-a clusters (multi-assignment spilling; column 0 is
        # the primary assignment)
        self.assignments = np.full(
            (self.store.capacity, max(1, self.config.multi_assign)), -1, np.int32
        )
        self.members: Optional[jax.Array] = None  # [C, L] padded slot table
        self.overflow: Optional[jax.Array] = None  # quota-spilled slots
        self._members_dirty = True
        self.trained = False
        self.seed = 42
        self._removals_since_train = 0

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors: np.ndarray) -> list[int]:
        accepted, slots = self.store.add_batch(ids, vectors)
        if accepted and self.trained:
            self._assign_slots(np.asarray(slots, np.int64))
        return accepted

    def remove(self, vec_id: int) -> bool:
        slot = self.store.remove(vec_id)
        if slot is None:
            return False
        self.assignments[slot, :] = -1
        self._members_dirty = True
        # staleness analog of the reference's centroid-removal rebuild
        # (IvfIndex.java:189-191 rebuilds when a centroid vector is removed;
        # our centroids are k-means means, so the trigger is aggregate drift)
        self._removals_since_train += 1
        if (
            self.trained
            and self._removals_since_train > max(64, self.store.size() // 4)
        ):
            self.build()
        return True

    # --------------------------------------------------------------- build
    def build(self) -> None:
        """Train the coarse quantizer + assign everything (reference:
        IvfIndex.buildIndex :335-399 k-means++ + one Lloyd pass; we run the
        configured number of Lloyd iterations on-device)."""
        from ..ops.kmeans import kmeans_fit

        n = self.store.size()
        # nClusters <= N/10 cap (reference: IvfIndex.java:41-57)
        n_clusters = max(1, min(self.config.num_clusters, max(n // 10, 1)))
        if n < 2:
            return
        st = self.store.state
        live = np.flatnonzero(np.asarray(st.valid))
        data = jnp.asarray(np.asarray(st.vectors)[live])
        self.centroids, _ = kmeans_fit(
            jax.random.PRNGKey(self.seed),
            data,
            k=n_clusters,
            iters=self.config.training_iterations,
            plus_plus=True,
        )
        self.assignments[:] = -1
        self._assign_slots(live)
        self.trained = True
        self._members_dirty = True
        self._removals_since_train = 0

    def _assign_slots(self, slots: np.ndarray) -> None:
        """Assign slots to their top-a clusters (multi-assignment spilling)."""
        a = min(max(1, self.config.multi_assign), int(self.centroids.shape[0]))
        vecs = self.store.state.vectors[jnp.asarray(slots)]
        d = pairwise_dist(vecs, self.centroids, self.metric)
        _, top_a = jax.lax.top_k(-d, a)
        self.assignments[slots] = -1
        self.assignments[slots, :a] = np.asarray(top_a)
        self._members_dirty = True

    def _member_table(self) -> tuple[jax.Array, int, jax.Array]:
        """Quota-capped [C, L] member table + overflow list, rebuilt lazily
        after mutations (vectorized argsort bucketing, core/member_table.py).

        The quota (8x the mean cluster size) bounds the per-query candidate
        gather against mega-clusters; members beyond it spill into a shared
        overflow list every query scans — lossless, unlike truncation, which
        on skewed corpora silently dropped an unbounded share of members."""
        if self.members is not None and not self._members_dirty:
            return self.members, self.members.shape[1], self.overflow
        from ..core.member_table import build_member_table

        table, max_len, over = build_member_table(
            self.assignments, np.asarray(self.store.state.valid),
            int(self.centroids.shape[0]), quota_mult=8.0, align=8,
        )
        self.members = jnp.asarray(table)
        self.overflow = jnp.asarray(over)
        self._members_dirty = False
        return self.members, max_len, self.overflow

    # --------------------------------------------------------------- search
    def search_batch(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(f"expected [*, {self.dim}] queries, got {queries.shape}")
        st = self.store.state
        n_live = self.store.size()
        padded, q_n = pad_queries_pow2(queries)
        k_eff = min(k, st.capacity)
        k_pad = min(pow2(k_eff), st.capacity)

        if not self.trained or n_live <= k:
            # brute-force fallback (reference: IvfIndex.java:215-225)
            dists, slots = blocked_knn(
                jnp.asarray(padded), st.vectors, st.valid, k_pad,
                metric=self.metric, b_norms=st.norms,
                block_n=min(8192, st.capacity),
            )
        else:
            members, max_len, overflow = self._member_table()
            nprobe = min(self.config.num_probes, int(self.centroids.shape[0]))
            # deterministic "random" fill pool (reference shuffles; we keep
            # the fixed-seed convention, SURVEY.md §4.5)
            live = np.flatnonzero(np.asarray(st.valid))
            rng = np.random.default_rng(self.seed + live.size)
            f = min(k_pad, live.size)
            fill = rng.choice(live, f, replace=False).astype(np.int32)
            if f < k_pad:
                fill = np.concatenate([fill, np.full(k_pad - f, -1, np.int32)])
            dists, slots = _ivf_search(
                jnp.asarray(padded), self.centroids, members, overflow,
                st.vectors, st.valid, jnp.asarray(fill),
                nprobe, k_pad, self.metric, max_len,
            )
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
            trained=self.trained,
            num_clusters=int(self.centroids.shape[0]) if self.trained else 0,
            num_probes=self.config.num_probes,
            multi_assign=self.config.multi_assign,
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        out = {
            "store": self.store.to_host(),
            "assignments": self.assignments,
            "trained": np.asarray([self.trained]),
        }
        if self.centroids is not None:
            out["centroids"] = np.asarray(self.centroids)
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        self.store = VectorStore.from_host(arrays["store"])
        assign = np.asarray(arrays["assignments"]).copy()
        if assign.ndim == 1:  # pre-multi-assign checkpoint format
            assign = assign[:, None]
        self.assignments = assign
        self.trained = bool(np.asarray(arrays["trained"])[0])
        self.centroids = (
            jnp.asarray(arrays["centroids"]) if "centroids" in arrays else None
        )
        self._members_dirty = True
        self.members = None
        self.overflow = None
