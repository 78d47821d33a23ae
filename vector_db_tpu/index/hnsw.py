"""HNSW index — hierarchical navigable small-world graph, uncompressed.

Analog of the reference's HNSW (reference: index/HnswIndex.java —
defaults M=32, efC=400, ef=400, cosine+normalize :21-26; insert :178-236;
search :347-380; remove+entry fixup :254-318; buildIndex re-insert :430-473;
native/index/HNSWIndex.{h,cpp}).

The graph lives in `ops/hnsw_graph.py` as padded adjacency arrays; insertion
runs in batched rounds (config.batch_insert) fully on-device.  For
metric="cosine" vectors are L2-normalized at the boundary (like the Java
reference) so squared-L2 traversal is order-equivalent to cosine distance.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..api.config import HnswConfig
from ..core.store import VectorStore
from ..ops import hnsw_graph as hg
from ..ops.distance import blocked_knn
from .base import DeferInsertMixin, VectorIndex, pad_queries_pow2, pow2


class HnswIndex(DeferInsertMixin, VectorIndex):
    kind = "hnsw"

    def __init__(self, dim: int, capacity: int, metric: str = "l2", config: Optional[HnswConfig] = None):
        super().__init__(dim, capacity, metric)
        self.config = config or HnswConfig()
        self.store = VectorStore(capacity, dim)
        self._max_level = self.config.derived_max_level(self.store.capacity)
        self.graph = hg.init_graph(self.store.capacity, self.config.m, self._max_level)
        self.seed = 42
        self._level_counter = 0  # distinct PRNG stream per insertion round
        # defer insert policy: adds buffered here until the flush threshold;
        # searches see them via an exact overlay (hg.hnsw_search_pending);
        # shared implementation in base.DeferInsertMixin
        self._init_pending(self.store.capacity)

    # ------------------------------------------------------------- helpers
    def _prep(self, vectors: np.ndarray) -> np.ndarray:
        vectors = np.asarray(vectors, np.float32)
        if self.metric == "cosine":
            # normalize at the boundary (reference: HnswIndex.java:21-26
            # cosine+normalize); L2 on unit vectors == 2*(1-cos)
            n = np.linalg.norm(vectors, axis=-1, keepdims=True)
            vectors = vectors / np.maximum(n, 1e-12)
        return vectors

    def _sample_levels(self, n: int) -> np.ndarray:
        """Geometric levels, mL = 1/ln(M) (reference: HnswIndex.java:678-690).

        Host-side numpy RNG: eager jax.random on this platform pays a ~60s
        threefry compile per call; levels are host metadata anyway.
        """
        rng = np.random.default_rng(self.seed * 1_000_003 + self._level_counter)
        self._level_counter += 1
        u = rng.uniform(1e-12, 1.0, n)
        ml = 1.0 / np.log(max(self.config.m, 2))
        lv = np.floor(-np.log(u) * ml).astype(np.int32)
        return np.clip(lv, 0, self._max_level - 1)

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors: np.ndarray) -> list[int]:
        vectors = self._prep(vectors)
        accepted, slots = self.store.add_batch(ids, vectors)
        if not accepted:
            return []
        slots_np = np.asarray(slots, np.int32)
        if self.config.insert_policy == "defer":
            self._pend_slots(slots_np)
        else:
            self._insert_slots(slots_np)
        return accepted

    # --------------------------------------- defer insert policy (mixin hooks)
    @property
    def _graph_heuristic(self) -> bool:
        return self.config.heuristic

    def _graph_insert(self, slots: np.ndarray) -> None:
        self._insert_slots(slots)  # from-scratch path (bulk_build)

    def _insert_slots(self, slots: np.ndarray) -> None:
        """Insert store slots into the graph in batched rounds."""
        levels = self._sample_levels(len(slots))
        st = self.store.state
        live = self.store.size() - len(slots)  # graph size before this call
        if (
            self.config.bulk_build
            and int(self.graph.entry) < 0
            and len(slots) >= 4 * self.config.m
        ):
            # building from scratch: exact-kNN bulk construction replaces
            # thousands of sequential insertion beams with a few matmuls
            self.graph = hg.bulk_build(
                self.graph, st.vectors, st.norms, slots, levels,
                m=self.config.m, heuristic=self.config.heuristic,
            )
            return
        if int(self.graph.entry) < 0:
            # seed the very first node (ops/hnsw_graph.py requires non-empty),
            # then ALSO insert it normally below: the seed must earn forward
            # edges from its batch-mates, or an outlier seed becomes an orphan
            # the moment the entry point is promoted away from it
            self.graph = hg.seed_first(
                self.graph,
                jnp.asarray(slots[0], jnp.int32),
                jnp.asarray(levels[0], jnp.int32),
            )
            live = max(live, 1)
        self.graph = hg.host_insert_stream(
            self.graph, st.vectors, st.norms, slots, levels,
            batch=max(1, self.config.batch_insert), live_before=live,
            efc=self.config.ef_construction,
            expand=max(1, self.config.expand_per_iter),
            heuristic=self.config.heuristic,
        )

    def remove(self, vec_id: int) -> bool:
        """Tombstone + eager unlink (reference: HnswIndex.removeVector
        :254-318).  Entry-point fixup picks the highest-level live node."""
        slot = self.store.remove(vec_id)
        if slot is None:
            return False
        if self._unpend_slot(slot):
            return True  # never reached the graph
        was_entry = int(self.graph.entry) == slot
        self.graph = hg.unlink_slot(self.graph, jnp.asarray(slot, jnp.int32))
        if was_entry:
            levels = np.asarray(self.graph.levels)
            valid = np.asarray(self.store.state.valid)
            live = np.flatnonzero(valid & (levels >= 0))
            if live.size:
                new_entry = int(live[np.argmax(levels[live])])
                self.graph = self.graph.replace(
                    entry=jnp.asarray(new_entry, jnp.int32),
                    entry_level=jnp.asarray(int(levels[new_entry]), jnp.int32),
                )
            else:
                self.graph = self.graph.replace(
                    entry=jnp.asarray(-1, jnp.int32),
                    entry_level=jnp.asarray(-1, jnp.int32),
                )
        return True

    def optimize_for_high_dimension(self) -> None:
        """Bump graph parameters for very high-dimensional data
        (reference: HnswIndex.optimizeForHighDimension :382-421 — raises
        M/efC/ef at dim >= 1000 and again at dim >= 1500).  Takes effect for
        subsequently inserted vectors; call build() to re-link existing ones."""
        if self.dim >= 1500:
            self.config.m = max(self.config.m, 48)
            self.config.ef_construction = max(self.config.ef_construction, 600)
            self.config.ef_search = max(self.config.ef_search, 600)
        elif self.dim >= 1000:
            self.config.m = max(self.config.m, 40)
            self.config.ef_construction = max(self.config.ef_construction, 500)
            self.config.ef_search = max(self.config.ef_search, 500)
        if self.config.m > self.graph.m:
            # grow the adjacency width; existing edge lists are preserved
            import jax.numpy as _jnp

            pad = self.config.m - self.graph.m
            self.graph = self.graph.replace(
                neighbors=_jnp.pad(
                    self.graph.neighbors, ((0, 0), (0, 0), (0, pad)),
                    constant_values=-1,
                )
            )

    def build(self) -> None:
        """Full rebuild: fresh graph, re-insert all live vectors sorted by id
        (reference: HnswIndex.buildIndex :430-473)."""
        ids_np = np.asarray(self.store.state.ids)
        valid = np.asarray(self.store.state.valid)
        live = np.flatnonzero(valid)
        order = live[np.argsort(ids_np[live], kind="stable")]
        self.graph = hg.init_graph(self.store.capacity, self.config.m, self._max_level)
        self._clear_pending()  # the rebuild connects everything
        if order.size:
            self._insert_slots(order.astype(np.int32))

    # --------------------------------------------------------------- search
    def search_batch(self, queries: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        queries = self._prep(queries)
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(f"expected [*, {self.dim}] queries, got {queries.shape}")
        st = self.store.state
        n_live = self.store.size()
        padded, q_n = pad_queries_pow2(queries)
        k_eff = max(1, min(k, st.capacity))
        k_pad = min(pow2(k_eff), st.capacity)

        if int(self.graph.entry) < 0 or n_live <= k:
            dists, slots = blocked_knn(
                jnp.asarray(padded), st.vectors, st.valid, k_pad,
                metric="l2", b_norms=st.norms, block_n=min(8192, st.capacity),
            )
        else:
            ef = min(
                max(self.config.ef_for_query(k_pad, n_live, self.dim), k_pad),
                st.capacity,
            )
            if self._pending_count > 0:
                # deferred adds: graph beam + exact overlay over pending rows
                dists, slots = hg.hnsw_search_pending(
                    self.graph, st.vectors, st.norms, st.valid,
                    jnp.asarray(padded), self._pending_padded(),
                    k_pad, ef, expand=max(1, self.config.expand_per_iter),
                )
            else:
                dists, slots = hg.hnsw_search(
                    self.graph, st.vectors, st.norms, st.valid,
                    jnp.asarray(padded), k_pad, ef,
                    expand=max(1, self.config.expand_per_iter),
                )
        slots_np = np.asarray(slots)[:q_n, :k_eff]
        ids_np = np.asarray(st.ids)
        ext = np.where(slots_np >= 0, ids_np[np.maximum(slots_np, 0)], -1)
        out_ids = np.full((q_n, k), -1, np.int32)
        out_d = np.full((q_n, k), np.inf, np.float32)
        out_ids[:, :k_eff] = ext
        dv = np.asarray(dists)[:q_n, :k_eff]
        if self.metric == "cosine":
            # traversal runs on squared L2 over unit vectors = 2*(1-cos);
            # halve at the result boundary so every index reports the same
            # cosine-distance currency (1 - cos)
            dv = dv * 0.5
        out_d[:, :k_eff] = dv
        return out_ids, out_d

    # ---------------------------------------------------------------- state
    def size(self) -> int:
        return self.store.size()

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        return self.store.get(vec_id)

    def stats(self) -> dict:
        """Level histogram + graph occupancy (reference:
        HnswIndex.getIndexStats :480-506)."""
        s = super().stats()
        levels = np.asarray(self.graph.levels)
        live = levels[levels >= 0]
        hist = {int(l): int(c) for l, c in zip(*np.unique(live, return_counts=True))}
        deg = np.asarray(self.graph.neighbors[0] >= 0).sum(axis=1)
        s.update(
            m=self.config.m,
            ef_construction=self.config.ef_construction,
            ef_search=self.config.ef_search,
            max_level=self._max_level,
            entry_point=int(self.graph.entry),
            level_histogram=hist,
            avg_degree_l0=float(deg[levels >= 0].mean()) if live.size else 0.0,
            pending_inserts=int(self._pending_count),
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        self.flush_pending()  # checkpoints always hold a complete graph
        return {
            "store": self.store.to_host(),
            "graph": {
                "neighbors": np.asarray(self.graph.neighbors),
                "levels": np.asarray(self.graph.levels),
                "entry": np.asarray(self.graph.entry),
                "entry_level": np.asarray(self.graph.entry_level),
            },
            "level_counter": np.asarray([self._level_counter]),
        }

    def load_state_arrays(self, arrays: dict) -> None:
        self.store = VectorStore.from_host(arrays["store"])
        self._init_pending(self.store.capacity)  # checkpoints hold complete graphs
        g = arrays["graph"]
        self.graph = hg.HnswGraph(
            neighbors=jnp.asarray(g["neighbors"]),
            levels=jnp.asarray(g["levels"]),
            entry=jnp.asarray(g["entry"]),
            entry_level=jnp.asarray(g["entry_level"]),
        )
        self._level_counter = int(np.asarray(arrays["level_counter"])[0])
