"""Abstract index interface — the `VectorIndex` seam every index implements.

Parity with the reference's twin interfaces (reference:
src/main/java/com/vectordb/index/VectorIndex.java:11-52 and
native/index/VectorIndex.h:9-35).  The surface here is batch-first:
``search`` takes a [Q, dim] query matrix and returns device arrays, because
scoring a batch of queries as one matmul is the whole point (SURVEY.md
§2.3).
Single-vector convenience wrappers sit on top.
"""

from __future__ import annotations

import abc
from typing import Optional, Sequence, Tuple

import numpy as np


def pow2(n: int) -> int:
    """Next power of two (>=1)."""
    return 1 << (max(int(n), 1) - 1).bit_length()


def pad_queries_pow2(queries: np.ndarray, min_q: int = 8) -> tuple[np.ndarray, int]:
    """Pad a [Q, d] query batch with zero rows to the next power of two.

    Bounds the number of distinct jit compilations per index to
    O(log Q_max) — the analog of the reference's fixed thread-pool fanout
    (HNSWIndex.cpp:543-571 always splits into numThreads chunks).
    Returns (padded queries, original Q).
    """
    q_n = queries.shape[0]
    qp = pow2(max(q_n, min_q))
    if qp != q_n:
        queries = np.pad(queries, ((0, qp - q_n), (0, 0)))
    return queries, q_n


class DeferInsertMixin:
    """Shared deferred-insert policy for the graph indexes (HnswIndex /
    HnswPqIndex): pending adds buffer in a slot mask, searches overlay the
    pending rows exactly, and a threshold flush connects the whole batch
    with exact-kNN delta insertion (ops/hnsw_graph.bulk_insert_delta) —
    amortized ~an order of magnitude under per-add beam insertion.

    Host state lives here (one implementation — round-4 review: the two
    copies had already diverged on the heuristic flag); subclasses provide
    ``store``, ``graph``, ``config`` (m / flush_min / flush_frac /
    flush_max), ``_sample_levels``, the from-scratch ``_graph_insert``
    hook, and ``_graph_heuristic``.
    """

    _graph_heuristic: bool = True

    def _graph_insert(self, slots: np.ndarray) -> None:
        raise NotImplementedError

    def _init_pending(self, capacity: int) -> None:
        self._pending_mask = np.zeros(capacity, bool)
        self._pending_count = 0
        self._pending_pad_cache = None

    def _pend_slots(self, slots_np: np.ndarray) -> None:
        """Buffer new slots; flush when the batch amortizes.

        With ``config.flush_chunk > 0`` the threshold-triggered flush
        connects at most that many slots per call; the remaining pending
        rows stay exactly visible through the search overlay and drain on
        subsequent adds (or an explicit :meth:`flush_pending`).  The
        default stays 0 (unbounded); whether a chunk pays on the H100 is not
        measured (ROADMAP A6)."""
        self._pending_mask[slots_np] = True
        self._pending_count += len(slots_np)
        self._pending_pad_cache = None
        if self._pending_count >= self._flush_threshold():
            chunk = int(getattr(self.config, "flush_chunk", 0))
            self.flush_pending(limit=chunk if chunk > 0 else None)

    def _unpend_slot(self, slot: int) -> bool:
        """Drop a removed slot that never reached the graph; True if it
        was pending."""
        if self._pending_mask[slot]:
            self._pending_mask[slot] = False
            self._pending_count -= 1
            self._pending_pad_cache = None
            return True
        return False

    def _clear_pending(self) -> None:
        self._pending_mask[:] = False
        self._pending_count = 0
        self._pending_pad_cache = None

    def _flush_threshold(self) -> int:
        """Pending count that triggers a bulk flush: a fraction of the
        connected graph (delta-insert cost amortises against it), floored
        so tiny indexes never flush per-add and capped so the per-search
        overlay scan stays bounded."""
        graph_live = max(0, self.store.size() - self._pending_count)
        return max(self.config.flush_min,
                   min(int(self.config.flush_frac * graph_live),
                       self.config.flush_max))

    def flush_pending(self, limit: Optional[int] = None) -> None:
        """Connect pending slots to the graph (exact-kNN delta insert;
        from-scratch path when the graph is still empty).

        ``limit`` caps how many slots this call connects (lowest slot
        first); the rest stay pending and searchable via the overlay.
        ``None`` (the default, and what ``build``/``close`` paths use)
        connects everything."""
        if self._pending_count == 0:
            return
        slots = np.flatnonzero(self._pending_mask).astype(np.int32)
        if limit is not None and 0 < limit < slots.size:
            slots = slots[:limit]
            self._pending_mask[slots] = False
            self._pending_count -= int(slots.size)
            self._pending_pad_cache = None
        else:
            self._clear_pending()
        if slots.size == 0:
            return
        if int(self.graph.entry) < 0:
            self._graph_insert(slots)
            return
        from ..ops import hnsw_graph as hg

        st = self.store.state
        self.graph = hg.bulk_insert_delta(
            self.graph, st.vectors, st.norms, st.valid,
            slots, self._sample_levels(len(slots)),
            m=self.config.m, heuristic=self._graph_heuristic,
        )

    def _pending_padded(self):
        """Pending slots padded to a pow2 length with -1, as a CACHED
        device array (round-4 review: the O(capacity) mask scan + re-upload
        ran per search; now it is once per pending-set mutation)."""
        if self._pending_pad_cache is None:
            import jax.numpy as jnp

            slots = np.flatnonzero(self._pending_mask).astype(np.int32)
            n_pad = max(8, 1 << max(0, int(slots.size - 1).bit_length()))
            self._pending_pad_cache = jnp.asarray(np.concatenate(
                [slots, np.full(n_pad - slots.size, -1, np.int32)]))
        return self._pending_pad_cache


class VectorIndex(abc.ABC):
    """Batch-first ANN index over a device-resident corpus."""

    #: human-readable type tag, e.g. "hnsw", "pq"
    kind: str = "base"

    def __init__(self, dim: int, capacity: int, metric: str = "l2"):
        self.dim = dim
        self.capacity = capacity
        self.metric = metric

    # ------------------------------------------------------------- mutation
    @abc.abstractmethod
    def add_batch(self, ids: Sequence[int], vectors: np.ndarray) -> list[int]:
        """Insert vectors; returns the list of accepted external ids."""

    def add(self, vec_id: int, vector: np.ndarray) -> bool:
        """Insert one vector (reference: VectorIndex.addVector)."""
        return bool(self.add_batch([vec_id], np.asarray(vector, np.float32)[None, :]))

    @abc.abstractmethod
    def remove(self, vec_id: int) -> bool:
        """Remove by external id (tombstone; reference: removeVector)."""

    @abc.abstractmethod
    def build(self) -> None:
        """(Re)build internal structures from live vectors
        (reference: VectorIndex.buildIndex)."""

    # --------------------------------------------------------------- search
    @abc.abstractmethod
    def search_batch(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        """k-NN for a [Q, dim] query batch.

        Returns (ids [Q, k] int32 external ids with -1 padding,
                 dists [Q, k] float32 squared-L2 / cosine distances).
        """

    def search(self, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
        ids, dists = self.search_batch(np.asarray(query, np.float32)[None, :], k)
        return ids[0], dists[0]

    # ---------------------------------------------------------------- state
    @abc.abstractmethod
    def size(self) -> int:
        """Number of live vectors."""

    @abc.abstractmethod
    def get(self, vec_id: int) -> Optional[np.ndarray]:
        """Fetch a stored vector by external id."""

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        """Checkpointable host arrays. Subclasses extend with their own state
        (unlike the reference, whose native save/load are TODO stubs —
        native/index/HNSWIndex.cpp:535-541)."""
        return {}

    def load_state_arrays(self, arrays: dict) -> None:
        raise NotImplementedError

    # ------------------------------------------------------------- metadata
    def stats(self) -> dict:
        """Observability hook (reference: HnswIndex.getIndexStats :480-506)."""
        return {
            "kind": self.kind,
            "size": self.size(),
            "dim": self.dim,
            "capacity": self.capacity,
            "metric": self.metric,
        }
