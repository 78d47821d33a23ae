"""Brute-force exact kNN index — the compute floor and ground-truth oracle.

Analog of the reference's brute-force paths (reference:
benchmark/RecallOptimizationTest.java:152-164 computes GT this way;
index/IvfIndex.java:215-225 falls back to it).  One blocked distance matmul
plus a fused top-k; 100% recall by construction.  Every other index's
tests use this as the oracle (SURVEY.md §4.5).
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from ..core.store import VectorStore
from ..ops.distance import blocked_knn
from .base import VectorIndex, pad_queries_pow2, pow2


class BruteForceIndex(VectorIndex):
    kind = "brute"

    def __init__(self, dim: int, capacity: int, metric: str = "l2", block_n: int = 8192):
        super().__init__(dim, capacity, metric)
        self.store = VectorStore(capacity, dim)
        self.block_n = block_n

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors: np.ndarray) -> list[int]:
        accepted, _ = self.store.add_batch(ids, vectors)
        return accepted

    def remove(self, vec_id: int) -> bool:
        return self.store.remove(vec_id) is not None

    def build(self) -> None:  # nothing to build: the store IS the index
        pass

    # --------------------------------------------------------------- search
    def search_batch(
        self, queries: np.ndarray, k: int
    ) -> Tuple[np.ndarray, np.ndarray]:
        queries = np.asarray(queries, np.float32)
        if queries.ndim != 2 or queries.shape[1] != self.dim:
            raise ValueError(f"expected [*, {self.dim}] queries, got {queries.shape}")
        st = self.store.state
        padded, q_n = pad_queries_pow2(queries)
        k_eff = min(k, st.capacity)
        k_pad = min(pow2(k_eff), st.capacity)
        dists, slots = blocked_knn(
            jnp.asarray(padded),
            st.vectors,
            st.valid,
            k_pad,
            metric=self.metric,
            b_norms=st.norms,
            block_n=min(self.block_n, st.capacity),
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

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        return {"store": self.store.to_host()}

    def load_state_arrays(self, arrays: dict) -> None:
        self.store = VectorStore.from_host(arrays["store"])
