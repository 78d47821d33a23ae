"""Flat Product-Quantization index with exhaustive ADC scan.

Analog of the reference's PQ index (reference:
index/PqIndex.java — 8 subvectors x 256 clusters :42-44, train in buildIndex
:347-487, distance-table search :250-330; native/index/PQIndex.{h,cpp} —
blocked 8-way-unrolled ADC scan :165-198, parallel encode :215-256).

Here: training is one vmapped k-means over all subspaces as matmuls, encode is
one batched argmin matmul, and search is a blocked ADC scan with fused top-k.
An optional exact re-rank (``refine_k``) over the raw store lifts recall above
the reference's pure-ADC ranking.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..api.config import PqConfig
from ..core.store import VectorStore
from ..ops import adc
from ..ops.distance import blocked_knn
from ..ops.topk import smallest_k
from .base import VectorIndex, pad_queries_pow2, pow2


class PqIndex(VectorIndex):
    kind = "pq"

    def __init__(self, dim: int, capacity: int, metric: str = "l2", config: Optional[PqConfig] = None):
        import dataclasses

        # private copy: subspace auto-adjust must not leak into a config
        # object shared across indexes (same contract as HnswPqIndex)
        config = dataclasses.replace(config) if config else PqConfig()
        # auto-adjust subspaces so dim divides evenly
        # (reference: index/HnswPqIndex.java:78-84)
        sub = min(config.num_subspaces, dim)
        while dim % sub != 0:
            sub -= 1
        config.num_subspaces = sub
        super().__init__(dim, capacity, metric)
        self.config = config
        self.store = VectorStore(capacity, dim)
        self.codebooks: Optional[jax.Array] = None  # [S, K, sub_dim]
        self.codes = jnp.zeros((self.store.capacity, sub), jnp.uint8)
        self.trained = False
        self.seed = 42  # fixed seed everywhere (SURVEY.md §4.5)
        # ADC backend seam (the SIMDDispatcher analog): "decode" = PQ
        # decode + one matmul (the fast path); "gather"/"onehot" = blocked
        # distance-table scans (oracles)
        self.adc_impl = "decode"
        self._fast_cache: Optional[tuple] = None
        # variance-balancing dimension permutation (train-time,
        # config.balance_dims; PQ space = vectors[:, perm])
        self.perm: Optional[jax.Array] = None

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors: np.ndarray) -> list[int]:
        accepted, slots = self.store.add_batch(ids, vectors)
        if accepted and self.trained:
            self._encode_slots(np.asarray(slots, np.int64))
        return accepted

    def remove(self, vec_id: int) -> bool:
        return self.store.remove(vec_id) is not None

    # --------------------------------------------------------------- train
    def train(self) -> bool:
        """Train codebooks on the live corpus (reference: trainCentroids
        :384-487 runs on all stored vectors)."""
        from ..ops.kmeans import subspace_kmeans_fit

        n = self.store.size()
        if n < self.config.num_centroids:
            return False
        st = self.store.state
        # compact live rows to the front so k-means sees a dense sample
        live = np.flatnonzero(np.asarray(st.valid))
        data = jnp.asarray(np.asarray(st.vectors)[live])
        if self.metric == "cosine":
            # quantize the unit sphere so L2-ranked ADC == cosine ranking
            # (see HnswPqIndex._pq_space)
            from ..ops.distance import normalize_rows

            data = normalize_rows(data)
        if self.config.balance_dims:
            v = np.asarray(jnp.var(data, axis=0))
            self.perm = jnp.asarray(
                adc.balanced_subspace_perm(v, self.config.num_subspaces)
            )
            data = data[:, self.perm]
        self.codebooks = subspace_kmeans_fit(
            jax.random.PRNGKey(self.seed),
            data,
            self.config.num_subspaces,
            k=self.config.num_centroids,
            iters=self.config.training_iterations,
            plus_plus=False,  # reference flat-PQ uses random init (PqIndex.java:384)
        )
        self.trained = True
        self._encode_slots(live)
        return True

    def build(self) -> None:
        """reference: PqIndex.buildIndex :347 — train + encode everything."""
        self.train()

    def _encode_slots(self, slots: np.ndarray) -> None:
        if slots.size == 0:
            return
        vecs = self.store.state.vectors[jnp.asarray(slots)]
        if self.metric == "cosine":
            from ..ops.distance import normalize_rows

            vecs = normalize_rows(vecs)
        if self.perm is not None:
            vecs = vecs[:, self.perm]
        new_codes = adc.pq_encode(vecs, self.codebooks)
        self.codes = self.codes.at[jnp.asarray(slots)].set(new_codes)
        self._fast_cache = None

    def _fast_tables(self):
        if self._fast_cache is None:
            ct = jnp.transpose(self.codes, (1, 0))
            cbt = adc.codebooks_to_cbt(self.codebooks)
            r32 = adc.pq_decode_recon_t(ct, cbt).astype(jnp.float32)
            self._fast_cache = (ct, cbt, jnp.sum(r32 * r32, axis=0))
        return self._fast_cache

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
            # brute-force fallback (reference: PqIndex.java:257-267)
            dists, slots = blocked_knn(
                jnp.asarray(padded), st.vectors, st.valid, k_pad,
                metric=self.metric, b_norms=st.norms,
                block_n=min(8192, st.capacity),
            )
            return self._to_external(q_n, k, k_eff, slots, dists)

        refine_k = self.config.refine_k
        if self.metric == "cosine":
            # ADC tables are subspace squared-L2; with refine_k=0 those values
            # would be reported as cosine distances.  Force an exact cosine
            # refine so the result currency matches every other index (the
            # L2-ranked ADC shortlist is the candidate generator only).
            refine_k = max(refine_k, 4 * k_eff, 64)

        q_adc = padded
        if self.metric == "cosine":
            # codes hold normalized rows; normalize the query for the scan
            q_adc = padded / np.maximum(
                np.linalg.norm(padded, axis=1, keepdims=True), 1e-12)

        def adc_topk(r):
            if self.adc_impl == "decode":
                ct, cbt, cnorms = self._fast_tables()
                return adc.adc_decode_topk(
                    jnp.asarray(q_adc), ct, cbt, st.valid, r,
                    code_norms=cnorms, perm=self.perm,
                )
            q_pq = (q_adc if self.perm is None
                    else np.asarray(q_adc)[:, np.asarray(self.perm)])
            tables = adc.build_distance_tables(
                jnp.asarray(q_pq), self.codebooks
            )
            return adc.adc_scan_topk(
                tables, self.codes, st.valid, r,
                block_n=min(4096, st.capacity), impl=self.adc_impl,
            )

        if refine_k and refine_k > k_eff:
            # ADC shortlist then exact re-rank over the raw store
            r = min(pow2(refine_k), st.capacity)
            _, cand = adc_topk(r)
            dists, slots = _refine_exact(
                jnp.asarray(padded), st.vectors, cand, k_pad, self.metric
            )
        else:
            dists, slots = adc_topk(k_pad)
        return self._to_external(q_n, k, k_eff, slots, dists)

    def _to_external(self, q_n, k, k_eff, slots, dists):
        slots_np = np.asarray(slots)[:q_n, :k_eff]
        ids_np = np.asarray(self.store.state.ids)
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
            num_subspaces=self.config.num_subspaces,
            num_centroids=self.config.num_centroids,
            compression_ratio=4.0 * self.dim / self.config.num_subspaces,
            code_bytes=self.store.capacity * self.config.num_subspaces,
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        out = {"store": self.store.to_host(), "codes": np.asarray(self.codes)}
        out["trained"] = np.asarray([self.trained])
        if self.codebooks is not None:
            out["codebooks"] = np.asarray(self.codebooks)
        if self.perm is not None:
            out["perm"] = np.asarray(self.perm)
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        self.store = VectorStore.from_host(arrays["store"])
        self.codes = jnp.asarray(arrays["codes"])
        self._fast_cache = None
        self.trained = bool(np.asarray(arrays["trained"])[0])
        self.codebooks = (
            jnp.asarray(arrays["codebooks"]) if "codebooks" in arrays else None
        )
        self.perm = jnp.asarray(arrays["perm"]) if "perm" in arrays else None


import functools


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _refine_exact(queries, base, cand_slots, k, metric):
    """Exact re-rank of candidate slots (reference: HnswPqIndex re-rank
    :647-664).  cand_slots: [Q, R] with -1 padding."""
    safe = jnp.maximum(cand_slots, 0)
    cand_vecs = base[safe]  # [Q, R, d]
    diff_ok = cand_slots >= 0
    if metric == "l2":
        d = jnp.sum((cand_vecs - queries[:, None, :]) ** 2, axis=2)
    else:
        qn = jnp.linalg.norm(queries, axis=1, keepdims=True)
        vn = jnp.linalg.norm(cand_vecs, axis=2)
        dot = jnp.einsum("qd,qrd->qr", queries, cand_vecs)
        d = 1.0 - dot / jnp.maximum(qn * vn, 1e-12)
    d = jnp.where(diff_ok, d, jnp.inf)
    return smallest_k(d, k, cand_slots)
