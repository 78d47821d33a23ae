"""HNSW+PQ flagship index — compressed codes + graph + exact re-rank.

Analog of the reference flagship (reference:
index/HnswPqIndex.java — lazy training on first min(10000, max/10) vectors
:170-175, per-subspace k-means :194-293, exact-distance graph build ("Fix #4")
:491-499, two-stage search: PQ candidate generation + exact re-rank
:616-664; native/index/HNSWPQIndex.{h,cpp} — pqM=64, pqBits=8, refine pool).

Batched redesign (SURVEY.md §7.3.2): the reference's recall fixes turned its
search into a near-brute-force scan over a PQ-pruned pool (efSearch = 15% of
N!).  With matrix units that observation inverts the architecture: the
search paths are **exhaustive scans** (matmuls over contiguous blocks)
followed by an exact re-rank of a small pool.  The HNSW graph is still built
(exact distances, like the reference) and serves the graph-traversal search
path (``config.use_graph=True``) — sequential beam expansion is gather- and
dispatch-bound, so the graph mode exists for reference-parity semantics,
incremental single-insert workloads, and stats — never as the speed path
(`_auto_scan_mode` always routes auto to a scan: the blocked f32 exact scan
up to ~700k live rows, the int8 pool scan above that).
"""

from __future__ import annotations

import functools
import threading
from typing import NamedTuple, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..api.config import HnswPqConfig
from ..core.store import VectorStore
from ..ops import adc
from ..ops import hnsw_graph as hg
from ..ops.distance import blocked_knn
from ..ops.topk import smallest_k
from .base import DeferInsertMixin, VectorIndex, pad_queries_pow2, pow2
from .pq import _refine_exact  # noqa: F401 (re-exported; pq tests import via here)



def _with_cache_lock(fn):
    """Serialize a lazy cache-refresh accessor among concurrent readers
    (the refresh kernels donate the previous cache arrays — see
    HnswPqIndex._cache_lock)."""
    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._cache_lock:
            return fn(self, *a, **k)
    return wrapper


class HnswPqIndex(DeferInsertMixin, VectorIndex):
    kind = "hnswpq"

    def __init__(
        self,
        dim: int,
        capacity: int,
        metric: str = "l2",
        config: Optional[HnswPqConfig] = None,
    ):
        import dataclasses

        # private copy: the ctor adjusts num_subspaces/refine_store below,
        # and a config object shared across indexes must not inherit that
        # (the same aliasing contract as Builder.with_search_mode)
        config = dataclasses.replace(config) if config else HnswPqConfig()
        sub = min(config.num_subspaces, dim)
        while dim % sub != 0:  # auto-adjust (reference: HnswPqIndex.java:78-84)
            sub -= 1
        config.num_subspaces = sub
        super().__init__(dim, capacity, metric)
        if not config.raw_store:
            # the >HBM compressed regime (see HnswPqConfig.raw_store): no
            # [cap, dim] f32 matrix exists — validate up front so the user
            # gets one clear error instead of a deep-path attribute failure
            if dim % 4 != 0:
                raise ValueError("raw_store=False requires dim % 4 == 0")
            if config.use_graph:
                raise ValueError(
                    "raw_store=False is incompatible with use_graph=True "
                    "(graph construction reads raw rows); use the scan modes"
                )
            if config.search_mode in ("scan_exact", "scan_pallas",
                                      "scan_bf16", "graph"):
                raise ValueError(
                    f"search_mode={config.search_mode!r} needs the raw f32 "
                    "store; with raw_store=False use adc_fast | pca | adc | "
                    "scan_int8 | scan_pallas_int8 | auto"
                )
            config.refine_store = "int8"
        elif config.refine_residual:
            raise ValueError(
                "refine_residual=True needs the compressed store "
                "(raw_store=False); the raw tier's f32 rows are already "
                "exact refine sources"
            )
        self.config = config
        self.store = VectorStore(capacity, dim, raw=config.raw_store,
                                 residual=config.refine_residual)
        self.codes = jnp.zeros((self.store.capacity, sub), jnp.uint8)
        self.codebooks: Optional[jax.Array] = None
        self.trained = False
        self.seed = 42
        # one-hot-matmul ADC (the gather variant is the alternative; which
        # is faster on the H100 is not measured); recall is preserved by the
        # exact refine stage
        self.adc_impl = "onehot"
        # graph state (exact-distance build, like reference Fix #4)
        self._max_level = max(
            1, int(np.log(max(self.store.capacity, 2)) / np.log(max(config.m, 2))) + 1
        )
        self.graph = hg.init_graph(self.store.capacity, config.m, self._max_level)
        self._level_counter = 0
        self._graph_dirty: list[int] = []  # slots added before training
        # defer insert policy (config.insert_policy): trained graph-mode adds
        # buffer here; searches fold pending rows into the exact refine pool
        self._init_pending(self.store.capacity)
        # optional IVF coarse quantizer for pruned scans (config.nlist > 0)
        self.coarse_centroids: Optional[jax.Array] = None  # [nlist, dim]
        self.coarse_assign = np.full(self.store.capacity, -1, np.int32)
        self._members: Optional[jax.Array] = None
        self._overflow: Optional[jax.Array] = None
        self._members_dirty = True
        # adc_fast derived state (codes transposed + gather-layout codebooks),
        # rebuilt lazily after any encode/train
        self._fast_cache: Optional[tuple] = None
        # variance-balancing dimension permutation (set at train time when
        # config.balance_dims; PQ space = vectors[:, perm])
        self.perm: Optional[jax.Array] = None
        # bf16-packed refine shadow (config.refine_store="bf16"), keyed on
        # the store's immutable vectors array
        self._packed_cache: Optional[tuple] = None
        # bf16 scan shadow for the bf16 pool scan
        # (search_mode="scan_pallas"), keyed on the vectors array
        self._scan16_cache: Optional[tuple] = None
        # int8 scan shadow for the s8 x s8 pool scan
        # (search_mode="scan_pallas_int8"), keyed like _scan16_cache
        self._scan8_cache: Optional[tuple] = None
        # GLOBAL-scale int8 shadow for the integer-epilogue pool scan
        # (int8_epilogue="global"), keyed like _scan8_cache
        self._scan8g_cache: Optional[tuple] = None
        # packed-store conditioning vectors (scan_pallas_int8 on the
        # compressed tier — no corpus copy, just off/sc/center)
        self._scan8p_cache: Optional[tuple] = None
        # cluster-major balanced layout for the cluster-pruned scan
        # (search_mode="scan_ivf"; ops/ivf_scan) + its exact-overlay set:
        # rows mutated since the last relayout are disabled in the grid and
        # scored exactly alongside the refine (like the graph's pending
        # overlay); past _IVF_OVERLAY_MAX the next search relayouts
        self._ivf_cache: Optional[tuple] = None
        self._ivf_overlay = np.empty(0, np.int64)
        self._ivf_overlay_dev: Optional[jax.Array] = None
        # dirty-slot records for INCREMENTAL cache maintenance (one per
        # cache family): [] = complete record (nothing dirty); list of
        # slot arrays = incrementally updatable; None = unknown writer
        # touched the store (next consumer does a full rebuild).  Keeps
        # churn-heavy large-N workloads off the O(N*d) rebuild cliffs
        # (~1 s/1M rows per shadow).
        self._scan8_dirty: Optional[list] = []   # int8 scan shadow
        self._scan8g_dirty: Optional[list] = []  # global int8 scan shadow
        self._scan16_dirty: Optional[list] = []  # bf16 scan shadow
        self._pack_dirty: Optional[list] = []    # packed refine shadows
        self._fast_dirty: Optional[list] = []    # ADC tables (ct/cnorms)
        self._ivf_dirty: Optional[list] = []     # scan_ivf layout overlay
        self._scan8_aux: Optional[jax.Array] = None  # musq (l2) / c0 (cos)
        self._scan8g_aux: Optional[jax.Array] = None  # musq (l2) / c0 (cos)
        # rows that clipped at +-127 against the cached global sv since the
        # last full _build_scan8g_shadow (a non-trivial clipped
        # fraction biases pool selection -> force a rebuild)
        self._scan8g_clipped: int = 0
        self._scan16_aux = None  # (musq, mean_norm) (l2) / (c0,) (cos)
        # serializes the lazy cache refreshes among CONCURRENT READERS:
        # the incremental update kernels DONATE the previous cache arrays,
        # so two searches racing into a refresh would hand the same donated
        # buffer to two device calls (writer-vs-reader exclusion is the
        # facade RWLock's job — utils/locks.py; this lock is only for
        # reader-vs-reader refresh races, and refreshes are short)
        # RLock: _ivf_layout holds it while consulting the scan shadows
        # (themselves lock-guarded) for its conditioning vectors
        self._cache_lock = threading.RLock()
        # PCA-proxy state (config.proxy_dims > 0; ops/pca): mean/basis fit
        # at train time, proxy rows [cap, p] bf16 maintained per encode
        self.pca_mean: Optional[jax.Array] = None
        self.pca_basis: Optional[jax.Array] = None
        self.proxy: Optional[jax.Array] = None
        self._proxy_norms: Optional[jax.Array] = None

    # ------------------------------------------------------------- helpers
    def _sample_levels(self, n: int) -> np.ndarray:
        rng = np.random.default_rng(self.seed * 1_000_003 + self._level_counter)
        self._level_counter += 1
        u = rng.uniform(1e-12, 1.0, n)
        ml = 1.0 / np.log(max(self.config.m, 2))
        return np.clip(
            np.floor(-np.log(u) * ml).astype(np.int32), 0, self._max_level - 1
        )

    # ------------------------------------------------------------- mutation
    # row-mutation records (store rows changed -> shadow rows requantize);
    # _fast_dirty is NOT here: the ADC tables derive from CODES, which only
    # change in _encode_slots (recording row mutations there too would burn
    # its degrade-to-None churn budget twice as fast, and removals — which
    # never touch codes — would void it for nothing)
    _DIRTY_RECORDS = ("_scan8_dirty", "_scan8g_dirty", "_scan16_dirty",
                      "_pack_dirty", "_ivf_dirty")
    _ALL_DIRTY = _DIRTY_RECORDS + ("_fast_dirty",)

    def _note_row_mutation(self, slots: np.ndarray) -> None:
        """Record store-row mutations for incremental cache refreshes
        (see _scan8_shadow / _scan16_shadow / the packed refine shadows).
        Over-threshold churn degrades that record to a full rebuild
        (None)."""
        arr = np.asarray(slots, np.int64).ravel()
        limit = max(8192, self.store.capacity // 8)
        for attr in self._DIRTY_RECORDS:
            rec = getattr(self, attr)
            if rec is None:
                continue
            rec.append(arr)
            if sum(a.size for a in rec) > limit:
                setattr(self, attr, None)

    def _note_store_rewrite(self) -> None:
        """An untracked bulk rewrite of the store (bulk_load / streamed
        ingest / checkpoint load) — every incremental record is void."""
        for attr in self._ALL_DIRTY:
            setattr(self, attr, None)

    def _take_dirty(self, attr: str):
        """Consume a dirty record: unique slots padded to a pow2 length
        (fewer jit specializations; duplicate scatters write identical
        values), or None when the record is empty/void."""
        rec = getattr(self, attr)
        if not rec or sum(a.size for a in rec) == 0:
            return None
        slots = np.unique(np.concatenate(rec))
        n_pad = 1 << max(0, int(slots.size - 1).bit_length())
        slots = np.concatenate(
            [slots, np.full(n_pad - slots.size, slots[0], slots.dtype)]
        ).astype(np.int32)
        return jnp.asarray(slots)

    def add_batch(self, ids: Sequence[int], vectors: np.ndarray) -> list[int]:
        accepted, slots = self.store.add_batch(ids, vectors)
        if not accepted:
            return []
        slots_np = np.asarray(slots, np.int32)
        self._note_row_mutation(slots_np)
        if not self.trained:
            # lazy training (reference: HnswPqIndex.java:170-175): buffer until
            # the training threshold, then train + encode + build everything
            self._graph_dirty.extend(slots_np.tolist())
            threshold = min(self.config.training_samples, max(self.capacity // 10, 256))
            if self.store.size() >= max(threshold, self.config.num_centroids):
                self.train()
        else:
            self._encode_slots(slots_np)
            if self.coarse_centroids is not None:
                self._assign_coarse(slots_np)
            if self.config.use_graph:
                if self.config.insert_policy == "defer":
                    self._pend_slots(slots_np)
                else:
                    self._insert_graph(slots_np)
        return accepted

    # --------------------------------------- defer insert policy (mixin hook)
    def _graph_insert(self, slots: np.ndarray) -> None:
        self._insert_graph(slots)  # from-scratch path (exact-kNN bulk build)

    def bulk_load(self, ids: Sequence[int], vectors) -> list[int]:
        """Zero-copy bulk ingest of a device-resident corpus + train.
        (See VectorStore.bulk_load.)"""
        accepted = self.store.bulk_load(ids, vectors)
        self._note_store_rewrite()  # bulk rewrite -> full cache rebuilds
        if accepted:
            self.train()
        return accepted

    def bulk_load_stream(self, chunks) -> int:
        """Streamed bulk ingest — the raw corpus never exists in full.

        ``chunks`` yields ``(ids, vectors)`` pairs: ids [c] ints, vectors
        [c, dim] float32 (device-resident arrays skip the host->device
        transfer).  Rows land in contiguous slots
        in arrival order.  The FIRST chunk trains the quantizers (PQ
        codebooks + optional PCA proxy + coarse lists) and therefore should
        be a representative sample of >= ``config.num_centroids`` rows;
        every chunk then flows through ONE donated jit step that writes the
        store (raw or int8-packed), the PQ codes, and the proxy — at no
        point is more than one raw f32 chunk resident.

        This is the ingest path for the >HBM regime (raw_store=False): at
        10M x 512 the donated step keeps peak HBM at resident-compressed
        (~7 GB) + one chunk (~270 MB), where a plain bulk_load would need
        the 20 GB raw matrix.  reference: the N >> memory roadmap,
        PERFORMANCE_BENCHMARK_AND_ROADMAP.md:475-525.

        Returns the number of rows ingested.  Use equal-sized chunks where
        possible: each distinct chunk length compiles the step once.
        """
        if self.store.size() > 0:
            raise ValueError("bulk_load_stream requires an empty index")
        self._note_store_rewrite()  # streamed rewrite -> full cache rebuilds
        if self.config.use_graph:
            raise ValueError(
                "bulk_load_stream does not build the HNSW graph; "
                "use use_graph=False (scan/adc/pca modes) or bulk_load"
            )
        state = self.store.state
        cap = state.capacity
        codes = self.codes
        proxy = None
        start = 0
        assigns: list[np.ndarray] = []
        id_map = self.store._id_to_slot  # updated per chunk (crash-safe:
        # on a mid-stream exception every WRITTEN row is tracked)
        try:
            for ids, vecs in chunks:
                ids_np = np.asarray(ids, np.int32)
                vecs = jnp.asarray(vecs, jnp.float32)
                c = vecs.shape[0]
                # validate BEFORE writing anything of this chunk — a late
                # global check would leave committed ghost rows behind
                if vecs.ndim != 2 or vecs.shape[1] != self.dim:
                    raise ValueError(
                        f"expected [*, {self.dim}] chunk, got {vecs.shape}")
                if len(ids_np) != c:
                    raise ValueError("ids/vectors length mismatch in chunk")
                if start + c > cap:
                    raise ValueError(
                        f"stream exceeds capacity: {start + c} > {cap}")
                if np.any(ids_np < 0):
                    raise ValueError("negative ids in bulk_load_stream")
                if np.unique(ids_np).size != c:
                    raise ValueError("duplicate ids within a chunk")
                if any(int(v) in id_map for v in ids_np):
                    raise ValueError("duplicate ids across chunks")
                if not self.trained:
                    self._fit_quantizers(vecs)
                    if self.proxy is not None:
                        proxy = self.proxy
                state, codes, proxy, assign = _stream_ingest_step(
                    state, codes, proxy, vecs,
                    jnp.asarray(ids_np), jnp.int32(start),
                    self.codebooks, self.perm, self.pca_mean, self.pca_basis,
                    self.coarse_centroids, self.metric,
                )
                if assign is not None:
                    assigns.append(np.asarray(assign))
                id_map.update(zip(ids_np.tolist(), range(start, start + c)))
                start += c
                # keep self pointing at LIVE buffers: the step donates its
                # inputs, so the previous state/codes/proxy objects are dead
                self.store.state = state
                self.codes = codes
                if proxy is not None:
                    self.proxy = proxy
        finally:
            # slot bookkeeping reflects whatever was actually written, even
            # when a later chunk raised
            self.store._free = list(range(cap - 1, start - 1, -1))
            if proxy is not None:
                self._proxy_norms = None
            self._fast_cache = None
            if assigns:
                done = np.concatenate(assigns)
                self.coarse_assign[:done.size] = done
                self._members_dirty = True
        return start

    def _fit_quantizers(self, data: jax.Array) -> None:
        """Fit PQ codebooks (+ optional PCA proxy + coarse quantizer) from a
        device-resident training sample [n, dim] — the train() core for the
        streamed path, where the sample is the first chunk rather than a
        gather from the store.  Does NOT encode anything."""
        from ..ops.kmeans import subspace_kmeans_fit
        from ..ops.distance import normalize_rows

        n = data.shape[0]
        if n < self.config.num_centroids:
            raise ValueError(
                f"first chunk must hold >= {self.config.num_centroids} "
                f"training rows, got {n}"
            )
        sample = data
        if n > self.config.training_samples:
            rng = np.random.default_rng(self.seed)
            pick = np.sort(rng.choice(n, self.config.training_samples,
                                      replace=False))
            sample = data[jnp.asarray(pick)]
        pq_data = normalize_rows(sample) if self.metric == "cosine" else sample
        if self.config.balance_dims:
            v = np.asarray(jnp.var(pq_data, axis=0))
            self.perm = jnp.asarray(
                adc.balanced_subspace_perm(v, self.config.num_subspaces)
            )
            pq_data = pq_data[:, self.perm]
        self.codebooks = subspace_kmeans_fit(
            jax.random.PRNGKey(self.seed),
            pq_data,
            self.config.num_subspaces,
            k=self.config.num_centroids,
            iters=self.config.training_iterations,
            plus_plus=True,
        )
        self.trained = True
        if self.config.proxy_dims > 0 and self.config.search_mode == "pca":
            from ..ops import pca

            p = min(self.config.proxy_dims, self.dim)
            raw = np.asarray(sample)
            if self.metric == "cosine":
                raw = raw / np.maximum(
                    np.linalg.norm(raw, axis=1, keepdims=True), 1e-12)
            mu, basis = pca.pca_fit(raw, p)
            self.pca_mean = jnp.asarray(mu)
            self.pca_basis = jnp.asarray(basis)
            self.proxy = jnp.zeros((self.store.capacity, p), jnp.bfloat16)
        if self.config.nlist == 0 and self.config.search_mode == "scan_ivf":
            # streamed ingest: the final live count is unknown mid-stream,
            # so auto-size the coarse quantizer from the store capacity
            from ..ops.ivf_scan import auto_ivf_geometry

            self.config.nlist = auto_ivf_geometry(
                self.store.capacity, winners=self.config.ivf_winners)[0]
        if self.config.nlist > 0:
            nlist = min(self.config.nlist, max(1, n // 8))
            full = normalize_rows(data) if self.metric == "cosine" else data
            coarse_cap = max(256 * nlist, 262144)
            if n > coarse_cap:
                rng = np.random.default_rng(self.seed + 7)
                full = full[jnp.asarray(np.sort(
                    rng.choice(n, coarse_cap, replace=False)))]
            self.coarse_centroids = self._coarse_kmeans(full, nlist)

    def _coarse_kmeans(self, full: jax.Array, nlist: int) -> jax.Array:
        """Train the coarse quantizer (seed+1, random init + Lloyd — ++
        seeding is a sequential k-step loop and random init converges on
        the full sample).  Routes through the row-blocked Lloyd when the
        dense [sample, nlist] one-hot would be HBM-hostile (scan_ivf-scale
        nlist: ~24 GB per Lloyd step at the 10M tier's auto nlist≈4883);
        the blocked path trims the sample to a chunk multiple — a few
        training rows, never corpus rows."""
        from ..ops.kmeans import kmeans_fit, kmeans_fit_blocked

        rows = int(full.shape[0])
        if rows * nlist > (1 << 27):
            chunk = max(128, min(rows, (1 << 26) // nlist) // 128 * 128)
            rows_r = rows // chunk * chunk
            return kmeans_fit_blocked(
                jax.random.PRNGKey(self.seed + 1), full[:rows_r], k=nlist,
                iters=self.config.training_iterations, chunk=chunk)
        return kmeans_fit(
            jax.random.PRNGKey(self.seed + 1), full, k=nlist,
            iters=self.config.training_iterations, plus_plus=False)[0]

    def remove(self, vec_id: int) -> bool:
        slot = self.store.remove(vec_id)
        if slot is None:
            return False
        self._note_row_mutation(np.asarray([slot]))
        self.coarse_assign[slot] = -1
        self._members_dirty = True
        if self.config.use_graph and self._unpend_slot(slot):
            return True  # never reached the graph
        if self.config.use_graph and int(self.graph.entry) == slot:
            self.graph = hg.unlink_slot(self.graph, jnp.asarray(slot, jnp.int32))
            levels = np.asarray(self.graph.levels)
            valid = np.asarray(self.store.state.valid)
            live = np.flatnonzero(valid & (levels >= 0))
            if live.size:
                ne = int(live[np.argmax(levels[live])])
                self.graph = self.graph.replace(
                    entry=jnp.asarray(ne, jnp.int32),
                    entry_level=jnp.asarray(int(levels[ne]), jnp.int32),
                )
            else:
                self.graph = self.graph.replace(
                    entry=jnp.asarray(-1, jnp.int32),
                    entry_level=jnp.asarray(-1, jnp.int32),
                )
        elif self.config.use_graph:
            self.graph = hg.unlink_slot(self.graph, jnp.asarray(slot, jnp.int32))
        return True

    # --------------------------------------------------------------- train
    def train(self) -> bool:
        """Per-subspace k-means on the live corpus (reference:
        HnswPqIndex.train :194-293 — k-means++ seeding, seed 42+subspace)."""
        from ..ops.kmeans import subspace_kmeans_fit

        n = self.store.size()
        if n < self.config.num_centroids:
            return False
        st = self.store.state
        live = np.flatnonzero(np.asarray(st.valid))
        sample = live
        cap_samples = self.config.training_samples
        if sample.size > cap_samples:
            rng = np.random.default_rng(self.seed)
            sample = rng.choice(sample, cap_samples, replace=False)
        data = self.store.rows(np.sort(sample))
        if self.metric == "cosine":
            from ..ops.distance import normalize_rows

            data = normalize_rows(data)
        if self.config.balance_dims:
            # variance-balanced dimension permutation (see ops/adc.
            # balanced_subspace_perm): variances computed on device, the
            # tiny [d] vector is the only transfer
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
            plus_plus=True,
        )
        self.trained = True
        if self.config.proxy_dims > 0 and self.config.search_mode == "pca":
            # PCA-proxy basis on the (unpermuted) training sample (ops/pca);
            # fitted ONLY for the pca mode — other modes must not pay the
            # sample re-gather, per-encode projection, or checkpoint bytes
            from ..ops import pca

            p = min(self.config.proxy_dims, self.dim)
            raw = np.asarray(self.store.rows(np.sort(sample)))
            if self.metric == "cosine":
                # proxy space = normalized rows (see ops/pca cosine contract)
                raw = raw / np.maximum(
                    np.linalg.norm(raw, axis=1, keepdims=True), 1e-12)
            mu, basis = pca.pca_fit(raw, p)
            self.pca_mean = jnp.asarray(mu)
            self.pca_basis = jnp.asarray(basis)
            self.proxy = jnp.zeros((self.store.capacity, p), jnp.bfloat16)
        self._encode_slots(live)
        if self.config.nlist == 0 and self.config.search_mode == "scan_ivf":
            # auto-size the coarse quantizer for the cluster-pruned tier
            # (sticky: the layout geometry keys off it)
            from ..ops.ivf_scan import auto_ivf_geometry

            self.config.nlist = auto_ivf_geometry(
                live.size, winners=self.config.ivf_winners)[0]
        if self.config.nlist > 0:
            nlist = min(self.config.nlist, max(1, live.size // 8))
            # the coarse quantizer trains on the FULL live set: subsampling
            # (20 pts/centroid) collapses centroids and produces mega-clusters
            # that blow up the padded member table; full-data k-means is a few
            # TFLOP of matmuls.  Above ~256 rows/centroid the estimate is
            # converged, so cap the sample there (a 10M-row gather would
            # otherwise materialise 20 GB in the compressed regime).

            coarse_rows = live
            coarse_cap = max(256 * nlist, 262144)
            if coarse_rows.size > coarse_cap:
                rng = np.random.default_rng(self.seed + 7)
                coarse_rows = np.sort(
                    rng.choice(coarse_rows, coarse_cap, replace=False))
            full = self.store.rows(coarse_rows)
            if self.metric == "cosine":
                from ..ops.distance import normalize_rows

                full = normalize_rows(full)  # coarse quantizer on the sphere
            self.coarse_centroids = self._coarse_kmeans(full, nlist)
            if self.config.search_mode != "scan_ivf":
                # scan_ivf places rows via its own balanced top-A pass
                # (ops/ivf_scan.coarse_choices, device-only) — the full-live
                # member assignment here would materialise [N, d] f32 rows
                # (20 GB at 10M compressed) for a table scan_ivf never reads
                self._assign_coarse(live)
        if self.config.use_graph:
            self._rebuild_graph()
        self._graph_dirty.clear()
        return True

    def _assign_coarse(self, slots: np.ndarray) -> None:
        from ..ops.distance import normalize_rows, pairwise_sq_l2

        vecs = self.store.rows(slots)
        if self.metric == "cosine":
            vecs = normalize_rows(vecs)  # centroids live on the sphere
        d = pairwise_sq_l2(vecs, self.coarse_centroids)
        self.coarse_assign[slots] = np.asarray(jnp.argmin(d, axis=1))
        self._members_dirty = True

    @_with_cache_lock
    def _member_table(self) -> tuple[jax.Array, int, jax.Array]:
        """Quota-capped [nlist, L] member-slot table + overflow list.

        Padding to the LARGEST cluster explodes the per-query gather when
        k-means produces a mega-cluster (observed: one 2.2k-member cluster at
        100k/1024 lists -> a 9 GB candidate gather).  Instead each cluster
        keeps at most a quota (4x the mean size); members beyond the quota
        spill into a shared overflow list that every query scans — bounded
        candidate width, no recall cliff.
        """
        if self._members is not None and not self._members_dirty:
            return self._members, self._members.shape[1], self._overflow
        from ..core.member_table import build_member_table

        table, max_len, over = build_member_table(
            self.coarse_assign, np.asarray(self.store.state.valid),
            int(self.coarse_centroids.shape[0]), quota_mult=4.0, align=32,
        )
        self._members = jnp.asarray(table)
        self._overflow = jnp.asarray(over)
        self._members_dirty = False
        return self._members, max_len, self._overflow

    def build(self) -> None:
        """reference: HnswPqIndex.buildIndex :677-718 — train if needed, then
        re-encode + rebuild the graph."""
        if not self.trained:
            self.train()
        else:
            live = np.flatnonzero(np.asarray(self.store.state.valid))
            self._encode_slots(live)
            if self.config.use_graph:
                self._rebuild_graph()

    def _encode_slots(self, slots: np.ndarray) -> None:
        if slots is None or self.codebooks is None:
            return
        slots = np.asarray(slots)
        if slots.size == 0:
            return
        # chunked: the row gather dequantizes/slices [c, dim] f32 — at 10M
        # live slots an unchunked gather would transiently materialise the
        # full raw matrix (20 GB at 512d), defeating the compressed store
        chunk = 1 << 18
        for s in range(0, slots.size, chunk):
            self._encode_slots_chunk(slots[s:s + chunk])
        # codes changed for these slots: the ADC tables refresh
        # incrementally.  This is the ONLY writer of _fast_dirty — codes
        # change nowhere else (removals flip `valid` only; bulk loads void
        # the record via _note_store_rewrite).
        if self._fast_dirty is not None:
            self._fast_dirty.append(np.asarray(slots, np.int64).ravel())
            if (sum(a.size for a in self._fast_dirty)
                    > max(8192, self.store.capacity // 8)):
                self._fast_dirty = None

    def _encode_slots_chunk(self, slots: np.ndarray) -> None:
        sl = jnp.asarray(slots)
        vecs = self.store.rows(sl)
        if self.proxy is not None:
            from ..ops import pca

            from ..ops.distance import normalize_rows

            pv = normalize_rows(vecs) if self.metric == "cosine" else vecs
            self.proxy = self.proxy.at[sl, :].set(
                pca.project_rows(pv, self.pca_mean, self.pca_basis)
            )
            self._proxy_norms = None
        new_codes = adc.pq_encode(self._pq_space(vecs), self.codebooks)
        self.codes = self.codes.at[sl].set(new_codes)

    def _pq_space(self, vecs):
        """Vectors as the quantizer sees them: normalized first under
        cosine (PQ encodes the unit sphere so quantized-L2 ranking equals
        cosine ranking), then dimension-permuted."""
        from ..ops.distance import normalize_rows

        if self.metric == "cosine":
            vecs = normalize_rows(vecs)
        if self.perm is not None:
            vecs = vecs[:, self.perm]
        return vecs

    @_with_cache_lock
    def _packed_refine_store(self, st):
        """bf16-packed refine shadow (config.refine_store="bf16"), cached on
        the store's immutable vectors array; None -> refine reads raw f32.

        The pack is per-row and stateless, so mutations recorded in
        _pack_dirty repack ONLY the dirty rows (bit-identical to a full
        rebuild) — steady churn pays O(dirty * d), not O(N * d)."""
        if self.config.refine_store != "bf16" or not self.store.raw:
            return None
        if (self._packed_cache is not None
                and self._packed_cache[0] is st.vectors):
            return self._packed_cache[1]
        slots = (self._take_dirty("_pack_dirty")
                 if self._packed_cache is not None else None)
        if slots is not None:
            self._packed_cache = (
                st.vectors,
                _update_packed_bf16(self._packed_cache[1], st.vectors,
                                    slots),
            )
        else:
            from ..ops.distance import pack_bf16_rows

            self._packed_cache = (st.vectors, pack_bf16_rows(st.vectors))
        self._pack_dirty = []
        return self._packed_cache[1]

    @_with_cache_lock
    def _int8_refine_store(self, st):
        """(packed [cap, d/4] int32, scales [cap]) refine source, or None.

        With raw_store=False the compressed store IS the int8 source (no
        shadow — those arrays are the only row representation).  With a raw
        store and refine_store="int8", a packed shadow is built and cached
        on the immutable vectors array (quarter refine traffic, ~0.4%
        distance error).  Incremental maintenance matches
        _packed_refine_store (per-row stateless pack; dirty rows only)."""
        if not self.store.raw:
            return st.packed, st.scales
        if self.config.refine_store != "int8":
            return None
        if (self._packed_cache is not None
                and self._packed_cache[0] is st.vectors):
            return self._packed_cache[1], self._packed_cache[2]
        slots = (self._take_dirty("_pack_dirty")
                 if self._packed_cache is not None else None)
        if slots is not None:
            self._packed_cache = (
                st.vectors,
                *_update_packed_int8(self._packed_cache[1],
                                     self._packed_cache[2], st.vectors,
                                     slots),
            )
        else:
            from ..ops.distance import pack_int8_rows

            self._packed_cache = (st.vectors, *pack_int8_rows(st.vectors))
        self._pack_dirty = []
        return self._packed_cache[1], self._packed_cache[2]

    def _int8_resid_store(self, st):
        """(resid [cap, d/4] i32, rscales [cap]) — the second-level int8
        residual refine rows (config.refine_residual), or (None, None).
        Lives in the store itself (written at add/bulk/stream time), so
        there is no cache to maintain; always a pair, so call sites pass
        the elements straight through as resid=/rscales= kwargs."""
        if self.store.raw or getattr(st, "resid", None) is None:
            return None, None
        return st.resid, st.rscales

    @_with_cache_lock
    def _scan16_shadow(self, st):
        """Cached bf16 scan shadow for search_mode="scan_pallas" (see
        _build_scan16_shadow).  Keyed on BOTH the vectors array and the
        valid mask: the selection offset bakes the tombstones in, so a
        delete must invalidate (unlike the refine shadows, whose stale
        rows are filtered by valid upstream).

        Mutations recorded in _scan16_dirty refresh the shadow
        INCREMENTALLY against the cached centering (_update_scan16_shadow),
        exactly like _scan8_shadow — O(dirty * d) per search under steady
        churn instead of the O(N * d) full rebuild."""
        if (self._scan16_cache is not None
                and self._scan16_cache[0] is st.vectors
                and self._scan16_cache[1] is st.valid):
            return self._scan16_cache[2]
        slots = (self._take_dirty("_scan16_dirty")
                 if (self._scan16_cache is not None
                     and self._scan16_aux is not None) else None)
        if slots is not None:
            base16, off, sc, cvec = self._scan16_cache[2]
            base16, off, sc = _update_scan16_shadow(
                base16, off, sc, st.vectors, st.norms, st.valid,
                slots, cvec, self._scan16_aux, self.metric)
            self._scan16_cache = (st.vectors, st.valid,
                                  (base16, off, sc, cvec))
        else:
            *shadow, aux = _build_scan16_shadow(
                st.vectors, st.norms, st.valid, self.metric, 2048)
            self._scan16_cache = (st.vectors, st.valid, tuple(shadow))
            self._scan16_aux = aux
        self._scan16_dirty = []
        return self._scan16_cache[2]

    @_with_cache_lock
    def _scan8_shadow(self, st):
        """Cached int8 scan shadow for search_mode="scan_pallas_int8" (see
        _build_scan8_shadow).  Keyed on vectors AND valid like
        _scan16_shadow (the selection offset bakes tombstones in).

        Mutations recorded in _scan8_dirty (add_batch/remove) refresh the
        shadow INCREMENTALLY — requantize only the dirty rows against the
        cached centering (_update_scan8_shadow) — so steady churn on a
        large index pays O(dirty * d) per search, not the O(N * d) full
        rebuild (~1 s at 1M x 512).  Any untracked store rewrite
        (bulk_load / load_state_arrays / over-threshold churn) sets
        _scan8_dirty = None, forcing the full rebuild."""
        if (self._scan8_cache is not None
                and self._scan8_cache[0] is st.vectors
                and self._scan8_cache[1] is st.valid):
            return self._scan8_cache[2]
        slots = (self._take_dirty("_scan8_dirty")
                 if (self._scan8_cache is not None
                     and self._scan8_aux is not None) else None)
        if slots is not None:
            base8, off, sc, cvec = self._scan8_cache[2]
            base8, off, sc = _update_scan8_shadow(
                base8, off, sc, st.vectors, st.norms, st.valid,
                slots, cvec, self._scan8_aux, self.metric)
            self._scan8_cache = (st.vectors, st.valid,
                                 (base8, off, sc, cvec))
        else:
            base8, off, sc, cvec, aux = _build_scan8_shadow(
                st.vectors, st.norms, st.valid, self.metric, 2048)
            self._scan8_cache = (st.vectors, st.valid,
                                 (base8, off, sc, cvec))
            self._scan8_aux = aux
        self._scan8_dirty = []
        return self._scan8_cache[2]

    @_with_cache_lock
    def _scan8g_shadow(self, st):
        """Cached GLOBAL-scale int8 scan shadow for the integer-epilogue
        pool scan (int8_epilogue="global"; see _build_scan8g_shadow /
        ops/pool_scan.int8g_pool_scan).  Same caching and
        incremental-refresh discipline as _scan8_shadow; the global scale
        ``sv`` is refreshed only by full rebuilds (interim wide rows clip,
        and the exact refine absorbs the error)."""
        if (self._scan8g_cache is not None
                and self._scan8g_cache[0] is st.vectors
                and self._scan8g_cache[1] is st.valid):
            return self._scan8g_cache[2]
        slots = (self._take_dirty("_scan8g_dirty")
                 if (self._scan8g_cache is not None
                     and self._scan8g_aux is not None) else None)
        if slots is not None:
            base8, off, sv, sgn, cvec = self._scan8g_cache[2]
            base8, off, n_clip = _update_scan8g_shadow(
                base8, off, st.vectors, st.norms, st.valid,
                slots, cvec, self._scan8g_aux, sv, self.metric)
            self._scan8g_clipped += int(n_clip)
            if self._scan8g_clipped > max(64, 0.01 * self.store.size()):
                # too many post-calibration rows clip at
                # +-127 against the stale global sv — pool selection is
                # biased; rebuild the shadow to refresh the scale
                slots = None
            else:
                self._scan8g_cache = (st.vectors, st.valid,
                                      (base8, off, sv, sgn, cvec))
        if slots is None:
            base8, off, sv, sgn, cvec, aux = _build_scan8g_shadow(
                st.vectors, st.norms, st.valid, self.metric, 2048)
            self._scan8g_cache = (st.vectors, st.valid,
                                  (base8, off, sv, sgn, cvec))
            self._scan8g_aux = aux
            self._scan8g_clipped = 0
        self._scan8g_dirty = []
        return self._scan8g_cache[2]

    @_with_cache_lock
    def _scan8p_shadow(self, st):
        """Cached conditioning vectors for the packed-store fused scan
        (search_mode="scan_pallas_int8", raw_store=False — see
        _build_scan8p_shadow).  Keyed on packed AND valid; the arrays are
        O(N) vectors, not a corpus copy."""
        if (self._scan8p_cache is None
                or self._scan8p_cache[0] is not st.packed
                or self._scan8p_cache[1] is not st.valid):
            self._scan8p_cache = (
                st.packed, st.valid,
                _build_scan8p_shadow(st.packed, st.scales, st.norms,
                                     st.valid, self.metric),
            )
        return self._scan8p_cache[2]

    # ------------------------------------------------------ scan_ivf layout
    _IVF_OVERLAY_MAX = 1024  # dirty rows scored exactly per search before
    # the next search triggers a full relayout instead

    @_with_cache_lock
    def _ivf_layout(self, st):
        """Cached balanced cluster-major layout for the cluster-pruned
        fused scan (search_mode="scan_ivf"; ops/ivf_scan).  Keyed on the
        store's row array AND valid like the scan shadows.

        Row mutations recorded in _ivf_dirty are handled WITHOUT moving
        grid rows: the touched positions are disabled (+inf selection
        offset) and the live slots join the exact-scored overlay —
        O(dirty) per search.  Past _IVF_OVERLAY_MAX accumulated overlay
        rows (or an untracked store rewrite) the layout fully rebuilds:
        one device-side top-A choices pass + balanced placement +
        cluster-major gather (no host round-trips)."""
        key = st.vectors if self.store.raw else st.packed
        c = self._ivf_cache
        if c is not None and c[0] is key and c[1] is st.valid:
            return c[2]
        if c is not None:
            slots = self._take_dirty("_ivf_dirty")
            if slots is not None:
                s_np = np.unique(np.asarray(slots)).astype(np.int64)
                new_ov = np.union1d(self._ivf_overlay, s_np)
                if new_ov.size <= self._IVF_OVERLAY_MAX:
                    lay = c[2]
                    pos = np.asarray(lay.slot2pos[jnp.asarray(s_np)])
                    live_pos = pos[pos >= 0]
                    if live_pos.size:
                        lay = lay._replace(
                            off_cm=lay.off_cm.at[
                                jnp.asarray(live_pos, jnp.int32)
                            ].set(jnp.inf),
                            slot2pos=lay.slot2pos.at[
                                jnp.asarray(s_np, jnp.int32)].set(-1),
                        )
                    self._ivf_overlay = new_ov
                    self._ivf_overlay_dev = None
                    self._ivf_cache = (key, st.valid, lay)
                    return lay
        lay = self._build_ivf_layout(st)
        self._ivf_cache = (key, st.valid, lay)
        self._ivf_dirty = []
        self._ivf_overlay = np.empty(0, np.int64)
        self._ivf_overlay_dev = None
        return lay

    def _build_ivf_layout(self, st):
        from ..ops import ivf_scan
        from ..ops.pool_scan import IVF_PW, LANES

        cents = self.coarse_centroids
        nlist = int(cents.shape[0])
        n_live = self.store.size()
        winners = max(1, self.config.ivf_winners)
        cap_max = (IVF_PW // winners) * LANES
        cap = min(max(-(-int(n_live / nlist * 1.3) // LANES) * LANES,
                      LANES), cap_max)
        if nlist * cap < n_live:
            raise ValueError(
                f"scan_ivf: nlist={nlist} cannot hold {n_live} rows at the "
                f"kernel's cluster capacity limit {cap_max} (ivf_winners="
                f"{winners}) — retrain with a larger nlist (0 auto-sizes) "
                "or fewer ivf_winners"
            )
        # top-A cluster choices per slot, device-only (chunk divides the
        # 128-rounded capacity and bounds the [chunk, nlist] score block)
        chunk = 128
        cap_rows = st.capacity
        for mult in (256, 64, 16, 4, 1):
            if cap_rows % (128 * mult) == 0 and 128 * mult * nlist <= 1 << 27:
                chunk = 128 * mult
                break
        if self.store.raw:
            base8, off, sc, cvec = self._scan8_shadow(st)
            packed_src = _pack_rows_i8(base8[:cap_rows])
            choices = ivf_scan.coarse_choices(
                st.vectors, None, cents, self.metric, 8, chunk,
                approx=nlist > 1024)
        else:
            off, sc, cvec = self._scan8p_shadow(st)
            packed_src = st.packed
            choices = ivf_scan.coarse_choices(
                st.packed, st.scales, cents, self.metric, 8, chunk,
                approx=nlist > 1024)
        pos2slot, slot2pos, spilled = ivf_scan.balanced_layout_dev(
            choices, st.valid, nlist, cap)
        cm, off_cm, sc_cm = _gather_ivf_cm(
            packed_src, off[:cap_rows], sc[:cap_rows], pos2slot)
        return _IvfLayout(cents, cm, off_cm, sc_cm, cvec, pos2slot,
                          slot2pos, cap, int(spilled))

    def _ivf_overlay_padded(self) -> Optional[jax.Array]:
        """Pending-overlay slots as a pow2-padded device array (-1 pads),
        or None when empty — mirrors DeferInsertMixin._pending_padded."""
        if self._ivf_overlay.size == 0:
            return None
        if self._ivf_overlay_dev is None:
            n = self._ivf_overlay.size
            n_pad = 1 << max(0, int(n - 1).bit_length())
            arr = np.full(n_pad, -1, np.int32)
            arr[:n] = self._ivf_overlay
            self._ivf_overlay_dev = jnp.asarray(arr)
        return self._ivf_overlay_dev

    @_with_cache_lock
    def _fast_tables(self) -> tuple[jax.Array, jax.Array, jax.Array]:
        """codes_t [S, cap] uint8 + cbt [S*sd, K] + cached reconstruction
        norms [cap] for adc_fast_search (the C2 norms-cache analog).

        Keyed on the codes/codebooks array identities; code mutations
        recorded in _fast_dirty refresh ct/cnorms INCREMENTALLY
        (transpose-scatter + per-subspace codebook sq-norm lookup for the
        dirty slots only) — steady churn on a large index avoids the O(N)
        chunked recon pass (~seconds at 10M slots)."""
        if (self._fast_cache is not None
                and self._fast_cache[0] is self.codes
                and self._fast_cache[1] is self.codebooks):
            return self._fast_cache[2:]
        slots = (self._take_dirty("_fast_dirty")
                 if (self._fast_cache is not None
                     and self._fast_cache[1] is self.codebooks) else None)
        if slots is not None:
            _, _, ct, cbt, cnorms = self._fast_cache
            ct, cnorms = _update_fast_tables(ct, cnorms, self.codes,
                                             self.codebooks, slots)
        else:
            ct = jnp.transpose(self.codes, (1, 0))
            cbt = adc.codebooks_to_cbt(self.codebooks)
            cap = ct.shape[1]
            chunk = 1 << 19
            if cap <= chunk:
                cnorms = _recon_norms(ct, cbt)
            else:
                # chunked + jit-fused: a full decode of a 10M-slot code
                # matrix would transiently materialise a [d, 10M] bf16
                # buffer (10 GB); eager per-op chunks still peak at 5x the
                # bf16 recon (astype/square/sum each materialise) — the
                # fused jit keeps peak at one [d, chunk] bf16 block
                parts = []
                for s in range(0, cap, chunk):
                    blk = jax.lax.dynamic_slice_in_dim(
                        ct, s, min(chunk, cap - s), axis=1)
                    parts.append(_recon_norms(blk, cbt))
                cnorms = jnp.concatenate(parts)
        self._fast_cache = (self.codes, self.codebooks, ct, cbt, cnorms)
        self._fast_dirty = []
        return self._fast_cache[2:]

    def _scan_chunk(self, capacity: int, q_n: int) -> int:
        """Chunk length for streamed large-N scans: FEW BIG chunks (each
        chunk pays a fixed selection cost), capped so the transient
        [Q, chunk] f32 distance block stays <= ~2 GB AND the [dim, chunk]
        bf16 decode buffer <= ~512 MB.  The values are not measured on the
        H100; see ROADMAP A5."""
        if q_n <= 64:
            # single/small-query path: per-chunk fixed costs matter less
            # (one user call), so take the smallest chunk and the smallest
            # [d, chunk] decode spike
            return min(131072, max(capacity, 128))
        by_q = (1 << 29) // max(q_n, 1)
        by_decode = (1 << 28) // max(self.dim, 1)
        chunk = max(131072, min(1 << 20, by_q, by_decode))
        return min(chunk - chunk % 128, max(capacity, 128))

    def _f32_scan_block(self, capacity: int, q_n: int) -> int:
        """Block length for the blocked f32 exact scan: FEW BIG blocks
        (each block pays a fixed selection and merge cost); the [Q, block]
        f32 buffer is capped at ~1 GB.  The values are not measured on the
        H100; see ROADMAP A5."""
        block = max(32768, min(1 << 20, (1 << 28) // max(q_n, 1)))
        return min(block - block % 128, max(capacity, 128))

    # ------------------------------------------------------------- graph ops
    def _insert_graph(self, slots: np.ndarray) -> None:
        levels = self._sample_levels(len(slots))
        st = self.store.state
        live = self.store.size() - len(slots)
        if int(self.graph.entry) < 0 and len(slots) >= 4 * self.config.m:
            # from-scratch: exact-kNN bulk construction (0.2 s warm at
            # 10k/128d vs ~40 s of sequential insertion beams)
            self.graph = hg.bulk_build(
                self.graph, st.vectors, st.norms, slots, levels,
                m=self.config.m, heuristic=True,
            )
            return
        if int(self.graph.entry) < 0:
            self.graph = hg.seed_first(
                self.graph,
                jnp.asarray(slots[0], jnp.int32),
                jnp.asarray(levels[0], jnp.int32),
            )
            live = max(live, 1)
        # exact distances for graph quality (reference Fix #4,
        # HnswPqIndex.java:491-499 uses buildEf >= 200)
        self.graph = hg.host_insert_stream(
            self.graph, st.vectors, st.norms, slots, levels,
            batch=64, live_before=live,
            efc=self.config.ef_construction, expand=4, heuristic=True,
        )

    def _rebuild_graph(self) -> None:
        ids_np = np.asarray(self.store.state.ids)
        valid = np.asarray(self.store.state.valid)
        live = np.flatnonzero(valid)
        order = live[np.argsort(ids_np[live], kind="stable")]
        self.graph = hg.init_graph(self.store.capacity, self.config.m, self._max_level)
        self._clear_pending()  # the rebuild connects everything
        if order.size:
            self._insert_graph(order.astype(np.int32))

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
            # exact fallback until trained (reference returns PQ-untrained
            # results from raw distances); compressed stores scan int8 rows
            if self.store.raw:
                dists, slots = blocked_knn(
                    jnp.asarray(padded), st.vectors, st.valid, k_pad,
                    metric=self.metric, b_norms=st.norms,
                    block_n=min(8192, st.capacity),
                )
            else:
                from ..ops.distance import blocked_knn_int8

                # recall_target=1.0: this fallback is the guaranteed-
                # exhaustive path (n_live <= k must return every live row),
                # matching the raw store's exact blocked_knn
                i8r = self._int8_resid_store(st)
                dists, slots = blocked_knn_int8(
                    jnp.asarray(padded), st.packed, st.scales, st.valid,
                    k_pad, metric=self.metric, b_norms=st.norms,
                    block_n=min(262144, st.capacity), recall_target=1.0,
                    resid=i8r[0], rscales=i8r[1],
                )
            return self._to_external(q_n, k, k_eff, slots, dists)

        refine = min(max(pow2(self.config.refine_k), k_pad), st.capacity)
        mode = self.config.search_mode
        if mode == "auto":
            mode = (_auto_scan_mode(self.config.use_graph, n_live)
                    if self.store.raw else "adc_fast")
        if not self.store.raw and mode in ("scan_exact", "scan_pallas",
                                           "scan_bf16", "graph"):
            raise ValueError(
                f"search_mode={mode!r} needs the raw f32 store "
                "(raw_store=False)"
            )
        if mode == "scan_pallas_int8" and not self.store.raw:
            # compressed tier: the s8 pool scan streams the store's OWN
            # packed rows (zero shadow memory) + int8 refine with exact
            # write-time norms (see _build_scan8p_shadow)
            off, sc, cvec = self._scan8p_shadow(st)
            from ..ops.pool_scan import preserved_pool_width

            # largest pool width <= 2048 that divides capacity (new stores
            # round to 2048; legacy 128-rounded checkpoints get a narrower
            # width — the scan refuses to pad-copy the packed array)
            w = preserved_pool_width(st.capacity)
            i8r = self._int8_resid_store(st)
            dists, ext = pallas_scan8p_refine(
                jnp.asarray(padded), st.packed, st.scales, st.norms, off, sc,
                cvec, st.ids, k_pad, self.metric,
                pool=min(max(4 * k_pad, 64), w), w=w,
                resid=i8r[0], rscales=i8r[1],
            )
            return self._emit(q_n, k, k_eff, dists, ext)
        if mode == "scan_ivf":
            # cluster-pruned scan (ops/ivf_scan): probe nprobe clusters
            # per query, scan ONLY probed clusters, exact/int8 refine +
            # exact overlay of rows
            # mutated since the last relayout
            if self.coarse_centroids is None:
                raise ValueError(
                    "search_mode='scan_ivf' needs a trained coarse "
                    "quantizer — call train()/build() after loading rows "
                    "(nlist=0 auto-sizes the partition count)"
                )
            from ..ops.pool_scan import IVF_PW

            lay = self._ivf_layout(st)
            nlist = int(lay.centroids.shape[0])
            nprobe = max(1, min(self.config.nprobe, nlist))
            p_cap = self.config.ivf_p_cap or int(np.clip(
                pow2(max(1, 4 * padded.shape[0] * nprobe // nlist)),
                32, 512))
            pool = self.config.ivf_pool or min(
                max(4 * k_pad, 256), nprobe * IVF_PW)
            ov = self._ivf_overlay_padded()
            lay_args = (lay.centroids, lay.cm_packed, lay.off_cm,
                        lay.sc_cm, lay.cvec, lay.pos2slot)
            if self.store.raw:
                dists, ext = pallas_ivf_refine_raw(
                    jnp.asarray(padded), *lay_args, st.vectors, st.valid,
                    st.ids, ov, k_pad, self.metric, nprobe, p_cap, pool,
                    max(1, self.config.ivf_winners))
            else:
                i8r = self._int8_resid_store(st)
                dists, ext = pallas_ivf_refine_packed(
                    jnp.asarray(padded), *lay_args, st.packed, st.scales,
                    st.norms, st.valid, st.ids, ov, k_pad, self.metric,
                    nprobe, p_cap, pool, max(1, self.config.ivf_winners),
                    resid=i8r[0], rscales=i8r[1])
            return self._emit(q_n, k, k_eff, dists, ext)
        if mode == "scan_int8":
            # exhaustive near-exact scan over the int8 rows (see
            # ops/distance.blocked_knn_int8)
            i8 = self._int8_refine_store(st)
            if i8 is None:
                raise ValueError(
                    "search_mode='scan_int8' needs raw_store=False or "
                    "refine_store='int8'"
                )
            from ..ops.distance import blocked_knn_int8

            # with residual rows the exhaustive scan scores at ~16-bit
            # precision — the compressed tier's effectively-exact mode
            i8r = self._int8_resid_store(st)
            dists, slots = blocked_knn_int8(
                jnp.asarray(padded), i8[0], i8[1], st.valid, k_pad,
                metric=self.metric, b_norms=st.norms,
                block_n=min(262144, st.capacity),
                recall_target=self.config.scan_recall_target,
                resid=i8r[0], rscales=i8r[1],
            )
            return self._to_external(q_n, k, k_eff, slots, dists)
        if mode == "scan_bf16":
            # bf16 scan + exact refine: the [Q, N] score buffer's f32
            # round-trip through device memory is a large share of the
            # exact scan's traffic — a bf16 buffer halves it, and
            # selection only has to CONTAIN the true top-k, which the exact
            # f32 refine then orders (see ops/distance.bf16_pool_scan)
            if padded.shape[0] * st.capacity * 2 > 512 * 1024 * 1024:
                # full-row bf16 buffer would not fit comfortably: stream
                # blocks (bf16 block buffer capped at ~512 MB)
                bn = max(131072, min(st.capacity,
                                     (1 << 28) // max(padded.shape[0], 1)))
                bn -= bn % 128
            else:
                bn = 0
            dists, ext = bf16_scan_refine(
                jnp.asarray(padded), st.vectors, st.norms, st.valid,
                st.ids, k_pad, self.metric,
                min(max(4 * k_pad, 32), st.capacity),
                self.config.scan_recall_target, block_n=bn,
            )
            return self._emit(q_n, k, k_eff, dists, ext)
        if mode in ("scan_exact", "scan_pallas", "scan_pallas_int8"):
            # the scans over the raw store (see HnswPqConfig.search_mode)
            if mode == "scan_pallas_int8" and self.config.int8_epilogue == "global":
                # integer-epilogue variant: global-scale shadow, ranked
                # in raw i32 (ops/pool_scan.int8g_pool_scan)
                base8, off, sv, sgn, cvec = self._scan8g_shadow(st)
                w = min(2048, base8.shape[0])
                dists, ext = pallas_scan8g_refine(
                    jnp.asarray(padded), st.vectors, base8, off, sv, sgn,
                    cvec, st.ids, k_pad, self.metric,
                    pool=min(max(4 * k_pad, 64), w), w=w,
                )
            elif mode == "scan_pallas_int8":
                # s8 x s8 pool scan over the quarter-width int8 shadow +
                # exact refine (see _build_scan8_shadow)
                base8, off, sc, cvec = self._scan8_shadow(st)
                w = min(2048, base8.shape[0])
                dists, ext = pallas_scan8_refine(
                    jnp.asarray(padded), st.vectors, base8, off, sc,
                    cvec, st.ids, k_pad, self.metric,
                    pool=min(max(4 * k_pad, 64), w), w=w,
                )
            elif mode == "scan_pallas":
                # bf16 shadow pool scan + exact refine
                base16, off, sc, cvec = self._scan16_shadow(st)
                w = min(2048, base16.shape[0])
                dists, ext = pallas_scan_refine(
                    jnp.asarray(padded), st.vectors, base16, off, sc,
                    cvec, st.ids, k_pad, self.metric,
                    pool=min(max(4 * k_pad, 64), w), w=w,
                )
            else:
                dists, ext = exact_scan_search(
                    jnp.asarray(padded), st.vectors, st.norms, st.valid,
                    st.ids, k_pad, self.metric,
                    self._f32_scan_block(st.capacity, padded.shape[0]),
                    self.config.scan_recall_target,
                )
            return self._emit(q_n, k, k_eff, dists, ext)
        if mode == "pca" and self.proxy is None:
            raise ValueError(
                "search_mode='pca' needs a fitted proxy: set proxy_dims > 0 "
                "and search_mode='pca' before training (or retrain/build())"
            )
        if mode == "pca":
            # PCA-proxy multi-stage path (ops/pca): tiny [Q, p] x [p, N]
            # proxy matmul -> ranked top-pca_r -> blocked exact refine
            from ..ops import pca

            if self._proxy_norms is None:
                # jit-fused: an eager astype would materialise the full
                # [cap, p] f32 proxy (2.5 GB at 10M) just to reduce it
                self._proxy_norms = _rows_sq_norms(self.proxy)
            packed = self._packed_refine_store(st)
            i8 = self._int8_refine_store(st)
            i8r = self._int8_resid_store(st)
            dists, ext = _pca_search_jit(
                jnp.asarray(padded), self.pca_mean, self.pca_basis,
                self.proxy, self._proxy_norms, st.valid,
                st.vectors if self.store.raw else self.proxy,
                st.ids, k=k_pad, select_r=max(self.config.pca_r, k_pad),
                metric=self.metric, packed_base=packed,
                block_n=self._scan_chunk(st.capacity, padded.shape[0]),
                int8_base=i8[0] if i8 is not None else None,
                int8_scales=i8[1] if i8 is not None else None,
                int8_norms=st.norms if i8 is not None else None,
                int8_resid=i8r[0], int8_rscales=i8r[1],
            )
            return self._emit(q_n, k, k_eff, dists, ext)
        if mode == "adc_fast":
            # fast memory-bound path: decode-kernel scan + unranked pool +
            # exact refine (scoring reads only codes + codebooks)
            ct, cbt, cnorms = self._fast_tables()
            bucket = max(2, min(self.config.adc_bucket, st.capacity // 2))
            # stream in chunks once [Q, N] distances would exceed 512 MB OR
            # the [d, N] bf16 decode buffer would exceed 1 GB (a Q=1 query
            # at 10M rows still cannot decode the whole corpus);
            # FEW BIG chunks (see _scan_chunk) — per-chunk approx_max_k
            # fixed cost dominates with many small ones
            need_chunk = (
                padded.shape[0] * st.capacity * 4 > 512 * 1024 * 1024
                or st.capacity * self.dim * 2 > 1024 * 1024 * 1024
            )
            chunk = (self._scan_chunk(st.capacity, padded.shape[0])
                     if need_chunk else 0)
            packed = self._packed_refine_store(st)
            i8 = self._int8_refine_store(st)
            i8r = self._int8_resid_store(st)
            dists, ext = _adc_fast_jit(
                jnp.asarray(padded), ct, cbt, st.valid,
                st.vectors if self.store.raw else st.packed, st.ids,
                k=k_pad, bucket=bucket, winners=self.config.adc_winners,
                metric=self.metric, chunk_n=chunk,
                pool_mode=self.config.adc_pool, code_norms=cnorms,
                perm=self.perm, packed_base=packed,
                select_r=self.config.adc_select_r,
                int8_base=i8[0] if i8 is not None else None,
                int8_scales=i8[1] if i8 is not None else None,
                int8_norms=st.norms if i8 is not None else None,
                int8_resid=i8r[0], int8_rscales=i8r[1],
            )
            return self._emit(q_n, k, k_eff, dists, ext)
        if (mode == "graph" or self.config.use_graph) and int(self.graph.entry) >= 0:
            # graph path: ADC-distance traversal + exact re-rank (reference
            # search shape, HnswPqIndex.java:616-664)
            q_pq = self._pq_space(jnp.asarray(padded))
            tables = adc.build_distance_tables(q_pq, self.codebooks)
            ef = min(max(pow2(self.config.ef_search), refine), st.capacity)
            _, cand = hnsw_pq_search(
                self.graph, self.codes, tables, st.valid, ef,
            )
            cand = cand[:, :refine]
            if self._pending_count > 0:
                # deferred graph adds: exact overlay over pending slots with
                # ONE [Q, P] dot_general merged into the refined top-k
                # (NEVER broadcast pending into the [Q, R, d] refine gather:
                # at Q=1024, d=512, P near flush_max that is tens of GB)
                dists, slots = _graph_refine_pending(
                    jnp.asarray(padded), st.vectors, st.valid, cand,
                    self._pending_padded(), k_pad, self.metric,
                )
            else:
                dists, slots = _blocked_rerank(
                    jnp.asarray(padded), st.vectors, cand, k_pad, self.metric
                )
            return self._to_external(q_n, k, k_eff, slots, dists)
        i8 = None if self.store.raw else self._int8_refine_store(st)
        i8r = self._int8_resid_store(st)
        base = st.vectors if self.store.raw else st.packed
        if self.coarse_centroids is not None:
            # IVF-pruned fused scan (ScaNN-style partition + score + re-rank)
            members, max_len, overflow = self._member_table()
            nprobe = min(self.config.nprobe, int(self.coarse_centroids.shape[0]))
            dists, ext = flagship_search_pruned(
                jnp.asarray(padded), self.codebooks, self.codes, st.valid,
                base, st.ids, self.coarse_centroids, members, overflow,
                k_pad, refine, nprobe, max_len, self.metric, self.perm,
                int8_base=i8[0] if i8 is not None else None,
                int8_scales=i8[1] if i8 is not None else None,
                int8_norms=st.norms if i8 is not None else None,
                int8_resid=i8r[0], int8_rscales=i8r[1],
            )
        else:
            # exhaustive fused scan
            dists, ext = flagship_search(
                jnp.asarray(padded), self.codebooks, self.codes, st.valid,
                base, st.ids, k_pad, refine,
                self.adc_impl, min(4096, st.capacity), self.metric,
                self.perm,
                int8_base=i8[0] if i8 is not None else None,
                int8_scales=i8[1] if i8 is not None else None,
                int8_norms=st.norms if i8 is not None else None,
                int8_resid=i8r[0], int8_rscales=i8r[1],
            )
        return self._emit(q_n, k, k_eff, dists, ext)

    def _emit(self, q_n, k, k_eff, dists, ext):
        """Fetch (dists, external ids) in ONE device_get (each separate
        np.asarray is a device round trip) and shape the [q_n, k] result."""
        import jax as _jax

        d_np, ext_np = _jax.device_get((dists, ext))
        out_ids = np.full((q_n, k), -1, np.int32)
        out_d = np.full((q_n, k), np.inf, np.float32)
        out_ids[:, :k_eff] = ext_np[:q_n, :k_eff]
        out_d[:, :k_eff] = d_np[:q_n, :k_eff]
        return out_ids, out_d

    def _to_external(self, q_n, k, k_eff, slots, dists):
        # slot -> external-id map runs ON DEVICE ([Q, k] gather) so only the
        # tiny result transfers — pulling the full [cap] ids array to host
        # costs ~40 MB per call at 10M capacity
        ext_dev = _slots_to_ids(self.store.state.ids, jnp.asarray(slots))
        ext = np.asarray(ext_dev)[:q_n, :k_eff]
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
        """reference: HnswPqIndex.getIndexStats :1069-1083 +
        HNSWPQIndex::getMemoryUsage :825-845."""
        s = super().stats()
        sub = self.config.num_subspaces
        code_bytes = self.store.capacity * sub
        cb_bytes = (
            int(np.prod(self.codebooks.shape)) * 4 if self.codebooks is not None else 0
        )
        graph_bytes = (
            int(np.prod(self.graph.neighbors.shape)) * 4 if self.config.use_graph else 0
        )
        proxy_bytes = (
            int(np.prod(self.proxy.shape)) * 2
            if self.proxy is not None else 0
        )
        store_bytes = (
            self.store.capacity * self.dim * 4 if self.store.raw
            # packed int8 rows + scales + exact norms (+ the second int8
            # level when refine_residual)
            else self.store.capacity * (self.dim + 8)
            + (self.store.capacity * (self.dim + 4)
               if getattr(self.store.state, "resid", None) is not None
               else 0)
        )
        s.update(
            trained=self.trained,
            num_subspaces=sub,
            num_centroids=self.config.num_centroids,
            compression_ratio=4.0 * self.dim / sub,
            index_bytes=code_bytes + cb_bytes + graph_bytes + proxy_bytes,
            proxy_bytes=proxy_bytes,
            raw_bytes=self.store.capacity * self.dim * 4,
            store_bytes=store_bytes,
            raw_store=self.store.raw,
            use_graph=self.config.use_graph,
            pending_inserts=int(self._pending_count),
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        if self.config.use_graph:
            self.flush_pending()  # checkpoints always hold a complete graph
        out = {
            "store": self.store.to_host(),
            "codes": np.asarray(self.codes),
            "trained": np.asarray([self.trained]),
            "level_counter": np.asarray([self._level_counter]),
            "graph": {
                "neighbors": np.asarray(self.graph.neighbors),
                "levels": np.asarray(self.graph.levels),
                "entry": np.asarray(self.graph.entry),
                "entry_level": np.asarray(self.graph.entry_level),
            },
        }
        if self.codebooks is not None:
            out["codebooks"] = np.asarray(self.codebooks)
        if self.perm is not None:
            out["perm"] = np.asarray(self.perm)
        if self.coarse_centroids is not None:
            out["coarse_centroids"] = np.asarray(self.coarse_centroids)
            out["coarse_assign"] = self.coarse_assign
        if self.proxy is not None:
            out["pca_mean"] = np.asarray(self.pca_mean)
            out["pca_basis"] = np.asarray(self.pca_basis)
            out["proxy"] = np.asarray(self.proxy, np.float32)
        return out

    def load_state_arrays(self, arrays: dict) -> None:
        self.store = VectorStore.from_host(arrays["store"])
        self._init_pending(self.store.capacity)  # checkpoints: complete graphs
        self.codes = jnp.asarray(arrays["codes"])
        self._fast_cache = None
        self._note_store_rewrite()  # untracked store rewrite -> full rebuilds
        self.trained = bool(np.asarray(arrays["trained"])[0])
        self._level_counter = int(np.asarray(arrays["level_counter"])[0])
        self.codebooks = (
            jnp.asarray(arrays["codebooks"]) if "codebooks" in arrays else None
        )
        self.perm = jnp.asarray(arrays["perm"]) if "perm" in arrays else None
        g = arrays["graph"]
        self.graph = hg.HnswGraph(
            neighbors=jnp.asarray(g["neighbors"]),
            levels=jnp.asarray(g["levels"]),
            entry=jnp.asarray(g["entry"]),
            entry_level=jnp.asarray(g["entry_level"]),
        )
        if "coarse_centroids" in arrays:
            self.coarse_centroids = jnp.asarray(arrays["coarse_centroids"])
            self.coarse_assign = np.asarray(arrays["coarse_assign"]).copy()
            self._members = None
            self._members_dirty = True
        if "proxy" in arrays:
            self.pca_mean = jnp.asarray(arrays["pca_mean"])
            self.pca_basis = jnp.asarray(arrays["pca_basis"])
            self.proxy = jnp.asarray(arrays["proxy"], jnp.bfloat16)
            self._proxy_norms = None


@jax.jit
def _slots_to_ids(ids, slots):
    return jnp.where(slots >= 0, ids[jnp.maximum(slots, 0)], -1)


# ONE-dispatch wrappers: adc_fast_search / pca_proxy_search are compositions
# of jitted pieces with eager glue — called eagerly from the index layer,
# every glue op would be a separate dispatch.  The index layer always calls
# through these.
from ..ops import pca as _pca_mod  # noqa: E402

_adc_fast_jit = functools.partial(
    jax.jit,
    static_argnames=("k", "bucket", "winners", "metric", "rerank_block",
                     "chunk_n", "pool_mode", "select_r"),
)(adc.adc_fast_search)

_pca_search_jit = functools.partial(
    jax.jit,
    static_argnames=("k", "select_r", "metric", "rerank_block", "block_n",
                     "force_chunked"),
)(_pca_mod.pca_proxy_search)


@jax.jit
def _rows_sq_norms(rows):
    r32 = rows.astype(jnp.float32)
    return jnp.sum(r32 * r32, axis=1)


@jax.jit
def _recon_norms(ct_blk, cbt):
    """Squared reconstruction norms of one code chunk, fused (decode +
    square + reduce in one program — peak memory is the [d, chunk] bf16
    reconstruction, nothing else materialises)."""
    r = adc.pq_decode_recon_t(ct_blk, cbt)
    return jnp.sum(r.astype(jnp.float32) * r.astype(jnp.float32), axis=0)


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _update_fast_tables(ct, cnorms, codes, codebooks, slots):
    """Incremental ADC-table refresh: transpose-scatter the re-encoded
    columns into codes_t and recompute reconstruction norms for the dirty
    slots ONLY.  The norms come from a per-subspace codebook sq-norm
    lookup over BF16-ROUNDED codebook entries — the same per-element
    values the full decode pass produces (_recon_norms via
    pq_decode_recon_t, which decodes in bf16), summed in a different f32
    order (per-subspace partials vs full-d reduction): codes_t is
    bit-exact vs a rebuild, cnorms agree to ~1e-6 relative (see
    tests/test_compressed_store.py::test_incremental_fast_tables_update).
    ``slots`` may contain duplicates (pow2 padding); the table arrays are
    donated in place."""
    sub = codes[slots].astype(jnp.int32)                      # [m, S]
    cb16 = codebooks.astype(jnp.bfloat16).astype(jnp.float32)
    cb_sq = jnp.sum(cb16 * cb16, axis=2)                      # [S, K]
    norms = jnp.sum(cb_sq[jnp.arange(sub.shape[1])[None, :], sub], axis=1)
    return (ct.at[:, slots].set(jnp.transpose(sub.astype(ct.dtype), (1, 0))),
            cnorms.at[slots].set(norms))


@functools.partial(
    jax.jit, static_argnames=("metric",), donate_argnums=(0, 1, 2)
)
def _stream_ingest_step(
    state, codes, proxy, vecs, ids, start,
    codebooks, perm, pca_mean, pca_basis, centroids, metric,
):
    """One streamed-ingest chunk as ONE device program: write the store
    (raw or int8-packed), encode PQ codes, project the proxy, assign coarse
    lists.  ``state``/``codes``/``proxy`` are DONATED — at 10M capacity they
    are gigabytes, and undonated functional updates would transiently double
    them.  ``start`` is a traced scalar so every chunk of a given length
    shares one compilation."""
    from ..ops.distance import (
        normalize_rows, pack_int8_residual, pack_int8_rows,
    )

    norms = jnp.sum(vecs * vecs, axis=1)
    valid_c = jnp.ones((vecs.shape[0],), bool)
    if hasattr(state, "packed"):          # Int8StoreState (compressed)
        packed, scale = pack_int8_rows(vecs)
        extra = {}
        if state.resid is not None:
            rp, rs = pack_int8_residual(vecs, packed, scale)
            extra = dict(
                resid=jax.lax.dynamic_update_slice(state.resid, rp,
                                                   (start, 0)),
                rscales=jax.lax.dynamic_update_slice(state.rscales, rs,
                                                     (start,)),
            )
        state = state.replace(
            packed=jax.lax.dynamic_update_slice(state.packed, packed,
                                                (start, 0)),
            scales=jax.lax.dynamic_update_slice(state.scales, scale,
                                                (start,)),
            ids=jax.lax.dynamic_update_slice(state.ids, ids, (start,)),
            norms=jax.lax.dynamic_update_slice(state.norms, norms, (start,)),
            valid=jax.lax.dynamic_update_slice(state.valid, valid_c,
                                               (start,)),
            **extra,
        )
    else:                                  # raw StoreState
        state = state.replace(
            vectors=jax.lax.dynamic_update_slice(state.vectors, vecs,
                                                 (start, 0)),
            ids=jax.lax.dynamic_update_slice(state.ids, ids, (start,)),
            norms=jax.lax.dynamic_update_slice(state.norms, norms, (start,)),
            valid=jax.lax.dynamic_update_slice(state.valid, valid_c,
                                               (start,)),
        )
    normed = normalize_rows(vecs) if metric == "cosine" else vecs
    pqv = normed if perm is None else normed[:, perm]
    codes_c = adc.pq_encode(pqv, codebooks)
    codes = jax.lax.dynamic_update_slice(codes, codes_c, (start, 0))
    if proxy is not None:
        from ..ops import pca as _pca

        proxy = jax.lax.dynamic_update_slice(
            proxy, _pca.project_rows(normed, pca_mean, pca_basis),
            (start, 0))
    assign = None
    if centroids is not None:
        from ..ops.distance import pairwise_sq_l2

        assign = jnp.argmin(
            pairwise_sq_l2(normed, centroids), axis=1
        ).astype(jnp.int32)
    return state, codes, proxy, assign


def _auto_scan_mode(use_graph: bool, n_live: int) -> str:
    """search_mode="auto" resolution on the raw store:

      * graph only when explicitly configured (the parity/incremental path;
        sequential beam expansion is gather- and dispatch-bound)
      * below 700k live rows: the BLOCKED f32 exact scan (exact_scan_search
        streams [Q, block_n] tiles, never [Q, N]) — plain XLA
      * from 700k live rows: the s8 x s8 pool scan (pallas_scan8_refine —
        per-row-quantized centered int8 shadow + exact f32 refine).  On the
        GPU its candidate stage is the one Pallas kernel compiled through
        Triton (ops/pool_scan); everything around it is plain XLA.

    The 700k crossover is not measured on the H100; see ROADMAP A5.  Caveat
    the auto user inherits: the int8 shadow is cached keyed on the vectors
    array, so the first search after a mutation batch refreshes it
    (incrementally for small batches; scan_exact has no such cache — pin
    search_mode="scan_exact" for churn-heavy large-N workloads).
    """
    if use_graph:
        return "graph"
    if n_live >= 700_000:
        return "scan_pallas_int8"
    return "scan_exact"


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "pool", "recall_target", "block_n"),
)
def bf16_scan_refine(queries, base, norms, valid, ids, k, metric, pool,
                     recall_target, block_n=0):
    """bf16-selection scan + exact f32 refine of a small ranked pool.

    Selection runs entirely in bf16 (ops/distance.bf16_pool_scan: bf16
    cross term AND a bf16 norm-centered score buffer — the [Q, N] buffer's
    HBM round-trip is the scan's real bound past ~100k rows, and bf16
    halves it); the blocked exact refine then orders the pool in f32.
    ``block_n`` streams the selection in blocks once the full-row bf16
    buffer would not fit (large-N regime)."""
    from ..ops.distance import bf16_pool_scan, blocked_rerank

    cand = bf16_pool_scan(
        queries, base, valid, pool, metric=metric, b_norms=norms,
        block_n=block_n, recall_target=recall_target,
    )
    # rb=pool: the default 512-row block pads a 32-candidate refine 16x
    # (the gather is the refine's whole cost)
    d, slots = blocked_rerank(queries, base, cand, k, metric, rb=pool)
    ext = jnp.where(jnp.isfinite(d), ids[jnp.maximum(slots, 0)], -1)
    return d, ext


@functools.partial(jax.jit, static_argnames=("metric", "pad_to"))
def _build_scan16_shadow(vectors, norms, valid, metric, pad_to):
    """bf16 scan shadow for the bf16 pool scan: (base16 padded to
    a ``pad_to`` row multiple, per-slot selection offset, per-slot scale,
    query centering vector, centering aux consts).  Conditioning mirrors
    ops/distance.bf16_pool_scan: a prefix-estimated corpus mean centers the
    queries and every large common-mode term is folded into the f32
    offset/scale rows, so the kernel's bf16 inputs only carry
    O(noise)-scale signal.  The trailing aux tuple ((musq, mean_norm) for
    l2, (c0,) for cosine) lets _update_scan16_shadow recondition single
    rows against this build's centering."""
    n = vectors.shape[0]
    m = min(4096, n)
    pref = vectors[:m]
    w = valid[:m].astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    mu = jnp.sum(pref * w[:, None], axis=0) / wsum
    musq = jnp.sum(mu * mu)
    live = jnp.maximum(jnp.sum(valid.astype(jnp.float32)), 1.0)
    if metric == "cosine":
        cdir = mu * jax.lax.rsqrt(jnp.maximum(musq, 1e-12))
        cv = vectors @ cdir
        iv = jax.lax.rsqrt(jnp.maximum(norms, 1e-12))
        pn = jnp.sqrt(jnp.maximum(jnp.sum(pref * pref, axis=1), 1e-12))
        c0 = jnp.sum((pref @ cdir) / pn * w) / wsum
        off = c0 - cv * iv
        sc = -iv
        center_vec = cdir
        aux = (c0,)
    else:
        mv = vectors @ mu
        mean_norm = jnp.sum(jnp.where(valid, norms, 0.0)) / live
        off = norms + musq - 2.0 * mv - (mean_norm - musq)
        sc = jnp.full((n,), -2.0, jnp.float32)
        center_vec = mu
        aux = (musq, mean_norm)
    off = jnp.where(valid, off, jnp.inf)
    base16 = vectors.astype(jnp.bfloat16)
    pad = (-n) % pad_to
    if pad:
        base16 = jnp.pad(base16, ((0, pad), (0, 0)))
        off = jnp.pad(off, (0, pad), constant_values=jnp.inf)
        sc = jnp.pad(sc, (0, pad))
    return base16, off, sc, center_vec, aux


@functools.partial(jax.jit, static_argnames=("metric",),
                   donate_argnums=(0, 1, 2))
def _update_scan16_shadow(base16, off, sc, vectors, norms, valid, slots,
                          cvec, aux, metric):
    """Incremental bf16-shadow refresh: recondition ONLY the mutated rows
    against the CACHED centering (cvec/aux from the last full
    _build_scan16_shadow) so all rows stay mutually consistent.
    O(dirty * d) instead of O(N * d); the shadow arrays are donated in
    place.  ``slots`` may contain duplicates (pow2 padding repeats a
    slot — the duplicate scatter writes identical values)."""
    rows = vectors[slots]
    rnorms = norms[slots]
    rvalid = valid[slots]
    if metric == "cosine":
        (c0,) = aux
        iv = jax.lax.rsqrt(jnp.maximum(rnorms, 1e-12))
        off_s = c0 - (rows @ cvec) * iv
        sc_s = -iv
    else:
        musq, mean_norm = aux
        off_s = rnorms + musq - 2.0 * (rows @ cvec) - (mean_norm - musq)
        sc_s = jnp.full(slots.shape, -2.0, jnp.float32)
    off_s = jnp.where(rvalid, off_s, jnp.inf)
    return (base16.at[slots].set(rows.astype(jnp.bfloat16)),
            off.at[slots].set(off_s),
            sc.at[slots].set(sc_s))


@functools.partial(jax.jit, donate_argnums=(0,))
def _update_packed_bf16(packed, vectors, slots):
    """Repack ONLY the mutated rows of the bf16 refine shadow (the pack is
    per-row and stateless, so this is bit-identical to a full rebuild)."""
    from ..ops.distance import pack_bf16_rows

    return packed.at[slots].set(pack_bf16_rows(vectors[slots]))


@functools.partial(jax.jit, donate_argnums=(0, 1))
def _update_packed_int8(packed, scales, vectors, slots):
    """Repack ONLY the mutated rows of the int8 refine shadow (per-row
    symmetric quantization is stateless; bit-identical to a rebuild)."""
    from ..ops.distance import pack_int8_rows

    r_packed, r_scales = pack_int8_rows(vectors[slots])
    return packed.at[slots].set(r_packed), scales.at[slots].set(r_scales)


@functools.partial(jax.jit, static_argnames=("metric", "pad_to"))
def _build_scan8_shadow(vectors, norms, valid, metric, pad_to):
    """int8 scan shadow for the s8 x s8 fused pool kernel: (base8 [N, d]
    int8 padded to a ``pad_to`` row multiple, per-slot f32 selection
    offset, per-slot f32 scale, query centering vector).

    Per-row symmetric quantization of CENTERED rows — centering matters
    more for int8 than bf16 (the range is absolute, so a common-mode
    offset eats quantization levels directly):

      * sq-L2: rows store (v - mu) / sv with sv = max|v - mu| / 127;
        off = ||v - mu||^2 exact f32; sc = -2 sv.  Selection score
        off + (q8 . v8) sc sq  ~=  ||v - mu||^2 - 2 (q - mu).(v - mu)
        = ||q - v||^2 - ||q - mu||^2 — rank-equivalent (per-query const).
      * cosine: rows store (v_hat - c0 cdir) / sv (NORMALIZED rows,
        centered by the mean corpus direction scaled by the mean cosine
        c0 — a per-slot 1/|v| scale would break shift-invariance on raw
        rows, so normalization happens before quantization);
        off = -(v_hat . cdir) exact f32; sc = -sv; queries center as
        q_hat - cdir.  Score ~= -q_hat . v_hat + per-query/global consts.

    `off` rides exact f32, so quantization only perturbs the O(noise)
    cross term; the caller's exact refine re-orders the pool.
    """
    n = vectors.shape[0]
    m = min(4096, n)
    pref = vectors[:m]
    w = valid[:m].astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    mu = jnp.sum(pref * w[:, None], axis=0) / wsum
    musq = jnp.sum(mu * mu)
    if metric == "cosine":
        cdir = mu * jax.lax.rsqrt(jnp.maximum(musq, 1e-12))
        iv = jax.lax.rsqrt(jnp.maximum(norms, 1e-12))
        pn = jnp.sqrt(jnp.maximum(jnp.sum(pref * pref, axis=1), 1e-12))
        c0 = jnp.sum((pref @ cdir) / pn * w) / wsum
        vhat = vectors * iv[:, None]
        ctr = vhat - c0 * cdir[None, :]
        off = -(vhat @ cdir)
        sgn = -1.0
        center_vec = cdir
        aux = c0
    else:
        ctr = vectors - mu[None, :]
        off = norms + musq - 2.0 * (vectors @ mu)  # ||v - mu||^2 exact
        sgn = -2.0
        center_vec = mu
        aux = musq
    sv = jnp.maximum(jnp.max(jnp.abs(ctr), axis=1), 1e-12) / 127.0
    base8 = jnp.clip(jnp.round(ctr / sv[:, None]), -127, 127).astype(jnp.int8)
    sc = sgn * sv
    off = jnp.where(valid, off, jnp.inf)
    pad = (-n) % pad_to
    if pad:
        base8 = jnp.pad(base8, ((0, pad), (0, 0)))
        off = jnp.pad(off, (0, pad), constant_values=jnp.inf)
        sc = jnp.pad(sc, (0, pad))
    return base8, off, sc, center_vec, aux


@functools.partial(jax.jit, static_argnames=("metric", "pad_to"))
def _build_scan8g_shadow(vectors, norms, valid, metric, pad_to):
    """GLOBAL-scale int8 shadow for the integer-epilogue pool scan
    (ops/pool_scan.int8g_pool_scan): identical
    centering/offset math to `_build_scan8_shadow`, but ONE quantization
    scale for the whole corpus (base8 = round(ctr / sv), sv scalar) so the
    kernel can rank in raw i32 with no per-slot dequant multiply.

    Centering is what makes the global scale affordable: after removing
    the common mode, row max-abs concentrates (isotropic/spectral corpora
    measure within ~2x of each other), so one scale loses <1 bit vs the
    per-row scales for most rows — and the caller's exact refine
    re-orders the pool regardless.  sv is measured over LIVE rows only (a
    stale dead row must not stretch the range).

    Returns (base8, off, sv, sgn, center_vec, aux): true selection score
    = off[n] - sgn * sv * sq * (q8 . v8_n), sgn = 2.0 sq-L2 / 1.0 cosine.
    """
    n = vectors.shape[0]
    m = min(4096, n)
    pref = vectors[:m]
    w = valid[:m].astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    mu = jnp.sum(pref * w[:, None], axis=0) / wsum
    musq = jnp.sum(mu * mu)
    if metric == "cosine":
        cdir = mu * jax.lax.rsqrt(jnp.maximum(musq, 1e-12))
        iv = jax.lax.rsqrt(jnp.maximum(norms, 1e-12))
        pn = jnp.sqrt(jnp.maximum(jnp.sum(pref * pref, axis=1), 1e-12))
        c0 = jnp.sum((pref @ cdir) / pn * w) / wsum
        vhat = vectors * iv[:, None]
        ctr = vhat - c0 * cdir[None, :]
        off = -(vhat @ cdir)
        sgn = 1.0
        center_vec = cdir
        aux = c0
    else:
        ctr = vectors - mu[None, :]
        off = norms + musq - 2.0 * (vectors @ mu)  # ||v - mu||^2 exact
        sgn = 2.0
        center_vec = mu
        aux = musq
    row_amax = jnp.max(jnp.abs(ctr), axis=1)
    sv = jnp.maximum(jnp.max(jnp.where(valid, row_amax, 0.0)), 1e-12) / 127.0
    base8 = jnp.clip(jnp.round(ctr / sv), -127, 127).astype(jnp.int8)
    off = jnp.where(valid, off, jnp.inf)
    pad = (-n) % pad_to
    if pad:
        base8 = jnp.pad(base8, ((0, pad), (0, 0)))
        off = jnp.pad(off, (0, pad), constant_values=jnp.inf)
    return base8, off, sv, sgn, center_vec, aux


@functools.partial(jax.jit, static_argnames=("metric",),
                   donate_argnums=(0, 1, 2))
def _update_scan8_shadow(base8, off, sc, vectors, norms, valid, slots,
                         cvec, aux, metric):
    """Incremental int8-shadow refresh: requantize ONLY the mutated rows
    against the CACHED centering (cvec/aux from the last full
    _build_scan8_shadow) so all rows stay mutually consistent — only a
    full rebuild refreshes the centering itself.  O(dirty * d) instead of
    O(N * d) (~1 s at 1M x 512); the shadow arrays are donated in place.
    ``slots`` may contain duplicates (pow2 padding repeats a slot — the
    duplicate scatter writes identical values)."""
    rows = vectors[slots]
    rnorms = norms[slots]
    rvalid = valid[slots]
    if metric == "cosine":
        iv = jax.lax.rsqrt(jnp.maximum(rnorms, 1e-12))
        vhat = rows * iv[:, None]
        ctr = vhat - aux * cvec[None, :]
        off_s = -(vhat @ cvec)
        sgn = -1.0
    else:
        ctr = rows - cvec[None, :]
        off_s = rnorms + aux - 2.0 * (rows @ cvec)
        sgn = -2.0
    sv = jnp.maximum(jnp.max(jnp.abs(ctr), axis=1), 1e-12) / 127.0
    r8 = jnp.clip(jnp.round(ctr / sv[:, None]), -127, 127).astype(jnp.int8)
    off_s = jnp.where(rvalid, off_s, jnp.inf)
    return (base8.at[slots].set(r8),
            off.at[slots].set(off_s),
            sc.at[slots].set(sgn * sv))


@functools.partial(jax.jit, static_argnames=("metric",),
                   donate_argnums=(0, 1))
def _update_scan8g_shadow(base8, off, vectors, norms, valid, slots, cvec,
                          aux, sv, metric):
    """Incremental GLOBAL-scale shadow refresh (`_build_scan8g_shadow`
    sibling of `_update_scan8_shadow`): requantize only the mutated rows
    against the CACHED centering AND the cached global scale ``sv`` — a
    new row wider than the calibrated range clips at +-127 (the next full
    rebuild refreshes sv; the exact refine absorbs the interim error).

    Also returns the number of distinct live rows in this batch that
    clipped (|ctr| > 127*sv): the caller accumulates it and forces a full
    rebuild when the clipped fraction grows non-trivial (clipped rows tie
    at the range boundary, silently biasing pool selection on
    offset/wide-range corpora — and the exact refine cannot
    recover rows the pool never returns)."""
    rows = vectors[slots]
    rnorms = norms[slots]
    rvalid = valid[slots]
    if metric == "cosine":
        iv = jax.lax.rsqrt(jnp.maximum(rnorms, 1e-12))
        vhat = rows * iv[:, None]
        ctr = vhat - aux * cvec[None, :]
        off_s = -(vhat @ cvec)
    else:
        ctr = rows - cvec[None, :]
        off_s = rnorms + aux - 2.0 * (rows @ cvec)
    r8 = jnp.clip(jnp.round(ctr / sv), -127, 127).astype(jnp.int8)
    off_s = jnp.where(rvalid, off_s, jnp.inf)
    # slots is unique + padded by repeating slots[0] (_take_dirty), so a
    # row is a duplicate pad iff it equals slots[0] at position > 0
    first = (jnp.arange(slots.shape[0]) == 0) | (slots != slots[0])
    clipped = jnp.any(jnp.abs(ctr) > 127.0 * sv, axis=1) & rvalid & first
    return (base8.at[slots].set(r8), off.at[slots].set(off_s),
            jnp.sum(clipped))


@functools.partial(jax.jit, static_argnames=("metric",))
def _build_scan8p_shadow(packed, scales, norms, valid, metric):
    """Conditioning vectors for the packed-store pool scan
    (search_mode="scan_pallas_int8" on the COMPRESSED tier): (per-slot f32
    selection offset, per-slot f32 scale, query centering vector).

    Unlike the raw-store shadows there is NO corpus copy — the scan
    (ops/pool_scan.packed_pool_scan) streams the store's own packed
    int8 rows.  Rows were quantized uncentered at write time (that error is
    the store's contract); centering here is query-side only, with the
    per-slot cross term ``cvec . v8_n`` folded into the offset by one
    blocked decode pass:

      * sq-L2: off = norms - 2 sv (mu . v8); sc = -2 sv; queries center
        as q - mu.  Score ~= ||q - v||^2 - ||q||-consts (v = quantized
        row, whose norm-term is EXACT from the stored write-time norms).
      * cosine: off = -sv/|v| (cdir . v8); sc = -sv/|v|; queries center
        as q_hat - cdir.  Score ~= -q_hat . v_hat + per-query consts.
    """
    n, dw = packed.shape
    d = dw * 4

    def _decode(chunk):
        return jax.lax.bitcast_convert_type(chunk, jnp.int8).reshape(
            chunk.shape[0], d).astype(jnp.float32)

    m = min(4096, n)
    pref8 = _decode(packed[:m]) * scales[:m, None]
    w = valid[:m].astype(jnp.float32)
    wsum = jnp.maximum(jnp.sum(w), 1.0)
    if metric == "cosine":
        pn = jnp.sqrt(jnp.maximum(jnp.sum(pref8 * pref8, axis=1), 1e-12))
        mu = jnp.sum(pref8 / pn[:, None] * w[:, None], axis=0) / wsum
        cvec = mu * jax.lax.rsqrt(jnp.maximum(jnp.sum(mu * mu), 1e-12))
    else:
        cvec = jnp.sum(pref8 * w[:, None], axis=0) / wsum

    # blocked correction pass: corr[n] = v8_n . cvec (selection-grade; the
    # per-chunk [chunk, d] f32 decode stays ~16-270 MB, never [N, d]).
    # chunk must DIVIDE n so no tail is dropped: capacity is always
    # 128-rounded, so the 128 fallback (legacy pre-2048-rounding
    # checkpoints) terminates
    chunk = 128
    for mult in (1024, 256, 64, 16, 4, 1):
        if n % (2048 * mult) == 0:
            chunk = 2048 * mult
            break

    def body(i, corr):
        blk = jax.lax.dynamic_slice_in_dim(packed, i * chunk, chunk, axis=0)
        c = _decode(blk) @ cvec
        return jax.lax.dynamic_update_slice_in_dim(corr, c, i * chunk, 0)

    corr = jax.lax.fori_loop(0, n // chunk, body,
                             jnp.zeros((n,), jnp.float32))
    if metric == "cosine":
        iv = jax.lax.rsqrt(jnp.maximum(norms, 1e-12))
        sc = -scales * iv
        off = sc * corr
    else:
        sc = -2.0 * scales
        off = norms - 2.0 * scales * corr
    off = jnp.where(valid, off, jnp.inf)
    return off, sc, cvec


class _IvfLayout(NamedTuple):
    """Balanced cluster-major layout for search_mode="scan_ivf" (built by
    HnswPqIndex._build_ivf_layout; see ops/ivf_scan for the design)."""

    centroids: jax.Array   # [nlist, d] coarse centroids (probe space)
    cm_packed: jax.Array   # [nlist*cap, d/4] i32 cluster-major int8 rows
    off_cm: jax.Array      # [nlist*cap] f32 selection offset (+inf pads)
    sc_cm: jax.Array       # [nlist*cap] f32 selection scale
    cvec: jax.Array        # [d] query centering vector
    pos2slot: jax.Array    # [nlist*cap] i32 grid position -> store slot
    slot2pos: jax.Array    # [capacity] i32 store slot -> grid position
    cap: int               # rows per cluster (static)
    spilled: int           # rows placed outside their top-8 clusters


@jax.jit
def _pack_rows_i8(rows8):
    """[N, d] int8 -> [N, d/4] i32 (ops/distance.pack_int8_rows layout)."""
    n, d = rows8.shape
    return jax.lax.bitcast_convert_type(
        rows8.reshape(n, d // 4, 4), jnp.int32)


@jax.jit
def _gather_ivf_cm(packed_src, off, sc, pos2slot):
    """Permute the packed rows + conditioning vectors cluster-major (one
    word-width row gather; -1 grid pads get +inf offsets)."""
    safe = jnp.maximum(pos2slot, 0)
    live = pos2slot >= 0
    cm = packed_src[safe]
    off_cm = jnp.where(live, off[safe], jnp.inf)
    sc_cm = jnp.where(live, sc[safe], 0.0)
    return cm, off_cm, sc_cm


def _ivf_candidates_overlay(queries, lay_args, valid, overlay, metric,
                            nprobe, p_cap, pool, winners):
    """Shared head of the scan_ivf refine wrappers: pruned-candidate stage
    + exact-overlay slots appended (disjoint from the pool by construction
    — overlaid rows' grid positions are disabled)."""
    from ..ops.ivf_scan import ivf_pool_candidates

    centroids, cm_packed, off_cm, sc_cm, cvec, pos2slot = lay_args
    _, slots = ivf_pool_candidates(
        queries, centroids, cm_packed, off_cm, sc_cm, cvec, pos2slot,
        metric, nprobe, p_cap, pool, winners)
    slots = jnp.where(
        (slots >= 0) & valid[jnp.maximum(slots, 0)], slots, -1)
    if overlay is not None:
        ov = jnp.where(
            (overlay >= 0) & valid[jnp.maximum(overlay, 0)], overlay, -1)
        slots = jnp.concatenate(
            [slots,
             jnp.broadcast_to(ov[None, :], (slots.shape[0], ov.shape[0]))],
            axis=1)
    return slots


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "nprobe", "p_cap", "pool", "winners"))
def pallas_ivf_refine_packed(queries, centroids, cm_packed, off_cm, sc_cm,
                             cvec, pos2slot, packed, scales, norms, valid,
                             ids, overlay, k, metric, nprobe, p_cap, pool,
                             winners, resid=None, rscales=None):
    """Cluster-pruned fused scan + int8(+residual) refine — scan_ivf on
    the compressed store (see ops/ivf_scan for the pipeline)."""
    from ..ops.distance import blocked_rerank_int8

    slots = _ivf_candidates_overlay(
        queries, (centroids, cm_packed, off_cm, sc_cm, cvec, pos2slot),
        valid, overlay, metric, nprobe, p_cap, pool, winners)
    d, out = blocked_rerank_int8(queries, packed, scales, slots, k, metric,
                                 b_norms=norms, resid=resid,
                                 rscales=rscales)
    ext = jnp.where(jnp.isfinite(d), ids[jnp.maximum(out, 0)], -1)
    return d, ext


@functools.partial(
    jax.jit,
    static_argnames=("k", "metric", "nprobe", "p_cap", "pool", "winners"))
def pallas_ivf_refine_raw(queries, centroids, cm_packed, off_cm, sc_cm,
                          cvec, pos2slot, base, valid, ids, overlay, k,
                          metric, nprobe, p_cap, pool, winners):
    """Cluster-pruned fused scan + exact f32 refine — scan_ivf on the raw
    store."""
    from ..ops.distance import blocked_rerank

    slots = _ivf_candidates_overlay(
        queries, (centroids, cm_packed, off_cm, sc_cm, cvec, pos2slot),
        valid, overlay, metric, nprobe, p_cap, pool, winners)
    d, out = blocked_rerank(queries, base, slots, k, metric)
    ext = jnp.where(jnp.isfinite(d), ids[jnp.maximum(out, 0)], -1)
    return d, ext


def _pool_select_cand(queries, center_vec, metric, pool_kernel, pool_args,
                      pool, w):
    """Shared head of every pallas_scan*_refine: center (and for cosine
    normalize) the queries, run the fused pool kernel, rank the [Q, w]
    bucket winners with one tiny approx select, and return the candidate
    slots [Q, pool] (-1 where empty)."""
    from ..ops.distance import normalize_rows

    q = normalize_rows(queries) if metric == "cosine" else queries
    qc = q - center_vec[None, :]
    vals, idx = pool_kernel(qc, *pool_args, w)
    nv, sel = jax.lax.approx_max_k(-vals, pool, recall_target=0.95)
    cand = jnp.take_along_axis(idx, sel, axis=1)
    return jnp.where(jnp.isfinite(nv), cand, -1)


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "pool", "w")
)
def pallas_scan8p_refine(queries, packed, scales, norms, off, sc, center_vec,
                         ids, k, metric, pool, w, resid=None, rscales=None):
    """Packed-store pool scan + int8 refine (the compressed tier's
    exhaustive fast path): packed_pool_scan streams the store's own int8
    rows (s8 x s8 -> s32), a tiny select ranks the bucket winners, and
    blocked_rerank_int8 re-scores the pool with exact write-time norms
    (``norms`` — only the cross term keeps quantization error).  With the
    second-level residual rows (config.refine_residual) the refine's cross
    term reaches ~16-bit precision too — the scan stage stays first-level
    s8 (selection only needs containment)."""
    from ..ops.distance import blocked_rerank_int8
    from ..ops.pool_scan import packed_pool_scan

    cand = _pool_select_cand(queries, center_vec, metric, packed_pool_scan,
                             (packed, off, sc), pool, w)
    d, slots = blocked_rerank_int8(queries, packed, scales, cand, k, metric,
                                   rb=pool, b_norms=norms, resid=resid,
                                   rscales=rscales)
    ext = jnp.where(jnp.isfinite(d), ids[jnp.maximum(slots, 0)], -1)
    return d, ext


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "pool", "w")
)
def pallas_scan8_refine(queries, base, base8, off, sc, center_vec, ids,
                        k, metric, pool, w):
    """s8 x s8 pool scan + exact refine: the int8 pool scan
    (ops/pool_scan.int8_pool_scan; the Triton kernel on the GPU) streams
    the quarter-width shadow, a tiny select ranks the [Q, w] bucket
    winners, and the blocked exact refine orders the pool in f32."""
    from ..ops.distance import blocked_rerank
    from ..ops.pool_scan import int8_pool_scan

    cand = _pool_select_cand(queries, center_vec, metric, int8_pool_scan,
                             (base8, off, sc), pool, w)
    d, slots = blocked_rerank(queries, base, cand, k, metric, rb=pool)
    ext = jnp.where(jnp.isfinite(d), ids[jnp.maximum(slots, 0)], -1)
    return d, ext


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "pool", "w")
)
def pallas_scan8g_refine(queries, base, base8, off, sv, sgn, center_vec,
                         ids, k, metric, pool, w):
    """Integer-epilogue pool scan + exact refine
    (``HnswPqConfig.int8_epilogue="global"``): int8g_pool_scan ranks in
    raw i32 (plain XLA); select + refine are identical to
    pallas_scan8_refine."""
    from ..ops.distance import blocked_rerank
    from ..ops.pool_scan import int8g_pool_scan

    cand = _pool_select_cand(queries, center_vec, metric, int8g_pool_scan,
                             (base8, off, sv, sgn), pool, w)
    d, slots = blocked_rerank(queries, base, cand, k, metric, rb=pool)
    ext = jnp.where(jnp.isfinite(d), ids[jnp.maximum(slots, 0)], -1)
    return d, ext


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "pool", "w")
)
def pallas_scan_refine(queries, base, base16, off, sc, center_vec, ids,
                       k, metric, pool, w):
    """bf16 pool scan + exact refine: ops/pool_scan.raw_pool_scan (plain
    XLA, bf16 operands, f32 accumulation) keeps bucket winners only, a tiny
    select ranks the [Q, w] bucket winners, and the blocked exact refine
    orders the pool in f32."""
    from ..ops.distance import blocked_rerank
    from ..ops.pool_scan import raw_pool_scan

    cand = _pool_select_cand(queries, center_vec, metric, raw_pool_scan,
                             (base16, off, sc), pool, w)
    d, slots = blocked_rerank(queries, base, cand, k, metric, rb=pool)
    ext = jnp.where(jnp.isfinite(d), ids[jnp.maximum(slots, 0)], -1)
    return d, ext


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "block_n", "recall_target")
)
def exact_scan_search(queries, base, norms, valid, ids, k, metric,
                      block_n, recall_target):
    """Blocked exact scan + external-id map — the flagship's default
    search (one dispatch; see HnswPqConfig.search_mode for the design
    rationale)."""
    from ..ops.distance import blocked_knn_fast

    d, slots = blocked_knn_fast(
        queries, base, valid, k, metric=metric, b_norms=norms,
        block_n=block_n, recall_target=recall_target,
    )
    ext = jnp.where(slots >= 0, ids[jnp.maximum(slots, 0)], -1)
    return d, ext


def _cosine_pq_queries(queries, metric, perm):
    """Queries as the quantizer sees them: normalized under cosine (the
    codes hold the unit sphere — see HnswPqIndex._pq_space), then permuted."""
    from ..ops.distance import normalize_rows

    q = normalize_rows(queries) if metric == "cosine" else queries
    return q if perm is None else q[:, perm]


@functools.partial(
    jax.jit, static_argnames=("k", "refine", "impl", "block_n", "metric")
)
def flagship_search(
    queries, codebooks, codes, valid, base, ids, k, refine, impl, block_n,
    metric, perm=None, int8_base=None, int8_scales=None, int8_norms=None,
    int8_resid=None, int8_rscales=None,
):
    """The whole flagship search as ONE device program: distance tables ->
    exhaustive blocked ADC scan with fused top-R -> exact re-rank -> external
    ids.  One dispatch per query batch (the reference pays a JNI crossing per
    call, VectorDBJNI.cpp:142-159; we pay one jit dispatch for the batch).
    With an int8 refine source (the compressed-store regime) the re-rank
    reads packed rows instead of `base`."""
    q_pq = _cosine_pq_queries(queries, metric, perm)
    tables = adc.build_distance_tables(q_pq, codebooks)
    _, cand = adc.adc_scan_topk(tables, codes, valid, refine,
                                block_n=block_n, impl=impl)
    d, slots = _rerank_any(queries, base, cand, k, metric,
                           int8_base, int8_scales, int8_norms,
                           int8_resid, int8_rscales)
    ext = jnp.where(jnp.isfinite(d), ids[jnp.maximum(slots, 0)], -1)
    return d, ext


def _rerank_any(queries, base, cand, k, metric, int8_base, int8_scales,
                int8_norms=None, int8_resid=None, int8_rscales=None):
    if int8_base is not None:
        from ..ops.distance import blocked_rerank_int8

        return blocked_rerank_int8(queries, int8_base, int8_scales, cand,
                                   k, metric, b_norms=int8_norms,
                                   resid=int8_resid, rscales=int8_rscales)
    return _blocked_rerank(queries, base, cand, k, metric)


from ..ops.distance import blocked_rerank as _blocked_rerank  # noqa: E402


@functools.partial(jax.jit, static_argnames=("k", "metric"))
def _graph_refine_pending(queries, base, valid, cand, pending, k, metric):
    """Blocked exact refine of the graph pool + exact overlay over deferred
    (pending) slots scored with ONE [Q, P] dot_general, merged via top_k.

    Mirrors ops/hnsw_graph.hnsw_search_pending's epilogue.  Pending slots
    are disjoint from graph nodes, so the merge cannot duplicate ids; the
    overlay never enters the [Q, R, d] refine gather (that broadcast is
    tens of GB at Q=1024, d=512, P near flush_max)."""
    d_g, i_g = _blocked_rerank(queries, base, cand, k, metric)
    safe = jnp.maximum(pending, 0)
    pv = base[safe]                                          # [P, d]
    dots = jax.lax.dot_general(queries, pv, (((1,), (1,)), ((), ())),
                               preferred_element_type=jnp.float32)
    if metric == "l2":
        qn = jnp.sum(queries * queries, axis=1)
        pn = jnp.sum(pv * pv, axis=1)
        d_p = jnp.maximum(qn[:, None] + pn[None, :] - 2.0 * dots, 0.0)
    else:
        qn = jnp.linalg.norm(queries, axis=1, keepdims=True)
        pn = jnp.linalg.norm(pv, axis=1)[None, :]
        d_p = 1.0 - dots / jnp.maximum(qn * pn, 1e-12)
    ok = (pending >= 0) & valid[safe]
    d_p = jnp.where(ok[None, :], d_p, jnp.inf)
    kp = min(k, d_p.shape[1])
    if d_p.shape[1] > 128:
        # the overlay tolerates an approximate reduction (the graph pool
        # still carries exact rows); an exact top-k on the GPU and the CPU
        negp, argp = jax.lax.approx_max_k(-d_p, kp, recall_target=0.99)
    else:
        negp, argp = jax.lax.top_k(-d_p, kp)
    i_p = jnp.where(jnp.isfinite(-negp), pending[argp], -1)
    cat_d = jnp.concatenate([d_g, -negp], axis=1)
    cat_i = jnp.concatenate([i_g, i_p], axis=1)
    neg, arg = jax.lax.top_k(-cat_d, k)
    out_i = jnp.take_along_axis(cat_i, arg, 1)
    return -neg, jnp.where(jnp.isfinite(-neg), out_i, -1)


@functools.partial(
    jax.jit, static_argnames=("k", "refine", "nprobe", "max_len", "metric")
)
def flagship_search_pruned(
    queries, codebooks, codes, valid, base, ids, centroids, members, overflow,
    k, refine, nprobe, max_len, metric, perm=None, int8_base=None,
    int8_scales=None, int8_norms=None, int8_resid=None, int8_rscales=None,
):
    """IVF-pruned flagship search, fused: coarse probe selection (one small
    matmul) -> gather probed clusters' codes -> ADC scoring -> top-R ->
    exact re-rank -> external ids.  The ScaNN-style partition/score/re-rank
    pipeline that keeps QPS flat as N grows (the exhaustive scan is O(N))."""
    q_n = queries.shape[0]
    q_pq = _cosine_pq_queries(queries, metric, perm)
    tables = adc.build_distance_tables(q_pq, codebooks)
    # probe selection (under cosine the centroids live on the sphere, so
    # the query normalizes too — raw-magnitude probing selects clusters by
    # norm, not angle; measured 66.6% vs 94.7% Recall@10)
    q_probe = queries
    if metric == "cosine":
        from ..ops.distance import normalize_rows

        q_probe = normalize_rows(queries)
    cd = (
        jnp.sum(q_probe * q_probe, axis=1)[:, None]
        + jnp.sum(centroids * centroids, axis=1)[None, :]
        - 2.0 * jax.lax.dot_general(q_probe, centroids,
                                    (((1,), (1,)), ((), ())),
                                    preferred_element_type=jnp.float32)
    )
    _, probes = jax.lax.top_k(-cd, nprobe)                 # [Q, P]
    cand = members[probes].reshape(q_n, nprobe * max_len)  # [Q, C] slots
    # the shared overflow list (quota-spilled members) is always scanned
    cand = jnp.concatenate(
        [cand, jnp.broadcast_to(overflow[None, :], (q_n, overflow.shape[0]))],
        axis=1,
    )
    cand = jnp.where(valid[jnp.maximum(cand, 0)], cand, -1)
    # blocked ADC scoring with a running top-R merge: never materialise the
    # full [Q, C, S] gather (at nprobe=64 that was a multi-GB allocation)
    c_total = cand.shape[1]
    cb = 2048
    c_pad = (-c_total) % cb
    if c_pad:
        cand = jnp.pad(cand, ((0, 0), (0, c_pad)), constant_values=-1)
    n_blocks = (c_total + c_pad) // cb
    r = min(refine, c_total)

    def score_block(carry, blk):
        top_d, top_i = carry
        cnd = jax.lax.dynamic_slice_in_dim(cand, blk * cb, cb, axis=1)
        safe = jnp.maximum(cnd, 0)
        cc = codes[safe].astype(jnp.int32)                 # [Q, cb, S]
        cc = jnp.swapaxes(cc, 1, 2)                        # [Q, S, cb]
        g = jnp.take_along_axis(tables, cc, axis=2)
        d = jnp.sum(g, axis=1)
        d = jnp.where(cnd >= 0, d, jnp.inf)
        cat_d = jnp.concatenate([top_d, d], axis=1)
        cat_i = jnp.concatenate([top_i, cnd], axis=1)
        neg, arg = jax.lax.top_k(-cat_d, r)
        return ((-neg), jnp.take_along_axis(cat_i, arg, 1)), None

    init = (jnp.full((q_n, r), jnp.inf), jnp.full((q_n, r), -1, jnp.int32))
    (negd, short), _ = jax.lax.scan(
        score_block, init, jnp.arange(n_blocks, dtype=jnp.int32)
    )
    short = jnp.where(jnp.isfinite(negd), short, -1)
    # exact re-rank (blocked — same OOM-safety as the exhaustive path)
    d, slots = _rerank_any(queries, base, short, k, metric,
                           int8_base, int8_scales, int8_norms,
                           int8_resid, int8_rscales)
    ext = jnp.where(jnp.isfinite(d), ids[jnp.maximum(slots, 0)], -1)
    return d, ext


@functools.partial(jax.jit, static_argnames=("ef",))
def hnsw_pq_search(graph, codes, tables, valid, ef):
    """Graph traversal with ADC distances (reference:
    HnswPqIndex.searchLayerClosestCompressed :794-827 + searchLayerWithSize
    :905-974): greedy descent on upper layers, ef-beam on layer 0, all with
    quantized distances; the caller re-ranks exactly."""
    q_n = tables.shape[0]
    dist = hg._adc_dist(codes, tables)
    entry = jnp.broadcast_to(graph.entry, (q_n,))
    entry_d = dist(entry[:, None])[:, 0]
    start = jnp.broadcast_to(graph.entry_level, (q_n,))
    stop = jnp.ones((q_n,), jnp.int32)
    cur, cur_d = hg._greedy_descent(graph.neighbors, dist, entry, entry_d, start, stop)
    pool_d, pool_i = hg._beam_level(
        graph.neighbors, jnp.asarray(0), dist, cur, cur_d,
        jnp.ones((q_n,), bool), ef, ef, 4,
    )
    ok = (pool_i >= 0) & valid[jnp.maximum(pool_i, 0)]
    pool_d = jnp.where(ok, pool_d, jnp.inf)
    pool_i = jnp.where(ok, pool_i, -1)
    return pool_d, pool_i
