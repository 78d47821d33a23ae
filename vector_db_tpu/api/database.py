"""VectorDatabase — the user-facing facade with Builder.

Parity with the reference's API layer (reference: core/VectorDatabase.java):
Builder (:326-410), addVector (:151-170, storage-first), getVector (:178),
deleteVector (:192-205), search (:214-221), size (:226), rebuildIndex
(:284-286), loadFromStorage (:291-313), close (:319), compression getters
(:253-276), and the IndexType-driven index factory (:71-103).

Differences: search is batch-first (a batch of queries is one matmul),
persistence checkpoints device arrays instead of replaying JSON, and the
JNI/handle seam is replaced by the jit dispatch boundary inside each index.
"""

from __future__ import annotations

import enum
import functools
import os
from typing import Optional, Sequence

import numpy as np

from ..core.types import SearchResult, Vector, make_results
from ..index.base import VectorIndex
from ..utils.locks import RWLock
from ..storage import checkpoint as ckpt
from .config import (
    AnnoyConfig,
    CompressionConfig,
    CompressionType,
    HnswConfig,
    HnswPqConfig,
    IvfConfig,
    LshConfig,
    PqConfig,
)

FORMAT_VERSION = 1



def _reads(fn):
    """Concurrent-reader facade method (see utils/locks.RWLock: readers run
    together; a writer is exclusive — the reference's shared_mutex shape)."""
    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._rw.read():
            return fn(self, *a, **k)
    return wrapper


def _writes(fn):
    """Exclusive-writer facade method: mutations DONATE the previous store
    buffers on the compressed tier (core/store._write_slots_int8), so a
    write must never overlap another write or an in-dispatch read."""
    @functools.wraps(fn)
    def wrapper(self, *a, **k):
        with self._rw.write():
            return fn(self, *a, **k)
    return wrapper


class IndexType(enum.Enum):
    """reference: core/VectorDatabase.java:25-32 (+ BRUTE, the exact baseline
    config of BASELINE.json)."""

    BRUTE = "brute"
    HNSW = "hnsw"
    ANNOY = "annoy"
    LSH = "lsh"
    IVF = "ivf"
    PQ = "pq"
    HNSWPQ = "hnswpq"


def _create_index(
    index_type: IndexType,
    dim: int,
    capacity: int,
    metric: str,
    compression: CompressionConfig,
    index_config=None,
) -> VectorIndex:
    """Index factory (reference: core/VectorDatabase.java:71-103).

    Like the reference, a PQ/HNSWPQ CompressionConfig overrides the plain
    index choice (:75-85).
    """
    if compression.enabled and index_type in (IndexType.HNSW, IndexType.HNSWPQ, IndexType.PQ):
        if compression.compression_type == CompressionType.HNSWPQ:
            index_type = IndexType.HNSWPQ
        elif compression.compression_type == CompressionType.PQ:
            index_type = IndexType.PQ

    if index_type == IndexType.BRUTE:
        from ..index.brute import BruteForceIndex

        return BruteForceIndex(dim, capacity, metric)
    if index_type == IndexType.HNSW:
        from ..index.hnsw import HnswIndex

        return HnswIndex(dim, capacity, metric, index_config or HnswConfig())
    if index_type == IndexType.HNSWPQ:
        from ..index.hnsw_pq import HnswPqIndex

        cfg = index_config
        if cfg is None:
            sub = compression.effective_subspaces(dim) if compression.enabled else max(1, dim // 8)
            cfg = HnswPqConfig(
                num_subspaces=sub,
                training_iterations=compression.training_iterations,
            )
        return HnswPqIndex(dim, capacity, metric, cfg)
    if index_type == IndexType.PQ:
        from ..index.pq import PqIndex

        cfg = index_config
        if cfg is None:
            sub = compression.effective_subspaces(dim) if compression.enabled else 8
            cfg = PqConfig(num_subspaces=sub)
        return PqIndex(dim, capacity, metric, cfg)
    if index_type == IndexType.IVF:
        from ..index.ivf import IvfIndex

        return IvfIndex(dim, capacity, metric, index_config or IvfConfig())
    if index_type == IndexType.LSH:
        from ..index.lsh import LshIndex

        return LshIndex(dim, capacity, metric, index_config or LshConfig())
    if index_type == IndexType.ANNOY:
        from ..index.annoy import AnnoyIndex

        return AnnoyIndex(dim, capacity, metric, index_config or AnnoyConfig())
    raise ValueError(f"unsupported index type: {index_type}")


class VectorDatabase:
    """Embedded vector database.

    Usage mirrors the reference Builder chain::

        db = (VectorDatabase.builder()
              .with_dimension(512)
              .with_max_elements(100_000)
              .with_index_type(IndexType.HNSWPQ)
              .with_compression(CompressionConfig.recommended_config(512))
              .with_storage_path("./data")
              .build())
    """

    def __init__(
        self,
        dimension: int,
        max_elements: int,
        index_type: IndexType = IndexType.HNSW,
        metric: str = "l2",
        storage_path: Optional[str] = None,
        compression: Optional[CompressionConfig] = None,
        index_config=None,
        flush_interval: int = 1000,
        auto_load: bool = True,
        durability: str = "flush",
    ):
        if dimension <= 0:
            raise ValueError("dimension must be positive")
        if max_elements <= 0:
            raise ValueError("max_elements must be positive")
        self.dimension = dimension
        self.max_elements = max_elements
        self.index_type = index_type
        self.metric = metric
        self.storage_path = storage_path
        self.compression = compression or CompressionConfig.default_config()
        self.flush_interval = flush_interval  # write-behind cadence
        # (reference: storage/VectorStorage.java:81,128 flushes every 1000)
        self._mutations_since_flush = 0
        self._closed = False
        # facade-level reader-writer lock (utils/locks.py): searches
        # run concurrently, mutations are exclusive — required because
        # big-store writes donate the previous state buffers
        self._rw = RWLock()
        self.index = _create_index(
            index_type, dimension, max_elements, metric, self.compression, index_config
        )
        # write-ahead log via the native storage engine (C++ libvdbstore with
        # a format-compatible Python fallback).  Durability policy:
        #   "buffered" — durable at checkpoint/flush/close only (the
        #                reference's 1000-mutation write-behind guarantee,
        #                VectorStorage.java:81)
        #   "flush"    — default: every acknowledged mutation survives a
        #                process crash (kill -9)
        #   "fsync"    — every acknowledged mutation survives an OS crash
        self.durability = durability
        self._engine = None
        # the compressed regime (HnswPqConfig.raw_store=False) is a
        # bulk/checkpoint tier: per-mutation WAL durability would write f32
        # row payloads the store itself refuses to hold (20 GB at 10M x 512)
        # and the save()-time WAL snapshot would do the same.  Durability
        # there = checkpoints (save()/close()); the WAL engine is skipped.
        compressed = (
            getattr(getattr(self.index, "store", None), "raw", True) is False
        )
        if storage_path and not compressed:
            from ..storage.native import open_engine

            wal_dir = os.path.join(storage_path, "wal")
            os.makedirs(wal_dir, exist_ok=True)
            self._engine = open_engine(wal_dir, dimension, durability=durability)
        if auto_load and storage_path:
            self.load_from_storage()

    # ---------------------------------------------------------------- builder
    @classmethod
    def builder(cls) -> "VectorDatabase.Builder":
        return cls.Builder()

    class Builder:
        """reference: core/VectorDatabase.java:326-410"""

        def __init__(self):
            self._dim: Optional[int] = None
            self._max: Optional[int] = None
            self._type = IndexType.HNSW
            self._metric = "l2"
            self._path: Optional[str] = None
            self._compression: Optional[CompressionConfig] = None
            self._index_config = None
            self._index: Optional[VectorIndex] = None
            self._durability = "flush"
            self._search_mode: Optional[str] = None

        def with_durability(self, durability: str) -> "VectorDatabase.Builder":
            """WAL durability: "buffered" | "flush" (default) | "fsync"."""
            self._durability = durability
            return self

        def with_dimension(self, d: int) -> "VectorDatabase.Builder":
            self._dim = d
            return self

        def with_max_elements(self, m: int) -> "VectorDatabase.Builder":
            self._max = m
            return self

        def with_index_type(self, t) -> "VectorDatabase.Builder":
            self._type = t if isinstance(t, IndexType) else IndexType(str(t))
            return self

        def with_metric(self, metric: str) -> "VectorDatabase.Builder":
            self._metric = metric
            return self

        def with_storage_path(self, p: str) -> "VectorDatabase.Builder":
            self._path = p
            return self

        def with_compression(self, c: CompressionConfig) -> "VectorDatabase.Builder":
            self._compression = c
            return self

        def with_index_config(self, cfg) -> "VectorDatabase.Builder":
            self._index_config = cfg
            return self

        def with_search_mode(self, mode: str) -> "VectorDatabase.Builder":
            """HNSWPQ search-mode shortcut (auto | scan_exact | scan_bf16 | scan_pallas
            | scan_pallas_int8 | scan_int8 | adc | adc_fast | pca | graph — see
            HnswPqConfig.search_mode) without hand-building an index config."""
            self._search_mode = mode
            return self

        def with_index(self, index: VectorIndex) -> "VectorDatabase.Builder":
            """Direct index injection (reference: Builder.withIndex :402)."""
            self._index = index
            return self

        def build(self) -> "VectorDatabase":
            if self._dim is None or self._max is None:
                raise ValueError("dimension and max_elements are required")
            if self._search_mode is not None:
                if self._type is not IndexType.HNSWPQ:
                    raise ValueError(
                        "with_search_mode applies to IndexType.HNSWPQ"
                    )
                import dataclasses

                from .config import HnswPqConfig

                cfg = self._index_config or HnswPqConfig()
                # replace, don't mutate: a config object shared across
                # builders must not inherit this builder's search mode
                self._index_config = dataclasses.replace(
                    cfg, search_mode=self._search_mode
                )
            db = VectorDatabase(
                self._dim,
                self._max,
                self._type,
                self._metric,
                self._path,
                self._compression,
                self._index_config,
                auto_load=self._index is None,
                durability=self._durability,
            )
            if self._index is not None:
                db.index = self._index
            return db

    # ------------------------------------------------------------------ CRUD
    @_writes
    def add_vector(self, vec_id: int, values: np.ndarray) -> bool:
        """Insert one vector; False on duplicate/overflow/dim-mismatch
        (reference: core/VectorDatabase.java:151-170)."""
        self._check_open()
        values = np.asarray(values, np.float32)
        if values.shape != (self.dimension,):
            return False
        ok = self.index.add(int(vec_id), values)
        if ok:
            if self._engine is not None:
                self._engine.append_add(int(vec_id), values)
            self._note_mutation()
        return ok

    @_writes
    def add_batch(self, ids: Sequence[int], values: np.ndarray) -> list[int]:
        """Batch insert; returns accepted ids (reference batch path:
        jni/NativeIndex.java:153-179)."""
        self._check_open()
        values = np.asarray(values, np.float32)
        id_list = [int(i) for i in ids]
        accepted = self.index.add_batch(id_list, values)
        if accepted:
            if self._engine is not None:
                # pair each accepted id with the row of its FIRST occurrence:
                # the store accepts the first occurrence of a duplicate id, so
                # rows must be deduplicated the same way or values[rows] would
                # zip against `accepted` off-by-one and persist wrong vectors
                first_row: dict[int, int] = {}
                for i, vid in enumerate(id_list):
                    if vid not in first_row:
                        first_row[vid] = i
                rows = [first_row[vid] for vid in accepted]
                self._engine.append_add_batch(
                    np.asarray(accepted, np.int32), values[rows]
                )
            self._note_mutation(len(accepted))
        return accepted

    @_writes
    def bulk_load(self, ids: Sequence[int], vectors) -> list[int]:
        """Zero-copy bulk ingest of an (ideally device-resident) corpus into
        an empty database — the fast path that skips per-row WAL appends (a
        checkpoint is written right after when a storage path is set, so
        durability is preserved).  See VectorStore.bulk_load."""
        self._check_open()
        if not hasattr(self.index, "bulk_load"):
            raise ValueError(
                f"index kind {self.index.kind!r} has no bulk_load"
            )
        accepted = self.index.bulk_load(ids, vectors)
        if accepted and self.storage_path:
            self._save_unlocked()
        return accepted

    @_writes
    def bulk_load_stream(self, chunks) -> int:
        """Streamed bulk ingest for corpora whose raw f32 form exceeds
        device memory (chunks yields (ids, vectors) pairs — see
        HnswPqIndex.bulk_load_stream); combine with
        HnswPqConfig(raw_store=False)."""
        self._check_open()
        if not hasattr(self.index, "bulk_load_stream"):
            raise ValueError(
                f"index kind {self.index.kind!r} has no bulk_load_stream"
            )
        n = self.index.bulk_load_stream(chunks)
        if n and self.storage_path:
            self._save_unlocked()
        return n

    @_reads
    def get_vector(self, vec_id: int) -> Optional[Vector]:
        """reference: core/VectorDatabase.java:178-185"""
        self._check_open()
        vals = self.index.get(int(vec_id))
        return Vector(int(vec_id), vals) if vals is not None else None

    @_writes
    def delete_vector(self, vec_id: int) -> bool:
        """reference: core/VectorDatabase.java:192-205"""
        self._check_open()
        ok = self.index.remove(int(vec_id))
        if ok:
            if self._engine is not None:
                self._engine.append_delete(int(vec_id))
            self._note_mutation()
        return ok

    # ---------------------------------------------------------------- search
    @_reads
    def search(self, query: np.ndarray, k: int) -> list[SearchResult]:
        """k-NN search (reference: core/VectorDatabase.java:214-221)."""
        self._check_open()
        query = np.asarray(query, np.float32)
        if query.shape != (self.dimension,):
            raise ValueError(f"query must have dimension {self.dimension}")
        ids, dists = self.index.search(query, k)
        return make_results(ids.tolist(), dists.tolist(), self.metric)

    @_reads
    def search_batch(self, queries: np.ndarray, k: int) -> list[list[SearchResult]]:
        """Batched k-NN — the QPS path (reference:
        jni/NativeIndex.java:187-230)."""
        self._check_open()
        from ..utils.stats import GLOBAL, timed

        queries = np.asarray(queries, np.float32)
        with timed("search_batch"):
            ids, dists = self.index.search_batch(queries, k)
        GLOBAL.bump("queries", queries.shape[0])
        return [
            make_results(ids[q].tolist(), dists[q].tolist(), self.metric)
            for q in range(queries.shape[0])
        ]

    # ------------------------------------------------------------------ state
    @_reads
    def size(self) -> int:
        self._check_open()
        return self.index.size()

    def metrics(self) -> dict:
        """Process-wide operation counters/latencies (SURVEY.md §5.1 analog
        of the reference's timing dumps)."""
        from ..utils.stats import GLOBAL

        return GLOBAL.snapshot()

    @_writes
    def rebuild_index(self) -> None:
        """reference: core/VectorDatabase.java:284-286"""
        self._check_open()
        self.index.build()

    def stats(self) -> dict:
        return self.index.stats()

    # ---------------------------------------------------------- compression
    def is_compression_enabled(self) -> bool:
        """reference: core/VectorDatabase.java:253-258"""
        return self.compression.enabled or self.index.kind in ("pq", "hnswpq")

    def get_compression_ratio(self) -> float:
        """reference: core/VectorDatabase.java:260-268.  Reflects the live
        index (an HNSWPQ/PQ index configured via with_index_config counts)."""
        s = self.index.stats()
        if "compression_ratio" in s:
            return float(s["compression_ratio"])
        return self.compression.compression_ratio(self.dimension)

    def get_memory_savings_pct(self) -> float:
        """reference: core/VectorDatabase.java:270-276"""
        r = self.get_compression_ratio()
        return (1.0 - 1.0 / r) * 100.0 if r > 0 else 0.0

    # ---------------------------------------------------------- persistence
    def save(self) -> bool:
        """Checkpoint the full database state (store + index structures)."""
        with self._rw.write():
            return self._save_unlocked()

    def _save_unlocked(self) -> bool:
        # callers inside a mutating facade method already hold the write
        # lock (RWLock is not reentrant)
        self._check_open()
        if not self.storage_path:
            return False
        meta = {
            "format_version": FORMAT_VERSION,
            "dimension": self.dimension,
            "max_elements": self.max_elements,
            "index_type": self.index_type.value,
            "index_kind": self.index.kind,
            "metric": self.metric,
            "size": self.index.size(),
        }
        arrays = self.index.state_arrays()
        ckpt.save_checkpoint(self.storage_path, meta, arrays)
        if self._engine is not None:
            # snapshot the live set -> WAL truncates (checkpoint and WAL
            # snapshot are now consistent).  Reuses the store snapshot already
            # fetched for the checkpoint: ONE bulk device->host transfer, then
            # live rows are selected host-side (a per-id index.get loop would
            # cost one device round trip per vector).
            snap = arrays.get("store")
            if snap is not None:
                ids_arr = np.asarray(snap["ids"])
                valid = np.asarray(snap["valid"])
                live = np.flatnonzero(valid)
                live = live[np.argsort(ids_arr[live], kind="stable")]
                self._engine.snapshot(
                    ids_arr[live].astype(np.int32),
                    np.asarray(snap["vectors"])[live],
                )
            else:
                self._engine.snapshot(
                    np.empty(0, np.int32),
                    np.empty((0, self.dimension), np.float32),
                )
        self._mutations_since_flush = 0
        return True

    @_writes
    def load_from_storage(self) -> bool:
        """Restore from checkpoint — O(bytes), no index rebuild
        (contrast reference: core/VectorDatabase.java:291-313 replays inserts)."""
        self._check_open()
        if not self.storage_path:
            return False
        loaded = ckpt.load_checkpoint(self.storage_path)
        if loaded is None:
            # no checkpoint: recover everything from the WAL alone
            return self._reconcile_wal() > 0
        meta, arrays = loaded
        if meta.get("dimension") != self.dimension:
            raise ValueError(
                f"checkpoint dimension {meta.get('dimension')} != {self.dimension}"
            )
        if meta.get("index_kind") != self.index.kind:
            # checkpoint was written by a different index type: rebuild via the
            # stored raw vectors if present
            if "store" in arrays:
                from ..core.store import VectorStore

                store = VectorStore.from_host(arrays["store"])
                ids = store.ids()
                if ids:
                    vecs = np.stack([store.get(i) for i in ids])
                    self.index.add_batch(ids, vecs)
                    self.index.build()
                return True
            return False
        self.index.load_state_arrays(arrays)
        # replay mutations that landed after the checkpoint from the WAL
        self._reconcile_wal()
        return True

    def _reconcile_wal(self) -> int:
        """Bring the index in line with the WAL's live set.  Returns the
        number of applied mutations (adds + deletes)."""
        if self._engine is None:
            return 0
        wal_ids, wal_vecs = self._engine.load(self.max_elements)
        wal_set = {int(i) for i in wal_ids}
        if hasattr(self.index, "store"):
            index_set = set(self.index.store.ids())
        else:
            index_set = set()
        applied = 0
        missing = [i for i, vid in enumerate(wal_ids) if int(vid) not in index_set]
        if missing:
            self.index.add_batch(
                [int(wal_ids[i]) for i in missing], wal_vecs[missing]
            )
            applied += len(missing)
        for vid in index_set - wal_set:
            if self.index.remove(vid):
                applied += 1
        return applied

    def close(self) -> None:
        """Flush and close (reference: core/VectorDatabase.java:319)."""
        with self._rw.write():
            if self._closed:
                return
            if self.storage_path:
                self._save_unlocked()
            if self._engine is not None:
                self._engine.close()
            self._closed = True

    def __enter__(self) -> "VectorDatabase":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # ---------------------------------------------------------------- private
    def _note_mutation(self, n: int = 1) -> None:
        self._mutations_since_flush += n
        if self.storage_path and self._mutations_since_flush >= self.flush_interval:
            self._save_unlocked()

    def _check_open(self) -> None:
        if self._closed:
            raise RuntimeError("database is closed")
