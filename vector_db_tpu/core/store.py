"""Device-resident vector store — SoA arrays in device memory.

Equivalent of the reference's native VectorStore
(reference: native/core/VectorStore.{h,cpp} — SoA float store + ids +
precomputed squared norms + atomic append).  Here the SoA lives on the
device as pre-allocated static-capacity JAX arrays; "locking" disappears
because state is an immutable pytree and the host wrapper is the single
writer (SURVEY.md §2.3: shared_mutex -> functional state).

Slot management (id -> slot map, tombstone freelist) is host-side runtime
metadata — the analog of the reference's handle bookkeeping, not compute.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterable, Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass

Array = jax.Array


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


@pytree_dataclass
class StoreState:
    """Immutable device arrays: the single source of truth for the corpus."""

    vectors: Array  # [cap, dim] float32
    ids: Array      # [cap] int32 external ids, -1 for empty slots
    norms: Array    # [cap] float32 squared L2 norms (VectorStore.cpp:98-104)
    valid: Array    # [cap] bool live-slot mask (tombstone deletes -> False)

    @property
    def capacity(self) -> int:
        return self.vectors.shape[0]

    @property
    def dim(self) -> int:
        return self.vectors.shape[1]


@pytree_dataclass
class Int8StoreState:
    """Compressed-store variant for corpora whose f32 rows exceed device
    memory: rows are int8-quantized and bit-packed four-per-int32 word
    (ops/distance.pack_int8_rows), 4x smaller than raw f32 — at 10M x 512
    the store is 5.1 GB where the raw matrix would be 20 GB.  Squared norms
    are captured EXACTLY from the incoming f32 rows at write time, so
    distance identities downstream only carry the ~0.4% cross-term
    quantization error.

    The reference's answer to N >> memory is IVF sharding + mmap
    (reference: PERFORMANCE_BENCHMARK_AND_ROADMAP.md:475-525); here the
    device-resident compressed row store IS the mmap analog — refine
    gathers read it as int32 words."""

    packed: Array   # [cap, dim/4] int32 (int8-packed rows)
    scales: Array   # [cap] float32 per-row dequant scales
    ids: Array      # [cap] int32 external ids, -1 for empty slots
    norms: Array    # [cap] float32 EXACT squared norms (from f32 at write)
    valid: Array    # [cap] bool live-slot mask
    # optional second-level int8 residual (HnswPqConfig.refine_residual):
    # row ~ scales*unpack(packed) + rscales*unpack(resid), ~16-bit
    # effective precision at half the bytes of f32 — removes the
    # refine-ordering recall ceiling (ops/distance.pack_int8_residual)
    resid: Optional[Array] = None    # [cap, dim/4] int32
    rscales: Optional[Array] = None  # [cap] float32

    @property
    def capacity(self) -> int:
        return self.packed.shape[0]

    @property
    def dim(self) -> int:
        return self.packed.shape[1] * 4

    @property
    def vectors(self) -> Array:
        """Dequantized rows [cap, dim] f32 — materialises the FULL matrix;
        only for small-capacity host paths (tests, rebuild-on-kind-change).
        Hot paths must use packed/scales directly."""
        from ..ops.distance import unpack_int8_rows

        out = unpack_int8_rows(self.packed, self.scales)
        if self.resid is not None:
            out = out + unpack_int8_rows(self.resid, self.rscales)
        return out


def init_store(capacity: int, dim: int, raw: bool = True,
               residual: bool = False):
    """Pre-allocated max-capacity arrays (reference pre-allocates the same way,
    native/core/VectorStore.cpp:32-34). Capacity is rounded up to a multiple of
    128 so every downstream kernel sees lane-aligned shapes.  ``raw=False``
    allocates the int8-compressed store (no [cap, dim] f32 matrix exists);
    ``residual=True`` adds the second-level int8 residual arrays."""
    cap = _round_up(max(capacity, 128), 128)
    if not raw:
        if dim % 4 != 0:
            raise ValueError(f"compressed store requires dim % 4 == 0, got {dim}")
        # 2048-rounded so the packed pool scan (ops/pool_scan.
        # packed_pool_scan) never has to pad-copy the multi-GB packed array
        # (its pool width w <= 2048 must divide the row count).  Its cost
        # and benefit are not measured on the H100; see ROADMAP A5.
        cap = _round_up(cap, 2048)
        return Int8StoreState(
            packed=jnp.zeros((cap, dim // 4), jnp.int32),
            scales=jnp.zeros((cap,), jnp.float32),
            ids=jnp.full((cap,), -1, jnp.int32),
            norms=jnp.zeros((cap,), jnp.float32),
            valid=jnp.zeros((cap,), bool),
            resid=jnp.zeros((cap, dim // 4), jnp.int32) if residual else None,
            rscales=jnp.zeros((cap,), jnp.float32) if residual else None,
        )
    if residual:
        raise ValueError("residual refine rows require raw=False "
                         "(the raw store's f32 rows are already exact)")
    return StoreState(
        vectors=jnp.zeros((cap, dim), jnp.float32),
        ids=jnp.full((cap,), -1, jnp.int32),
        norms=jnp.zeros((cap,), jnp.float32),
        valid=jnp.zeros((cap,), bool),
    )


@jax.jit
def _write_slots(state: StoreState, slots: Array, vecs: Array, ids: Array) -> StoreState:
    norms = jnp.sum(vecs * vecs, axis=-1)
    return state.replace(
        vectors=state.vectors.at[slots].set(vecs),
        ids=state.ids.at[slots].set(ids),
        norms=state.norms.at[slots].set(norms),
        valid=state.valid.at[slots].set(ids >= 0),
    )


@functools.partial(jax.jit, donate_argnums=(0,))
def _write_slots_int8(
    state: Int8StoreState, slots: Array, vecs: Array, ids: Array
) -> Int8StoreState:
    """Scatter-write into the compressed store.  The state is DONATED: at
    large capacities the packed array is gigabytes, and an undonated
    .at[].set would transiently double it."""
    from ..ops.distance import pack_int8_residual, pack_int8_rows

    norms = jnp.sum(vecs * vecs, axis=-1)
    packed, scale = pack_int8_rows(vecs)
    extra = {}
    if state.resid is not None:
        rp, rs = pack_int8_residual(vecs, packed, scale)
        extra = dict(resid=state.resid.at[slots].set(rp),
                     rscales=state.rscales.at[slots].set(rs))
    return state.replace(
        packed=state.packed.at[slots].set(packed),
        scales=state.scales.at[slots].set(scale),
        ids=state.ids.at[slots].set(ids),
        norms=state.norms.at[slots].set(norms),
        valid=state.valid.at[slots].set(ids >= 0),
        **extra,
    )


@jax.jit
def _clear_slots(state: StoreState, slots: Array) -> StoreState:
    return state.replace(
        ids=state.ids.at[slots].set(-1),
        valid=state.valid.at[slots].set(False),
    )


class VectorStore:
    """Host wrapper: single-writer slot allocator over a StoreState pytree.

    Add-batches are padded to the next power of two so jit recompiles are
    bounded (static shapes; SURVEY.md §7.3.3).
    """

    def __init__(self, capacity: int, dim: int, raw: bool = True,
                 residual: bool = False):
        if dim <= 0:
            raise ValueError(f"dim must be positive, got {dim}")
        self.raw = raw
        self.state = init_store(capacity, dim, raw=raw, residual=residual)
        self.dim = dim
        self._id_to_slot: dict[int, int] = {}
        self._free: list[int] = list(range(self.state.capacity - 1, -1, -1))

    # ------------------------------------------------------------- properties
    @property
    def capacity(self) -> int:
        return self.state.capacity

    def __len__(self) -> int:
        return len(self._id_to_slot)

    def size(self) -> int:
        return len(self._id_to_slot)

    def contains(self, vec_id: int) -> bool:
        return vec_id in self._id_to_slot

    def slot_of(self, vec_id: int) -> Optional[int]:
        return self._id_to_slot.get(vec_id)

    def ids(self) -> list[int]:
        return list(self._id_to_slot.keys())

    # -------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vecs: np.ndarray) -> tuple[list[int], list[int]]:
        """Insert a batch. Returns (accepted external ids, assigned slots).

        Duplicate ids and capacity overflow are rejected per-row (the reference
        returns false for duplicates, index/HnswIndex.java:139-151).
        """
        vecs = np.asarray(vecs, dtype=np.float32)
        if vecs.ndim != 2 or vecs.shape[1] != self.dim:
            raise ValueError(f"expected [*, {self.dim}] vectors, got {vecs.shape}")
        take_ids: list[int] = []
        take_rows: list[int] = []
        slots: list[int] = []
        for row, vid in enumerate(ids):
            vid = int(vid)
            if vid < 0 or vid in self._id_to_slot or not self._free:
                continue
            slot = self._free.pop()
            self._id_to_slot[vid] = slot
            take_ids.append(vid)
            take_rows.append(row)
            slots.append(slot)
        if not take_ids:
            return [], []
        n = len(take_ids)
        n_pad = 1 << (n - 1).bit_length()  # next pow2 => bounded recompiles
        pad = n_pad - n
        # pad rows are exact duplicates of the last real row: the scatter write
        # is idempotent, so padding never changes the final state
        slot_arr = np.asarray(slots + [slots[-1]] * pad, np.int32)
        id_arr = np.asarray(take_ids + [take_ids[-1]] * pad, np.int32)
        vec_arr = np.concatenate(
            [vecs[take_rows], np.repeat(vecs[take_rows][-1:], pad, 0)], 0
        )
        write = _write_slots if self.raw else _write_slots_int8
        self.state = write(
            self.state,
            jnp.asarray(slot_arr),
            jnp.asarray(vec_arr),
            jnp.asarray(id_arr),
        )
        return take_ids, slots

    def add(self, vec_id: int, vec: np.ndarray) -> Optional[int]:
        accepted, slots = self.add_batch([vec_id], np.asarray(vec, np.float32)[None, :])
        return slots[0] if accepted else None

    def bulk_load(self, ids: Sequence[int], vectors: Array) -> list[int]:
        """Zero-copy bulk ingest of an already-device-resident [n, dim] array.

        The store must be empty; rows land in slots 0..n-1.  Avoids the
        host->device round trip of add_batch: a corpus generated or already
        resident on the device is ingested without a transfer.
        """
        if self._id_to_slot:
            raise ValueError("bulk_load requires an empty store")
        n = vectors.shape[0]
        if n > self.state.capacity or vectors.shape[1] != self.dim:
            raise ValueError(f"bulk_load shape {vectors.shape} exceeds store")
        ids_np = np.asarray(list(ids), np.int32)
        if len(ids_np) != n:
            raise ValueError("ids/vectors length mismatch")
        cap = self.state.capacity
        id_arr = jnp.full((cap,), -1, jnp.int32).at[:n].set(jnp.asarray(ids_np))
        if self.raw:
            vec_arr = jnp.zeros((cap, self.dim), jnp.float32).at[:n].set(vectors)
            self.state = StoreState(
                vectors=vec_arr,
                ids=id_arr,
                norms=jnp.sum(vec_arr * vec_arr, axis=1),
                valid=id_arr >= 0,
            )
        else:
            from ..ops.distance import pack_int8_residual, pack_int8_rows

            vectors = jnp.asarray(vectors, jnp.float32)
            packed, scale = pack_int8_rows(vectors)
            extra = {}
            if self.state.resid is not None:
                rp, rs = pack_int8_residual(vectors, packed, scale)
                extra = dict(
                    resid=jnp.zeros((cap, self.dim // 4), jnp.int32)
                    .at[:n].set(rp),
                    rscales=jnp.zeros((cap,), jnp.float32).at[:n].set(rs),
                )
            self.state = Int8StoreState(
                packed=jnp.zeros((cap, self.dim // 4), jnp.int32).at[:n].set(packed),
                scales=jnp.zeros((cap,), jnp.float32).at[:n].set(scale),
                ids=id_arr,
                norms=jnp.zeros((cap,), jnp.float32)
                .at[:n].set(jnp.sum(vectors * vectors, axis=1)),
                valid=id_arr >= 0,
                **extra,
            )
        self._id_to_slot = {int(v): i for i, v in enumerate(ids_np)}
        self._free = list(range(cap - 1, n - 1, -1))
        return ids_np.tolist()

    def rows(self, slots) -> jax.Array:
        """Device rows [len(slots), dim] f32 for the given slot array —
        raw-store slices or int8 dequantization (the compressed regime's
        only f32 view; ~0.4% per-element error).  The seam every consumer
        of row values (PQ training/encode, coarse assignment, rebuilds)
        goes through so index code is store-format agnostic."""
        sl = jnp.asarray(slots)
        if self.raw:
            return self.state.vectors[sl]
        from ..ops.distance import unpack_int8_rows

        out = unpack_int8_rows(self.state.packed[sl], self.state.scales[sl])
        if self.state.resid is not None:
            out = out + unpack_int8_rows(self.state.resid[sl],
                                         self.state.rscales[sl])
        return out

    def remove(self, vec_id: int) -> Optional[int]:
        """Tombstone delete. Returns the freed slot, or None if absent."""
        slot = self._id_to_slot.pop(int(vec_id), None)
        if slot is None:
            return None
        self.state = _clear_slots(self.state, jnp.asarray([slot], jnp.int32))
        self._free.append(slot)
        return slot

    def get(self, vec_id: int) -> Optional[np.ndarray]:
        slot = self._id_to_slot.get(int(vec_id))
        if slot is None:
            return None
        if self.raw:
            return np.asarray(self.state.vectors[slot])
        return np.asarray(self.rows(np.asarray([slot], np.int32))[0])

    # ---------------------------------------------------------- persistence
    def to_host(self) -> dict:
        """Snapshot for checkpointing (storage/checkpoint.py).  The
        compressed store checkpoints its packed/scales arrays (7x fewer
        bytes than dequantized f32 would be — and dequantizing 10M rows to
        save them would itself OOM)."""
        out = {
            "ids": np.asarray(self.state.ids),
            "norms": np.asarray(self.state.norms),
            "valid": np.asarray(self.state.valid),
        }
        if self.raw:
            out["vectors"] = np.asarray(self.state.vectors)
        else:
            out["packed8"] = np.asarray(self.state.packed)
            out["scales8"] = np.asarray(self.state.scales)
            if self.state.resid is not None:
                out["resid8"] = np.asarray(self.state.resid)
                out["rscales8"] = np.asarray(self.state.rscales)
        return out

    @classmethod
    def from_host(cls, arrays: dict) -> "VectorStore":
        st = cls.__new__(cls)
        st.raw = "vectors" in arrays
        if st.raw:
            vecs = np.asarray(arrays["vectors"], np.float32)
            cap, st.dim = vecs.shape
            st.state = StoreState(
                vectors=jnp.asarray(vecs),
                ids=jnp.asarray(arrays["ids"], jnp.int32),
                norms=jnp.asarray(arrays["norms"], jnp.float32),
                valid=jnp.asarray(arrays["valid"], bool),
            )
        else:
            packed = np.asarray(arrays["packed8"], np.int32)
            cap = packed.shape[0]
            st.dim = packed.shape[1] * 4
            st.state = Int8StoreState(
                packed=jnp.asarray(packed),
                scales=jnp.asarray(arrays["scales8"], jnp.float32),
                ids=jnp.asarray(arrays["ids"], jnp.int32),
                norms=jnp.asarray(arrays["norms"], jnp.float32),
                valid=jnp.asarray(arrays["valid"], bool),
                resid=(jnp.asarray(arrays["resid8"], jnp.int32)
                       if "resid8" in arrays else None),
                rscales=(jnp.asarray(arrays["rscales8"], jnp.float32)
                         if "rscales8" in arrays else None),
            )
        ids = np.asarray(arrays["ids"])
        valid = np.asarray(arrays["valid"])
        st._id_to_slot = {int(i): s for s, i in enumerate(ids) if valid[s]}
        st._free = [s for s in range(cap - 1, -1, -1) if not valid[s]]
        return st
