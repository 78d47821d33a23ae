"""LSH index — random-projection hashing with exact re-rank.

Analog of the reference's LSH (reference: index/LshIndex.java —
10 hash fns x 5 tables, bucket width 4 :40-42, quantized-projection hash
:115-135, candidate-union + exact re-rank search :245-281, buildIndex
regenerates hash fns :303-339; native/index/LSHIndex.cpp — 10 tables x 20
sign bits, collision counting :78-117).

Array design: codes for all vectors live as a device matrix
``bucket_ids [T, cap] int32``; search compares the query's codes against it
full-N (memory-bound integer ops instead of host-side hash maps) and exact
re-ranks the collision set — the reference's candidate-union + re-rank as
two fused device ops.  Two modes:

  * multi-probe sign-LSH (default, ``hamming_radius > 0``): bit-packed
    SimHash codes, candidate iff Hamming distance <= r in some table — the
    array form of multi-probe LSH.  Scale-free and honestly recalls 79-96%
    where exact-bucket matching recalls ~0 (see LshConfig).
  * exact-bucket (``hamming_radius == 0``): quantized-projection polynomial
    hash + equality, the reference's semantics (incl. its failure mode:
    AND-of-16 quantized projections collides essentially never on
    high-dimensional data — its published 75% row leans on random-fill,
    LshIndex.java:261-265).
"""

from __future__ import annotations

import functools
import threading
from typing import Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..api.config import LshConfig
from ..core.store import VectorStore
from ..ops.distance import blocked_knn, pairwise_dist
from .base import VectorIndex, pad_queries_pow2, pow2

# candidate-table pool for num_tables=0 (auto) in sign mode: the joint
# (tables, radius) calibration picks a prefix of this many tables
# (index/lsh.LshIndex._auto_tables_calibrate)
_AUTO_TABLE_POOL = 32


def _popcount(x: np.ndarray) -> np.ndarray:
    """Vectorized popcount of int32 code matrices (advisor r3: the
    bin().count Python loop was the last host inner loop in a search
    path — np.bitwise_count is ~1000x faster at calibration sizes).

    np.bitwise_count needs NumPy >= 2.0 (advisor r4: pyproject allows
    1.24+ where the default sign-mode auto-calibration would raise at
    first search); fall back to an unpackbits popcount on 1.x."""
    u = x.view(np.uint32)
    if hasattr(np, "bitwise_count"):
        return np.bitwise_count(u)
    bytes_ = u.view(np.uint8).reshape(*u.shape, 4)
    return np.unpackbits(bytes_, axis=-1).sum(axis=-1).astype(u.dtype)


@jax.jit
def _bucket_ids(vectors: jnp.ndarray, planes: jnp.ndarray, width: float) -> jnp.ndarray:
    """Quantized-projection bucket ids (reference: LshIndex.java:115-135 —
    Arrays.hashCode over floor(dot/bucketWidth) per hash fn).

    vectors [N, d]; planes [T, H, d] -> [T, N] int32 mixed hash.
    """
    proj = jnp.einsum("nd,thd->tnh", vectors, planes,
                      preferred_element_type=jnp.float32)
    q = jnp.floor(proj / width).astype(jnp.int32)
    # 31-based polynomial hash mix, same family as Java's Arrays.hashCode
    def mix(carry, x):
        return carry * jnp.int32(31) + x, None
    h0 = jnp.ones(q.shape[:2], jnp.int32)
    h, _ = jax.lax.scan(mix, h0, jnp.moveaxis(q, 2, 0))
    return h


@jax.jit
def _sign_codes(vectors: jnp.ndarray, planes: jnp.ndarray) -> jnp.ndarray:
    """Bit-packed sign codes (SimHash): bit h of table t = (v . plane_th >= 0).

    vectors [N, d]; planes [T, H<=31, d] -> [T, N] int32.  Used by the
    multi-probe search (`hamming_radius > 0`): candidate iff some table's
    code is within Hamming radius r of the query's — the array-program form
    of classic multi-probe LSH (probing all buckets at Hamming distance <= r
    == one XOR + popcount over the resident code matrix; no bucket maps).
    Sign bits need no bucket width, so this mode is scale-free.
    """
    proj = jnp.einsum("nd,thd->tnh", vectors, planes,
                      preferred_element_type=jnp.float32)
    h = planes.shape[1]
    weights = jnp.asarray(1 << np.arange(h), jnp.int32)
    return jnp.sum((proj >= 0).astype(jnp.int32) * weights[None, None, :],
                   axis=2)


@functools.partial(
    jax.jit, static_argnames=("k", "metric", "block_n", "radius")
)
def _lsh_search(
    queries, planes, width, bucket_ids, base, b_norms, valid, k,
    metric="l2", block_n=4096, radius=0,
):
    """Blocked collision-gated scan fused with a running top-k (reference:
    LSHIndex.cpp:78-117 counts collisions across tables, then re-ranks).

    Streams the corpus in ``block_n``-row tiles: per tile the collision test
    is a [T, Q, block] integer compare reduced over tables, the re-rank is one
    distance matmul masked to colliding rows, and survivors merge into the
    running top-k.  Peak memory is O(Q * block_n) — never the full [T, Q, N]
    hit tensor or [Q, N] distance matrix (at 100k x 1024 queries those are
    ~1 GB + 400 MB per dispatch).  Pruning here means *masking* a dense
    stream rather than gathering candidates, exactly like the valid-slot
    tombstone mask.
    """
    if radius > 0:
        qb = _sign_codes(queries, planes)             # [T, Q]
    else:
        qb = _bucket_ids(queries, planes, width)      # [T, Q]
    q_n = queries.shape[0]
    n = base.shape[0]
    q_norms = jnp.sum(queries * queries, axis=1)
    n_pad = (-n) % block_n
    if n_pad:
        base = jnp.pad(base, ((0, n_pad), (0, 0)))
        valid = jnp.pad(valid, (0, n_pad))
        b_norms = jnp.pad(b_norms, (0, n_pad))
        bucket_ids = jnp.pad(bucket_ids, ((0, 0), (0, n_pad)))
    num_blocks = (n + n_pad) // block_n

    def body(carry, blk):
        top_d, top_i = carry
        start = blk * block_n
        b_blk = jax.lax.dynamic_slice_in_dim(base, start, block_n, axis=0)
        v_blk = jax.lax.dynamic_slice_in_dim(valid, start, block_n, axis=0)
        n_blk = jax.lax.dynamic_slice_in_dim(b_norms, start, block_n, axis=0)
        bid_blk = jax.lax.dynamic_slice_in_dim(bucket_ids, start, block_n, axis=1)
        if radius > 0:
            hd = jax.lax.population_count(bid_blk[:, None, :] ^ qb[:, :, None])
            hit = jnp.any(hd <= radius, axis=0)                       # [Q, B]
        else:
            hit = jnp.any(bid_blk[:, None, :] == qb[:, :, None], axis=0)
        d_blk = pairwise_dist(queries, b_blk, metric, q_norms, n_blk)
        d_blk = jnp.where(hit & v_blk[None, :], d_blk, jnp.inf)
        i_blk = start + jax.lax.broadcasted_iota(jnp.int32, (q_n, block_n), 1)
        cat_d = jnp.concatenate([top_d, d_blk], axis=1)
        cat_i = jnp.concatenate([top_i, i_blk], axis=1)
        neg, arg = jax.lax.top_k(-cat_d, k)
        return ((-neg), jnp.take_along_axis(cat_i, arg, axis=1)), None

    init = (
        jnp.full((q_n, k), jnp.inf, jnp.float32),
        jnp.full((q_n, k), -1, jnp.int32),
    )
    (top_d, top_i), _ = jax.lax.scan(
        body, init, jnp.arange(num_blocks, dtype=jnp.int32)
    )
    top_i = jnp.where(jnp.isfinite(top_d), top_i, -1)
    return top_d, top_i


class LshIndex(VectorIndex):
    kind = "lsh"

    def __init__(self, dim: int, capacity: int, metric: str = "l2", config: Optional[LshConfig] = None):
        super().__init__(dim, capacity, metric)
        self.config = config or LshConfig()
        # an explicit bucket_width opts into exact-bucket mode: the width is
        # only meaningful for quantized-projection hashing, so honoring it
        # beats silently ignoring it in favor of the default hamming_radius
        # (LshConfig(num_bits=8, bucket_width=4.0) means reference parity)
        # sign (multi-probe) mode unless an explicit width or radius=0
        # opts into exact-bucket semantics
        self._sign_mode = (self.config.bucket_width <= 0
                           and self.config.hamming_radius != 0)
        # auto bit count (LshConfig.num_bits=0): sign mode packs the max 31
        # bits into the int32 code — neighbor/random Hamming separation
        # grows ~sqrt(bits) and the calibrated radius spends it (measured
        # honest R@10 vs the old 16/24-bit rule: 75.5->92.3% at 128d x 10k
        # iso, 63->71% at 512d x 20k iso).  Exact-bucket mode keeps the
        # dimension-aware 16/24 (its AND-of-all-projections hash gets
        # strictly rarer with more bits).
        self._bits = self.config.num_bits or (
            31 if self._sign_mode else (16 if dim < 256 else 24))
        # fixed radius (> 0), or None -> data-calibrated (_auto_radius)
        self._radius: Optional[int] = (
            0 if not self._sign_mode
            else (self.config.hamming_radius
                  if self.config.hamming_radius > 0 else None)
        )
        if self._sign_mode and self._bits > 31:
            raise ValueError(
                "multi-probe sign codes pack into int32: num_bits <= 31 "
                f"required with hamming_radius != 0, got {self._bits}"
            )
        # table count (num_tables=0 -> auto): in sign mode the count is
        # CALIBRATED jointly with the radius at build/first-search from a
        # 32-table candidate pool (_auto_tables_calibrate) — more tables
        # buy recall at high dim where any single-table radius stops
        # separating neighbors from the bulk.  Exact-bucket mode keeps the
        # reference's 10 (its AND-of-all-bits hash leaves no collision
        # mass to trade tables against; LshIndex.java:40-42).
        self._auto_tables = self.config.num_tables == 0 and self._sign_mode
        self._tables = (self.config.num_tables
                        or (_AUTO_TABLE_POOL if self._sign_mode else 10))
        self._tables_final = not self._auto_tables
        self.store = VectorStore(capacity, dim)
        self.seed = 42
        self._gen = 0  # regenerated on build (reference :303-339)
        self._width: Optional[float] = (
            float(self.config.bucket_width)
            if self.config.bucket_width > 0 else None
        )  # bucket_width <= 0 -> data-calibrated at build (see _auto_width)
        self.planes = self._make_planes()
        self.bucket_ids = jnp.zeros((self._tables, self.store.capacity), jnp.int32)
        # observability: how many result rows were exact-scan backfilled
        # because the collision set came up short (reference random-fills,
        # LshIndex.java:261-265) — exposed in stats() so tests can assert
        # recall with backfill accounted for
        self._backfill_rows = 0
        self._backfill_queries = 0
        # serializes the lazy first-search calibrations among CONCURRENT
        # READERS (round-4 review: _truncate_tables mutates planes and
        # bucket_ids non-atomically — a racing search could read a t-table
        # planes with a 32-table bucket_ids; the facade RWLock only
        # excludes writers).  Same pattern as HnswPqIndex._cache_lock.
        self._calib_lock = threading.Lock()

    def _make_planes(self) -> jnp.ndarray:
        rng = np.random.default_rng(self.seed + 7919 * self._gen)
        planes = rng.standard_normal(
            (self._tables, self._bits, self.dim)
        ).astype(np.float32)
        return jnp.asarray(planes)

    def _auto_radius(self) -> int:
        """Data-calibrated Hamming radius (the sign-mode analog of
        _auto_width): measure the min-table Hamming distance between ~256
        sample points and their TRUE nearest neighbors, take the 75th
        percentile (so a typical neighbor collides in at least one table),
        and cap it where the expected random-pair collision fraction
        (binomial tail, union over tables) exceeds ~35% — beyond that the
        gate stops being LSH and becomes a near-full scan."""
        import math

        st = self.store.state
        live = np.flatnonzero(np.asarray(st.valid))
        if live.size < 8:
            return max(1, self._bits // 4)
        rng = np.random.default_rng(self.seed + 13)
        sample = live[rng.permutation(live.size)[:256]]
        sj = st.vectors[jnp.asarray(sample)]
        _, nn = blocked_knn(
            sj, st.vectors, st.valid, 2, metric=self.metric,
            b_norms=st.norms, block_n=min(8192, st.capacity),
        )
        nn_np = np.asarray(nn)[:, 1]  # column 0 is the point itself
        ok = nn_np >= 0
        if not ok.any():
            return max(1, self._bits // 4)
        qs = _sign_codes(sj, self.planes)                       # [T, S]
        ns = _sign_codes(st.vectors[jnp.asarray(nn_np[ok])], self.planes)
        hd = _popcount(np.asarray(qs)[:, ok] ^ np.asarray(ns))
        min_hd = hd.min(axis=0)                                 # [S]
        r = int(np.percentile(min_hd, 75.0))
        # cap: largest r with union random-collision fraction <= 0.35
        # (r=4 at 16 bits/10 tables — the 79%-recall setting at 128d —
        # sits at 0.32; a 0.30 cap regressed it to r=3 / 41%)
        b, t = self._bits, self._tables
        cdf = 0.0
        r_cap = 1
        for i in range(b + 1):
            cdf += math.comb(b, i) / (2.0 ** b)
            if 1.0 - (1.0 - cdf) ** t <= 0.35:
                r_cap = i
            else:
                break
        return max(1, min(r, r_cap))

    def _truncate_tables(self, t: int) -> None:
        """Keep the first ``t`` candidate tables (prefixes of the pool are
        unbiased table samples — the planes are iid)."""
        if t < int(self.planes.shape[0]):
            self.planes = self.planes[:t]
            self.bucket_ids = self.bucket_ids[:t]
        self._tables = int(self.planes.shape[0])
        self._tables_final = True

    def _auto_tables_calibrate(self) -> None:
        """Joint (num_tables, radius) calibration for auto-table sign mode
        (round-3 verdict #8: bits and radius calibrated, but num_tables=10
        stayed static and isotropic 512d x 100k measured 57.9%).

        From a pool of ``_AUTO_TABLE_POOL`` candidate tables, measure on a
        ~256-point corpus sample (a) per-table Hamming distances to each
        point's TRUE nearest neighbor and (b) to random corpus rows, then
        pick the table-prefix/radius pair (t, r) maximizing the measured
        neighbor-collision rate P(min-table HD <= r) subject to the
        measured random-pair collision mass <= 0.35 (beyond that the gate
        is a near-full scan, not LSH).  The mass is EMPIRICAL, not the
        binomial model, so correlated projections (realistic embedding
        spectra) spend the budget honestly.  High dim is where this
        matters: neighbor and random codes overlap per-table, and min over
        ~3x more tables at a tighter radius separates them again (each
        table is an independent draw for the neighbor but the random mass
        is capped by construction)."""
        st = self.store.state
        live = np.flatnonzero(np.asarray(st.valid))
        pool = int(self.planes.shape[0])
        if live.size < 8:
            self._truncate_tables(min(10, pool))
            return
        rng = np.random.default_rng(self.seed + 13)
        sample = live[rng.permutation(live.size)[:256]]
        sj = st.vectors[jnp.asarray(sample)]
        _, nn = blocked_knn(
            sj, st.vectors, st.valid, 2, metric=self.metric,
            b_norms=st.norms, block_n=min(8192, st.capacity),
        )
        nn_np = np.asarray(nn)[:, 1]  # column 0 is the point itself
        ok = nn_np >= 0
        if not ok.any():
            self._truncate_tables(min(10, pool))
            return
        qs = np.asarray(_sign_codes(sj, self.planes))           # [T, S]
        ns = np.asarray(
            _sign_codes(st.vectors[jnp.asarray(nn_np[ok])], self.planes))
        hd_nn = _popcount(qs[:, ok] ^ ns)                       # [T, S']
        reps = 4
        rand_rows = live[rng.integers(0, live.size,
                                      size=(sample.size, reps))]
        not_self = (rand_rows != sample[:, None]).reshape(-1)
        rs = np.asarray(
            _sign_codes(st.vectors[jnp.asarray(rand_rows.reshape(-1))],
                        self.planes))
        hd_rand = _popcount(np.repeat(qs, reps, axis=1) ^ rs)
        hd_rand = hd_rand[:, not_self]                          # [T, P]
        # prefix minima: row t-1 = min over the first t tables
        cmin_nn = np.minimum.accumulate(hd_nn, axis=0)
        cmin_rand = np.minimum.accumulate(hd_rand, axis=0)
        radii = ([self.config.hamming_radius]
                 if self.config.hamming_radius > 0
                 else range(1, self._bits))
        best = None  # ((hit, -mass, -t, -r), t, r)
        for t in (2, 4, 6, 8, 10, 12, 16, 20, 24, 28, 32):
            if t > pool:
                break
            for r in radii:
                mass = float((cmin_rand[t - 1] <= r).mean())
                if mass > 0.35:
                    break  # mass grows with r — rest of the row is out
                hit = float((cmin_nn[t - 1] <= r).mean())
                # maximize hit; tie-break lower mass, fewer tables
                # (scan cost is O(T)), tighter radius
                key = (round(hit, 3), -round(mass, 3), -t, -r)
                if best is None or key > best[0]:
                    best = (key, t, r)
        if best is None:
            # even r=1 is over budget at every table count (degenerate
            # corpus, e.g. many duplicates): smallest gate that is still LSH
            self._truncate_tables(min(10, pool))
            if self.config.hamming_radius <= 0:
                self._radius = 1
            return
        _, t, r = best
        self._truncate_tables(t)
        if self.config.hamming_radius <= 0:
            self._radius = int(r)

    def _effective_radius(self) -> int:
        if (self._auto_tables and not self._tables_final) or self._radius is None:
            with self._calib_lock:  # double-checked: one reader calibrates
                if self._auto_tables and not self._tables_final:
                    self._auto_tables_calibrate()
                if self._radius is None:
                    self._radius = self._auto_radius()
        return self._radius

    def _auto_width(self) -> float:
        """Data-calibrated bucket width: ~10x the median nearest-neighbor
        distance of a corpus sample.

        The reference hardcodes width 4.0 (LshIndex.java:40-42), which only
        matches ITS benchmark scale (uniform[-1,1] at 128d, projections
        ~N(0, 6.5^2)); at 512d the projections are ~4x wider and a fixed 4.0
        yields ZERO collisions (measured: 100% backfill at 512d x 100k).
        For a unit-normal plane the projected gap of a true neighbor pair
        has std = their distance, so width = alpha * d_nn makes the per-
        function collision probability ~1 - d_nn/width ~ 0.9, i.e. a
        per-table (num_bits=16 AND) probability of ~0.19 and a 10-table
        union of ~0.88 — honest-LSH recall at any dimension/scale.
        """
        st = self.store.state
        live = np.flatnonzero(np.asarray(st.valid))
        if live.size < 4:
            return 4.0
        rng = np.random.default_rng(self.seed)
        sample = live[rng.permutation(live.size)[:256]]
        sj = st.vectors[jnp.asarray(sample)]
        d2, _ = blocked_knn(
            sj, st.vectors, st.valid, 2, metric="l2", b_norms=st.norms,
            block_n=min(8192, st.capacity),
        )
        # column 0 is the sample point itself (distance 0); column 1 is its
        # nearest true neighbor
        nn = np.sqrt(np.maximum(np.asarray(d2)[:, 1], 0.0))
        med = float(np.median(nn[np.isfinite(nn)]))
        return max(med * 10.0, 1e-6)

    def _effective_width(self) -> float:
        if self._width is None:
            with self._calib_lock:
                if self._width is None:
                    self._width = self._auto_width()
        return self._width

    # ------------------------------------------------------------- mutation
    def add_batch(self, ids: Sequence[int], vectors: np.ndarray) -> list[int]:
        accepted, slots = self.store.add_batch(ids, vectors)
        if accepted:
            sl = jnp.asarray(np.asarray(slots, np.int64))
            vecs = self.store.state.vectors[sl]
            if self._sign_mode:
                new_b = _sign_codes(vecs, self.planes)  # [T, B]
            else:
                new_b = _bucket_ids(vecs, self.planes,
                                    self._effective_width())
            self.bucket_ids = self.bucket_ids.at[:, sl].set(new_b)
        return accepted

    def remove(self, vec_id: int) -> bool:
        return self.store.remove(vec_id) is not None

    def build(self) -> None:
        """Regenerate hash functions + rehash everything (reference:
        LshIndex.buildIndex :303-339)."""
        self._gen += 1
        if self._auto_tables:
            # regenerate the FULL candidate pool; the next search
            # recalibrates (tables, radius) against the current corpus
            self._tables = _AUTO_TABLE_POOL
            self._tables_final = False
        self.planes = self._make_planes()
        if self.config.bucket_width <= 0:
            self._width = None  # recalibrate against the current corpus
        if self._sign_mode and self.config.hamming_radius < 0:
            self._radius = None  # recalibrate against the current corpus
        st = self.store.state
        if self._sign_mode:
            self.bucket_ids = _sign_codes(st.vectors, self.planes)
        else:
            self.bucket_ids = _bucket_ids(st.vectors, self.planes,
                                          self._effective_width())

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

        if n_live <= k:
            dists, slots = blocked_knn(
                jnp.asarray(padded), st.vectors, st.valid, k_pad,
                metric=self.metric, b_norms=st.norms,
                block_n=min(8192, st.capacity),
            )
        else:
            r = self._effective_radius() if self._sign_mode else 0
            dists, slots = _lsh_search(
                jnp.asarray(padded), self.planes,
                jnp.asarray(1.0 if r > 0 else self._effective_width(),
                            jnp.float32),
                self.bucket_ids, st.vectors, st.norms, st.valid, k_pad,
                metric=self.metric, block_n=min(4096, st.capacity),
                radius=r,
            )
            # random-fill parity (reference: LshIndex.java:261-265): if the
            # collision set came up short, backfill from the exact scan.
            # Backfill events are counted (stats) and can be disabled
            # (config.backfill=False) so tests measure honest LSH recall.
            miss = np.asarray(slots[:q_n, :k_eff] < 0)
            if miss.any():
                self._backfill_rows += int(miss.sum())
                self._backfill_queries += int(miss.any(axis=1).sum())
                if self.config.backfill:
                    fd, fs = blocked_knn(
                        jnp.asarray(padded), st.vectors, st.valid, k_pad,
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
            # actual table count (auto mode truncates the candidate pool
            # at calibration; pre-calibration this reports the pool size)
            num_tables=self._tables,
            num_bits=self._bits,
            bucket_width=(self._effective_width()
                          if not self._sign_mode else 0.0),
            # -1 = auto, not yet calibrated (stats must not trigger the
            # calibration kNN)
            hamming_radius=(self._radius if self._radius is not None
                            else -1),
            backfill_rows=self._backfill_rows,
            backfill_queries=self._backfill_queries,
        )
        return s

    # ------------------------------------------------------------ persistence
    def state_arrays(self) -> dict:
        return {
            "store": self.store.to_host(),
            "planes": np.asarray(self.planes),
            "bucket_ids": np.asarray(self.bucket_ids),
            "gen": np.asarray([self._gen]),
            # sign-code mode never reads the width; persisting it must not
            # trigger the auto-width corpus calibration
            "width": np.asarray([self._width if self._width is not None
                                 else (self._effective_width()
                                       if not self._sign_mode
                                       else 0.0)], np.float64),
            # calibrated radius rides along (-1 = not yet calibrated)
            "radius": np.asarray([self._radius if self._radius is not None
                                  else -1], np.int64),
            # auto-table calibration state (the count itself rides in
            # planes.shape[0])
            "tables_final": np.asarray([int(self._tables_final)], np.int64),
        }

    def load_state_arrays(self, arrays: dict) -> None:
        self.store = VectorStore.from_host(arrays["store"])
        self.planes = jnp.asarray(arrays["planes"])
        self.bucket_ids = jnp.asarray(arrays["bucket_ids"])
        self._gen = int(np.asarray(arrays["gen"])[0])
        if "width" in arrays:
            w = float(np.asarray(arrays["width"])[0])
            self._width = w if w > 0 else None
        if "radius" in arrays:
            r = int(np.asarray(arrays["radius"])[0])
            if self._sign_mode:
                self._radius = r if r >= 0 else None
        self._tables = int(self.planes.shape[0])
        if "tables_final" in arrays:
            self._tables_final = bool(int(np.asarray(arrays["tables_final"])[0]))
        else:  # pre-round-4 checkpoint: infer from the calibrated radius
            self._tables_final = (not self._auto_tables
                                  or self._radius is not None)
