"""Compression and index configuration.

Parity with the reference's CompressionConfig (reference:
config/CompressionConfig.java:46-203) including every factory preset and the
compression-ratio math, plus per-index config dataclasses mirroring
HNSWConfig / HNSWPQConfig / PQConfig / IVFConfig (native/index/*.h).
"""

from __future__ import annotations

import dataclasses
import enum
import math


class CompressionType(enum.Enum):
    """reference: config/CompressionConfig.java:46-65"""

    NONE = "none"
    PQ = "pq"
    HNSWPQ = "hnswpq"


@dataclasses.dataclass
class CompressionConfig:
    """Product-quantization compression settings.

    compression ratio = 4 * dim / num_subspaces (CompressionConfig.java:180-192):
    each float32 subvector of dim/num_subspaces floats becomes one uint8 code.
    """

    enabled: bool = False
    compression_type: CompressionType = CompressionType.NONE
    num_subspaces: int = 8
    num_centroids: int = 256
    training_iterations: int = 25

    # -------------------------------------------------------------- presets
    @classmethod
    def default_config(cls) -> "CompressionConfig":
        """Compression off (CompressionConfig.java:70)."""
        return cls()

    @classmethod
    def pq_config(cls, num_subspaces: int = 8) -> "CompressionConfig":
        """Flat-PQ preset (CompressionConfig.java:83-92)."""
        return cls(True, CompressionType.PQ, num_subspaces)

    @classmethod
    def hnsw_pq_config(cls, num_subspaces: int = 8) -> "CompressionConfig":
        """HNSW+PQ preset (CompressionConfig.java:94-104)."""
        return cls(True, CompressionType.HNSWPQ, num_subspaces)

    @classmethod
    def recommended_config(cls, dimension: int) -> "CompressionConfig":
        """dim/8 subspaces -> 32x at 512-dim (CompressionConfig.java:114-130)."""
        sub = max(1, dimension // 8)
        return cls(True, CompressionType.HNSWPQ, sub)

    @classmethod
    def high_recall_config(cls, dimension: int) -> "CompressionConfig":
        """dim/4 subspaces -> 16x (CompressionConfig.java:139-151)."""
        sub = max(1, dimension // 4)
        return cls(True, CompressionType.HNSWPQ, sub)

    @classmethod
    def high_compression_config(cls, dimension: int) -> "CompressionConfig":
        """dim/16 subspaces -> 64x (CompressionConfig.java:160-172)."""
        sub = max(1, dimension // 16)
        return cls(True, CompressionType.HNSWPQ, sub)

    # ---------------------------------------------------------------- maths
    def compression_ratio(self, dimension: int) -> float:
        """4 * dim / subspaces (CompressionConfig.java:180-192)."""
        if not self.enabled or self.num_subspaces <= 0:
            return 1.0
        return 4.0 * dimension / self.num_subspaces

    def memory_savings_pct(self, dimension: int) -> float:
        """(1 - 1/ratio) * 100 (CompressionConfig.java:194-203)."""
        r = self.compression_ratio(dimension)
        return (1.0 - 1.0 / r) * 100.0 if r > 0 else 0.0

    def effective_subspaces(self, dimension: int) -> int:
        """Auto-adjust so dim % subspaces == 0 (reference:
        index/HnswPqIndex.java:78-84, findBestSubspaceDivisor :113-130)."""
        sub = min(self.num_subspaces, dimension)
        if dimension % sub == 0:
            return sub
        best = 1
        for cand in range(sub, 0, -1):
            if dimension % cand == 0:
                best = cand
                break
        return best


@dataclasses.dataclass
class HnswConfig:
    """reference: index/HnswIndex.java:21-26 (Java defaults M=32, efC=400,
    ef=400) and native/index/HNSWIndex.h:15-50 (adaptive efSearch)."""

    m: int = 32
    ef_construction: int = 400
    ef_search: int = 0  # 0 -> adaptive log-N-scaled ef (the native reference's
    # HNSWConfig::getEfSearch policy, HNSWIndex.h:31-50); > 0 -> fixed ef with
    # the Java reference's max(ef, 4k) floor (HnswIndex.java:347)
    ef_delta: int = 32  # adaptive base offset (reference efSearchDelta)
    max_level: int = 0  # 0 -> derived from capacity: log_M(cap)+1
    expand_per_iter: int = 4  # candidates expanded per beam iteration
    batch_insert: int = 64  # nodes inserted per frozen-graph round
    heuristic: bool = True  # diversity neighbor selection (native reference
    # behaviour, HNSWIndex.cpp:322-469); False -> simple nearest-M (Java)
    bulk_build: bool = True  # from-scratch builds use exact-kNN graph
    # construction (a few matmuls) instead of sequential insertion beams;
    # incremental adds still use beam insertion
    insert_policy: str = "defer"  # incremental-add policy:
    # "defer" (default): adds are buffered in a pending set (searches see
    #   them through an exact overlay scan, so results never lag) and
    #   connected in bulk by exact-kNN delta insertion
    #   (ops/hnsw_graph.bulk_insert_delta) when the buffer crosses the
    #   flush threshold — the batched answer to the reference native's
    #   sequential per-vector insert loop (docs/OPTIMIZATION_SUMMARY.
    #   md:59): per-node beam descents are gather- and dispatch-bound, one
    #   new x live matmul is not.
    # "stream": legacy per-round beam insertion (insert the moment
    #   add_batch returns) — graph arrays are current after every add.
    flush_min: int = 1024   # defer: flush when pending >= max(flush_min,
    flush_frac: float = 0.25  # min(flush_frac * graph_live, flush_max))
    flush_max: int = 32768  # bound on the overlay scan width per search
    flush_chunk: int = 0  # > 0: a threshold-triggered flush connects at
    # most this many slots per add_batch call (pow2 recommended — the delta
    # insert pads to pow2, so a fixed chunk compiles once); the rest drain
    # on later adds and stay searchable via the overlay.  0 (default):
    # connect the whole pending set at once.  Which is faster on the H100
    # is not measured (ROADMAP A6).

    def derived_max_level(self, capacity: int) -> int:
        if self.max_level > 0:
            return self.max_level
        return max(1, int(math.log(max(capacity, 2)) / math.log(max(self.m, 2))) + 1)

    def ef_for_query(self, k: int, n: int = 1000, dim: int = 0) -> int:
        """Per-query beam width.

        Fixed mode (ef_search > 0): ef = max(ef, 4k) (reference:
        index/HnswIndex.java:347).
        Adaptive mode (ef_search == 0): log-N-scaled with size-stepped floors
        and caps, matching the native reference policy (HNSWIndex.h:31-50) —
        base (k + delta) grows ~20% per decade of N, the k-multiplier floor
        steps 4/5/6/8 at 1k/5k/20k, capped at 300 (<=10k) / 400 (>10k), so
        recall/latency self-tunes as the corpus grows.  A dimension-aware
        floor widens the beam on high-dim corpora where greedy descent loses
        discrimination (hubness): measured at 512d x 10k / k=10, ef=60
        scored 84.1% Recall@10 while ef=256 scored 95.1% (the BASELINE.md
        >=95% config target) — the log-N policy alone is tuned for the
        reference's 128d benchmarks and is too lean above ~256d.  Past 20k
        rows at high dim the floor rises again (512/768) and the cap lifts
        to 1024: recall at the worst measured cell (512d x 50k uniform)
        goes 75.0% -> 88.7% (see the inline measurements below).
        """
        if self.ef_search > 0:
            return max(self.ef_search, 4 * k)
        base = k + self.ef_delta
        if n > 100:
            base = int(base * (1.0 + 0.2 * math.log10(n / 100.0 + 1.0)))
        mult = 4
        if n > 1000:
            mult = 5
        if n > 5000:
            mult = 6
        if n > 20000:
            mult = 8
        ef = max(base, k * mult)
        floor = 0
        if dim >= 256 and n > 1000:
            # step with dim (256 at 256d, 288 at 512d, 320 at >=768d), and
            # +64 beyond 20k rows where the 128d-tuned policy under-shoots
            floor = 256 + 32 * min(max((dim - 128) // 256, 0), 2)
            if n > 20000:
                floor += 64
        cap = 300 if n <= 10000 else 400
        if dim >= 256:
            # High dim + large N is where greedy descent loses the most
            # discrimination (hubness): measured at 512d x 50k uniform,
            # Q=100 — ef 352 -> 75.0% R@10, 768 -> 88.7%, 1024 -> 92.8%
            # (the beam's cost in ef is not measured on the H100).  So
            # past 20k rows the beam widens to 768 (>=384d;
            # 512 at 256-383d where hubness is milder) instead of clipping
            # at the native reference's 128d-tuned 400 cap.
            cap = 1024 if n > 10000 else cap
            if n > 20000:
                floor = max(floor, 768 if dim >= 384 else 512)
        # never clip an adaptive beam under the Java reference's fixed-mode
        # floor max(ef, 4k) (index/HnswIndex.java:347)
        cap = max(cap, 4 * k)
        return min(max(ef, floor), max(cap, floor))


@dataclasses.dataclass
class HnswPqConfig:
    """Flagship config (reference: index/HnswPqIndex.java:27-32 — M=32,
    efC=ef=64, squared-L2; native/index/HNSWPQIndex.h:22-35 — pqM=64,
    pqBits=8, 25 k-means iterations)."""

    m: int = 32
    ef_construction: int = 64
    ef_search: int = 64
    num_subspaces: int = 64
    num_centroids: int = 256
    training_iterations: int = 25
    training_samples: int = 10000  # lazy-train threshold (HnswPqIndex.java:170-175)
    refine_k: int = 1024  # exact re-rank pool per query (analog of the
    # reference's 50k re-rank, HnswPqIndex.java:647-664 — here the ADC scan
    # is exhaustive, and a ~1k refine pool saturates Recall@10 at 32x)
    use_graph: bool = False  # False -> exhaustive ADC scan path;
    # True -> HNSW traversal over PQ codes (large-N path)
    insert_policy: str = "defer"  # graph-mode incremental adds: "defer"
    # buffers adds in a pending set (visible to every search through an
    # exact overlay) and bulk-connects them with exact-kNN delta insertion
    # on flush; "stream" inserts immediately via beam rounds (legacy).
    # See HnswConfig.insert_policy.
    flush_min: int = 1024
    flush_frac: float = 0.25
    flush_max: int = 32768
    flush_chunk: int = 0  # see HnswConfig.flush_chunk (bounded flush)
    nlist: int = 0  # > 0 -> IVF coarse quantizer: for search_mode="adc"
    # it restricts the ADC scan to nprobe member lists; for
    # search_mode="scan_ivf" it is the cluster-pruned tier's
    # partition count (0 = auto ~N/2048 at train time, ops/ivf_scan.
    # auto_ivf_geometry)
    nprobe: int = 32
    # --- scan_ivf geometry (the cluster-pruned scan tier; see
    # ops/ivf_scan.py).  0 = auto.
    ivf_p_cap: int = 0  # prober-tile rows per cluster (auto: ~4x the mean
    # probers/cluster, pow2-clamped to [32, 512]; probes beyond the tile
    # are dropped — the query just loses that one cluster)
    ivf_winners: int = 4  # best rows kept per 128-lane bucket per probed
    # cluster (winners * cap/128 <= 128 bounds the cluster capacity)
    ivf_pool: int = 0  # merged candidate pool per query before the exact
    # refine (auto: max(4*k, 256))
    search_mode: str = "auto"  # auto | scan_exact | scan_bf16 |
    # scan_pallas | scan_pallas_int8 | adc | adc_fast | pca | graph |
    # scan_int8 | scan_ivf.  On the GPU every mode runs plain XLA except
    # the int8 pool scan of scan_pallas_int8, which is one Pallas kernel
    # compiled through Triton (ops/pool_scan).  No mode's speed has been
    # measured on the H100 yet (ROADMAP A5).
    # "auto": scan_exact below 700k live rows, scan_pallas_int8 above
    #   (hnsw_pq._auto_scan_mode), adc_fast when raw_store=False.
    # "scan_exact": blocked exact scan over the raw store with an
    #   approx_max_k block reduction (exact sort-based top-k on the GPU).
    #   Streams beat gathers: the exhaustive matmul is the fast path
    #   whenever the raw vectors are device-resident (the reference also
    #   keeps raw vectors for its 50k-deep exact re-rank,
    #   HnswPqIndex.java:647-664).
    # "scan_bf16": bf16-cross-term scan + exact f32 refine of a small
    #   ranked pool; selection only has to contain the true top-k
    #   (hnsw_pq.bf16_scan_refine).
    # "scan_pallas": bf16 conditioned-shadow scan + strided-bucket pool
    #   (ops/pool_scan.raw_pool_scan, plain XLA) + exact f32 refine.
    # "scan_pallas_int8": the s8 x s8 -> s32 pool scan
    #   (ops/pool_scan.int8_pool_scan) — same pool + exact-refine pipeline
    #   over a per-row-quantized CENTERED int8 shadow: a quarter of the
    #   f32 rows' bytes, with exact-f32 per-slot offsets so quantization
    #   only perturbs the cross term.  On the compressed tier it scans the
    #   store's own packed rows.
    # "adc": ADC scan (+ optional IVF pruning) + exact refine — the
    #   memory-bound path; uses only codes + codebooks for candidate scoring.
    # "adc_fast": the FAST memory-bound path — PQ decode + one matmul over
    #   the reconstruction + unranked bucket pool + exact refine
    #   (ops/adc.adc_fast_search).  Scoring reads only codes + codebooks.
    # "graph": HNSW traversal with ADC distances + exact refine.
    # "scan_int8": exhaustive blocked scan over the int8 row store
    #   (ops/distance.blocked_knn_int8) — near-exact ranking (the cross term
    #   carries ~0.4% quantization error; norms are write-time exact) at 1/4
    #   the stream bytes of scan_exact.  The exhaustive option for
    #   raw_store=False, where no f32 matrix exists.
    # "scan_ivf": the cluster-pruned scan (ops/ivf_scan): a coarse
    #   quantizer (nlist) partitions the corpus into a balanced
    #   cluster-major int8 grid; each batch probes nprobe clusters per
    #   query and scores only probed clusters against their own
    #   prober-query tiles — O(nprobe/nlist) of the exhaustive scans'
    #   work.  Works on both stores (raw tier refines exact-f32,
    #   compressed tier int8+residual); needs train()/build() after rows
    #   exist (the coarse quantizer).  Explicit opt-in only; never chosen
    #   by "auto".
    scan_recall_target: float = 0.99  # approx_max_k target; 1.0 -> exact
    int8_epilogue: str = "per_row"  # scan_pallas_int8 (raw store) scan
    # variant: "per_row" = per-row-scaled shadow, f32 epilogue
    # (ops/pool_scan.int8_pool_scan); "global" = ONE corpus scale + one
    # batch scale, ranked in raw int32 (ops/pool_scan.int8g_pool_scan,
    # plain XLA).  Whether "global" earns its place on the H100 is not
    # measured (ROADMAP C2/C3).
    adc_bucket: int = 32  # adc_fast pool granularity: keep the best
    # `adc_winners` per `adc_bucket` corpus slots -> pool = winners*N/bucket
    # rows re-ranked exactly; smaller bucket / more winners = higher recall,
    # more refine traffic
    adc_winners: int = 1
    adc_pool: str = "bucket"  # adc_fast pool selection: "bucket" (fast,
    # right for structured corpora) | "approx" (ranked top-R via
    # approx_max_k; slower but keeps the deep-quantized-rank candidates that
    # isotropic/structureless corpora need — see ops/adc._score_pool_chunk)
    balance_dims: bool = True  # variance-balanced dimension permutation
    # before PQ (ops/adc.balanced_subspace_perm) — equalises per-subspace
    # variance on decaying-spectrum corpora; no-op cost, big recall win on
    # real embeddings, exactly neutral on isotropic data
    refine_store: str = "f32"  # adc_fast/pca refine source: "f32" reads the
    # raw store; "bf16" keeps a bit-packed bf16 shadow (ops/distance.
    # pack_bf16_rows) — half the refine traffic, ~0.03% distance error;
    # "int8" keeps a bit-packed int8 shadow (pack_int8_rows) — quarter the
    # traffic, ~0.4% error.  With raw_store=False the store itself is the
    # int8 shadow and this field is forced to "int8".
    raw_store: bool = True  # False -> the compressed regime: the
    # VectorStore holds int8-packed rows (+ exact norms) INSTEAD of the
    # [cap, dim] f32 matrix, so capacity is bounded by codes + proxy + int8
    # rows (~0.7 GB/M at 512d vs 2 GB/M raw f32).  Search modes: adc_fast
    # (default), pca, adc, scan_int8, scan_pallas_int8 (the pool scan
    # streams the packed rows directly); scan_exact/scan_pallas/graph need
    # raw rows and raise.
    # The reference's N >> memory roadmap answer is IVF sharding + mmap
    # (reference: PERFORMANCE_BENCHMARK_AND_ROADMAP.md:475-525).
    refine_residual: bool = False  # compressed tier only (raw_store=False):
    # store a SECOND int8 level holding each row's quantization residual
    # (ops/distance.pack_int8_residual) and add it in every int8 refine —
    # ~16-bit effective row precision at half the bytes of f32, which
    # removes the refine-ordering recall ceiling (a perfectly-contained
    # pool ranks 99.3% -> 100% Recall@10 at 512d in the CPU tests).  Cost:
    # +0.52 GB/M rows at 512d resident and 2x refine gather bytes.  The
    # pool scans keep reading the FIRST level only (selection is
    # containment-grade); scan_int8's exhaustive scorer DOES read both
    # levels (2x scan bytes for an effectively exact exhaustive mode).
    adc_select_r: int = 0  # > 0 -> narrow the (wide, cheap) pool to a ranked
    # top-R with one tiny approx_max_k over pool VALUES before the refine
    # gathers — a hybrid between the pure bucket pool (selection loss) and
    # full-distance ranked selection (a sort-sized select)
    proxy_dims: int = 32  # PCA-proxy dims for search_mode="pca" (ops/pca):
    # a [p, N] bf16 truncated-PCA projection (64 B/vec at p=32 — the same
    # index-memory class as the 32x codes) scanned with one tiny matmul,
    # then exact refine of the ranked top-pca_r.  0 disables fitting.
    pca_r: int = 256  # refine pool for the pca mode (measured containment
    # at 512d x 100k spectral: p=32/R=256 -> 97.0%, p=64/R=128 -> 99.05%)


@dataclasses.dataclass
class PqConfig:
    """reference: index/PqIndex.java:42-44 (8 subvectors x 256 clusters),
    native/index/PQIndex.h:10-14."""

    num_subspaces: int = 8
    num_centroids: int = 256
    training_iterations: int = 10
    refine_k: int = 0  # 0 -> pure ADC ranking (reference behaviour)
    balance_dims: bool = True  # see HnswPqConfig.balance_dims


@dataclasses.dataclass
class IvfConfig:
    """reference: index/IvfIndex.java:41-57 (nClusters=100 capped at N/10,
    nProbes=10), native/index/IVFIndex.h:9-13 (25 iterations)."""

    num_clusters: int = 100
    num_probes: int = 10
    training_iterations: int = 25
    multi_assign: int = 8  # spill each vector into its top-a clusters.
    # Honest k-means clusters are tight, so fixed-nprobe recall on them is
    # far below the reference's near-degenerate single-Lloyd clustering
    # (33.7% vs 88% at nprobe=10).  Multi-assignment
    # restores parity at the same nprobe: a neighbor is found when ITS top-a
    # clusters intersect the query's top-nprobe.  Measured at 128d x 10k,
    # nprobe=10: a=1 -> 34%, a=4 -> 73%, a=8 -> 91% Recall@10 (reference: 88%).
    # Cost: a * 4 bytes/vector of member-table entries — the same
    # volume-for-recall trade the reference's mega-clusters made implicitly.


@dataclasses.dataclass
class LshConfig:
    """reference: index/LshIndex.java:40-42 (10 hash fns x 5 tables,
    bucket width 4) and native/index/LSHIndex.{h,cpp} (10 tables x 20 bits)."""

    num_tables: int = 0  # 0 -> DATA-CALIBRATED (sign mode): jointly with
    # the radius, a prefix of a 32-table candidate pool is chosen to
    # maximize measured true-neighbor collision rate under a <=35%
    # random-collision mass budget (index/lsh._auto_tables_calibrate) —
    # high dim needs more tables at a tighter radius (static 10 measured
    # 57.9% honest at isotropic 512d x 100k).  Explicit values are fixed
    # (10 = reference parity); exact-bucket mode resolves 0 -> 10.
    num_bits: int = 0  # 0 -> dimension-aware: 16 below 256d, 24 at >= 256d
    # (high-dim angles concentrate, so more bits are needed before a radius
    # gate can separate neighbors from the bulk); explicit values <= 31
    # (codes pack into int32)
    hamming_radius: int = -1  # multi-probe sign-LSH (the default):
    # candidate iff some table's bit-packed sign code is within this Hamming
    # radius of the query's (one XOR+popcount over the resident code matrix
    # — the array-program form of multi-probe LSH).
    # -1 -> DATA-CALIBRATED at build/first-search (index/lsh._auto_radius):
    # the radius is set to the ~75th percentile of true-neighbor min-table
    # Hamming distances measured on a corpus sample, capped so the expected
    # random-pair collision fraction stays <= ~30% (binomial tail x table
    # union) — honest recall then tracks the corpus instead of one tuned
    # scale (a fixed r=4/16-bit setup measured 79% on uniform 128d but 57%
    # at 512d x 100k).  > 0 -> fixed radius.  0 -> exact-bucket match on
    # quantized projections (strict reference-parity semantics).
    bucket_width: float = 0.0  # setting this > 0 OPTS INTO exact-bucket
    # mode (hamming_radius is ignored): a width is only meaningful for
    # quantized-projection hashing, so an explicit width means
    # reference-parity semantics.
    # <= 0 -> data-calibrated at build() (~10x the median nn distance of a
    # corpus sample, index/lsh._auto_width); the reference's fixed 4.0 only
    # matches its own 128d uniform[-1,1] scale — at 512d it yields zero
    # collisions.  Pass an explicit width for strict reference parity.
    backfill: bool = True  # exact-scan fill when collisions < k (reference
    # random-fills, LshIndex.java:261-265); False -> honest LSH-only results
    # (-1 padded rows), with backfill events counted in stats either way


@dataclasses.dataclass
class AnnoyConfig:
    """reference: index/AnnoyIndex.java:32-38 (10 trees, leaf<=10) and
    native/index/AnnoyIndex.{h,cpp}."""

    num_trees: int = 12  # reference default is 10; 12 trees with the wide
    # descent beam measure 97.8% honest Recall@10 at the reference config
    # (128d x 10k) vs 80% at 10 trees/beam 64 — the reference's published
    # 85% leans on its random-fill (README.md:225-232)
    leaf_size: int = 16
    search_k: int = 0  # descent beam per tree; 0 -> auto: 128, widened to
    # 512 above dim 256 (see AnnoyIndex search: beam 64 -> 80%, 96 ->
    # 97.4%, 128 -> 97.8% honest @ 12 trees/128d; at 512d x 100k beam
    # 128 -> 36.6%, 512 -> 82.3% — r5)
    backfill: bool = True  # exact-scan fill when the forest yields < k
    # candidates; False -> honest forest-only results (-1 padded rows)
