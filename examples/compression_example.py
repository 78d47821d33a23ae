"""Compression on/off/custom + performance demo.

Parity with the reference's CompressionExample.java (331 lines): compare
uncompressed vs PQ-compressed databases — memory, build time, search time,
recall — across the CompressionConfig presets.

Run: python examples/compression_example.py [--n 10000] [--dim 512]
"""

import argparse
import sys
import time

import numpy as np

sys.path.insert(0, ".")

from vector_db_tpu import CompressionConfig, IndexType, VectorDatabase


def build_db(dim, n, compression=None, index_type=IndexType.HNSWPQ):
    b = (VectorDatabase.builder().with_dimension(dim).with_max_elements(n)
         .with_index_type(index_type))
    if compression is not None:
        b = b.with_compression(compression)
    return b.build()


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000)
    ap.add_argument("--dim", type=int, default=512)
    ap.add_argument("--queries", type=int, default=100)
    args = ap.parse_args()
    dim, n, k = args.dim, args.n, 10

    rng = np.random.default_rng(42)
    # power-law eigenspectrum — what real embedding models emit (isotropic
    # noise is PQ/PCA's information-theoretic worst case and represents no
    # real workload; see BENCH_REPORT A4)
    scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
    vecs = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
    queries = (rng.standard_normal((args.queries, dim))
               * scale).astype(np.float32)

    gt = build_db(dim, n, index_type=IndexType.BRUTE)
    gt.add_batch(range(n), vecs)
    gt_sets = [{r.id for r in row} for row in gt.search_batch(queries, k)]

    presets = [
        ("uncompressed", None, IndexType.HNSW),
        ("recommended (dim/8, 32x)", CompressionConfig.recommended_config(dim), IndexType.HNSWPQ),
        ("high recall (dim/4, 16x)", CompressionConfig.high_recall_config(dim), IndexType.HNSWPQ),
        ("high compression (dim/16, 64x)", CompressionConfig.high_compression_config(dim), IndexType.HNSWPQ),
        # memory-bound scoring: candidate generation reads ONLY the 32x codes
        # + codebooks (PQ decode + one matmul); raw vectors are
        # touched just for the exact top-pool refine
        ("memory-bound (adc_fast, 32x)", CompressionConfig.recommended_config(dim), "adc_fast"),
        # PCA-proxy multi-stage: a [dim/8]-dim truncated-PCA first stage
        # (64 B/vec at 512d) + exact refine — ops/pca
        ("pca proxy (dim/8 dims + refine)", CompressionConfig.recommended_config(dim), "pca"),
        # the compressed store: NO raw f32 matrix exists (4x smaller
        # total); the int8 pool scan streams the store's own int8 rows
        ("compressed store (no raw f32, 4x)", None, "compressed"),
        # + second int8 level: ~16-bit refine precision at half f32 bytes —
        # the refine-ordering recall ceiling disappears (docs/COMPRESSED_TIER.md)
        ("compressed + residual (2.5x)", None, "residual"),
    ]

    print(f"\n{'preset':32s} {'ratio':>6s} {'build s':>8s} {'ms/q':>7s} "
          f"{'Recall@10':>10s} {'index MB':>9s} {'saved':>6s}")
    print("-" * 84)
    for name, comp, itype in presets:
        if itype in ("adc_fast", "pca", "compressed", "residual"):
            from vector_db_tpu.api.config import HnswPqConfig

            sub = max(1, dim // 8)
            if itype == "adc_fast":
                cfg = HnswPqConfig(num_subspaces=sub, search_mode="adc_fast",
                                   adc_bucket=16, adc_winners=2)
            elif itype == "pca":
                cfg = HnswPqConfig(num_subspaces=sub, search_mode="pca",
                                   proxy_dims=max(8, dim // 8), pca_r=256)
            else:
                cfg = HnswPqConfig(num_subspaces=sub, raw_store=False,
                                   refine_residual=itype == "residual",
                                   search_mode="scan_pallas_int8")
            b = (VectorDatabase.builder().with_dimension(dim)
                 .with_max_elements(n).with_index_type(IndexType.HNSWPQ)
                 .with_compression(comp).with_index_config(cfg))
            db = b.build()
        else:
            db = build_db(dim, n, comp, itype)
        t0 = time.time()
        db.add_batch(range(n), vecs)
        db.rebuild_index()
        t_build = time.time() - t0
        db.search_batch(queries, k)
        t0 = time.time()
        res = db.search_batch(queries, k)
        dt = time.time() - t0
        recall = np.mean(
            [len({r.id for r in res[i]} & gt_sets[i]) / k
             for i in range(args.queries)]
        )
        ratio = db.get_compression_ratio()
        st = db.stats()
        # memory column (reference: CompressionExample.java:276-282 prints
        # build/search/memory-savings per preset): compressed index
        # structures (codes+codebooks+proxy) in MB, plus the savings pct
        idx_mb = st.get("index_bytes", st["capacity"] * dim * 4) / 1e6
        if not st.get("raw_store", True):
            # compressed store: the savings that matter are TOTAL resident
            # bytes vs a raw f32 store (the whole point of the tier)
            saved = 100.0 * (1.0 - (st["store_bytes"] + st["index_bytes"])
                             / st["raw_bytes"])
        else:
            saved = db.get_memory_savings_pct() if comp is not None else 0.0
        print(f"{name:32s} {ratio:5.0f}x {t_build:8.1f} "
              f"{dt*1000/args.queries:7.2f} {recall:10.1%} {idx_mb:9.1f} "
              f"{saved:5.1f}%")
        db.close()
    print("\ndone.")


if __name__ == "__main__":
    main()
