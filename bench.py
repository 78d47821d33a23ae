"""Flagship benchmark: prints ONE JSON line.

Config mirrors BASELINE.json's north star: HNSW+PQ flagship at 512-dim x
100k vectors, 32x compression (64 subspaces x 8 bits), k=10, seed 42.
Measures Recall@10 against an exact ground truth computed at HIGHEST
matmul precision, and the batched search time of the flagship's default
(auto) search program and of the memory-bound adc_fast program: the median
of timed calls, each ended by ``block_until_ready``.  Every line names the
device it ran on; off the GPU the script exits non-zero and prints nothing.

Baseline: the reference's published 2,391 QPS / 97.60% Recall@10 at 512-dim
(PERFORMANCE_EVALUATION_LATEST.md:62-64; BASELINE.md).
"""

import json
import sys
import time

import numpy as np


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def median_seconds(fn, arg, calls=30):
    """Median wall time of ``calls`` calls of ``fn(arg)`` after one warm
    call (compilation), each ended by block_until_ready."""
    import jax

    jax.block_until_ready(fn(arg))
    times = []
    for _ in range(calls):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(arg))
        times.append(time.perf_counter() - t0)
    return float(np.median(times))


def main():
    import jax
    import jax.numpy as jnp

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"bench: no GPU (platform {dev.platform!r})")
        return 2
    sys.path.insert(0, ".")
    from vector_db_tpu.api.config import HnswPqConfig
    from vector_db_tpu.index.hnsw_pq import HnswPqIndex, exact_scan_search
    from vector_db_tpu.ops.distance import blocked_knn
    from vector_db_tpu.utils.compile_cache import enable_compile_cache

    enable_compile_cache()
    dim, n, nq, k = 512, 100_000, 1024, 10
    log(f"bench: flagship HNSWPQ {dim}d x {n} vectors, 32x, k={k}, "
        f"devices={jax.devices()}")
    # the corpus is generated on the device
    gen = jax.jit(
        lambda key, shape: jax.random.normal(key, shape, jnp.float32),
        static_argnames="shape",
    )
    vj = gen(jax.random.PRNGKey(42), (n, dim))
    qj = gen(jax.random.PRNGKey(7), (nq, dim))

    def ground_truth(q, v):
        with jax.default_matmul_precision("highest"):
            _, gi = blocked_knn(q, v, jnp.ones(n, bool), k, block_n=16384)
        return [set(r.tolist()) for r in np.asarray(gi)]

    def recall(ids, gt):
        return float(np.mean(
            [len(set(ids[i].tolist()) & gt[i]) / k for i in range(nq)]))

    gt_sets = ground_truth(qj, vj)

    # build the flagship index (zero-copy ingest, PQ train + encode on device)
    cfg = HnswPqConfig(num_subspaces=64, training_samples=20000)
    idx = HnswPqIndex(dim, n, "l2", cfg)
    t0 = time.time()
    idx.bulk_load(range(n), vj)
    t_build = time.time() - t0
    log(f"build (ingest+train+encode): {t_build:.1f}s  trained={idx.trained}  "
        f"ratio={idx.stats()['compression_ratio']}x")

    # recall through the public API
    ids, _ = idx.search_batch(np.asarray(qj), k)
    rec = recall(ids, gt_sets)
    log(f"Recall@10: {rec:.4f}")

    # the batched search program auto picks at this size (the exact scan)
    st = idx.store.state

    def program(q_n):
        blk = idx._f32_scan_block(n, q_n)
        return jax.jit(lambda q: exact_scan_search(
            q, st.vectors, st.norms, st.valid, st.ids, 16, "l2", blk,
            cfg.scan_recall_target))

    dt = median_seconds(program(nq), qj)
    qps = nq / dt
    log(f"batched QPS: {qps:.0f}  ({dt*1000:.3f} ms / {nq}-query batch)")
    # single-query latency: search_batch pads Q=1 to 8 (pad_queries_pow2)
    dt1 = median_seconds(program(8), qj[:8])
    log(f"Q=1 latency: {dt1*1000:.3f} ms")

    # ---- memory-bound mode (candidate scoring reads ONLY codes+codebooks) --
    # Corpus: power-law eigenspectrum (what real embedding models emit; PQ
    # at 32x on isotropic noise is information-theoretically recall-capped)
    from vector_db_tpu.ops import adc as adc_ops
    from vector_db_tpu.ops.distance import pack_bf16_rows

    scale = jnp.asarray((np.arange(dim) + 1.0) ** -0.5, jnp.float32)
    vj2 = gen(jax.random.PRNGKey(42), (n, dim)) * scale[None, :]
    qj2 = gen(jax.random.PRNGKey(7), (nq, dim)) * scale[None, :]
    gt2_sets = ground_truth(qj2, vj2)
    cfg2 = HnswPqConfig(num_subspaces=64, training_samples=20000,
                        search_mode="adc_fast", adc_pool="approx",
                        adc_select_r=128, refine_store="bf16")
    idx2 = HnswPqIndex(dim, n, "l2", cfg2)
    idx2.bulk_load(range(n), vj2)
    ids2, _ = idx2.search_batch(np.asarray(qj2), k)
    rec2 = recall(ids2, gt2_sets)
    log(f"memory-bound Recall@10: {rec2:.4f}")
    st2 = idx2.store.state
    ct2, cbt2, cnorms2 = idx2._fast_tables()
    packed2 = pack_bf16_rows(st2.vectors)
    mb = jax.jit(lambda q: adc_ops.adc_fast_search(
        q, ct2, cbt2, st2.valid, st2.vectors, st2.ids, 16,
        bucket=cfg2.adc_bucket, winners=1, pool_mode="approx",
        code_norms=cnorms2, perm=idx2.perm, packed_base=packed2,
        select_r=128))
    dt2 = median_seconds(mb, qj2)
    qps2 = nq / dt2
    log(f"memory-bound QPS: {qps2:.0f}  ({dt2*1000:.3f} ms / {nq}-query "
        f"batch)")

    baseline_qps = 2391.0  # reference flagship single-node QPS
    print(json.dumps({
        "metric": "hnswpq_flagship_batched_qps_512d_100k_k10",
        "value": round(qps, 1),
        "unit": "QPS",
        "vs_baseline": round(qps / baseline_qps, 2),
        "recall_at_10": round(rec, 4),
        "baseline_recall_at_10": 0.976,
        "build_seconds": round(t_build, 1),
        "q1_latency_ms": round(dt1 * 1000, 3),
        # memory-bound mode: candidate scoring reads only codes + codebooks
        # (raw rows touched only in the top-128 exact refine), power-law
        # corpus, same 512d x 100k x 32x shapes
        "adc_fast_qps": round(qps2, 1),
        "adc_fast_recall_at_10": round(rec2, 4),
        "adc_fast_vs_baseline": round(qps2 / baseline_qps, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
