#!/usr/bin/env python3
"""Smoke test of the vector database on NVIDIA GPUs.

    python chip_smoke.py [--seed 42]    one card: every phase below
    python chip_smoke.py --chips 4      four cards: the sharded path only

One process drives the card(s) throughout, through the public API
(`VectorDatabase`, `ShardedDatabase`), at corpus sizes users run.  Data is
generated on the device from ``--seed``: gaussian rows, and rows with the
power-law spectrum of bench.py's memory-bound corpus (``spectral``).  Every
search phase is compared with `reference_topk`, a plain exact top-k at
HIGHEST matmul precision that shares no code with the package, and prints
one line: its Recall@10, the precision it ran at, and its wall time (first
call, compilation included, and a warm call).  A phase below its floor
raises, and the script exits non-zero without a result line.

Phases on one card:
  device      jax and device, the card's name and power limit (nvidia-smi)
  flagship    HNSWPQ raw tier, 1M x 512 spectral, 32x codes: auto (the int8
              pool scan above 700k rows), scan_exact, Q=1, delete 1%,
              close and reopen from the storage path
  compressed  HNSWPQ raw_store=False, 1M x 512 spectral: auto (adc_fast),
              scan_pallas_int8 (the packed pool scan), scan_int8, pca
  indexes     BRUTE, HNSW, PQ, IVF, LSH, ANNOY at 100k x 128 spectral
  kernel      the Triton int8 pool-scan kernel against the plain XLA pool
              scan at 1M x 512 int8 rows, Q=1024, pool width 2048: medians
              of 25 timed calls each
  tests       the tests marked ``gpu``, in this process

With ``--chips 4``: ShardedDatabase on a 4-card mesh, 4M x 512 spectral
(1M rows per card, so search() routes to search_fused): the raw tier's
search, search_flagship after train_pq, and add_batch/remove; the
compressed tier's search, search_fused and search_pca; bytes in use on
each card.

The last line of standard output is one JSON object:
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.
Off the GPU, or run outside a checkout of the repository, the script exits
non-zero and prints no such line.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import gc
import json
import os
import shutil
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
STORE_DIR = os.path.join(ROOT, ".scratch", "chip_smoke_store")

# Recall@10 floors against the plain reference: the value measured on an
# H100 at the default seed, less 0.005, rounded down to 0.01 (PERF.md,
# "Recall floors").  q1 is one query, so one missed neighbour is 0.1.
FLOORS = {
    "scan_exact": 0.99,
    "auto": 0.99,
    "q1": 0.9,
    "scan_pallas_int8": 0.96,
    "scan_int8": 0.96,
    "adc_fast": 0.96,
    "pca": 0.85,
    "brute": 0.99,
    "hnsw": 0.96,
    "pq": 0.24,
    "ivf": 0.99,
    "lsh": 0.98,
    "annoy": 0.43,
    "sharded_search": 0.99,
    "sharded_flagship": 0.99,
    "sharded_packed": 0.95,
    "sharded_pca": 0.92,
}

# what each path computes in, printed beside its recall (float32 matmuls
# keep JAX's default precision in the library: TF32 on the GPU)
PRECISION = {
    "scan_exact": "f32 scan at default matmul precision (TF32 on the GPU)",
    "int8_pool": "s8 x s8 -> s32 pool scan, f32 refine at default precision",
    "packed_pool": "s8 x s8 -> s32 pool scan over the packed store, "
                   "int8 refine in bf16 x bf16 -> f32",
    "scan_int8": "bf16 x bf16 -> f32 scan of the int8 rows",
    "adc_fast": "bf16 PQ decode-scan, int8 refine in bf16 x bf16 -> f32",
    "pca": "bf16 PCA-proxy scan, int8 refine in bf16 x bf16 -> f32",
    "pca_raw": "bf16 PCA-proxy scan, f32 refine at default precision",
    "flagship": "PQ ADC scan, f32 refine at default precision",
    "index": "f32 at default matmul precision (TF32 on the GPU)",
}


# the path search_mode="auto" (and ShardedDatabase.search) takes
_AUTO_PATH = {"scan_pallas_int8": "int8_pool", "scan_exact": "scan_exact"}


@dataclasses.dataclass(frozen=True)
class Sizes:
    """Corpus and batch sizes of the phases (the tests shrink them)."""

    dim: int = 512
    rows: int = 1_000_000         # flagship and compressed tiers
    ingest_chunk: int = 125_000   # bulk_load_stream chunk (divides rows)
    queries: int = 1024
    k: int = 10
    reopen_queries: int = 8
    delete_frac: float = 0.01
    index_dim: int = 128
    index_rows: int = 100_000     # the six other index types
    index_queries: int = 256
    kernel_rows: int = 1 << 20
    kernel_width: int = 2048
    kernel_calls: int = 25
    shard_rows: int = 4_000_000   # --chips 4: 1M rows per card
    shard_churn: int = 4096       # rows removed and added on the raw tier


def log(*parts) -> None:
    print(*parts, flush=True)


def card_lines() -> list[str]:
    """``name, power.limit`` of each card, from nvidia-smi (a child that
    does not touch JAX)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return [ln.strip() for ln in out.stdout.splitlines() if ln.strip()]


# ------------------------------------------------------------ the reference


def _reference_block(q, c, alive, k: int, metric: str):
    import jax
    import jax.numpy as jnp

    hi = jax.lax.Precision.HIGHEST
    if metric == "cosine":
        c = c / jnp.maximum(jnp.linalg.norm(c, axis=1, keepdims=True), 1e-30)
        d = -jnp.matmul(q, c.T, precision=hi)
    else:   # squared L2 without the per-query constant |q|^2
        d = (jnp.sum(c * c, axis=1)[None, :]
             - 2.0 * jnp.matmul(q, c.T, precision=hi))
    d = jnp.where(alive[None, :], d, jnp.inf)
    neg, idx = jax.lax.top_k(-d, k)
    return -neg, idx


def reference_topk(queries, corpus, k: int, metric: str = "l2",
                   alive=None, block: int = 131072) -> np.ndarray:
    """Exact top-k row indices of each query under squared L2 or cosine
    distance, at HIGHEST matmul precision, blocked over the corpus (numpy
    or device rows).  Rows where ``alive`` is False never appear."""
    import jax
    import jax.numpy as jnp

    step = jax.jit(_reference_block, static_argnames=("k", "metric"))
    q = jnp.asarray(queries, jnp.float32)
    if metric == "cosine":
        q = q / jnp.maximum(jnp.linalg.norm(q, axis=1, keepdims=True), 1e-30)
    n = corpus.shape[0]
    alive = np.ones(n, bool) if alive is None else np.asarray(alive, bool)
    best_d = best_i = None
    for s in range(0, n, block):
        d, i = step(q, jnp.asarray(corpus[s:s + block], jnp.float32),
                    jnp.asarray(alive[s:s + block]), min(k, n - s), metric)
        i = i + s
        if best_d is not None:
            d = jnp.concatenate([best_d, d], axis=1)
            i = jnp.concatenate([best_i, i], axis=1)
        neg, arg = jax.lax.top_k(-d, min(k, d.shape[1]))
        best_d, best_i = -neg, jnp.take_along_axis(i, arg, axis=1)
    return np.asarray(best_i)


def recall_at(got_ids, ref_ids, k: int) -> float:
    """Mean |got[:k] & ref[:k]| / k over the queries."""
    got_ids, ref_ids = np.asarray(got_ids), np.asarray(ref_ids)
    return float(np.mean([
        len(set(got_ids[i, :k].tolist()) & set(ref_ids[i, :k].tolist())) / k
        for i in range(ref_ids.shape[0])]))


def result_ids(results, k: int) -> np.ndarray:
    """[Q, k] ids from VectorDatabase.search_batch results, -1 padded."""
    out = np.full((len(results), k), -1, np.int64)
    for i, row in enumerate(results):
        ids = [r.id for r in row][:k]
        out[i, :len(ids)] = ids
    return out


def check(name: str, recall: float, floor: float, precision: str,
          first_s: float, warm_s: float | None = None) -> None:
    warm = "" if warm_s is None else f" warm_s={warm_s:.4f}"
    log(f"phase {name}: recall@10={recall:.4f} floor={floor} "
        f"precision=[{precision}] first_s={first_s:.3f}{warm}")
    if not recall >= floor:
        raise AssertionError(f"{name}: Recall@10 {recall:.4f} < {floor}")


def timed(fn, *args):
    t0 = time.perf_counter()
    out = fn(*args)
    return out, time.perf_counter() - t0


# -------------------------------------------------------------- data


def spectral_rows(key, n: int, dim: int):
    """Gaussian rows scaled by a power-law spectrum, (i + 1) ** -0.5 on
    dimension i: what embedding models emit (bench.py's memory-bound
    corpus)."""
    import jax
    import jax.numpy as jnp

    scale = (jnp.arange(dim, dtype=jnp.float32) + 1.0) ** -0.5
    return jax.random.normal(key, (n, dim), jnp.float32) * scale[None, :]


def _search_phase(db, name, queries, ref, k, floor, precision):
    """search_batch twice (compilation, then warm) and check recall."""
    res, first = timed(db.search_batch, queries, k)
    res, warm = timed(db.search_batch, queries, k)
    got = result_ids(res, k)
    check(name, recall_at(got, ref, k), floor, precision, first, warm)
    return got


# ---------------------------------------------------------------- phases


def phase_flagship(sizes: Sizes, seed: int, floors=FLOORS) -> None:
    """HNSWPQ raw tier through VectorDatabase, with storage."""
    import jax

    from vector_db_tpu import CompressionConfig, IndexType, VectorDatabase
    from vector_db_tpu.index.hnsw_pq import _auto_scan_mode

    n, dim, k = sizes.rows, sizes.dim, sizes.k
    key = jax.random.PRNGKey(seed)
    corpus = spectral_rows(jax.random.fold_in(key, 1), n, dim)
    queries = np.asarray(spectral_rows(jax.random.fold_in(key, 2),
                                       sizes.queries, dim))
    shutil.rmtree(STORE_DIR, ignore_errors=True)

    def open_db():
        # flush_interval=n: one checkpoint at ingest and one at close,
        # none per thousand deletes
        return VectorDatabase(
            dim, n, IndexType.HNSWPQ, storage_path=STORE_DIR,
            compression=CompressionConfig.recommended_config(dim),
            flush_interval=n)

    db = open_db()
    log(f"flagship: storage engine {type(db._engine).__name__}")
    step = sizes.ingest_chunk
    t0 = time.perf_counter()
    db.bulk_load_stream(
        (np.arange(s, min(s + step, n)), corpus[s:s + step])
        for s in range(0, n, step))
    log(f"flagship: ingested {db.size()} x {dim} in "
        f"{time.perf_counter() - t0:.1f}s (store, PQ train, encode, "
        f"checkpoint); compression {db.get_compression_ratio():.0f}x")
    ref = reference_topk(queries, corpus, k)
    cfg = db.index.config
    auto = PRECISION[_AUTO_PATH[_auto_scan_mode(False, db.size())]]
    _search_phase(db, "auto", queries, ref, k, floors["auto"], auto)
    cfg.search_mode = "scan_exact"
    _search_phase(db, "scan_exact", queries, ref, k, floors["scan_exact"],
                  PRECISION["scan_exact"])
    cfg.search_mode = "auto"
    res, first = timed(db.search, queries[0], k)
    res, warm = timed(db.search, queries[0], k)
    check("q1", recall_at(result_ids([res], k), ref[:1], k),
          floors["q1"], auto, first, warm)

    # delete 1% of the ids: none may come back
    rng = np.random.default_rng(seed)
    gone = rng.choice(n, int(n * sizes.delete_frac), replace=False)
    t0 = time.perf_counter()
    for vid in gone.tolist():
        assert db.delete_vector(vid)
    log(f"flagship: deleted {gone.size} ids in "
        f"{time.perf_counter() - t0:.1f}s")
    alive = np.ones(n, bool)
    alive[gone] = False
    ref = reference_topk(queries, corpus, k, alive=alive)
    got = _search_phase(db, "auto_after_delete", queries, ref, k,
                        floors["auto"], auto)
    assert not np.isin(got, gone).any(), "a deleted id came back"

    # close, reopen from the storage path: the same top-k
    few = queries[:sizes.reopen_queries]
    before = result_ids(db.search_batch(few, k), k)
    t0 = time.perf_counter()
    db.close()
    del db
    gc.collect()
    db = open_db()
    log(f"flagship: close + reopen {time.perf_counter() - t0:.1f}s, "
        f"{db.size()} rows, engine {type(db._engine).__name__}")
    after = result_ids(db.search_batch(few, k), k)
    assert np.array_equal(before, after), (before, after)
    log(f"phase reopen: same top-{k} for {len(few)} queries")
    db.close()
    shutil.rmtree(STORE_DIR, ignore_errors=True)


def phase_compressed(sizes: Sizes, seed: int, floors=FLOORS) -> None:
    """HNSWPQ compressed tier (raw_store=False) through VectorDatabase."""
    import jax

    from vector_db_tpu import CompressionConfig, IndexType, VectorDatabase
    from vector_db_tpu.api.config import HnswPqConfig

    n, dim, k = sizes.rows, sizes.dim, sizes.k
    key = jax.random.PRNGKey(seed + 1)
    corpus = spectral_rows(jax.random.fold_in(key, 1), n, dim)
    queries = np.asarray(spectral_rows(jax.random.fold_in(key, 2),
                                       sizes.queries, dim))
    sub = CompressionConfig.recommended_config(dim).effective_subspaces(dim)
    # search_mode="pca" at ingest fits the PCA proxy; the other modes are
    # chosen per phase on the same index
    cfg = HnswPqConfig(num_subspaces=sub, raw_store=False, search_mode="pca")
    db = VectorDatabase(dim, n, IndexType.HNSWPQ, index_config=cfg)
    step = sizes.ingest_chunk
    t0 = time.perf_counter()
    db.bulk_load_stream(
        (np.arange(s, min(s + step, n)), corpus[s:s + step])
        for s in range(0, n, step))
    log(f"compressed: ingested {db.size()} x {dim} in "
        f"{time.perf_counter() - t0:.1f}s")
    ref = reference_topk(queries, corpus, k)
    del corpus
    cfg = db.index.config
    for mode, floor, prec in (
            ("auto", "adc_fast", "adc_fast"),
            ("scan_pallas_int8", "scan_pallas_int8", "packed_pool"),
            ("scan_int8", "scan_int8", "scan_int8"),
            ("pca", "pca", "pca")):
        cfg.search_mode = mode
        name = "adc_fast" if mode == "auto" else mode
        _search_phase(db, f"compressed_{name}", queries, ref, k,
                      floors[floor], PRECISION[prec])
    db.close()


INDEX_TYPES = ("BRUTE", "HNSW", "PQ", "IVF", "LSH", "ANNOY")


def phase_indexes(sizes: Sizes, seed: int, floors=FLOORS) -> None:
    """The six other index types through VectorDatabase."""
    import jax

    from vector_db_tpu import IndexType, VectorDatabase

    n, dim, k = sizes.index_rows, sizes.index_dim, sizes.k
    key = jax.random.PRNGKey(seed + 2)
    corpus = np.asarray(spectral_rows(jax.random.fold_in(key, 1), n, dim))
    queries = np.asarray(spectral_rows(jax.random.fold_in(key, 2),
                                       sizes.index_queries, dim))
    ref = reference_topk(queries, corpus, k)
    for name in INDEX_TYPES:
        db = (VectorDatabase.builder().with_dimension(dim)
              .with_max_elements(n).with_index_type(IndexType[name]).build())
        t0 = time.perf_counter()
        db.add_batch(range(n), corpus)
        db.rebuild_index()
        log(f"indexes: {name} {n} x {dim} built in "
            f"{time.perf_counter() - t0:.1f}s")
        _search_phase(db, f"index_{name.lower()}", queries, ref, k,
                      floors[name.lower()], PRECISION["index"])
        db.close()


def phase_kernel(sizes: Sizes, seed: int, cards: list[str],
                 kernel: str = "triton") -> dict:
    """The Triton int8 pool-scan kernel against the plain XLA pool scan:
    agreement, then the median of ``kernel_calls`` timed calls each
    (``kernel="interpret"`` runs the same kernel on the CPU)."""
    import jax
    import jax.numpy as jnp

    from vector_db_tpu.ops import pool_scan

    n, dim, w = sizes.kernel_rows, sizes.dim, sizes.kernel_width
    key = jax.random.PRNGKey(seed + 3)
    ks = jax.random.split(key, 4)
    base8 = jax.random.randint(ks[0], (n, dim), -127, 128, jnp.int32
                               ).astype(jnp.int8)
    off = jax.random.normal(ks[1], (n,), jnp.float32)
    off = off.at[::97].set(jnp.inf)                 # dead slots
    sc = -jax.random.uniform(ks[2], (n,), jnp.float32, 0.5, 2.0)
    q = jax.random.normal(ks[3], (sizes.queries, dim), jnp.float32)
    calls = {impl: functools.partial(pool_scan.int8_pool_scan, q, base8, off,
                                     sc, w, impl=impl)
             for impl in (kernel, "xla")}
    outs = {}
    for impl, fn in calls.items():
        t0 = time.perf_counter()
        outs[impl] = jax.block_until_ready(fn())
        log(f"kernel: {impl} first call (compile + run) "
            f"{time.perf_counter() - t0:.2f}s")
        jax.block_until_ready(fn())
    (vt, it), (vx, ix) = outs[kernel], outs["xla"]
    same = float(np.mean(np.asarray(it) == np.asarray(ix)))
    fin = np.isfinite(np.asarray(vx))
    close = np.allclose(np.asarray(vt)[fin], np.asarray(vx)[fin],
                        rtol=1e-5, atol=1e-5)
    log(f"kernel: slots equal {same:.6f}, scores close {close}")
    assert same >= 0.999 and close, "kernel disagrees with the plain form"
    times = {impl: [] for impl in calls}
    for r in range(sizes.kernel_calls):
        order = (kernel, "xla") if r % 2 == 0 else ("xla", kernel)
        for impl in order:
            t0 = time.perf_counter()
            jax.block_until_ready(calls[impl]())
            times[impl].append(time.perf_counter() - t0)
    med = {impl: float(np.median(t)) * 1e3 for impl, t in times.items()}
    log(f"phase kernel: int8 pool scan {n} x {dim} int8, Q={sizes.queries},"
        f" w={w}: {kernel} median {med[kernel]:.3f} ms, xla median "
        f"{med['xla']:.3f} ms ({sizes.kernel_calls} calls each) on "
        f"{' | '.join(cards)}")
    return med


def phase_tests() -> None:
    """The tests marked ``gpu``, in this process (one JAX process per
    card)."""
    import pytest

    os.environ["VDB_TEST_DEVICE"] = "gpu"
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      "-p", "no:randomly", os.path.join(ROOT, "tests")])
    log(f"phase tests: pytest -m gpu exit code {int(rc)}")
    if int(rc) != 0:
        raise AssertionError(f"tests marked gpu failed (pytest rc {int(rc)})")


def _shard_capacity(rows: int, extra: int, shards: int) -> int:
    """Capacity whose per-shard rows are a multiple of 2048, so the pool
    scan keeps its full 2048 width on every shard."""
    per = -(-(rows + extra) // shards)
    return -(-per // 2048) * 2048 * shards


def _device_bytes(label: str, devices) -> None:
    used = [(d.memory_stats() or {}).get("bytes_in_use", "n/a")
            for d in devices]
    log(f"{label}: bytes_in_use per device "
        + ", ".join(f"{d.id}={b}" for d, b in zip(devices, used)))


def phase_sharded(sizes: Sizes, seed: int, n_cards: int = 4,
                  floors=FLOORS) -> None:
    """ShardedDatabase on an ``n_cards`` mesh, compared with the plain
    reference."""
    import jax

    from vector_db_tpu.parallel.sharded import ShardedDatabase, make_mesh

    devices = jax.devices()[:n_cards]
    assert len(devices) == n_cards, f"need {n_cards} devices"
    mesh = make_mesh(devices=devices)
    n, dim, k = sizes.shard_rows, sizes.dim, sizes.k
    churn = sizes.shard_churn
    key = jax.random.PRNGKey(seed + 4)
    queries = np.asarray(spectral_rows(jax.random.fold_in(key, 0),
                                       sizes.queries, dim))
    t0 = time.perf_counter()
    block = 262144
    corpus = np.empty((n, dim), np.float32)
    for i, s in enumerate(range(0, n, block)):
        corpus[s:s + block] = np.asarray(spectral_rows(
            jax.random.fold_in(key, i + 1), min(block, n - s), dim))
    ref = reference_topk(queries, corpus, k)
    log(f"sharded: {n} x {dim} rows and reference in "
        f"{time.perf_counter() - t0:.1f}s")
    cap = _shard_capacity(n, churn, n_cards)
    sub = dim // 8

    # ---- raw tier
    db = ShardedDatabase(mesh, dim=dim, capacity=cap, num_subspaces=sub)
    t0 = time.perf_counter()
    db.add_batch(np.arange(n), corpus)
    log(f"sharded raw: add_batch {n} in {time.perf_counter() - t0:.1f}s, "
        f"{db.per_shard} rows per shard")
    fused = n >= db.fused_threshold * n_cards
    raw_path = PRECISION["int8_pool" if fused else "scan_exact"]
    (ext, _), first = timed(db.search, queries, k)
    (ext, _), warm = timed(db.search, queries, k)
    check("sharded_search", recall_at(ext, ref, k),
          floors["sharded_search"], raw_path, first, warm)
    _device_bytes("sharded raw", devices)
    t0 = time.perf_counter()
    # train_pq's default 16 centroids: its data-parallel Lloyd step holds
    # [subspaces, rows per shard, centroids] f32 distances on each card
    db.train_pq()
    log(f"sharded raw: train_pq {time.perf_counter() - t0:.1f}s")
    (ext, _), first = timed(db.search_flagship, queries, k)
    (ext, _), warm = timed(db.search_flagship, queries, k)
    check("sharded_flagship", recall_at(ext, ref, k),
          floors["sharded_flagship"], PRECISION["flagship"], first, warm)
    rng = np.random.default_rng(seed)
    gone = rng.choice(n, churn, replace=False)
    for vid in gone.tolist():
        assert db.remove(vid)
    fresh = np.asarray(spectral_rows(jax.random.fold_in(key, 10 ** 6),
                                     churn, dim))
    acc = db.add_batch(np.arange(n, n + churn), fresh)
    assert len(acc) == churn
    alive = np.ones(n + churn, bool)
    alive[gone] = False
    ref2 = reference_topk(queries, np.concatenate([corpus, fresh]), k,
                          alive=alive)
    (ext, _), first = timed(db.search, queries, k)
    assert not np.isin(ext, gone).any(), "a removed id came back"
    check("sharded_search_after_churn", recall_at(ext, ref2, k),
          floors["sharded_search"], raw_path, first)
    del db
    gc.collect()

    # ---- compressed tier
    db = ShardedDatabase(mesh, dim=dim, capacity=cap, num_subspaces=sub,
                         raw_store=False)
    t0 = time.perf_counter()
    db.add_batch(np.arange(n), corpus)
    log(f"sharded compressed: add_batch {n} in "
        f"{time.perf_counter() - t0:.1f}s")
    del corpus
    for name, fn, prec in (("sharded_packed", db.search,
                            "packed_pool" if fused else "scan_int8"),
                           ("sharded_search_fused", db.search_fused,
                            "packed_pool")):
        (ext, _), first = timed(fn, queries, k)
        (ext, _), warm = timed(fn, queries, k)
        check(name, recall_at(ext, ref, k), floors["sharded_packed"],
              PRECISION[prec], first, warm)
    _device_bytes("sharded compressed", devices)
    db.fit_pca()
    (ext, _), first = timed(db.search_pca, queries, k)
    (ext, _), warm = timed(db.search_pca, queries, k)
    check("sharded_pca", recall_at(ext, ref, k), floors["sharded_pca"],
          PRECISION["pca"], first, warm)


# ------------------------------------------------------------------ main


def _import_package():
    """The package of this checkout, never one installed elsewhere."""
    sys.path.insert(0, ROOT)
    import vector_db_tpu

    where = os.path.dirname(os.path.abspath(vector_db_tpu.__file__))
    if os.path.dirname(where) != ROOT:
        raise ImportError(f"vector_db_tpu from {where}, not from {ROOT}")
    return vector_db_tpu


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--chips", type=int, default=1, choices=(1, 4),
                    help="4: run only the sharded path on four cards")
    args = ap.parse_args(argv)

    import jax

    devices = jax.devices()
    log(f"jax {jax.__version__}, devices {devices}")
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (platform {devices[0].platform!r})",
              file=sys.stderr)
        return 2
    cards = card_lines()
    for line in cards:
        log(line)
    _import_package()
    from vector_db_tpu.utils.compile_cache import enable_compile_cache

    log(f"compile cache: {enable_compile_cache()}")
    log(f"default matmul precision: {jax.config.jax_default_matmul_precision}")
    sizes = Sizes()
    t_all = time.perf_counter()
    if args.chips == 4:
        if len(devices) < 4:
            print(f"chip_smoke: --chips 4 needs four cards, found "
                  f"{len(devices)}", file=sys.stderr)
            return 2
        phase_sharded(sizes, args.seed)
    else:
        build = subprocess.run(["make", "-C", os.path.join(ROOT, "native")],
                               capture_output=True, text=True)
        log(f"native engine build: make exit code {build.returncode}")
        phase_flagship(sizes, args.seed)
        gc.collect()
        phase_compressed(sizes, args.seed)
        gc.collect()
        phase_indexes(sizes, args.seed)
        gc.collect()
        phase_kernel(sizes, args.seed, cards)
        gc.collect()
        phase_tests()
    log(f"all phases passed in {time.perf_counter() - t_all:.1f}s")
    for line in cards:
        log(line)
    print(json.dumps({"ok": True, "device": {
        "platform": devices[0].platform, "kind": devices[0].device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
