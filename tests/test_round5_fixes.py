"""Round-5 fix tests (ADVICE r4 items).

- high: the graph-mode deferred-insert overlay must never broadcast the
  pending slot set into the [Q, R, d] refine gather (tens of GB at scale)
  — it is scored with one [Q, P] dot_general and merged via top_k
  (index/hnsw_pq._graph_refine_pending).
- medium: index/lsh._popcount must work without np.bitwise_count
  (NumPy < 2.0 — pyproject allows >= 1.24).
- low: rows added after global-shadow calibration that clip at +-127
  against the stale global sv must be counted, and a non-trivial clipped
  fraction must force a full shadow rebuild (sv refresh).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vector_db_tpu.api.config import HnswPqConfig
from vector_db_tpu.index.hnsw_pq import HnswPqIndex, _graph_refine_pending


@pytest.fixture
def rng():
    return np.random.default_rng(42)


class TestGraphPendingOverlay:
    """ADVICE r4 high: pending slots merge via a [Q, P] dot_general, not
    a [Q, R+P, d] gather."""

    @pytest.mark.parametrize("metric", ["l2", "cosine"])
    @pytest.mark.parametrize("n_pend", [64, 512])  # exact / approx merge
    def test_matches_oracle(self, rng, metric, n_pend):
        n, d, q_n, r, k = 2048, 32, 16, 64, 8
        base = rng.standard_normal((n, d)).astype(np.float32)
        queries = rng.standard_normal((q_n, d)).astype(np.float32)
        valid = np.ones(n, bool)
        # disjoint graph pool / pending sets, -1 padded like production
        perm = rng.permutation(n)
        cand = np.sort(perm[: r * q_n].reshape(q_n, r), axis=1).astype(np.int32)
        cand[:, -2:] = -1
        pending = perm[r * q_n : r * q_n + n_pend].astype(np.int32).copy()
        pending[-3:] = -1

        d_out, s_out = _graph_refine_pending(
            jnp.asarray(queries), jnp.asarray(base), jnp.asarray(valid),
            jnp.asarray(cand), jnp.asarray(pending), k, metric)
        d_out, s_out = np.asarray(d_out), np.asarray(s_out)

        for i in range(q_n):
            pool = np.concatenate([cand[i], pending])
            pool = np.unique(pool[pool >= 0])
            if metric == "l2":
                dist = ((base[pool] - queries[i]) ** 2).sum(1)
            else:
                dist = 1.0 - (base[pool] @ queries[i]) / np.maximum(
                    np.linalg.norm(base[pool], axis=1)
                    * np.linalg.norm(queries[i]), 1e-12)
            want = set(pool[np.argsort(dist)[:k]].tolist())
            got = set(s_out[i].tolist())
            # approx_max_k on the wide pending overlay tolerates <1 miss
            assert len(got & want) >= k - 1, (i, got, want)
            assert (np.diff(d_out[i]) >= -1e-5).all()

    def test_search_with_pending_matches_flush(self, rng):
        """End-to-end: graph search with a large pending buffer agrees
        with the same index after flushing (same top-1 self-retrieval)."""
        n, dim = 1536, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        cfg = HnswPqConfig(num_subspaces=8, training_samples=512,
                           use_graph=True, search_mode="graph",
                           flush_min=4096, m=8)
        idx = HnswPqIndex(dim, n, "l2", cfg)
        idx.add_batch(range(512), vecs[:512])
        idx.add_batch(range(512, n), vecs[512:])
        assert idx.stats()["pending_inserts"] == n - 512
        ids, _ = idx.search_batch(vecs[900:916], 1)
        assert (ids[:, 0] == np.arange(900, 916)).mean() >= 0.9


class TestPopcountFallback:
    """ADVICE r4 medium: NumPy 1.x has no np.bitwise_count."""

    def test_fallback_matches(self, rng, monkeypatch):
        from vector_db_tpu.index import lsh

        x = rng.integers(-2**31, 2**31, size=(13, 7)).astype(np.int32)
        want = np.array([[bin(int(v)).count("1") for v in row]
                         for row in x.view(np.uint32)])
        assert (lsh._popcount(x) == want).all()
        monkeypatch.delattr(np, "bitwise_count")
        assert (lsh._popcount(x) == want).all()

    def test_default_lsh_search_without_bitwise_count(self, rng,
                                                      monkeypatch):
        """The default (num_tables=0 auto) sign-mode index calibrates at
        first search — that path must not require NumPy 2.0."""
        from vector_db_tpu.api.config import LshConfig
        from vector_db_tpu.index.lsh import LshIndex

        monkeypatch.delattr(np, "bitwise_count")
        n, dim = 512, 16
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        idx = LshIndex(dim, n, "l2", LshConfig())
        idx.add_batch(range(n), vecs)
        ids, _ = idx.search_batch(vecs[:8], 1)
        assert (ids[:, 0] == np.arange(8)).mean() >= 0.9


class TestAnnoyHighDimWarning:
    """VERDICT r4 #6: Annoy at 512d x 100k measures 36.6% honest recall
    even with beam 128 — the index warns once at high dim and surfaces
    the regime in stats() (mirroring _auto_scan_mode's honesty)."""

    def test_warns_once_and_flags_stats(self, rng, caplog):
        from vector_db_tpu.api.config import AnnoyConfig
        from vector_db_tpu.index.annoy import AnnoyIndex

        n, dim = 256, 512
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        idx = AnnoyIndex(dim, n, "l2", AnnoyConfig())
        with caplog.at_level("WARNING", logger="vector_db_tpu.index.annoy"):
            idx.add_batch(range(n), vecs)
            idx.build()
            idx.build()  # second build must NOT re-warn
        warns = [r for r in caplog.records if "HNSWPQ" in r.message]
        assert len(warns) == 1, [r.message for r in caplog.records]
        assert idx.stats()["high_dim"] is True

    def test_auto_beam_widens_at_high_dim(self, rng, monkeypatch):
        """search_k=0 resolves to beam 512 above the dim threshold
        (measured 36.6% -> 82.3% honest R@10 at 512d x 100k) and stays
        128 below it."""
        from vector_db_tpu.api.config import AnnoyConfig
        from vector_db_tpu.index import annoy as annoy_mod
        from vector_db_tpu.index.annoy import AnnoyIndex

        seen = {}
        orig = annoy_mod._descend

        def spy(q, hp, th, ch, roots, max_depth, beam=4):
            seen["beam"] = beam
            return orig(q, hp, th, ch, roots, max_depth, beam)

        monkeypatch.setattr(annoy_mod, "_descend", spy)
        for dim, want in ((512, 512), (64, 128)):
            n = 384
            idx = AnnoyIndex(dim, n, "l2", AnnoyConfig())
            idx.add_batch(range(n),
                          rng.standard_normal((n, dim)).astype(np.float32))
            idx.build()
            idx.search_batch(
                rng.standard_normal((4, dim)).astype(np.float32), 5)
            assert seen["beam"] == want, (dim, seen)

    def test_wide_candidate_rerank_matches_narrow(self, rng):
        """C > 8192 routes through blocked_rerank (the high-dim auto beam
        yields ~196k-wide unions; the one-shot [Q, C, d] gather and the
        full-row exact top_k are pathological there) — results must match
        the narrow path on the same candidate set."""
        from vector_db_tpu.index.annoy import _rerank

        n, d, q_n, k = 4096, 16, 8, 5
        base = rng.standard_normal((n, d)).astype(np.float32)
        qs = rng.standard_normal((q_n, d)).astype(np.float32)
        norms = (base ** 2).sum(1)
        valid = np.ones(n, bool)
        valid[7] = False
        cand_small = rng.integers(0, n, size=(q_n, 4096)).astype(np.int32)
        cand_small[:, -5:] = -1
        pad = np.full((q_n, 16384 - 4096), -1, np.int32)
        cand_wide = np.concatenate([cand_small, pad], axis=1)
        args = (jnp.asarray(qs), jnp.asarray(base), jnp.asarray(norms),
                jnp.asarray(valid))
        d_n, s_n = _rerank(*args, jnp.asarray(cand_small), k)
        d_w, s_w = _rerank(*args, jnp.asarray(cand_wide), k)
        assert (np.asarray(s_n) == np.asarray(s_w)).all()
        np.testing.assert_allclose(np.asarray(d_n), np.asarray(d_w),
                                   rtol=1e-5, atol=1e-5)
        assert 7 not in set(np.asarray(s_w).ravel().tolist())

    def test_low_dim_silent(self, rng, caplog):
        from vector_db_tpu.api.config import AnnoyConfig
        from vector_db_tpu.index.annoy import AnnoyIndex

        idx = AnnoyIndex(64, 256, "l2", AnnoyConfig())
        vecs = rng.standard_normal((256, 64)).astype(np.float32)
        with caplog.at_level("WARNING", logger="vector_db_tpu.index.annoy"):
            idx.add_batch(range(256), vecs)
            idx.build()
        assert not [r for r in caplog.records if "HNSWPQ" in r.message]
        assert idx.stats()["high_dim"] is False


class TestScan8gClipRebuild:
    """ADVICE r4 low: clipped post-calibration rows are tracked and a
    non-trivial fraction forces a shadow rebuild (sv refresh)."""

    def _index(self, rng, n_cap=6000, n=3000, dim=64):
        cfg = HnswPqConfig(num_subspaces=8, training_samples=512,
                           use_graph=False, search_mode="scan_pallas_int8",
                           int8_epilogue="global")
        idx = HnswPqIndex(dim, n_cap, "l2", cfg)
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        idx.add_batch(range(n), vecs)
        return idx, vecs

    def test_many_clipped_rows_trigger_rebuild(self, rng):
        idx, vecs = self._index(rng)
        qs = vecs[:8]
        idx.search_batch(qs, 5)
        assert idx._scan8g_cache is not None
        sv0 = float(idx._scan8g_cache[2][2])
        # 128 rows far outside the calibrated range (> max(64, 1% of N))
        wide = 10.0 * rng.standard_normal((128, 64)).astype(np.float32)
        idx.add_batch(range(9000, 9128), wide)
        idx.search_batch(qs, 5)  # incremental update counts clips -> rebuild
        sv1 = float(idx._scan8g_cache[2][2])
        assert sv1 > sv0 * 2, (sv0, sv1)
        assert idx._scan8g_clipped == 0
        # the wide rows are findable at full fidelity post-rebuild
        ids, _ = idx.search_batch(wide[:8], 1)
        assert (ids[:, 0] == np.arange(9000, 9008)).all()

    def test_global_shadow_containment_at_100k(self, rng):
        """VERDICT r4 weak #3: the global-scale shadow's pool selection at
        REAL scale (100k x 512) — scored with the exact kernel formula in
        plain jnp (ops/pool_scan.int8g_pool_scan computes the same
        off_i - q8.v8 affine score) must contain the true top-10 within a
        2048-wide pool at >= 99%."""
        from vector_db_tpu.index.hnsw_pq import _build_scan8g_shadow

        n, dim, q_n, k, w = 100_000, 512, 64, 10, 2048
        scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
        vecs = (rng.standard_normal((n, dim)).astype(np.float32)
                * scale[None, :])
        qs = (rng.standard_normal((q_n, dim)).astype(np.float32)
              * scale[None, :])
        vj, qj = jnp.asarray(vecs), jnp.asarray(qs)
        norms = jnp.sum(vj * vj, axis=1)
        valid = jnp.ones(n, bool)
        base8, off, sv, sgn, cvec, _aux = _build_scan8g_shadow(
            vj, norms, valid, "l2", 128)
        qc = qj - cvec[None, :]
        sq = jnp.maximum(jnp.max(jnp.abs(qc)), 1e-12) / 127.0
        q8 = jnp.clip(jnp.round(qc / sq), -127, 127).astype(jnp.int8)
        c = float(sgn) * sv * sq
        lim = float(1 << 26)
        off_i = jnp.where(jnp.isfinite(off),
                          jnp.clip(jnp.round(off / c), -lim, lim),
                          float(1 << 29)).astype(jnp.int32)
        cross = jax.lax.dot_general(
            q8[:, :].astype(jnp.int32), base8[:n].astype(jnp.int32),
            (((1,), (1,)), ((), ())))
        score = off_i[:n][None, :] - cross
        pool = np.asarray(jnp.argsort(score, axis=1)[:, :w])
        d_true = (jnp.sum(qj * qj, 1)[:, None] + norms[None, :]
                  - 2.0 * qj @ vj.T)
        gt = np.asarray(jnp.argsort(d_true, axis=1)[:, :k])
        cont = np.mean([len(set(pool[i]) & set(gt[i])) / k
                        for i in range(q_n)])
        assert cont >= 0.99, cont

    def test_few_clipped_rows_accumulate_without_rebuild(self, rng):
        idx, vecs = self._index(rng)
        idx.search_batch(vecs[:4], 5)
        sv0 = float(idx._scan8g_cache[2][2])
        wide = 10.0 * rng.standard_normal((8, 64)).astype(np.float32)
        idx.add_batch(range(9000, 9008), wide)
        idx.search_batch(vecs[:4], 5)
        assert float(idx._scan8g_cache[2][2]) == sv0  # no rebuild
        assert 0 < idx._scan8g_clipped <= 8


class TestHighDimLargeNBeam:
    """r5: the adaptive ef policy widens past 20k rows at high dim.

    At 512d x 50k uniform (the A8 worst cell) recall rose with ef past the
    128d-tuned 400 cap while the beam's cost stayed nearly flat in ef;
    its time on the H100 is not measured yet.
    """

    def test_wide_beam_at_high_dim_large_n(self):
        from vector_db_tpu.api.config import HnswConfig

        cfg = HnswConfig()
        assert cfg.ef_for_query(16, 50_000, dim=512) == 768
        assert cfg.ef_for_query(16, 50_000, dim=256) == 512
        # 10k cells keep the round-3 policy (95.5% measured at ef=288)
        assert cfg.ef_for_query(16, 10_000, dim=512) == 288
        # low dim unaffected at any N
        assert cfg.ef_for_query(16, 50_000, dim=128) == 128
        assert cfg.ef_for_query(100, 100_000, dim=0) == 400

    def test_java_4k_floor_never_clipped_by_adaptive_cap(self):
        from vector_db_tpu.api.config import HnswConfig

        cfg = HnswConfig()
        # k_pad=128 (the K=100 sweep): k*mult=768 must not clip at 400
        assert cfg.ef_for_query(128, 10_000, dim=128) >= 4 * 128


class TestBoundedFlush:
    """r5 (VERDICT r4 weak #4): `flush_chunk > 0` caps how many pending
    slots a threshold-triggered flush connects per add_batch call, bounding
    the synchronous latency spike of a full flush at 512d.  The remainder drains on later adds and stays
    exactly searchable through the overlay meanwhile."""

    def _cfg(self, **kw):
        from vector_db_tpu.api.config import HnswConfig

        return HnswConfig(m=8, ef_construction=64, **kw)

    def test_chunked_flush_caps_per_call_and_drains(self, rng):
        from vector_db_tpu.index.hnsw import HnswIndex

        idx = HnswIndex(16, 2048, "l2",
                        self._cfg(flush_min=256, flush_chunk=64))
        vecs = rng.standard_normal((1024, 16)).astype(np.float32)
        # seed a connected graph so the delta path (not from-scratch) runs
        idx.add_batch(range(512), vecs[:512])
        idx.flush_pending()
        base_connected = int((np.asarray(idx.graph.levels) >= 0).sum())
        assert base_connected == 512

        # cross the threshold: exactly ONE chunk must connect per call
        idx.add_batch(range(512, 768), vecs[512:768])  # pending 256 >= 256
        connected = int((np.asarray(idx.graph.levels) >= 0).sum())
        assert connected == base_connected + 64
        assert idx.stats()["pending_inserts"] == 192

        # still above threshold: each subsequent add drains one more chunk
        idx.add_batch(range(768, 832), vecs[768:832])
        connected2 = int((np.asarray(idx.graph.levels) >= 0).sum())
        assert connected2 == connected + 64
        # pending rows remain exactly searchable through the overlay
        ids, _ = idx.search_batch(vecs[800:808], 1)
        assert (ids[:, 0] == np.arange(800, 808)).all()

        # an explicit unbounded flush connects everything
        idx.flush_pending()
        assert idx.stats()["pending_inserts"] == 0
        assert int((np.asarray(idx.graph.levels) >= 0).sum()) == 832

    def test_limit_ge_pending_clears_all(self, rng):
        from vector_db_tpu.index.hnsw import HnswIndex

        idx = HnswIndex(16, 512, "l2", self._cfg(flush_min=4096))
        vecs = rng.standard_normal((100, 16)).astype(np.float32)
        idx.add_batch(range(100), vecs)
        idx.flush_pending(limit=100)
        assert idx.stats()["pending_inserts"] == 0

    def test_chunked_recall_matches_full_flush(self, rng):
        from vector_db_tpu.index.hnsw import HnswIndex

        n, dim = 1024, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        q = vecs[:32] + 0.05 * rng.standard_normal((32, dim)).astype(
            np.float32)
        gt = np.argsort(((q[:, None, :] - vecs[None, :, :]) ** 2).sum(-1),
                        1)[:, :10]

        chunked = HnswIndex(dim, n, "l2",
                            self._cfg(flush_min=128, flush_chunk=64))
        for s in range(0, n, 64):
            chunked.add_batch(range(s, s + 64), vecs[s:s + 64])
        full = HnswIndex(dim, n, "l2", self._cfg(flush_min=128))
        for s in range(0, n, 64):
            full.add_batch(range(s, s + 64), vecs[s:s + 64])

        def recall(idx):
            ids, _ = idx.search_batch(q, 10)
            return np.mean([len(set(ids[i]) & set(gt[i])) / 10
                            for i in range(len(q))])

        rc, rf = recall(chunked), recall(full)
        assert rc >= rf - 0.02  # overlay keeps pending rows exact

    def test_hnsw_pq_chunked_flush(self, rng):
        idx = HnswPqIndex(dim=32, capacity=1024, config=HnswPqConfig(
            m=8, ef_construction=64, use_graph=True,
            flush_min=128, flush_chunk=32))
        vecs = rng.standard_normal((512, 32)).astype(np.float32)
        idx.add_batch(range(256), vecs[:256])
        idx.flush_pending()
        idx.add_batch(range(256, 384), vecs[256:384])  # trigger: one chunk
        assert idx.stats()["pending_inserts"] == 96
        ids, _ = idx.search_batch(vecs[300:308], 1)
        assert (ids[:, 0] == np.arange(300, 308)).all()

    def test_chunked_flush_from_empty_graph(self, rng):
        """The first threshold crossing with an EMPTY graph routes the
        chunk through the from-scratch build; the rest stay pending."""
        from vector_db_tpu.index.hnsw import HnswIndex

        idx = HnswIndex(16, 1024, "l2",
                        self._cfg(flush_min=128, flush_chunk=64))
        vecs = rng.standard_normal((256, 16)).astype(np.float32)
        idx.add_batch(range(256), vecs)
        assert int(idx.graph.entry) >= 0  # chunk built the graph
        assert int((np.asarray(idx.graph.levels) >= 0).sum()) == 64
        assert idx.stats()["pending_inserts"] == 192
        ids, _ = idx.search_batch(vecs[200:208], 1)
        assert (ids[:, 0] == np.arange(200, 208)).all()
        idx.flush_pending()
        assert idx.stats()["pending_inserts"] == 0
        assert int((np.asarray(idx.graph.levels) >= 0).sum()) == 256
