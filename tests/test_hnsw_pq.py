"""HNSW+PQ flagship tests (reference analog: test_hnswpq.cpp — train/add/
sorted-distance :26-70, recall-vs-HNSW :146-214; RecallOptimizationTest
assertion floors, scaled for CPU CI)."""

import numpy as np
import pytest

from vector_db_tpu.api.config import HnswPqConfig
from vector_db_tpu.index.brute import BruteForceIndex
from vector_db_tpu.index.hnsw_pq import HnswPqIndex


def small_cfg(**kw):
    base = dict(
        m=8,
        ef_construction=32,
        ef_search=64,
        num_subspaces=4,
        num_centroids=16,
        training_iterations=8,
        training_samples=128,
        refine_k=64,
        use_graph=False,
        search_mode="adc",  # exercise the memory-bound ADC path; the
        # "auto" exact-scan default is covered by TestScanMode
    )
    base.update(kw)
    return HnswPqConfig(**base)


@pytest.fixture(scope="module")
def built():
    rng = np.random.default_rng(42)
    n, dim = 400, 16
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    idx = HnswPqIndex(dim, 512, "l2", small_cfg())
    idx.add_batch(range(n), vecs)
    brute = BruteForceIndex(dim, 512)
    brute.add_batch(range(n), vecs)
    return idx, brute, vecs


class TestLazyTraining:
    def test_trains_at_threshold(self, rng):
        idx = HnswPqIndex(16, 512, "l2", small_cfg(training_samples=64))
        vecs = rng.standard_normal((300, 16)).astype(np.float32)
        idx.add_batch(range(30), vecs[:30])
        assert not idx.trained  # below threshold
        idx.add_batch(range(30, 300), vecs[30:])
        assert idx.trained  # lazy-trained mid-stream

    def test_untrained_search_is_exact(self, rng):
        idx = HnswPqIndex(16, 512, "l2", small_cfg())
        vecs = rng.standard_normal((50, 16)).astype(np.float32)
        idx.add_batch(range(50), vecs)
        assert not idx.trained
        ids, _ = idx.search(vecs[11], 1)
        assert ids[0] == 11


class TestFlagshipSearch:
    def test_recall_floor(self, built, rng):
        # reference: RecallOptimizationTest.java:204-205 asserts >= 70%/85%
        idx, brute, vecs = built
        q = rng.standard_normal((30, 16)).astype(np.float32)
        a, _ = idx.search_batch(q, 10)
        g, _ = brute.search_batch(q, 10)
        recall = np.mean([len(set(a[i]) & set(g[i])) / 10 for i in range(30)])
        assert recall >= 0.85

    def test_self_retrieval(self, built):
        idx, _, vecs = built
        ids, d = idx.search_batch(vecs[:20], 1)
        assert (ids[:, 0] == np.arange(20)).all()
        assert (d[:, 0] < 0.1).all()  # exact re-rank distances

    def test_sorted_distances(self, built, rng):
        idx, _, _ = built
        _, d = idx.search(rng.standard_normal(16).astype(np.float32), 10)
        finite = d[np.isfinite(d)]
        assert (np.diff(finite) >= -1e-5).all()

    def test_graph_path_recall(self, rng):
        n, dim = 400, 16
        vecs = np.random.default_rng(7).standard_normal((n, dim)).astype(np.float32)
        idx = HnswPqIndex(dim, 512, "l2", small_cfg(use_graph=True, refine_k=64))
        idx.add_batch(range(n), vecs)
        assert idx.trained
        brute = BruteForceIndex(dim, 512)
        brute.add_batch(range(n), vecs)
        q = vecs[:20]
        a, _ = idx.search_batch(q, 10)
        g, _ = brute.search_batch(q, 10)
        recall = np.mean([len(set(a[i]) & set(g[i])) / 10 for i in range(20)])
        assert recall >= 0.7  # graph+ADC traversal floor at small params

    def test_add_after_train(self, built):
        idx, _, _ = built
        nv = np.random.default_rng(9).standard_normal(16).astype(np.float32)
        idx.add(5000, nv)
        ids, _ = idx.search(nv, 1)
        assert ids[0] == 5000
        assert idx.remove(5000)


class TestCompression:
    def test_stats_and_ratio(self, built):
        idx, _, _ = built
        s = idx.stats()
        assert s["trained"]
        assert s["compression_ratio"] == pytest.approx(16.0)
        assert s["index_bytes"] < s["raw_bytes"]

    def test_deletion(self, rng):
        idx = HnswPqIndex(16, 512, "l2", small_cfg(training_samples=64))
        vecs = rng.standard_normal((200, 16)).astype(np.float32)
        idx.add_batch(range(200), vecs)
        assert idx.trained
        assert idx.remove(5)
        ids, _ = idx.search(vecs[5], 3)
        assert 5 not in ids

    def test_rebuild(self, rng):
        idx = HnswPqIndex(16, 512, "l2", small_cfg(training_samples=64))
        vecs = rng.standard_normal((200, 16)).astype(np.float32)
        idx.add_batch(range(200), vecs)
        for i in range(50):
            idx.remove(i)
        idx.build()
        assert idx.size() == 150
        ids, _ = idx.search(vecs[100], 1)
        assert ids[0] == 100


class TestScanMode:
    def test_auto_exact_scan_full_recall(self, built, rng):
        """The auto mode (blocked exact scan) matches brute-force exactly."""
        idx, brute, vecs = built
        idx.config.search_mode = "auto"
        try:
            q = rng.standard_normal((16, 16)).astype(np.float32)
            a, _ = idx.search_batch(q, 10)
            g, _ = brute.search_batch(q, 10)
            recall = np.mean([len(set(a[i]) & set(g[i])) / 10 for i in range(16)])
            assert recall >= 0.99
        finally:
            idx.config.search_mode = "adc"

    def test_pruned_adc_path(self, rng):
        n, dim = 512, 16
        vecs = np.random.default_rng(11).standard_normal((n, dim)).astype(np.float32)
        cfg = small_cfg(nlist=8, nprobe=4, refine_k=64, training_samples=128)
        idx = HnswPqIndex(dim, n, "l2", cfg)
        idx.add_batch(range(n), vecs)
        assert idx.trained and idx.coarse_centroids is not None
        ids, _ = idx.search_batch(vecs[:16], 1)
        # nprobe=4 of 8 clusters: self-cluster always probed -> self found
        assert (ids[:, 0] == np.arange(16)).mean() >= 0.9


class TestPersistence:
    def test_roundtrip(self, built):
        idx, _, vecs = built
        arrays = idx.state_arrays()
        idx2 = HnswPqIndex(16, 512, "l2", small_cfg())
        idx2.load_state_arrays(arrays)
        assert idx2.trained and idx2.size() == idx.size()
        a, _ = idx.search(vecs[7], 5)
        b, _ = idx2.search(vecs[7], 5)
        np.testing.assert_array_equal(a, b)


class TestPcaProxyMode:
    """search_mode='pca': truncated-PCA proxy scan + exact refine (ops/pca)."""

    def _corpus(self, n=2048, dim=64):
        rng = np.random.default_rng(42)
        scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
        return (rng.standard_normal((n, dim)) * scale).astype(np.float32)

    def test_recall_vs_brute(self):
        from vector_db_tpu.index.brute import BruteForceIndex

        vecs = self._corpus()
        n, dim = vecs.shape
        cfg = HnswPqConfig(num_subspaces=8, training_samples=1024,
                           search_mode="pca", proxy_dims=16, pca_r=128)
        idx = HnswPqIndex(dim, n, "l2", cfg)
        idx.add_batch(range(n), vecs)
        brute = BruteForceIndex(dim, n)
        brute.add_batch(range(n), vecs)
        q = vecs[:32] + 0.01 * np.random.default_rng(1).standard_normal(
            (32, dim)).astype(np.float32)
        a, da = idx.search_batch(q, 10)
        g, dg = brute.search_batch(q, 10)
        recall = np.mean([len(set(a[i]) & set(g[i])) / 10 for i in range(32)])
        assert recall >= 0.9, recall
        # refine distances are exact
        np.testing.assert_allclose(da[:, 0], dg[:, 0], rtol=1e-3, atol=1e-3)

    def test_incremental_adds_update_proxy(self):
        vecs = self._corpus(1024, 32)
        cfg = HnswPqConfig(num_subspaces=8, training_samples=512,
                           search_mode="pca", proxy_dims=8, pca_r=64)
        idx = HnswPqIndex(32, 2048, "l2", cfg)
        idx.add_batch(range(1024), vecs)
        assert idx.trained and idx.proxy is not None
        nv = vecs[7] * 0.5
        idx.add_batch([9999], nv[None, :])
        ids, _ = idx.search_batch(nv[None, :], 1)
        assert ids[0, 0] == 9999

    def test_persistence_roundtrip(self):
        vecs = self._corpus(1024, 32)
        cfg = HnswPqConfig(num_subspaces=8, training_samples=512,
                           search_mode="pca", proxy_dims=8, pca_r=64)
        idx = HnswPqIndex(32, 1024, "l2", cfg)
        idx.add_batch(range(1024), vecs)
        idx2 = HnswPqIndex(32, 1024, "l2", cfg)
        idx2.load_state_arrays(idx.state_arrays())
        a, _ = idx.search_batch(vecs[:8], 5)
        b, _ = idx2.search_batch(vecs[:8], 5)
        np.testing.assert_array_equal(a, b)

    def test_remove_excludes_from_pca_path(self):
        vecs = self._corpus(1024, 32)
        cfg = HnswPqConfig(num_subspaces=8, training_samples=512,
                           search_mode="pca", proxy_dims=8, pca_r=64)
        idx = HnswPqIndex(32, 1024, "l2", cfg)
        idx.add_batch(range(1024), vecs)
        assert idx.remove(5)
        ids, _ = idx.search_batch(vecs[5:6], 5)
        assert 5 not in ids[0]

    def test_chunked_proxy_selection_matches_fullrow(self):
        from vector_db_tpu.ops import pca
        import jax.numpy as jnp

        vecs = self._corpus(1024, 32)
        mu, basis = pca.pca_fit(vecs[:512], 8)
        mu_j, basis_j = jnp.asarray(mu), jnp.asarray(basis)
        proxy = pca.project_rows(jnp.asarray(vecs), mu_j, basis_j)
        p32 = proxy.astype(jnp.float32)
        pnorms = jnp.sum(p32 * p32, axis=1)
        args = (jnp.asarray(vecs[:8]), mu_j, basis_j, proxy, pnorms,
                jnp.ones(1024, bool), jnp.asarray(vecs),
                jnp.arange(1024, dtype=jnp.int32), 5)
        d1, e1 = pca.pca_proxy_search(*args, select_r=64)
        d2, e2 = pca.pca_proxy_search(*args, select_r=64, block_n=256,
                                      force_chunked=True)
        assert (np.asarray(e1)[:, 0] == np.arange(8)).all()
        assert (np.asarray(e2)[:, 0] == np.arange(8)).all()
        np.testing.assert_allclose(np.asarray(d1)[:, 0],
                                   np.asarray(d2)[:, 0], atol=1e-4)

    def test_cosine_metric_with_varied_norms(self):
        """Cosine pca mode must rank by angle, not magnitude (regression:
        un-normalized proxies scored 55% here)."""
        from vector_db_tpu.index.brute import BruteForceIndex

        rng = np.random.default_rng(42)
        n, dim = 2048, 64
        scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
        vecs = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
        vecs *= rng.uniform(0.1, 10.0, (n, 1)).astype(np.float32)
        cfg = HnswPqConfig(num_subspaces=8, training_samples=1024,
                           search_mode="pca", proxy_dims=16, pca_r=128)
        idx = HnswPqIndex(dim, n, "cosine", cfg)
        idx.add_batch(range(n), vecs)
        brute = BruteForceIndex(dim, n, "cosine")
        brute.add_batch(range(n), vecs)
        a, _ = idx.search_batch(vecs[:32], 10)
        g, _ = brute.search_batch(vecs[:32], 10)
        rec = np.mean([len(set(a[i]) & set(g[i])) / 10 for i in range(32)])
        assert rec >= 0.9, rec
