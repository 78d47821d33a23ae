"""Fast memory-bound mode tests: the PQ decode (ops/adc.pq_decode_recon_t)
and the adc_fast_search pipeline against numpy oracles."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vector_db_tpu.ops import adc
from vector_db_tpu.ops.adc import pq_decode_recon_t


@pytest.fixture(scope="module")
def pq_state():
    rng = np.random.default_rng(42)
    s, k_tab, sd, n = 8, 16, 4, 600
    cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
    codes = rng.integers(0, k_tab, size=(n, s)).astype(np.uint8)
    return s, k_tab, sd, n, cb, codes


class TestDecodeKernel:
    def test_matches_numpy_decode(self, pq_state):
        s, k_tab, sd, n, cb, codes = pq_state
        cbt = adc.codebooks_to_cbt(jnp.asarray(cb))
        recon_t = pq_decode_recon_t(jnp.asarray(codes.T.copy()), cbt)
        want = np.concatenate(
            [cb[si, codes[:, si], :] for si in range(s)], axis=1
        ).T
        np.testing.assert_allclose(
            np.asarray(recon_t, np.float32), want, atol=0.02
        )

    def test_k256_table(self):
        rng = np.random.default_rng(1)
        s, k_tab, sd, n = 4, 256, 2, 256
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        codes = rng.integers(0, k_tab, size=(n, s)).astype(np.uint8)
        cbt = adc.codebooks_to_cbt(jnp.asarray(cb))
        recon_t = pq_decode_recon_t(jnp.asarray(codes.T.copy()), cbt)
        want = np.concatenate(
            [cb[si, codes[:, si], :] for si in range(s)], axis=1
        ).T
        np.testing.assert_allclose(
            np.asarray(recon_t, np.float32), want, atol=0.05
        )

    def test_uneven_n_padding(self, pq_state):
        s, k_tab, sd, n, cb, codes = pq_state
        cbt = adc.codebooks_to_cbt(jnp.asarray(cb))
        recon_t = pq_decode_recon_t(jnp.asarray(codes.T[:, :300].copy()),
                                    cbt)
        assert recon_t.shape == (s * sd, 300)


class TestAdcFastSearch:
    def test_exact_on_grid_data(self):
        """Vectors that sit exactly on centroids: PQ distance == exact
        distance, so the pipeline must return the true nearest neighbors."""
        rng = np.random.default_rng(7)
        s, k_tab, sd = 4, 16, 4
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        picks = rng.integers(0, k_tab, size=(256, s))
        base = np.concatenate(
            [cb[si, picks[:, si], :] for si in range(s)], axis=1
        ).astype(np.float32)
        codes = picks.astype(np.uint8)
        q = base[:8] + 0.01 * rng.normal(size=(8, s * sd)).astype(np.float32)
        d, ext = adc.adc_fast_search(
            jnp.asarray(q), jnp.asarray(codes.T.copy()),
            adc.codebooks_to_cbt(jnp.asarray(cb)),
            jnp.ones(256, bool), jnp.asarray(base),
            jnp.arange(256, dtype=jnp.int32), 1, bucket=4, winners=2,
        )
        # top-1 == the grid point each query was perturbed from (unless two
        # picks coincide, in which case either copy is exact-correct)
        got = np.asarray(ext)[:, 0]
        for i in range(8):
            assert np.allclose(base[got[i]], base[i], atol=1e-5)

    def test_recall_floor_clustered(self):
        from vector_db_tpu.ops.distance import blocked_knn
        from vector_db_tpu.ops.kmeans import subspace_kmeans_fit

        rng = np.random.default_rng(3)
        dim, nc, per = 32, 30, 20
        centers = rng.normal(size=(nc, dim)).astype(np.float32) * 3
        base = (
            centers[:, None, :] + 0.2 * rng.normal(size=(nc, per, dim))
        ).reshape(-1, dim).astype(np.float32)
        n = len(base)
        q = base[::17][:16] + 0.05 * rng.normal(size=(16, dim)).astype(
            np.float32
        )
        gt_d, gt_i = blocked_knn(
            jnp.asarray(q), jnp.asarray(base), jnp.ones(n, bool), 10,
            block_n=512,
        )
        cb = subspace_kmeans_fit(
            jax.random.PRNGKey(42), jnp.asarray(base), num_subspaces=8,
            k=16, iters=8,
        )
        codes = adc.pq_encode(jnp.asarray(base), cb)
        d, ext = adc.adc_fast_search(
            jnp.asarray(q), jnp.transpose(codes, (1, 0)),
            adc.codebooks_to_cbt(cb), jnp.ones(n, bool), jnp.asarray(base),
            jnp.arange(n, dtype=jnp.int32), 10, bucket=8, winners=2,
        )
        gt_np = np.asarray(gt_i)
        ext_np = np.asarray(ext)
        recall = np.mean([
            len(set(ext_np[i].tolist()) & set(gt_np[i].tolist())) / 10
            for i in range(16)
        ])
        assert recall >= 0.9

    def test_respects_valid_and_distances_sorted(self, pq_state):
        s, k_tab, sd, n, cb, codes = pq_state
        rng = np.random.default_rng(5)
        base = rng.normal(size=(n, s * sd)).astype(np.float32)
        valid = np.ones(n, bool)
        valid[::2] = False
        q = base[:4]
        d, ext = adc.adc_fast_search(
            jnp.asarray(q), jnp.asarray(codes.T.copy()),
            adc.codebooks_to_cbt(jnp.asarray(cb)),
            jnp.asarray(valid), jnp.asarray(base),
            jnp.arange(n, dtype=jnp.int32), 5, bucket=4, winners=1,
        )
        ext_np = np.asarray(ext)
        assert (ext_np % 2 == 1).all()  # only odd (valid) slots
        d_np = np.asarray(d)
        assert (np.diff(d_np, axis=1) >= -1e-6).all()


class TestIndexIntegration:
    def test_adc_fast_mode_via_index(self):
        from vector_db_tpu.api.config import HnswPqConfig
        from vector_db_tpu.index.hnsw_pq import HnswPqIndex

        rng = np.random.default_rng(11)
        dim, n = 32, 800
        base = rng.normal(size=(n, dim)).astype(np.float32)
        cfg = HnswPqConfig(
            num_subspaces=8, num_centroids=32, training_samples=800,
            search_mode="adc_fast", adc_bucket=8, adc_winners=2,
        )
        idx = HnswPqIndex(dim, 1024, "l2", cfg)
        idx.add_batch(range(n), base)
        assert idx.trained
        ids, d = idx.search_batch(base[:8], 5)
        assert (ids[:, 0] == np.arange(8)).all()
        # delete never resurfaces through the fast path
        idx.remove(3)
        ids, _ = idx.search_batch(base[3:4], 5)
        assert 3 not in ids[0]


class TestAutoMode:
    def test_crossover_selection(self):
        from vector_db_tpu.index.hnsw_pq import _auto_scan_mode

        # blocked exact scan up to mid N; the int8 pool scan takes over
        # at large N — crossover threshold 700k live rows (not measured
        # on the H100; see ROADMAP A5)
        assert _auto_scan_mode(False, 100_000) == "scan_exact"
        assert _auto_scan_mode(False, 524_288) == "scan_exact"
        assert _auto_scan_mode(False, 1_000_000) == "scan_pallas_int8"
        assert _auto_scan_mode(True, 100_000) == "graph"
        assert _auto_scan_mode(True, 1_000_000) == "graph"


class TestChunkedLargeN:
    def test_chunked_matches_unchunked(self):
        rng = np.random.default_rng(13)
        s, k_tab, sd, n = 8, 16, 4, 1000
        dim = s * sd
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        base = rng.normal(size=(n, dim)).astype(np.float32)
        codes = np.asarray(adc.pq_encode(jnp.asarray(base), jnp.asarray(cb)))
        valid = np.ones(n, bool)
        valid[100:120] = False
        q = base[:8]
        args = (jnp.asarray(q), jnp.asarray(codes.T.copy()),
                adc.codebooks_to_cbt(jnp.asarray(cb)), jnp.asarray(valid),
                jnp.asarray(base), jnp.arange(n, dtype=jnp.int32), 5)
        d_full, e_full = adc.adc_fast_search(*args, bucket=4, winners=2)
        d_chunk, e_chunk = adc.adc_fast_search(*args, bucket=4, winners=2,
                                               chunk_n=256)
        # same pool contents modulo bucket boundaries -> same exact top-5
        # on well-separated data; assert distances match
        np.testing.assert_allclose(np.asarray(d_chunk)[:, 0],
                                   np.asarray(d_full)[:, 0], rtol=1e-4)
        assert (np.asarray(e_chunk)[:, 0] == np.asarray(e_full)[:, 0]).all()


class TestApproxPool:
    def test_approx_mode_matches_bucket_on_easy_data(self):
        rng = np.random.default_rng(21)
        s, k_tab, sd, n = 8, 16, 4, 512
        dim = s * sd
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        base = rng.normal(size=(n, dim)).astype(np.float32)
        codes = np.asarray(adc.pq_encode(jnp.asarray(base), jnp.asarray(cb)))
        valid = np.ones(n, bool)
        valid[7] = False
        q = base[:6]
        args = (jnp.asarray(q), jnp.asarray(codes.T.copy()),
                adc.codebooks_to_cbt(jnp.asarray(cb)), jnp.asarray(valid),
                jnp.asarray(base), jnp.arange(n, dtype=jnp.int32), 3)
        d_a, e_a = adc.adc_fast_search(*args, bucket=4, winners=2,
                                       pool_mode="approx")
        d_b, e_b = adc.adc_fast_search(*args, bucket=4, winners=2,
                                       pool_mode="bucket")
        # both pools are ~n/2 wide here; exact refine makes top-1 agree
        assert (np.asarray(e_a)[:, 0] == np.asarray(e_b)[:, 0]).all()
        assert 7 not in np.asarray(e_a)  # deleted slot never returned

    def test_cached_code_norms_identical(self):
        rng = np.random.default_rng(22)
        s, k_tab, sd, n = 8, 16, 4, 512
        dim = s * sd
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        base = rng.normal(size=(n, dim)).astype(np.float32)
        codes = np.asarray(adc.pq_encode(jnp.asarray(base), jnp.asarray(cb)))
        ct = jnp.asarray(codes.T.copy())
        cbt = adc.codebooks_to_cbt(jnp.asarray(cb))
        valid = jnp.ones(n, bool)
        from vector_db_tpu.ops.adc import pq_decode_recon_t
        r32 = pq_decode_recon_t(ct, cbt).astype(jnp.float32)
        cached = jnp.sum(r32 * r32, axis=0)
        args = (jnp.asarray(base[:5]), ct, cbt, valid, jnp.asarray(base),
                jnp.arange(n, dtype=jnp.int32), 4)
        d1, e1 = adc.adc_fast_search(*args, bucket=8, winners=1)
        d2, e2 = adc.adc_fast_search(*args, bucket=8, winners=1,
                                     code_norms=cached)
        np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))


class TestBalancedPerm:
    def test_perm_is_valid_and_balanced(self):
        v = (np.arange(64) + 1.0) ** -1.0
        perm = adc.balanced_subspace_perm(v, 8)
        assert sorted(perm.tolist()) == list(range(64))
        loads = v[perm].reshape(8, 8).sum(1)
        # dim 0 alone carries more variance than the per-subspace average, so
        # perfect balance is impossible; assert we're near that floor and far
        # from the consecutive-slice imbalance (20.5x on this spectrum)
        assert loads.max() / loads.min() < 2.5

    def test_perm_improves_spectral_recall(self):
        from vector_db_tpu.api.config import PqConfig
        from vector_db_tpu.index.pq import PqIndex
        from vector_db_tpu.index.brute import BruteForceIndex

        rng = np.random.default_rng(31)
        dim, n = 64, 1500
        scale = (np.arange(dim) + 1.0) ** -0.5
        base = (rng.normal(size=(n, dim)) * scale).astype(np.float32)
        q = (rng.normal(size=(24, dim)) * scale).astype(np.float32)
        brute = BruteForceIndex(dim, 2048)
        brute.add_batch(range(n), base)
        gt, _ = brute.search_batch(q, 10)

        recalls = {}
        for bal in (False, True):
            idx = PqIndex(dim, 2048, "l2",
                          PqConfig(num_subspaces=8, balance_dims=bal))
            idx.add_batch(range(n), base)
            idx.build()
            ids, _ = idx.search_batch(q, 10)
            recalls[bal] = np.mean(
                [len(set(ids[i]) & set(gt[i])) / 10 for i in range(24)]
            )
        assert recalls[True] > recalls[False] + 0.1, recalls

    def test_perm_roundtrips_through_persistence(self):
        from vector_db_tpu.api.config import HnswPqConfig
        from vector_db_tpu.index.hnsw_pq import HnswPqIndex

        rng = np.random.default_rng(33)
        dim, n = 32, 600
        scale = (np.arange(dim) + 1.0) ** -0.5
        base = (rng.normal(size=(n, dim)) * scale).astype(np.float32)
        cfg = HnswPqConfig(num_subspaces=8, num_centroids=32,
                           training_samples=600, search_mode="adc_fast",
                           adc_bucket=8, adc_winners=2)
        idx = HnswPqIndex(dim, 1024, "l2", cfg)
        idx.add_batch(range(n), base)
        assert idx.perm is not None
        idx2 = HnswPqIndex(dim, 1024, "l2", cfg)
        idx2.load_state_arrays(idx.state_arrays())
        a, _ = idx.search_batch(base[:6], 5)
        b, _ = idx2.search_batch(base[:6], 5)
        np.testing.assert_array_equal(a, b)


class TestPackedRefine:
    def test_packed_matches_f32_neighbors(self):
        rng = np.random.default_rng(61)
        s, k_tab, sd, n = 8, 16, 4, 800
        dim = s * sd
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        base = rng.normal(size=(n, dim)).astype(np.float32)
        codes = np.asarray(adc.pq_encode(jnp.asarray(base), jnp.asarray(cb)))
        valid = jnp.ones(n, bool)
        q = base[:8]
        from vector_db_tpu.ops.distance import pack_bf16_rows
        packed = pack_bf16_rows(jnp.asarray(base))
        args = (jnp.asarray(q), jnp.asarray(codes.T.copy()),
                adc.codebooks_to_cbt(jnp.asarray(cb)), valid,
                jnp.asarray(base), jnp.arange(n, dtype=jnp.int32), 5)
        d32, e32 = adc.adc_fast_search(*args, bucket=4, winners=2)
        d16, e16 = adc.adc_fast_search(*args, bucket=4, winners=2,
                                       packed_base=packed)
        assert (np.asarray(e16)[:, 0] == np.asarray(e32)[:, 0]).all()
        np.testing.assert_allclose(np.asarray(d16), np.asarray(d32),
                                   rtol=2e-2, atol=0.5)

    def test_index_bf16_refine_store(self):
        from vector_db_tpu.api.config import HnswPqConfig
        from vector_db_tpu.index.hnsw_pq import HnswPqIndex

        rng = np.random.default_rng(62)
        dim, n = 32, 600
        base = rng.normal(size=(n, dim)).astype(np.float32)
        cfg = HnswPqConfig(num_subspaces=8, num_centroids=32,
                           training_samples=600, search_mode="adc_fast",
                           adc_bucket=8, adc_winners=2, refine_store="bf16")
        idx = HnswPqIndex(dim, 1024, "l2", cfg)
        idx.add_batch(range(n), base)
        ids, _ = idx.search_batch(base[:8], 3)
        assert (ids[:, 0] == np.arange(8)).all()
        # mutation invalidates the shadow
        idx.add_batch([900], base[:1] * 0.5)
        ids, _ = idx.search_batch(base[:1] * 0.5, 1)
        assert ids[0, 0] == 900


class TestSelectNarrowing:
    def test_select_r_preserves_top_results(self):
        rng = np.random.default_rng(71)
        s, k_tab, sd, n = 8, 16, 4, 1024
        dim = s * sd
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        base = rng.normal(size=(n, dim)).astype(np.float32)
        codes = np.asarray(adc.pq_encode(jnp.asarray(base), jnp.asarray(cb)))
        q = base[:6]
        args = (jnp.asarray(q), jnp.asarray(codes.T.copy()),
                adc.codebooks_to_cbt(jnp.asarray(cb)), jnp.ones(n, bool),
                jnp.asarray(base), jnp.arange(n, dtype=jnp.int32), 3)
        d_w, e_w = adc.adc_fast_search(*args, bucket=2, winners=1)
        d_n, e_n = adc.adc_fast_search(*args, bucket=2, winners=1,
                                       select_r=128)
        # self-retrieval survives the narrowing
        assert (np.asarray(e_n)[:, 0] == np.arange(6)).all()
        assert (np.asarray(e_w)[:, 0] == np.arange(6)).all()

    def test_select_r_with_fused_and_chunks(self):
        rng = np.random.default_rng(72)
        s, k_tab, sd, n = 4, 16, 4, 1024
        dim = s * sd
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        base = rng.normal(size=(n, dim)).astype(np.float32)
        codes = np.asarray(adc.pq_encode(jnp.asarray(base), jnp.asarray(cb)))
        q = base[:4]
        args = (jnp.asarray(q), jnp.asarray(codes.T.copy()),
                adc.codebooks_to_cbt(jnp.asarray(cb)), jnp.ones(n, bool),
                jnp.asarray(base), jnp.arange(n, dtype=jnp.int32), 3)
        d1, e1 = adc.adc_fast_search(*args, bucket=4, winners=1,
                                     pool_mode="bucket", select_r=64)
        assert (np.asarray(e1)[:, 0] == np.arange(4)).all()
        d2, e2 = adc.adc_fast_search(*args, bucket=4, winners=1,
                                     chunk_n=256, select_r=64)
        assert (np.asarray(e2)[:, 0] == np.arange(4)).all()


class TestApproxRankedDirect:
    def test_approx_select_r_requests_ranked_pool_directly(self):
        """pool_mode='approx' + select_r asks approx_max_k for top-select_r
        directly (no redundant narrowing pass) and matches brute top-k."""
        rng = np.random.default_rng(73)
        s, k_tab, sd, n = 8, 16, 4, 2048
        dim = s * sd
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        base = rng.normal(size=(n, dim)).astype(np.float32)
        codes = np.asarray(adc.pq_encode(jnp.asarray(base), jnp.asarray(cb)))
        q = base[:8]
        args = (jnp.asarray(q), jnp.asarray(codes.T.copy()),
                adc.codebooks_to_cbt(jnp.asarray(cb)), jnp.ones(n, bool),
                jnp.asarray(base), jnp.arange(n, dtype=jnp.int32), 5)
        # bucket value is ignored/overridden when approx + select_r
        d1, e1 = adc.adc_fast_search(*args, bucket=7, winners=1,
                                     pool_mode="approx", select_r=256)
        d2, e2 = adc.adc_fast_search(*args, bucket=8, winners=1,
                                     pool_mode="approx", select_r=256)
        assert (np.asarray(e1)[:, 0] == np.arange(8)).all()
        np.testing.assert_array_equal(np.asarray(e1), np.asarray(e2))
        # exact distances from the refine: self-distance ~ 0
        assert float(np.asarray(d1)[:, 0].max()) < 1e-3

    def test_approx_select_r_respects_winners(self):
        rng = np.random.default_rng(74)
        s, k_tab, sd, n = 4, 16, 4, 1024
        dim = s * sd
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        base = rng.normal(size=(n, dim)).astype(np.float32)
        codes = np.asarray(adc.pq_encode(jnp.asarray(base), jnp.asarray(cb)))
        q = base[:4]
        args = (jnp.asarray(q), jnp.asarray(codes.T.copy()),
                adc.codebooks_to_cbt(jnp.asarray(cb)), jnp.ones(n, bool),
                jnp.asarray(base), jnp.arange(n, dtype=jnp.int32), 3)
        d, e = adc.adc_fast_search(*args, bucket=4, winners=2,
                                   pool_mode="approx", select_r=128)
        assert (np.asarray(e)[:, 0] == np.arange(4)).all()


class TestDecodeCross:
    def test_decode_cross_equivalence(self, pq_state):
        s, k_tab, sd, n, cb, codes = pq_state
        rng = np.random.default_rng(6)
        q = jnp.asarray(rng.normal(size=(5, s * sd)).astype(np.float32))
        cbt = adc.codebooks_to_cbt(jnp.asarray(cb))
        ct = jnp.asarray(codes.T.copy())
        recon = pq_decode_recon_t(ct, cbt).astype(jnp.float32)
        # the cross term's contract: bf16 operands, f32 accumulation
        q16 = np.asarray(q.astype(jnp.bfloat16).astype(jnp.float32))
        want = q16 @ np.asarray(recon)
        got = np.asarray(adc._decode_cross(q, ct, cbt))
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)

    def test_odd_subdim(self):
        rng = np.random.default_rng(7)
        s, k_tab, sd, n = 4, 16, 3, 300
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        codes = rng.integers(0, k_tab, size=(n, s)).astype(np.uint8)
        cbt = adc.codebooks_to_cbt(jnp.asarray(cb))
        ct = jnp.asarray(codes.T.copy())
        q = jnp.asarray(rng.normal(size=(3, s * sd)).astype(np.float32))
        recon = pq_decode_recon_t(ct, cbt).astype(jnp.float32)
        # the cross term's contract: bf16 operands, f32 accumulation
        q16 = np.asarray(q.astype(jnp.bfloat16).astype(jnp.float32))
        want = q16 @ np.asarray(recon)
        got = np.asarray(adc._decode_cross(q, ct, cbt))
        np.testing.assert_allclose(got, want, rtol=2e-2, atol=2e-2)


class TestOddCodebookSizes:
    def test_decode_k200(self):
        """128 < K < 256: a table that is not a power of two (regression:
        any num_centroids in (128, 256) once crashed the decode)."""
        rng = np.random.default_rng(8)
        s, k_tab, sd, n = 4, 200, 4, 512
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        codes = rng.integers(0, k_tab, size=(n, s)).astype(np.uint8)
        cbt = adc.codebooks_to_cbt(jnp.asarray(cb))
        ct = jnp.asarray(codes.T.copy())
        recon = pq_decode_recon_t(ct, cbt)
        want = np.concatenate(
            [cb[si, codes[:, si], :] for si in range(s)], axis=1).T
        np.testing.assert_allclose(np.asarray(recon, np.float32), want,
                                   atol=0.02)

    def test_pq_index_k200_end_to_end(self):
        from vector_db_tpu.api.config import PqConfig
        from vector_db_tpu.index.pq import PqIndex

        rng = np.random.default_rng(9)
        vecs = rng.standard_normal((600, 32)).astype(np.float32)
        idx = PqIndex(32, 1024, "l2",
                      PqConfig(num_subspaces=4, num_centroids=200))
        idx.add_batch(range(600), vecs)
        idx.build()
        ids, _ = idx.search_batch(vecs[:8], 5)
        assert ids.shape == (8, 5)

    def test_fused_pool_k200(self):
        """The decode + matmul + bucket pool over a K=200 table: one slot
        per strided bucket, each in range or -1."""
        rng = np.random.default_rng(10)
        s, k_tab, sd, n = 4, 200, 4, 512
        dim = s * sd
        cb = rng.normal(size=(s, k_tab, sd)).astype(np.float32)
        base = rng.normal(size=(n, dim)).astype(np.float32)
        codes = np.asarray(adc.pq_encode(jnp.asarray(base), jnp.asarray(cb)))
        cbt = adc.codebooks_to_cbt(jnp.asarray(cb))
        ct = jnp.asarray(codes.T.copy())
        cnorms = adc.code_norms_from_codes(ct, cbt, jnp.ones(n, bool))
        vals, idx = adc._score_pool_chunk(
            jnp.asarray(base[:4]).astype(adc.SCAN_DTYPE), ct, cbt, cnorms,
            bucket=4, winners=1)
        got = np.asarray(idx)
        assert got.shape == (4, n // 4)
        assert ((got >= -1) & (got < n)).all()
