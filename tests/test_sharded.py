"""Multi-chip sharding tests on the 8-device CPU fake
(SURVEY.md §4.5: xla_force_host_platform_device_count is the multi-chip fake,
the way the reference CI uses QEMU)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from vector_db_tpu.parallel import sharded as sh


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "conftest must provide 8 virtual devices"
    return sh.make_mesh(8)


@pytest.fixture(scope="module")
def corpus(mesh):
    rng = np.random.default_rng(42)
    n, dim = 512, 32
    vecs = rng.standard_normal((n, dim)).astype(np.float32)
    return vecs


class TestShardedKnn:
    def test_matches_single_device(self, mesh, corpus):
        rng = np.random.default_rng(0)
        q = rng.standard_normal((16, 32)).astype(np.float32)
        valid = np.ones(512, bool)
        norms = (corpus ** 2).sum(1)
        base_s, valid_s, norms_s = sh.shard_corpus(
            mesh, jnp.asarray(corpus), jnp.asarray(valid), jnp.asarray(norms)
        )
        fn = sh.sharded_knn(mesh, 10)
        d, idx = fn(jnp.asarray(q), base_s, valid_s, norms_s)
        # single-device reference
        full = ((q[:, None, :] - corpus[None]) ** 2).sum(-1)
        want = np.sort(full, axis=1)[:, :10]
        got = np.take_along_axis(full, np.asarray(idx), axis=1)
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=0.15)

    def test_respects_valid(self, mesh, corpus):
        valid = np.ones(512, bool)
        valid[:64] = False  # kill shard 0 entirely
        norms = (corpus ** 2).sum(1)
        base_s, valid_s, norms_s = sh.shard_corpus(
            mesh, jnp.asarray(corpus), jnp.asarray(valid), jnp.asarray(norms)
        )
        fn = sh.sharded_knn(mesh, 5)
        d, idx = fn(jnp.asarray(corpus[:4]), base_s, valid_s, norms_s)
        assert not np.isin(np.asarray(idx), np.arange(64)).any()


class TestDpKnn:
    def test_matches_single_device(self, mesh, corpus):
        rng = np.random.default_rng(1)
        q = rng.standard_normal((16, 32)).astype(np.float32)  # 16 = 8 * 2
        valid = jnp.ones(512, bool)
        norms = jnp.asarray((corpus ** 2).sum(1))
        fn = sh.dp_knn(mesh, 5)
        d, idx = fn(jnp.asarray(q), jnp.asarray(corpus), valid, norms)
        full = ((q[:, None, :] - corpus[None]) ** 2).sum(-1)
        want = np.sort(full, axis=1)[:, :5]
        got = np.take_along_axis(full, np.asarray(idx), axis=1)
        np.testing.assert_allclose(got, want, rtol=5e-3, atol=0.15)


class TestShardedKmeans:
    def test_matches_single_device_step(self, mesh, corpus):
        from vector_db_tpu.ops.kmeans import lloyd_iteration

        k = 8
        cents = corpus[:k].copy()
        data = jnp.asarray(corpus)
        norms = jnp.sum(data * data, axis=1)
        want, _ = lloyd_iteration(data, jnp.asarray(cents), norms,
                                  jnp.ones(512, bool))
        (data_s,) = sh.shard_corpus(mesh, data)
        (cents_r,) = sh.replicate(mesh, jnp.asarray(cents))
        step = sh.sharded_kmeans_step(mesh)
        got = step(data_s, cents_r)
        np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                   rtol=1e-4, atol=1e-4)


class TestShardedDatabase:
    def test_exact_search(self, mesh, corpus):
        ids = np.arange(512, dtype=np.int32)
        valid = np.ones(512, bool)
        db = sh.ShardedDatabase(mesh, corpus, ids, valid)
        ext, d = db.search(corpus[:8], 1)
        np.testing.assert_array_equal(ext[:, 0], np.arange(8))

    def test_flagship_search(self, mesh, corpus):
        from vector_db_tpu.ops import adc
        from vector_db_tpu.ops.kmeans import subspace_kmeans_fit

        cb = subspace_kmeans_fit(jax.random.PRNGKey(0), jnp.asarray(corpus),
                                 num_subspaces=4, k=16, iters=5)
        codes = adc.pq_encode(jnp.asarray(corpus), cb)
        ids = np.arange(512, dtype=np.int32)
        valid = np.ones(512, bool)
        db = sh.ShardedDatabase(mesh, corpus, ids, valid,
                                codes=np.asarray(codes), codebooks=np.asarray(cb))
        ext, d = db.search_flagship(corpus[:8], 5, refine=32)
        np.testing.assert_array_equal(ext[:, 0], np.arange(8))

    def test_pads_uneven_corpus(self, mesh):
        rng = np.random.default_rng(3)
        vecs = rng.standard_normal((100, 16)).astype(np.float32)  # 100 % 8 != 0
        ids = np.arange(100, dtype=np.int32)
        db = sh.ShardedDatabase(mesh, vecs, ids, np.ones(100, bool))
        ext, d = db.search(vecs[:4], 3)
        np.testing.assert_array_equal(ext[:, 0], np.arange(4))
        assert (ext >= -1).all() and (ext < 100).all()


class TestShardedCrudBuild:
    """Round-2: CRUD + sharded end-to-end build (VERDICT 'multi-chip
    CRUD/build'): empty db -> add_batch -> train_pq (data-parallel subspace
    k-means) -> sharded encode -> flagship search -> deletes at uneven N."""

    def test_end_to_end_build_and_search(self, mesh):
        rng = np.random.default_rng(7)
        n, dim = 300, 32  # uneven: 300 % 8 != 0
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=512, num_subspaces=4)
        acc = db.add_batch(np.arange(n), vecs)
        assert len(acc) == n and db.size() == n
        db.train_pq(num_centroids=16, iters=5)
        ext, d = db.search_flagship(vecs[:8], 5, refine=64)
        np.testing.assert_array_equal(ext[:, 0], np.arange(8))
        # exact path agrees on top-1
        ext2, _ = db.search(vecs[:8], 1)
        np.testing.assert_array_equal(ext2[:, 0], np.arange(8))

    def test_incremental_adds_after_train(self, mesh):
        rng = np.random.default_rng(8)
        dim = 32
        vecs = rng.standard_normal((200, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=512, num_subspaces=4)
        db.add_batch(np.arange(100), vecs[:100])
        db.train_pq(num_centroids=16, iters=4)
        db.add_batch(np.arange(100, 200), vecs[100:])  # encoded incrementally
        ext, _ = db.search_flagship(vecs[150:154], 3, refine=32)
        np.testing.assert_array_equal(ext[:, 0], np.arange(150, 154))

    def test_deletes_and_slot_reuse(self, mesh):
        rng = np.random.default_rng(9)
        dim = 16
        vecs = rng.standard_normal((100, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=128)
        db.add_batch(np.arange(100), vecs)
        for i in range(0, 100, 3):
            assert db.remove(i)
        assert db.size() == 100 - len(range(0, 100, 3))
        ext, _ = db.search(vecs[:6], 2)
        for row, qi in enumerate(range(6)):
            if qi % 3 == 0:
                assert qi not in ext[row]  # deleted ids never come back
            else:
                assert ext[row, 0] == qi
        # freed slots are reused: refill beyond the naive fill pointer
        fill_before = db._fill.copy()
        more = rng.standard_normal((30, dim)).astype(np.float32)
        acc = db.add_batch(np.arange(1000, 1030), more)
        assert len(acc) == 30
        assert (db._fill <= db.per_shard).all()
        ext, _ = db.search(more[:3], 1)
        np.testing.assert_array_equal(ext[:, 0], np.arange(1000, 1003))

    def test_duplicate_ids_rejected(self, mesh):
        rng = np.random.default_rng(10)
        vecs = rng.standard_normal((10, 16)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=16, capacity=64)
        assert len(db.add_batch([1, 1, 2], vecs[:3])) == 2
        assert db.size() == 2


class TestShardedPca:
    def test_pca_search_finds_self(self, mesh):
        from vector_db_tpu.ops import pca
        from vector_db_tpu.parallel import sharded as sh

        rng = np.random.default_rng(42)
        n, dim, p, k = 256, 32, 8, 4
        scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
        vecs = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
        mu, basis = pca.pca_fit(vecs[:128], p)
        mu_j, basis_j = jnp.asarray(mu), jnp.asarray(basis)
        proxy = pca.project_rows(jnp.asarray(vecs), mu_j, basis_j)
        p32 = proxy.astype(jnp.float32)
        pnorms = jnp.sum(p32 * p32, axis=1)
        valid = jnp.ones(n, bool)
        ids = jnp.arange(100, 100 + n, dtype=jnp.int32)
        proxy_s, pnorms_s, valid_s, base_s, ids_s = sh.shard_corpus(
            mesh, proxy, pnorms, valid, jnp.asarray(vecs), ids)
        fn = sh.sharded_pca_search(mesh, k, 32)
        q = jnp.asarray(vecs[:8])
        d, e = fn(q, mu_j, basis_j, proxy_s, pnorms_s, valid_s, base_s,
                  ids_s)
        assert (np.asarray(e)[:, 0] == 100 + np.arange(8)).all()
        assert float(np.asarray(d)[:, 0].max()) < 1e-3

    def test_pca_search_respects_tombstones(self, mesh):
        from vector_db_tpu.ops import pca
        from vector_db_tpu.parallel import sharded as sh

        rng = np.random.default_rng(3)
        n, dim, p, k = 128, 16, 4, 3
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        mu, basis = pca.pca_fit(vecs, p)
        mu_j, basis_j = jnp.asarray(mu), jnp.asarray(basis)
        proxy = pca.project_rows(jnp.asarray(vecs), mu_j, basis_j)
        p32 = proxy.astype(jnp.float32)
        pnorms = jnp.sum(p32 * p32, axis=1)
        valid = np.ones(n, bool)
        valid[5] = False
        ids = jnp.arange(n, dtype=jnp.int32)
        shards = sh.shard_corpus(mesh, proxy, pnorms, jnp.asarray(valid),
                                 jnp.asarray(vecs), ids)
        fn = sh.sharded_pca_search(mesh, k, 16)
        d, e = fn(jnp.asarray(vecs[5:6]), mu_j, basis_j, *shards)
        assert 5 not in np.asarray(e)[0]

    def test_sharded_database_search_pca(self, mesh):
        from vector_db_tpu.parallel import sharded as sh

        rng = np.random.default_rng(7)
        n, dim = 256, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=2 * n,
                                num_subspaces=4)
        db.add_batch(np.arange(n), vecs)
        db.fit_pca(8)
        ext, d = db.search_pca(vecs[:8], 3, select_r=32)
        assert (ext[:, 0] == np.arange(8)).all()
        # mutations invalidate the cached proxy
        assert db.remove(0)
        ext2, _ = db.search_pca(vecs[:1], 3, select_r=32)
        assert 0 not in ext2[0]

    def test_sharded_database_cosine_metric(self, mesh):
        from vector_db_tpu.parallel import sharded as sh

        rng = np.random.default_rng(11)
        n, dim = 256, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        vecs *= rng.uniform(0.1, 10.0, (n, 1)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=2 * n,
                                num_subspaces=4, metric="cosine")
        db.add_batch(np.arange(n), vecs)
        # exact cosine search: a scaled copy of row 7 must match row 7 first
        ext, d = db.search(2.5 * vecs[7:8], 3)
        assert ext[0, 0] == 7
        assert abs(d[0, 0]) < 1e-4
        db.train_pq(num_centroids=16, iters=6)
        ext2, _ = db.search_flagship(3.0 * vecs[7:8], 3, refine=32)
        assert ext2[0, 0] == 7
        db.fit_pca(8)
        ext3, _ = db.search_pca(0.5 * vecs[7:8], 3, select_r=32)
        assert ext3[0, 0] == 7


class TestShardedPersistence:
    """Round-3 (VERDICT #3): the multi-chip tier persists — save/load over
    the checkpoint layer preserving search results exactly, plus the
    vectorized bulk ingest (no per-row Python/argmin loop)."""

    def test_save_load_roundtrip_preserves_search(self, mesh, tmp_path):
        rng = np.random.default_rng(21)
        n, dim = 400, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=512, num_subspaces=4)
        db.add_batch(np.arange(n), vecs)
        db.train_pq(num_centroids=16, iters=5)
        db.fit_pca(8)
        for i in range(0, 40, 3):
            db.remove(i)
        q = rng.standard_normal((16, dim)).astype(np.float32)
        exact_before = db.search(q, 5)
        flag_before = db.search_flagship(q, 5, refine=64)
        pca_before = db.search_pca(q, 5, select_r=64)
        db.save(str(tmp_path / "sdb"))

        db2 = sh.ShardedDatabase.load(mesh, str(tmp_path / "sdb"))
        assert db2.size() == db.size()
        exact_after = db2.search(q, 5)
        np.testing.assert_array_equal(exact_before[0], exact_after[0])
        np.testing.assert_allclose(exact_before[1], exact_after[1],
                                   rtol=1e-5, atol=1e-5)
        flag_after = db2.search_flagship(q, 5, refine=64)
        np.testing.assert_array_equal(flag_before[0], flag_after[0])
        pca_after = db2.search_pca(q, 5, select_r=64)
        np.testing.assert_array_equal(pca_before[0], pca_after[0])
        # deleted ids stay deleted; CRUD continues post-load
        assert db2.remove(100)
        assert len(db2.add_batch([9000], vecs[:1])) == 1

    def test_load_onto_different_mesh_size(self, mesh, tmp_path):
        rng = np.random.default_rng(22)
        n, dim = 300, 16
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=512)
        db.add_batch(np.arange(n), vecs)
        db.save(str(tmp_path / "sdb4"))
        mesh4 = sh.make_mesh(4)  # reshard 8 -> 4 devices
        db2 = sh.ShardedDatabase.load(mesh4, str(tmp_path / "sdb4"))
        assert db2.n_shards == 4 and db2.size() == n
        ext, _ = db2.search(vecs[:8], 1)
        np.testing.assert_array_equal(ext[:, 0], np.arange(8))

    def test_missing_checkpoint_raises(self, mesh, tmp_path):
        with pytest.raises(FileNotFoundError):
            sh.ShardedDatabase.load(mesh, str(tmp_path / "nope"))

    def test_bulk_ingest_is_vectorized_and_balanced(self, mesh):
        import time

        rng = np.random.default_rng(23)
        n, dim = 100_000, 16
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n)
        t0 = time.time()
        acc = db.add_batch(np.arange(n), vecs)
        dt = time.time() - t0
        assert len(acc) == n
        # host time scales ~linearly: 100k well under 1s => 1M < 5s
        # (VERDICT #3 target); the old per-row loop took ~30s at 100k
        assert dt < 3.0, f"bulk ingest too slow: {dt:.1f}s at 100k"
        # shards stay balanced (water filling)
        loads = db._fill - np.asarray([len(f) for f in db._free])
        assert loads.max() - loads.min() <= 1

    def test_bulk_ingest_partial_capacity(self, mesh):
        # per-shard capacity is 128-rounded (lane-aligned shards), so the
        # smallest 8-shard capacity is 1024; the bound still rejects excess
        rng = np.random.default_rng(24)
        vecs = rng.standard_normal((1200, 16)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=16, capacity=1024)
        assert db.capacity == 1024
        acc = db.add_batch(np.arange(1200), vecs)
        assert len(acc) == 1024  # capacity-bounded, like the loop version
        assert db.size() == 1024


class TestMultiprocessExample:
    def test_single_process_fallback_runs(self, mesh):
        """examples/multiprocess_dcn.py drives the same shard_map programs a
        multi-process deployment would (docs/SCALING.md §3); the no-arg
        fallback must run on the virtual 8-device mesh and agree with a
        local brute-force check on shard 0's rows."""
        import importlib.util
        spec = importlib.util.spec_from_file_location(
            "mp_example", "examples/multiprocess_dcn.py")
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        d, idx = mod.main(["--per-shard", "256", "--dim", "16"])
        assert d.shape == (64, 10) and (idx >= 0).all()
        assert (d[:, :-1] <= d[:, 1:] + 1e-6).all()


class TestShardedCompressedTier:
    """raw_store=False on the multi-chip tier: int8-packed shards (4x less
    HBM per chip AND per host mirror), near-exact int8 scan, flagship with
    int8 refine, persistence — the docs/SCALING.md '~80M per 8-chip slice'
    stack through the API."""

    def _gt(self, vecs, q, k=10):
        d = ((q**2).sum(1)[:, None] + (vecs**2).sum(1)[None, :]
             - 2.0 * q @ vecs.T)
        return np.argsort(d, 1)[:, :k]

    def test_int8_scan_near_exact(self, mesh):
        rng = np.random.default_rng(31)
        n, dim = 2048, 64
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=False)
        db.add_batch(np.arange(n), vecs)
        q = rng.standard_normal((64, dim)).astype(np.float32)
        ext, d = db.search(q, 10)
        gt = self._gt(vecs, q)
        rec = np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist())) / 10
                       for i in range(64)])
        assert rec >= 0.97
        assert (d[:, :-1] <= d[:, 1:] + 1e-5).all()

    def test_flagship_int8_refine(self, mesh):
        rng = np.random.default_rng(32)
        n, dim = 2048, 64
        scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
        vecs = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n + 64,
                                num_subspaces=16, raw_store=False)
        db.add_batch(np.arange(n), vecs)
        db.train_pq(num_centroids=64, iters=8)
        q = (rng.standard_normal((64, dim)) * scale).astype(np.float32)
        ext, _ = db.search_flagship(q, 10, refine=128)
        gt = self._gt(vecs, q)
        rec = np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist())) / 10
                       for i in range(64)])
        assert rec >= 0.9
        # incremental adds encode through the dequantized-row seam
        more = (rng.standard_normal((8, dim)) * scale).astype(np.float32) + 2.0
        db.add_batch(np.arange(5000, 5008), more)
        ext2, _ = db.search_flagship(more, 1, refine=128)
        np.testing.assert_array_equal(ext2[:, 0], np.arange(5000, 5008))

    def test_compressed_save_load(self, mesh, tmp_path):
        rng = np.random.default_rng(33)
        n, dim = 1024, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n,
                                num_subspaces=8, raw_store=False)
        db.add_batch(np.arange(n), vecs)
        db.train_pq(num_centroids=32, iters=5)
        q = rng.standard_normal((16, dim)).astype(np.float32)
        before = db.search(q, 5)
        flag_before = db.search_flagship(q, 5, refine=64)
        db.save(str(tmp_path / "c8"))
        db2 = sh.ShardedDatabase.load(mesh, str(tmp_path / "c8"))
        assert not db2.raw
        after = db2.search(q, 5)
        np.testing.assert_array_equal(before[0], after[0])
        np.testing.assert_allclose(before[1], after[1], rtol=1e-5, atol=1e-5)
        flag_after = db2.search_flagship(q, 5, refine=64)
        np.testing.assert_array_equal(flag_before[0], flag_after[0])

    def test_pca_unfitted_guarded(self, mesh):
        """search_pca without a basis raises cleanly (fit_pca itself now
        WORKS on the compressed tier — TestShardedCompressedPca — fitting
        on dequantized rows)."""
        db = sh.ShardedDatabase(mesh, dim=32, capacity=256, raw_store=False)
        db.add_batch(np.arange(64),
                     np.random.default_rng(0).standard_normal(
                         (64, 32)).astype(np.float32))
        with pytest.raises(ValueError, match="fit_pca"):
            db.search_pca(np.zeros((1, 32), np.float32), 1)

    def test_fused_scan(self, mesh):
        """search_fused: the per-device packed pool scan + int8 refine +
        cross-device merge (multi-device scan_pallas_int8)."""
        rng = np.random.default_rng(34)
        n, dim = 2048, 64
        vecs = (rng.standard_normal((n, dim)) + 2.0).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=False)
        db.add_batch(np.arange(n), vecs)
        q = (rng.standard_normal((32, dim)) + 2.0).astype(np.float32)
        ext, d = db.search_fused(q, 10)
        gt = self._gt(vecs, q)
        rec = np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist())) / 10
                       for i in range(32)])
        assert rec >= 0.95, rec
        assert (d[:, :-1] <= d[:, 1:] + 1e-5).all()
        # mutation invalidates the conditioning cache (identity-keyed)
        db.remove(0)
        ext2, _ = db.search_fused(vecs[:1], 1)
        assert ext2[0, 0] != 0

    def test_fused_scan_cosine(self, mesh):
        rng = np.random.default_rng(37)
        n, dim = 2048, 64
        vecs = (rng.standard_normal((n, dim)) + 3.0).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, metric="cosine",
                                raw_store=False)
        db.add_batch(np.arange(n), vecs)
        q = (rng.standard_normal((16, dim)) + 3.0).astype(np.float32)
        ext, _ = db.search_fused(q, 10)
        vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        gt = np.argsort(1.0 - qn @ vn.T, 1)[:, :10]
        rec = np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist())) / 10
                       for i in range(16)])
        assert rec >= 0.9, rec

    def test_search_auto_routes_to_fused(self, mesh):
        """search() crosses over to the fused kernel above the per-shard
        threshold (the sharded analog of single-chip auto)."""
        rng = np.random.default_rng(36)
        n, dim = 1024, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=False)
        db.add_batch(np.arange(n), vecs)
        db.fused_threshold = 1  # force the crossover at test scale
        calls = []
        orig = db._search_fused_impl
        db._search_fused_impl = (
            lambda q, k, **kw: (calls.append(1), orig(q, k))[1])
        ext, _ = db.search(vecs[:4], 1)
        assert calls, "search() did not route to search_fused"
        assert (ext[:, 0] == np.arange(4)).all()

    def test_fused_scan_raw_tier(self, mesh):
        """search_fused on the RAW tier: int8 shadow scan + exact f32
        refine per shard (sharded_fused_raw8)."""
        rng = np.random.default_rng(35)
        n, dim = 2048, 64
        vecs = (rng.standard_normal((n, dim)) + 2.0).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n)
        db.add_batch(np.arange(n), vecs)
        q = (rng.standard_normal((32, dim)) + 2.0).astype(np.float32)
        ext, d = db.search_fused(q, 10)
        gt = self._gt(vecs, q)
        rec = np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist())) / 10
                       for i in range(32)])
        # exact f32 refine: raw-tier fused recall must be near-perfect
        assert rec >= 0.97, rec
        assert (d[:, :-1] <= d[:, 1:] + 1e-5).all()

    def test_fused_scan_raw_tier_int8g(self, mesh):
        """search_fused with int8_epilogue="global": per-shard global-scale
        shadows + the integer-epilogue kernel (sharded_fused_raw8g — the
        multi-chip HnswPqConfig.int8_epilogue analog, r5)."""
        rng = np.random.default_rng(35)
        n, dim = 2048, 64
        vecs = (rng.standard_normal((n, dim)) + 2.0).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n,
                                int8_epilogue="global")
        db.add_batch(np.arange(n), vecs)
        q = (rng.standard_normal((32, dim)) + 2.0).astype(np.float32)
        ext, d = db.search_fused(q, 10)
        gt = self._gt(vecs, q)
        rec = np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist())) / 10
                       for i in range(32)])
        assert rec >= 0.97, rec
        assert (d[:, :-1] <= d[:, 1:] + 1e-5).all()
        # mutation invalidates the conditioning cache; the refreshed
        # shadow must not resurface removed rows
        db.remove(0)
        ext2, _ = db.search_fused(vecs[:1], 1)
        assert ext2[0, 0] != 0

    def test_fused_scan_raw_tier_int8g_cosine(self, mesh):
        rng = np.random.default_rng(38)
        n, dim = 2048, 64
        vecs = (rng.standard_normal((n, dim)) + 3.0).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, metric="cosine",
                                int8_epilogue="global")
        db.add_batch(np.arange(n), vecs)
        q = (rng.standard_normal((16, dim)) + 3.0).astype(np.float32)
        ext, _ = db.search_fused(q, 10)
        vn = vecs / np.linalg.norm(vecs, axis=1, keepdims=True)
        qn = q / np.linalg.norm(q, axis=1, keepdims=True)
        gt = np.argsort(1.0 - qn @ vn.T, 1)[:, :10]
        rec = np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist())) / 10
                       for i in range(16)])
        assert rec >= 0.9, rec

    def test_int8_epilogue_validated(self, mesh):
        with pytest.raises(ValueError, match="int8_epilogue"):
            sh.ShardedDatabase(mesh, dim=32, capacity=256,
                               int8_epilogue="bogus")


class TestShardedResidualRefine:
    """refine_residual=True on the multi-chip compressed tier: second-level
    int8 residual shards make every int8 refine effectively exact (~16-bit
    precision; the multi-chip HnswPqConfig.refine_residual analog)."""

    def _gt(self, vecs, q, k=10):
        d = ((q**2).sum(1)[:, None] + (vecs**2).sum(1)[None, :]
             - 2.0 * q @ vecs.T)
        return np.argsort(d, 1)[:, :k]

    def _rec(self, ext, gt):
        return np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist()))
                        / gt.shape[1] for i in range(len(gt))])

    def test_raw_tier_rejects_residual(self, mesh):
        with pytest.raises(ValueError, match="refine_residual"):
            sh.ShardedDatabase(mesh, dim=32, capacity=256,
                               refine_residual=True)

    def test_fused_residual_beats_single_level(self, mesh):
        rng = np.random.default_rng(41)
        n, dim = 2048, 64
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        q = vecs[:48] + 0.02 * rng.standard_normal((48, dim)).astype(
            np.float32)
        gt = self._gt(vecs, q)
        recs = {}
        for res in (False, True):
            db = sh.ShardedDatabase(mesh, dim=dim, capacity=n,
                                    raw_store=False, refine_residual=res)
            db.add_batch(np.arange(n), vecs)
            ext, d = db.search_fused(q, 10)
            recs[res] = self._rec(ext, gt)
            assert (d[:, :-1] <= d[:, 1:] + 1e-5).all()
        assert recs[True] >= recs[False] - 1e-9, recs
        assert recs[True] >= 0.99, recs

    def test_flagship_residual(self, mesh):
        rng = np.random.default_rng(42)
        n, dim = 2048, 64
        scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
        vecs = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n + 64,
                                num_subspaces=16, raw_store=False,
                                refine_residual=True)
        db.add_batch(np.arange(n), vecs)
        db.train_pq(num_centroids=64, iters=8)
        q = (rng.standard_normal((48, dim)) * scale).astype(np.float32)
        ext, _ = db.search_flagship(q, 10, refine=256)
        assert self._rec(ext, self._gt(vecs, q)) >= 0.9

    def test_residual_save_load_bit_exact(self, mesh, tmp_path):
        rng = np.random.default_rng(43)
        n, dim = 1024, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n,
                                raw_store=False, refine_residual=True)
        db.add_batch(np.arange(n), vecs)
        q = rng.standard_normal((16, dim)).astype(np.float32)
        e1, d1 = db.search_fused(q, 10)
        path = str(tmp_path / "resid_ck")
        db.save(path)
        db2 = sh.ShardedDatabase.load(mesh, path)
        assert db2.residual
        # both packed levels restore verbatim -> identical results
        e2, d2 = db2.search_fused(q, 10)
        np.testing.assert_array_equal(e1, e2)
        np.testing.assert_allclose(d1, d2, rtol=1e-6, atol=1e-6)
        # churn after reload keeps the residual mirror consistent
        assert db2.remove(0)
        newv = rng.standard_normal((1, dim)).astype(np.float32)
        assert db2.add_batch(np.asarray([5000]), newv) == [5000]
        ext, _ = db2.search_fused(newv, 1)
        assert ext[0, 0] == 5000


class TestShardedCompressedPca:
    """search_pca on the compressed tier: proxy derived from dequantized
    int8 shards, refine against packed rows with exact norms — the
    multi-chip analog of the single-chip compressed `pca` mode."""

    def _gt(self, vecs, q, k=10):
        d = ((q**2).sum(1)[:, None] + (vecs**2).sum(1)[None, :]
             - 2.0 * q @ vecs.T)
        return np.argsort(d, 1)[:, :k]

    @pytest.mark.parametrize("residual", [False, True])
    def test_compressed_pca_recall(self, mesh, residual):
        rng = np.random.default_rng(51)
        n, dim = 2048, 64
        scale = ((np.arange(dim) + 1.0) ** -0.5).astype(np.float32)
        vecs = (rng.standard_normal((n, dim)) * scale).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=False,
                                refine_residual=residual)
        db.add_batch(np.arange(n), vecs)
        db.fit_pca(p=16)
        q = (rng.standard_normal((48, dim)) * scale).astype(np.float32)
        ext, d = db.search_pca(q, 10, select_r=256)
        gt = self._gt(vecs, q)
        rec = np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist())) / 10
                       for i in range(48)])
        assert rec >= 0.9, rec
        assert (d[:, :-1] <= d[:, 1:] + 1e-5).all()

    def test_proxy_tracks_mutations(self, mesh):
        rng = np.random.default_rng(52)
        n, dim = 1024, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n + 128,
                                raw_store=False)
        db.add_batch(np.arange(n), vecs)
        db.fit_pca(p=16)
        db.search_pca(vecs[:4], 1)  # derive + cache the proxy
        newv = rng.standard_normal((4, dim)).astype(np.float32) + 3.0
        db.add_batch(np.arange(9000, 9004), newv)
        ext, _ = db.search_pca(newv, 1, select_r=128)
        assert ext[:, 0].tolist() == [9000, 9001, 9002, 9003]

    def test_exact_scan_residual_oracle_exact(self, mesh):
        """search() on the residual compressed tier scans BOTH int8 levels
        — exhaustive and effectively exact (matches the f32 oracle)."""
        rng = np.random.default_rng(53)
        n, dim = 1024, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=False,
                                refine_residual=True)
        db.add_batch(np.arange(n), vecs)
        q = vecs[:32] + 0.02 * rng.standard_normal((32, dim)).astype(
            np.float32)
        ext, _ = db.search(q, 10)
        gt = self._gt(vecs, q)
        rec = np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist())) / 10
                       for i in range(32)])
        assert rec == 1.0, rec


class TestShardedConcurrency:
    """Facade RWLock on the multi-chip tier: concurrent searches are
    consistent, and searches interleaved with adds neither crash nor see
    mixed-generation shard pieces."""

    def test_concurrent_search_and_add(self, mesh):
        import concurrent.futures

        rng = np.random.default_rng(61)
        n, dim = 512, 32
        vecs = rng.standard_normal((n + 64, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n + 128,
                                raw_store=False, refine_residual=True)
        db.add_batch(np.arange(n), vecs[:n])
        db.search(vecs[:4], 3)  # warm

        def searcher(_):
            ext, d = db.search(vecs[:4], 3)
            return (ext[:, 0] == np.arange(4)).all() and bool(
                (d[:, :-1] <= d[:, 1:] + 1e-5).all())

        def mutator(i):
            return db.add_batch(np.asarray([n + i]),
                                vecs[n + i:n + i + 1]) == [n + i]

        with concurrent.futures.ThreadPoolExecutor(max_workers=4) as ex:
            futs = [ex.submit(searcher, i) if i % 2 else ex.submit(mutator, i)
                    for i in range(32)]
            assert all(f.result() for f in futs)
        added = n + np.arange(0, 32, 2)
        ext, _ = db.search(vecs[added], 1)
        assert (ext[:, 0] == added).all()


class TestDevicePayload:
    """host_mirror=False (VERDICT r3 #4): the big row payloads live ONLY as
    per-shard device pieces — no full-capacity host numpy arrays — with
    streamed ingest, in-place scatter mutation, and O(shard) save/load."""

    def _gt(self, vecs, q, k=10):
        d = ((q[:, None, :] - vecs[None, :, :]) ** 2).sum(-1)
        return np.argsort(d, axis=1)[:, :k]

    def test_no_host_payload_arrays(self, mesh):
        db = sh.ShardedDatabase(mesh, dim=32, capacity=1024,
                                raw_store=False, host_mirror=False)
        assert not hasattr(db, "_h_packed")
        assert not hasattr(db, "_h_vec")
        assert "packed" in db._dev_pieces

    def test_crud_and_search_parity(self, mesh):
        rng = np.random.default_rng(71)
        n, dim = 1024, 32
        vecs = (rng.standard_normal((n, dim)) + 1.0).astype(np.float32)
        q = vecs[:16] + 0.01 * rng.standard_normal((16, dim)).astype(
            np.float32)
        ha, hb = {}, {}
        for hm in (True, False):
            db = sh.ShardedDatabase(mesh, dim=dim, capacity=n,
                                    raw_store=False, host_mirror=hm)
            db.add_batch(np.arange(n), vecs)
            ext, d = db.search(q, 10)
            (ha if hm else hb)["r"] = (np.asarray(ext), np.asarray(d))
            db.remove(3)
            ext2, _ = db.search(vecs[3:4], 1)
            assert ext2[0, 0] != 3
        np.testing.assert_array_equal(ha["r"][0], hb["r"][0])
        np.testing.assert_allclose(ha["r"][1], hb["r"][1], rtol=1e-5)

    def test_raw_device_mode(self, mesh):
        rng = np.random.default_rng(72)
        n, dim = 512, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=True,
                                host_mirror=False)
        assert not hasattr(db, "_h_vec")
        db.add_batch(np.arange(n), vecs)
        q = vecs[:8]
        ext, _ = db.search(q, 10)
        gt = self._gt(vecs, q)
        rec = np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist())) / 10
                       for i in range(8)])
        assert rec == 1.0, rec
        # overwrite via slot reuse keeps pieces current
        db.remove(0)
        db.add_batch([5000], vecs[:1] * 2.0)
        ext2, _ = db.search(vecs[:1] * 2.0, 1)
        assert ext2[0, 0] == 5000

    def test_stream_ingest(self, mesh):
        rng = np.random.default_rng(73)
        n, dim = 2048, 32
        vecs = (rng.standard_normal((n, dim)) + 0.5).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=False,
                                num_subspaces=8, host_mirror=False)
        chunks = ((np.arange(s, s + 256), vecs[s:s + 256])
                  for s in range(0, n, 256))
        total = db.bulk_load_stream(chunks, num_centroids=16)
        assert total == n
        assert db.codebooks is not None  # first chunk trained
        assert db._h_codes[: n].any()    # encoded chunk by chunk
        q = vecs[:16]
        ext, _ = db.search(q, 10)
        gt = self._gt(vecs, q)
        rec = np.mean([len(set(ext[i].tolist()) & set(gt[i].tolist())) / 10
                       for i in range(16)])
        assert rec >= 0.95, rec

    def test_stream_requires_empty(self, mesh):
        db = sh.ShardedDatabase(mesh, dim=32, capacity=256,
                                raw_store=False, host_mirror=False)
        db.add_batch([1], np.ones((1, 32), np.float32))
        with pytest.raises(ValueError):
            db.bulk_load_stream([(np.asarray([2]),
                                  np.ones((1, 32), np.float32))])

    def test_save_load_roundtrip(self, mesh, tmp_path):
        rng = np.random.default_rng(74)
        n, dim = 1024, 32
        vecs = (rng.standard_normal((n, dim)) + 1.0).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=False,
                                refine_residual=True, num_subspaces=8,
                                host_mirror=False)
        db.bulk_load_stream([(np.arange(n), vecs)], num_centroids=16)
        q = vecs[:16]
        ext0, d0 = db.search(q, 10)
        path = str(tmp_path / "devckpt")
        db.save(path)
        for hm in (False, True):
            db2 = sh.ShardedDatabase.load(mesh, path, host_mirror=hm)
            ext1, d1 = db2.search(q, 10)
            np.testing.assert_array_equal(np.asarray(ext0),
                                          np.asarray(ext1))
            np.testing.assert_allclose(np.asarray(d0), np.asarray(d1),
                                       rtol=1e-5)

    def test_dense_checkpoint_into_device_mode(self, mesh, tmp_path):
        """Old-format (host-mirror) checkpoints restore into a
        host_mirror=False database."""
        rng = np.random.default_rng(75)
        n, dim = 512, 32
        vecs = (rng.standard_normal((n, dim)) + 1.0).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=False)
        db.add_batch(np.arange(n), vecs)
        path = str(tmp_path / "densckpt")
        db.save(path)
        db2 = sh.ShardedDatabase.load(mesh, path, host_mirror=False)
        assert not hasattr(db2, "_h_packed")
        ext0, _ = db.search(vecs[:8], 5)
        ext1, _ = db2.search(vecs[:8], 5)
        np.testing.assert_array_equal(np.asarray(ext0), np.asarray(ext1))

    def test_fit_pca_device_mode(self, mesh):
        rng = np.random.default_rng(76)
        n, dim = 512, 32
        vecs = (rng.standard_normal((n, dim)) *
                ((np.arange(dim) + 1.0) ** -0.5)).astype(np.float32)
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=False,
                                num_subspaces=8, host_mirror=False)
        db.bulk_load_stream([(np.arange(n), vecs)], num_centroids=16)
        db.fit_pca(p=8)
        ext, _ = db.search_pca(vecs[:8], 5)
        assert (np.asarray(ext)[:, 0] == np.arange(8)).all()
