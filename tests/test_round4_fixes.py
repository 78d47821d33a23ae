"""Round-4 fixes: pool widths that the packed pool scan keeps unchanged
(it never pad-copies the packed store), the empty-dirty-record guard, and
the LSH percentile docstring alignment."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vector_db_tpu.ops.pool_scan import LANES, preserved_pool_width


class TestPreservedPoolWidth:
    def test_invariants_sweep(self):
        """Every returned width is the largest LANES multiple <= 2048 that
        divides n — the contract packed_pool_scan enforces before refusing
        to pad-copy the store."""
        for mult in range(1, 200):
            n = mult * LANES
            w = preserved_pool_width(n)
            assert n % w == 0, (n, w)
            assert w <= 2048 and w % LANES == 0, (n, w)
            assert not any(n % v == 0
                           for v in range(w + LANES, min(n, 2048) + 1, LANES))

    def test_advisor_cases(self):
        # per_shard=1920 (capacity 15360 / 8 shards): the pool scan takes
        # any LANES multiple, so the whole shard is one pass
        assert preserved_pool_width(1920) == 1920
        # legacy 128-rounded checkpoint capacity 3200 = 25 * 128: 640
        assert preserved_pool_width(3200) == 640
        # modern 2048-rounded stores keep the full 2048 width
        assert preserved_pool_width(2048) == 2048
        assert preserved_pool_width(1 << 20) == 2048

    def test_rejects_unaligned(self):
        with pytest.raises(ValueError):
            preserved_pool_width(1000)

    @pytest.mark.parametrize("n", [1920, 3200])
    def test_legacy_capacity_scan(self, n):
        """The exact _emit path a legacy 128-rounded compressed checkpoint
        rides (index/hnsw_pq.py scan_pallas_int8): shadow build + packed
        pool scan + int8 refine must run (a width that does not divide the
        rows raises ValueError inside packed_pool_scan) and find the true
        NN."""
        from vector_db_tpu.index.hnsw_pq import (_build_scan8p_shadow,
                                                 pallas_scan8p_refine)
        from vector_db_tpu.ops.distance import pack_int8_rows

        rng = np.random.default_rng(7)
        dim = 64
        vecs = (rng.standard_normal((n, dim)) + 1.0).astype(np.float32)
        packed, scales = pack_int8_rows(jnp.asarray(vecs))
        norms = jnp.sum(jnp.asarray(vecs) ** 2, axis=1)
        valid = jnp.ones((n,), bool)
        ids = jnp.arange(n, dtype=jnp.int32)
        off, sc, cvec = _build_scan8p_shadow(packed, scales, norms, valid,
                                             "l2")
        q = vecs[:4] + 0.01 * rng.standard_normal((4, dim)).astype(np.float32)
        w = preserved_pool_width(n)
        d, ext = pallas_scan8p_refine(jnp.asarray(q), packed, scales, norms,
                                      off, sc, cvec, ids, k=8, metric="l2",
                                      pool=64, w=w)
        ext = np.asarray(ext)
        assert (ext[np.arange(4), 0] == np.arange(4)).all(), ext[:, 0]


class TestShardedFusedWidth:
    def test_per_shard_1920_search_fused(self):
        """The advisor's exact repro: ShardedDatabase(capacity=15360,
        raw_store=False).search_fused used to raise ValueError (per_shard
        =1920, kernel width rounded 1920->2048)."""
        from vector_db_tpu.parallel import sharded as sh

        assert len(jax.devices()) >= 8
        mesh = sh.make_mesh(8)
        rng = np.random.default_rng(11)
        n, dim = 15360, 64
        db = sh.ShardedDatabase(mesh, dim=dim, capacity=n, raw_store=False)
        assert db.per_shard == 1920
        vecs = (rng.standard_normal((4096, dim)) + 1.0).astype(np.float32)
        db.add_batch(np.arange(4096), vecs)
        q = vecs[:8] + 0.01 * rng.standard_normal((8, dim)).astype(np.float32)
        ext, d = db.search_fused(q, 5)
        hits = np.mean([int(ext[i, 0] == i) for i in range(8)])
        assert hits >= 0.9, (hits, ext[:, 0])


class TestTakeDirtyGuard:
    def test_all_empty_records(self):
        """A dirty record holding only empty arrays must yield None, not
        IndexError (advisor r3 low)."""
        from vector_db_tpu.index.hnsw_pq import HnswPqConfig, HnswPqIndex

        idx = HnswPqIndex(dim=32, capacity=256, config=HnswPqConfig())
        attr = idx._DIRTY_RECORDS[0]
        setattr(idx, attr, [np.zeros(0, np.int64), np.zeros(0, np.int64)])
        assert idx._take_dirty(attr) is None


class TestDeferInsertPolicy:
    """VERDICT r3 #3: incremental graph adds ride a pending buffer + exact
    overlay, flushed in bulk by exact-kNN delta insertion — not per-round
    beam descents."""

    def _cfg(self, **kw):
        from vector_db_tpu.api.config import HnswConfig

        return HnswConfig(m=8, ef_construction=64, **kw)

    def test_pending_visible_before_flush(self):
        from vector_db_tpu.index.hnsw import HnswIndex

        rng = np.random.default_rng(3)
        idx = HnswIndex(16, 2048, "l2", self._cfg(flush_min=4096))
        vecs = rng.standard_normal((600, 16)).astype(np.float32)
        # seed a connected graph, then defer the rest
        idx.add_batch(range(300), vecs[:300])
        idx.flush_pending()
        idx.add_batch(range(300, 600), vecs[300:])
        assert idx.stats()["pending_inserts"] == 300
        # pending rows must be searchable through the overlay
        ids, _ = idx.search_batch(vecs[450:460], 1)
        assert (ids[:, 0] == np.arange(450, 460)).all()

    def test_flush_threshold_triggers(self):
        from vector_db_tpu.index.hnsw import HnswIndex

        rng = np.random.default_rng(4)
        idx = HnswIndex(16, 1024, "l2", self._cfg(flush_min=64))
        vecs = rng.standard_normal((512, 16)).astype(np.float32)
        for s in range(0, 512, 32):
            idx.add_batch(range(s, s + 32), vecs[s:s + 32])
        # threshold starts at 64 and grows with the graph -> several
        # flushes happened; everything is either connected or pending
        pending = idx.stats()["pending_inserts"]
        connected = int((np.asarray(idx.graph.levels) >= 0).sum())
        assert connected + pending == 512
        assert connected >= 384 and pending < 128

    def test_incremental_recall_matches_rebuild(self):
        from vector_db_tpu.index.hnsw import HnswIndex

        rng = np.random.default_rng(5)
        n, dim = 2048, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        q = vecs[:64] + 0.05 * rng.standard_normal((64, dim)).astype(
            np.float32)
        gt = np.argsort(((q[:, None, :] - vecs[None, :, :]) ** 2).sum(-1),
                        1)[:, :10]

        inc = HnswIndex(dim, n, "l2", self._cfg(flush_min=256))
        for s in range(0, n, 128):
            inc.add_batch(range(s, s + 128), vecs[s:s + 128])
        reb = HnswIndex(dim, n, "l2", self._cfg())
        reb.add_batch(range(n), vecs)
        reb.build()

        def recall(idx):
            ids, _ = idx.search_batch(q, 10)
            return np.mean([len(set(ids[i].tolist()) & set(gt[i].tolist()))
                            / 10 for i in range(64)])

        r_inc, r_reb = recall(inc), recall(reb)
        assert r_inc >= r_reb - 0.01, (r_inc, r_reb)

    def test_remove_pending(self):
        from vector_db_tpu.index.hnsw import HnswIndex

        rng = np.random.default_rng(6)
        idx = HnswIndex(16, 512, "l2", self._cfg(flush_min=4096))
        vecs = rng.standard_normal((300, 16)).astype(np.float32)
        idx.add_batch(range(200), vecs[:200])
        idx.flush_pending()
        idx.add_batch(range(200, 300), vecs[200:])
        assert idx.remove(250)
        assert idx.stats()["pending_inserts"] == 99
        ids, _ = idx.search(vecs[250], 1)
        assert ids[0] != 250

    def test_checkpoint_flushes(self):
        from vector_db_tpu.index.hnsw import HnswIndex

        rng = np.random.default_rng(8)
        idx = HnswIndex(16, 512, "l2", self._cfg(flush_min=4096))
        vecs = rng.standard_normal((300, 16)).astype(np.float32)
        idx.add_batch(range(300), vecs)
        arrays = idx.state_arrays()
        assert idx.stats()["pending_inserts"] == 0
        idx2 = HnswIndex(16, 512, "l2", self._cfg())
        idx2.load_state_arrays(arrays)
        ids, _ = idx2.search_batch(vecs[:16], 1)
        assert (ids[:, 0] == np.arange(16)).mean() >= 0.9

    def test_stream_policy_unchanged(self):
        from vector_db_tpu.index.hnsw import HnswIndex

        rng = np.random.default_rng(9)
        idx = HnswIndex(16, 512, "l2",
                        self._cfg(insert_policy="stream"))
        vecs = rng.standard_normal((200, 16)).astype(np.float32)
        idx.add_batch(range(200), vecs)
        assert idx.stats()["pending_inserts"] == 0
        assert (np.asarray(idx.graph.levels) >= 0).sum() == 200

    def test_hnswpq_graph_defer(self):
        from vector_db_tpu.api.config import HnswPqConfig
        from vector_db_tpu.index.hnsw_pq import HnswPqIndex

        rng = np.random.default_rng(10)
        n, dim = 1024, 32
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        cfg = HnswPqConfig(num_subspaces=8, training_samples=512,
                           use_graph=True, search_mode="graph",
                           flush_min=4096, m=8)
        idx = HnswPqIndex(dim, n, "l2", cfg)
        idx.add_batch(range(512), vecs[:512])   # triggers train + build
        assert idx.trained
        idx.add_batch(range(512, n), vecs[512:])
        assert idx.stats()["pending_inserts"] == 512
        # pending rows reachable through the refine-pool overlay
        ids, _ = idx.search_batch(vecs[700:710], 1)
        assert (ids[:, 0] == np.arange(700, 710)).mean() >= 0.9
        idx.flush_pending()
        assert idx.stats()["pending_inserts"] == 0
        ids, _ = idx.search_batch(vecs[700:710], 1)
        assert (ids[:, 0] == np.arange(700, 710)).mean() >= 0.9


class TestLshPercentileDoc:
    def test_docstring_matches_code(self):
        """The docstring and the implementation must agree on the
        percentile (advisor r3 low: one said 65th, code used 75)."""
        import inspect

        from vector_db_tpu.index.lsh import LshIndex

        src = inspect.getsource(LshIndex._auto_radius)
        doc = LshIndex._auto_radius.__doc__
        assert "75.0" in src
        assert "75th" in doc and "65th" not in doc


class TestLshAutoTables:
    """Round-4 (VERDICT #8): num_tables=0 (new default) calibrates the
    table count jointly with the radius from a 32-table pool, under an
    empirical <=35% random-collision mass budget.  Measured honest R@10
    (CPU, isotropic): 128d x 10k 75.5% -> 92.3%, 512d x 20k 54.2% -> 71.1%
    vs the static 10-table default."""

    def _corpus(self, rng, n, dim):
        return rng.standard_normal((n, dim)).astype(np.float32)

    def test_calibration_truncates_pool_and_persists(self, rng):
        from vector_db_tpu.api.config import LshConfig
        from vector_db_tpu.index.lsh import _AUTO_TABLE_POOL, LshIndex

        n, dim = 2048, 64
        vecs = self._corpus(rng, n, dim)
        idx = LshIndex(dim, n, config=LshConfig(backfill=False))
        assert idx.stats()["num_tables"] == _AUTO_TABLE_POOL  # pool pre-cal
        idx.add_batch(range(n), vecs)
        idx.build()
        q = self._corpus(rng, 32, dim)
        idx.search_batch(q, 5)  # triggers joint calibration
        s = idx.stats()
        assert 2 <= s["num_tables"] <= _AUTO_TABLE_POOL
        assert idx.planes.shape[0] == s["num_tables"]
        assert idx.bucket_ids.shape[0] == s["num_tables"]
        assert s["hamming_radius"] >= 1
        # both the table choice and the radius ride through checkpoints
        idx2 = LshIndex(dim, n, config=LshConfig(backfill=False))
        idx2.load_state_arrays(idx.state_arrays())
        assert idx2._tables == s["num_tables"] and idx2._tables_final
        ids1, _ = idx.search_batch(q, 5)
        ids2, _ = idx2.search_batch(q, 5)
        np.testing.assert_array_equal(ids1, ids2)

    def test_build_recalibrates(self, rng):
        from vector_db_tpu.api.config import LshConfig
        from vector_db_tpu.index.lsh import _AUTO_TABLE_POOL, LshIndex

        n, dim = 1024, 32
        idx = LshIndex(dim, n, config=LshConfig(backfill=False))
        idx.add_batch(range(n), self._corpus(rng, n, dim))
        idx.build()
        idx.search_batch(self._corpus(rng, 8, dim), 3)
        assert idx._tables_final
        idx.build()  # regenerates the full pool, re-arms calibration
        assert not idx._tables_final
        assert idx.planes.shape[0] == _AUTO_TABLE_POOL
        idx.search_batch(self._corpus(rng, 8, dim), 3)
        assert idx._tables_final

    def test_explicit_tables_stay_fixed(self, rng):
        from vector_db_tpu.api.config import LshConfig
        from vector_db_tpu.index.lsh import LshIndex

        n, dim = 1024, 32
        idx = LshIndex(dim, n, config=LshConfig(num_tables=6, backfill=False))
        idx.add_batch(range(n), self._corpus(rng, n, dim))
        idx.build()
        idx.search_batch(self._corpus(rng, 8, dim), 3)
        assert idx.stats()["num_tables"] == 6
        assert idx.planes.shape[0] == 6

    def test_fixed_radius_still_calibrates_tables(self, rng):
        from vector_db_tpu.api.config import LshConfig
        from vector_db_tpu.index.lsh import LshIndex

        n, dim = 1024, 32
        idx = LshIndex(dim, n,
                       config=LshConfig(hamming_radius=5, backfill=False))
        assert idx._radius == 5
        idx.add_batch(range(n), self._corpus(rng, n, dim))
        idx.build()
        idx.search_batch(self._corpus(rng, 8, dim), 3)
        assert idx._radius == 5  # radius respected
        assert idx._tables_final  # tables still calibrated

    def test_auto_beats_static_ten_at_high_dim(self, rng):
        """The VERDICT #8 acceptance direction: at high dim the calibrated
        config chooses more tables than the old static 10 and improves
        honest recall (full-scale evidence in BENCH_REPORT §6)."""
        from vector_db_tpu.api.config import LshConfig
        from vector_db_tpu.index.lsh import LshIndex
        from vector_db_tpu.ops.distance import blocked_knn

        n, dim, k = 4096, 256, 10
        vecs = self._corpus(rng, n, dim)
        qs = self._corpus(rng, 64, dim)

        def recall(cfg):
            idx = LshIndex(dim, n, "l2", cfg)
            idx.add_batch(range(n), vecs)
            idx.build()
            ids, _ = idx.search_batch(qs, k)
            st = idx.store.state
            _, ts_ = blocked_knn(jnp.asarray(qs), st.vectors, st.valid, k,
                                 metric="l2", b_norms=st.norms, block_n=4096)
            true_ids = np.asarray(st.ids)[np.asarray(ts_)]
            hits = [len(set(ids[i]) & set(true_ids[i])) / k
                    for i in range(len(qs))]
            return float(np.mean(hits)), idx.stats()["num_tables"]

        r_auto, t_auto = recall(LshConfig(backfill=False))
        r_old, _ = recall(LshConfig(num_tables=10, num_bits=24,
                                    backfill=False))
        assert t_auto > 10
        assert r_auto >= r_old - 0.02  # never meaningfully worse
        assert r_auto >= 0.60  # honest floor at isotropic 256d x 4k


class TestAnnoyDefaultBeam:
    """Round-4 (VERDICT #5): AnnoyConfig documented search_k=0 -> 128 but
    the search path resolved 0 -> 64 — the whole gap between the 80.6%
    BENCH row and the config's tuned numbers.  Measured honest R@10 at the
    reference config (128d x 10k uniform): 86.6% at beam 64 -> 98.3% at
    the fixed default (reference publishes 85% WITH random-fill)."""

    def test_default_beam_is_128(self, rng):
        """Round-5 update: search_k=0 resolves through auto_beam — still
        128 at/below dim 256 (the reference config), 512 above (see
        tests/test_round5_fixes.py::test_auto_beam_widens_at_high_dim)."""
        import inspect

        from vector_db_tpu.index.annoy import AnnoyIndex

        src = inspect.getsource(AnnoyIndex.search_batch)
        assert "search_k or auto_beam" in src
        assert "512 if self.dim > HIGH_DIM_THRESHOLD else 128" in src

    def test_honest_recall_at_scaled_reference_config(self, rng):
        from vector_db_tpu.api.config import AnnoyConfig
        from vector_db_tpu.index.annoy import AnnoyIndex
        from vector_db_tpu.ops.distance import blocked_knn

        n, dim, k = 4096, 128, 10
        vecs = rng.uniform(-1, 1, (n, dim)).astype(np.float32)
        qs = rng.uniform(-1, 1, (32, dim)).astype(np.float32)
        idx = AnnoyIndex(dim, n, "l2", AnnoyConfig(backfill=False))
        idx.add_batch(range(n), vecs)
        idx.build()
        ids, _ = idx.search_batch(qs, k)
        st = idx.store.state
        _, ts_ = blocked_knn(jnp.asarray(qs), st.vectors, st.valid, k,
                             metric="l2", b_norms=st.norms, block_n=4096)
        true_ids = np.asarray(st.ids)[np.asarray(ts_)]
        hits = [len(set(ids[i]) & set(true_ids[i])) / k for i in range(32)]
        assert float(np.mean(hits)) >= 0.90


class TestInt8GlobalEpilogue:
    """Round-4 (VERDICT #2): int8_epilogue="global" routes scan_pallas_int8
    through the integer-epilogue kernel (global-scale shadow, raw-i32
    ranking) with the same pool+exact-refine contract."""

    def _index(self, rng, n=3000, dim=64, metric="l2"):
        from vector_db_tpu.api.config import HnswPqConfig
        from vector_db_tpu.index.hnsw_pq import HnswPqIndex

        cfg = HnswPqConfig(num_subspaces=8, training_samples=512,
                           use_graph=False, search_mode="scan_pallas_int8",
                           int8_epilogue="global")
        idx = HnswPqIndex(dim, n, metric, cfg)
        vecs = rng.standard_normal((n, dim)).astype(np.float32)
        idx.add_batch(range(n), vecs)
        return idx, vecs

    @pytest.mark.parametrize("metric", ["l2", "cosine"])
    def test_recall_vs_brute(self, rng, metric):
        from vector_db_tpu.ops.distance import blocked_knn

        idx, vecs = self._index(rng, metric=metric)
        qs = rng.standard_normal((32, 64)).astype(np.float32)
        ids, _ = idx.search_batch(qs, 10)
        st = idx.store.state
        _, gt = blocked_knn(jnp.asarray(qs), st.vectors, st.valid, 10,
                            metric=metric, b_norms=st.norms, block_n=4096)
        gt_ids = np.asarray(st.ids)[np.asarray(gt)]
        rec = np.mean([len(set(ids[i]) & set(gt_ids[i])) / 10
                       for i in range(32)])
        assert rec >= 0.95, (metric, rec)

    def test_incremental_shadow_after_churn(self, rng):
        """add/remove after the first search must refresh the global
        shadow incrementally (dirty-slot requantize at the CACHED sv) and
        keep results exact for the surviving rows."""
        idx, vecs = self._index(rng)
        qs = vecs[100:108] + 0.01 * rng.standard_normal((8, 64)).astype(np.float32)
        idx.search_batch(qs, 5)  # builds the shadow cache
        assert idx._scan8g_cache is not None
        # churn: remove some hits, add replacements
        for vid in range(100, 104):
            assert idx.remove(vid)
        new = rng.standard_normal((4, 64)).astype(np.float32)
        idx.add_batch(range(5000, 5004), new)
        ids, _ = idx.search_batch(qs[:4], 5)
        flat = set(ids.ravel().tolist())
        assert not ({100, 101, 102, 103} & flat)
        # the new rows are findable through the refreshed shadow
        ids2, _ = idx.search_batch(new, 1)
        assert (ids2[:, 0] == np.arange(5000, 5004)).all()


class TestSlotZeroScatterClobber:
    """Round-4 review finding (CONFIRMED): the forward-edge scatters in
    _delta_level_edges and bulk_build mapped -1 pads to index 0 via
    max(slots, 0); a duplicate-index .at[].set is last-wins, so a padded
    batch containing store slot 0 silently clobbered slot 0's freshly
    computed edges with its stale row.  Fixed with the same
    out-of-bounds-dump (mode="drop") the reverse pass already used."""

    def test_bulk_insert_delta_slot0_keeps_edges(self):
        import vector_db_tpu.ops.hnsw_graph as hg

        n, d, m = 48, 16, 4
        r = np.random.default_rng(0)
        base = jnp.asarray(r.standard_normal((n, d)).astype(np.float32))
        norms = jnp.sum(base * base, axis=1)
        valid = jnp.ones(n, bool)
        g = hg.init_graph(n, m, 4)
        # existing graph over slots 3..47
        old = np.arange(3, n, dtype=np.int32)
        g = hg.bulk_build(g, base, norms, old,
                          np.zeros(old.size, np.int32), m=m)
        # delta batch of 3 (pads to 8 -> five -1 pads) INCLUDING slot 0
        news = np.asarray([0, 1, 2], np.int32)
        g = hg.bulk_insert_delta(g, base, norms, valid, news,
                                 np.zeros(3, np.int32), m=m)
        row0 = np.asarray(g.neighbors[0, 0])
        assert (row0 >= 0).any(), "slot 0 lost its forward edges to pads"
        # and they are sensible: true neighbors of vector 0 among the rest
        full = np.array(
            norms[None, :] + norms[0] - 2.0 * (base @ base[0])[None, :]
        ).ravel()
        full[0] = np.inf
        true10 = set(np.argsort(full)[:10].tolist())
        assert set(row0[row0 >= 0].tolist()) & true10

    def test_bulk_build_slot0_keeps_edges(self):
        import vector_db_tpu.ops.hnsw_graph as hg

        n, d, m = 40, 16, 4  # 40 members -> pads to 64 (24 pads)
        r = np.random.default_rng(1)
        base = jnp.asarray(r.standard_normal((n, d)).astype(np.float32))
        norms = jnp.sum(base * base, axis=1)
        g = hg.init_graph(n, m, 4)
        slots = np.arange(n, dtype=np.int32)  # includes slot 0
        g = hg.bulk_build(g, base, norms, slots,
                          np.zeros(n, np.int32), m=m)
        row0 = np.asarray(g.neighbors[0, 0])
        assert (row0 >= 0).any(), "slot 0 lost its forward edges to pads"
