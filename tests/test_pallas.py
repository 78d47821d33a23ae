"""Pool-scan tests (ops/pool_scan): the plain XLA forms against exact
oracles, the Triton int8 kernel in interpret mode against the plain form,
and the one function that picks the implementation per platform."""

import jax.numpy as jnp
import numpy as np
import pytest

from vector_db_tpu.ops import pool_scan
from vector_db_tpu.ops.pool_scan import (
    int8_pool_scan,
    int8g_pool_scan,
    packed_pool_scan,
    raw_pool_scan,
)


class TestFusedRawPool:
    """raw_pool_scan: bf16 scan + strided-bucket pool (the scan_pallas
    candidate stage; pallas_scan_refine orders it exactly)."""

    def _setup(self, n=3000, d=64, q=16, offset=0.0, seed=3):
        r = np.random.default_rng(seed)
        base = (r.standard_normal((n, d)) + offset).astype(np.float32)
        qs = (r.standard_normal((q, d)) + offset).astype(np.float32)
        return jnp.asarray(qs), jnp.asarray(base)

    def _shadow(self, base, valid, metric="l2"):
        from vector_db_tpu.index.hnsw_pq import _build_scan16_shadow

        norms = jnp.sum(base * base, axis=1)
        return _build_scan16_shadow(base, norms, jnp.asarray(valid),
                                    metric, 1024)[:4]  # drop aux

    @pytest.mark.parametrize("metric", ["l2", "cosine"])
    @pytest.mark.parametrize("offset", [0.0, 10.0])
    def test_pool_contains_topk(self, metric, offset):
        from vector_db_tpu.ops.distance import blocked_knn, normalize_rows
        q, base = self._setup(offset=offset)
        valid = np.ones(base.shape[0], bool)
        base16, off, sc, cvec = self._shadow(base, valid, metric)
        qq = normalize_rows(q) if metric == "cosine" else q
        vals, idx = raw_pool_scan(qq - cvec[None, :], base16, off, sc, 512)
        _, gt_i = blocked_knn(q, base, jnp.asarray(valid), 10,
                              metric=metric, block_n=512)
        got, gt = np.asarray(idx), np.asarray(gt_i)
        rec = np.mean([len(set(got[i]) & set(gt[i])) / 10
                       for i in range(q.shape[0])])
        # one winner per strided bucket: top-10 of 3000 in 512 buckets
        # collides occasionally; containment must stay high
        assert rec >= 0.9, (metric, offset, rec)

    def test_dead_slots_never_returned(self):
        q, base = self._setup()
        valid = np.ones(base.shape[0], bool)
        dead = np.random.default_rng(0).choice(base.shape[0], 500,
                                               replace=False)
        valid[dead] = False
        base16, off, sc, cvec = self._shadow(base, valid)
        _, idx = raw_pool_scan(q - cvec[None, :], base16, off, sc, 512)
        live = np.asarray(idx)
        live = live[live >= 0]
        assert valid[live].all()

    def test_ragged_n_pads_in_shadow(self):
        """n not a multiple of w: the shadow builder pre-pads, pool indices
        stay inside the real corpus."""
        q, base = self._setup(n=1111)
        valid = np.ones(1111, bool)
        base16, off, sc, cvec = self._shadow(base, valid)
        assert base16.shape[0] % 1024 == 0
        vals, idx = raw_pool_scan(q - cvec[None, :], base16, off, sc, 256)
        got = np.asarray(idx)
        assert got.max() < 1111
        # padded tail is +inf off -> never selected as finite
        assert (np.asarray(vals)[got >= 0] < np.inf).all()

    def test_small_batch_single_query(self):
        q, base = self._setup(q=1)
        valid = np.ones(base.shape[0], bool)
        base16, off, sc, cvec = self._shadow(base, valid)
        vals, idx = raw_pool_scan(q - cvec[None, :], base16, off, sc, 256)
        assert idx.shape == (1, 256)
        full = ((np.asarray(q)[:, None] - np.asarray(base)[None]) ** 2).sum(-1)
        best = int(np.argmin(full[0]))
        assert best in set(np.asarray(idx)[0].tolist())


class TestFusedInt8Pool:
    """int8_pool_scan: s8 x s8 -> s32 scan + strided-bucket pool (the
    scan_pallas_int8 candidate stage; pallas_scan8_refine orders it
    exactly).  Same contract as TestFusedRawPool with a quantized shadow."""

    def _setup(self, n=3000, d=64, q=16, offset=0.0, seed=3):
        r = np.random.default_rng(seed)
        base = (r.standard_normal((n, d)) + offset).astype(np.float32)
        qs = (r.standard_normal((q, d)) + offset).astype(np.float32)
        return jnp.asarray(qs), jnp.asarray(base)

    def _shadow(self, base, valid, metric="l2"):
        from vector_db_tpu.index.hnsw_pq import _build_scan8_shadow

        norms = jnp.sum(base * base, axis=1)
        return _build_scan8_shadow(base, norms, jnp.asarray(valid),
                                   metric, 1024)[:4]  # drop aux

    @pytest.mark.parametrize("metric", ["l2", "cosine"])
    @pytest.mark.parametrize("offset", [0.0, 10.0])
    def test_pool_contains_topk(self, metric, offset):
        from vector_db_tpu.ops.distance import blocked_knn, normalize_rows
        q, base = self._setup(offset=offset)
        valid = np.ones(base.shape[0], bool)
        base8, off, sc, cvec = self._shadow(base, valid, metric)
        assert base8.dtype == jnp.int8
        qq = normalize_rows(q) if metric == "cosine" else q
        vals, idx = int8_pool_scan(qq - cvec[None, :], base8, off, sc, 512)
        _, gt_i = blocked_knn(q, base, jnp.asarray(valid), 10,
                              metric=metric, block_n=512)
        got, gt = np.asarray(idx), np.asarray(gt_i)
        rec = np.mean([len(set(got[i]) & set(gt[i])) / 10
                       for i in range(q.shape[0])])
        # strided buckets + int8 quantization noise: containment must
        # survive both (the exact refine orders the pool downstream)
        assert rec >= 0.9, (metric, offset, rec)

    def test_dead_slots_never_returned(self):
        q, base = self._setup()
        valid = np.ones(base.shape[0], bool)
        dead = np.random.default_rng(0).choice(base.shape[0], 500,
                                               replace=False)
        valid[dead] = False
        base8, off, sc, cvec = self._shadow(base, valid)
        _, idx = int8_pool_scan(q - cvec[None, :], base8, off, sc, 512)
        live = np.asarray(idx)
        live = live[live >= 0]
        assert valid[live].all()

    def test_ragged_n_pads_in_shadow(self):
        q, base = self._setup(n=1111)
        valid = np.ones(1111, bool)
        base8, off, sc, cvec = self._shadow(base, valid)
        assert base8.shape[0] % 1024 == 0
        vals, idx = int8_pool_scan(q - cvec[None, :], base8, off, sc, 256)
        got = np.asarray(idx)
        assert got.max() < 1111
        assert (np.asarray(vals)[got >= 0] < np.inf).all()

    def test_small_batch_single_query(self):
        q, base = self._setup(q=1)
        valid = np.ones(base.shape[0], bool)
        base8, off, sc, cvec = self._shadow(base, valid)
        vals, idx = int8_pool_scan(q - cvec[None, :], base8, off, sc, 256)
        assert idx.shape == (1, 256)
        full = ((np.asarray(q)[:, None] - np.asarray(base)[None]) ** 2).sum(-1)
        best = int(np.argmin(full[0]))
        assert best in set(np.asarray(idx)[0].tolist())


class TestFusedInt8gPool:
    """int8g_pool_scan: the integer-epilogue variant — global-scale
    shadow, i32 subtract + min-accumulate.  Same pool contract as
    int8_pool_scan."""

    def _setup(self, n=3000, d=64, q=16, offset=0.0, seed=3):
        r = np.random.default_rng(seed)
        base = (r.standard_normal((n, d)) + offset).astype(np.float32)
        qs = (r.standard_normal((q, d)) + offset).astype(np.float32)
        return jnp.asarray(qs), jnp.asarray(base)

    def _shadow(self, base, valid, metric="l2"):
        from vector_db_tpu.index.hnsw_pq import _build_scan8g_shadow

        norms = jnp.sum(base * base, axis=1)
        return _build_scan8g_shadow(base, norms, jnp.asarray(valid),
                                    metric, 1024)[:5]  # drop aux

    @pytest.mark.parametrize("metric", ["l2", "cosine"])
    @pytest.mark.parametrize("offset", [0.0, 10.0])
    def test_pool_contains_topk(self, metric, offset):
        from vector_db_tpu.ops.distance import blocked_knn, normalize_rows
        q, base = self._setup(offset=offset)
        valid = np.ones(base.shape[0], bool)
        base8, off, sv, sgn, cvec = self._shadow(base, valid, metric)
        assert base8.dtype == jnp.int8
        qq = normalize_rows(q) if metric == "cosine" else q
        vals, idx = int8g_pool_scan(qq - cvec[None, :], base8, off, sv,
                                     sgn, 512)
        _, gt_i = blocked_knn(q, base, jnp.asarray(valid), 10,
                              metric=metric, block_n=512)
        got, gt = np.asarray(idx), np.asarray(gt_i)
        rec = np.mean([len(set(got[i]) & set(gt[i])) / 10
                       for i in range(q.shape[0])])
        assert rec >= 0.9, (metric, offset, rec)

    def test_matches_integer_oracle_exactly(self):
        """The scan's bucket winners must equal the per-bucket argmin of
        the numpy-recomputed i32 score (deterministic given the same
        q8/off_i — this checks the pass/epilogue wiring, not the
        quantization)."""
        q, base = self._setup(n=2048, d=64, q=8)
        valid = np.ones(2048, bool)
        base8, off, sv, sgn, cvec = self._shadow(base, valid)
        w = 512
        qc = q - cvec[None, :]
        vals, idx = int8g_pool_scan(qc, base8, off, sv, sgn, w)
        # recompute the integer score exactly as the wrapper does
        qn = np.asarray(qc)
        sq = max(np.abs(qn).max(), 1e-12) / 127.0
        q8 = np.clip(np.round(qn / sq), -127, 127).astype(np.int64)
        c = float(sgn) * float(sv) * sq
        off_np = np.asarray(off)
        off_i = np.where(np.isfinite(off_np),
                         np.clip(np.round(off_np / c), -(1 << 26), 1 << 26),
                         float(1 << 29)).astype(np.int64)
        cross = q8 @ np.asarray(base8, np.int64).T          # [Q, N]
        dist = off_i[None, :] - cross
        n_rows = dist.shape[1]
        got_idx = np.asarray(idx)
        for qi in range(q.shape[0]):
            per_bucket = dist[qi].reshape(n_rows // w, w)   # [passes, w]
            best = per_bucket.argmin(axis=0) * w + np.arange(w)
            best_val = per_bucket.min(axis=0)
            ok = got_idx[qi] >= 0
            # winners match wherever the min is unique
            uniq = (per_bucket == best_val[None, :]).sum(axis=0) == 1
            assert (got_idx[qi][ok & uniq] == best[ok & uniq]).all()

    def test_dead_slots_never_returned(self):
        q, base = self._setup()
        valid = np.ones(base.shape[0], bool)
        dead = np.random.default_rng(0).choice(base.shape[0], 500,
                                               replace=False)
        valid[dead] = False
        base8, off, sv, sgn, cvec = self._shadow(base, valid)
        _, idx = int8g_pool_scan(q - cvec[None, :], base8, off, sv, sgn,
                                  512)
        live = np.asarray(idx)
        live = live[live >= 0]
        assert valid[live].all()

    def test_single_query(self):
        q, base = self._setup(q=1)
        valid = np.ones(base.shape[0], bool)
        base8, off, sv, sgn, cvec = self._shadow(base, valid)
        vals, idx = int8g_pool_scan(q - cvec[None, :], base8, off, sv,
                                     sgn, 256)
        assert idx.shape == (1, 256)
        full = ((np.asarray(q)[:, None] - np.asarray(base)[None]) ** 2).sum(-1)
        best = int(np.argmin(full[0]))
        assert best in set(np.asarray(idx)[0].tolist())


def _dead_mask(n, seed=5):
    valid = np.ones(n, bool)
    valid[np.random.default_rng(seed).choice(n, n // 10, replace=False)] = False
    return valid


# (rows, queries, pool width): a ragged corpus, one query, and a query
# count that is not a multiple of the kernel's query tile
_KERNEL_CASES = {"ragged_n": (1111, 16, 256), "q1": (2048, 1, 512),
                 "q_off_tile": (2048, 70, 256)}


class TestTritonKernelInterpret:
    """The Triton int8 pool kernel, run by the Pallas interpreter, against
    the plain XLA pool scan: same winners, same scores, no dead slot."""

    def _int8_args(self, n, q_n, metric):
        from vector_db_tpu.index.hnsw_pq import _build_scan8_shadow

        r = np.random.default_rng(n + q_n)
        base = jnp.asarray((r.standard_normal((n, 64)) + 1.0)
                           .astype(np.float32))
        valid = _dead_mask(n)
        base8, off, sc, cvec, _ = _build_scan8_shadow(
            base, jnp.sum(base * base, axis=1), jnp.asarray(valid), metric,
            128)
        q = jnp.asarray(r.standard_normal((q_n, 64)).astype(np.float32))
        return q - cvec[None, :], base8, off, sc, valid

    def _packed_args(self, n, q_n, metric):
        from vector_db_tpu.index.hnsw_pq import _build_scan8p_shadow
        from vector_db_tpu.ops.distance import pack_int8_rows

        n = -(-n // 128) * 128     # store capacities are LANES multiples
        r = np.random.default_rng(n + q_n)
        base = jnp.asarray((r.standard_normal((n, 64)) + 1.0)
                           .astype(np.float32))
        valid = _dead_mask(n)
        packed, scales = pack_int8_rows(base)
        off, sc, cvec = _build_scan8p_shadow(
            packed, scales, jnp.sum(base * base, axis=1), jnp.asarray(valid),
            metric)
        q = jnp.asarray(r.standard_normal((q_n, 64)).astype(np.float32))
        return q - cvec[None, :], packed, off, sc, valid

    @pytest.mark.parametrize("case", sorted(_KERNEL_CASES))
    @pytest.mark.parametrize("metric", ["l2", "cosine"])
    @pytest.mark.parametrize("tier", ["int8", "packed"])
    def test_kernel_matches_plain(self, tier, metric, case):
        n, q_n, w = _KERNEL_CASES[case]
        if tier == "int8":
            qc, corpus, off, sc, valid = self._int8_args(n, q_n, metric)
            scan = int8_pool_scan
        else:
            qc, corpus, off, sc, valid = self._packed_args(n, q_n, metric)
            w = pool_scan.preserved_pool_width(corpus.shape[0], w)
            scan = packed_pool_scan
        vk, ik = scan(qc, corpus, off, sc, w, impl="interpret")
        vx, ix = scan(qc, corpus, off, sc, w, impl="xla")
        assert ik.shape == ix.shape == (q_n, w)
        np.testing.assert_array_equal(np.asarray(ik), np.asarray(ix))
        np.testing.assert_array_equal(np.asarray(vk), np.asarray(vx))
        got = np.asarray(ik)
        live = got[got >= 0]
        assert live.size and live.max() < valid.shape[0]
        assert valid[live].all()


class TestPoolScanImpl:
    """One function picks the implementation: the kernel on the GPU, the
    plain form on the CPU, and nothing anywhere else."""

    def test_gpu_selects_triton_kernel(self):
        assert pool_scan.pool_scan_impl("gpu") == "triton"

    def test_cpu_selects_plain_form(self):
        assert pool_scan.pool_scan_impl("cpu") == "xla"

    def test_other_platform_raises(self):
        with pytest.raises(NotImplementedError):
            pool_scan.pool_scan_impl("rocm")


@pytest.mark.gpu
class TestOnGpu:
    """The pool-scan kernel and the PQ decode compiled for the card at real
    widths, against the plain forms.  They skip off the GPU; chip_smoke.py
    runs them on the card."""

    def test_gpu_runs_the_kernel(self, gpu):
        import jax

        assert pool_scan.pool_scan_impl(jax.default_backend()) == "triton"

    @pytest.mark.parametrize("tier", ["int8", "packed"])
    def test_kernel_matches_plain_at_width(self, gpu, tier):
        import jax

        n, d, q_n, w = 1 << 18, 512, 256, 2048
        ks = jax.random.split(jax.random.PRNGKey(7), 4)
        base8 = jax.random.randint(ks[0], (n, d), -127, 128, jnp.int32
                                   ).astype(jnp.int8)
        off = jax.random.normal(ks[1], (n,), jnp.float32).at[::13].set(
            jnp.inf)
        sc = -jax.random.uniform(ks[2], (n,), jnp.float32, 0.5, 2.0)
        q = jax.random.normal(ks[3], (q_n, d), jnp.float32)
        if tier == "packed":
            corpus = jax.lax.bitcast_convert_type(
                base8.reshape(n, d // 4, 4), jnp.int32)
            scan = packed_pool_scan
        else:
            corpus, scan = base8, int8_pool_scan
        vk, ik = scan(q, corpus, off, sc, w, impl="triton")
        vx, ix = scan(q, corpus, off, sc, w, impl="xla")
        ik, ix = np.asarray(ik), np.asarray(ix)
        assert ik.shape == (q_n, w)
        # integer cross terms are exact; the f32 epilogue may round the
        # last bit differently, which can swap a near-tie's winner
        assert np.mean(ik == ix) >= 0.9999
        fin = np.isfinite(np.asarray(vx))
        np.testing.assert_allclose(np.asarray(vk)[fin], np.asarray(vx)[fin],
                                   rtol=1e-5, atol=1e-5)

    def test_decode_at_width(self, gpu):
        from vector_db_tpu.ops import adc

        r = np.random.default_rng(8)
        s, k_tab, sd, n = 64, 256, 8, 1 << 17
        cb = r.normal(size=(s, k_tab, sd)).astype(np.float32)
        codes = r.integers(0, k_tab, size=(n, s)).astype(np.uint8)
        got = adc.pq_decode_recon_t(jnp.asarray(codes.T.copy()),
                                    adc.codebooks_to_cbt(jnp.asarray(cb)))
        cb16 = np.asarray(jnp.asarray(cb).astype(jnp.bfloat16)
                          .astype(jnp.float32))
        want = np.concatenate([cb16[i, codes[:, i], :] for i in range(s)],
                              axis=1).T
        np.testing.assert_array_equal(np.asarray(got, np.float32), want)
