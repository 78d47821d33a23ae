"""Tests for the cluster-pruned scan tier (search_mode="scan_ivf").

Covers ops/ivf_scan (inversion, balanced layout, geometry, candidates)
and the HnswPqIndex integration (raw + compressed recall, CRUD overlay,
relayout threshold, checkpoint roundtrip, cosine).
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from vector_db_tpu.api.config import HnswPqConfig
from vector_db_tpu.index.hnsw_pq import HnswPqIndex
from vector_db_tpu.ops import ivf_scan
from vector_db_tpu.ops.pool_scan import IVF_PW, LANES


def _mixture(rng, n, d, modes=40, scale=3.0):
    centers = rng.normal(size=(modes, d)).astype(np.float32) * scale
    return (centers[rng.integers(0, modes, n)]
            + rng.normal(size=(n, d)).astype(np.float32)), centers


def _true_topk(q, x, k):
    dq = ((q ** 2).sum(1)[:, None] + (x ** 2).sum(1)[None, :]
          - 2.0 * q @ x.T)
    return np.argsort(dq, axis=1)[:, :k]


def _recall(ids, true):
    k = true.shape[1]
    return np.mean([
        len(set(true[i]) & set(ids[i][:k])) / k for i in range(len(true))])


# ------------------------------------------------------------------- ops


def test_invert_probers_oracle():
    rng = np.random.default_rng(0)
    nlist, p_cap, q_n, nprobe = 13, 4, 9, 5
    top_c = rng.integers(0, nlist, (q_n, nprobe)).astype(np.int32)
    probers, ppos = ivf_scan.invert_probers(jnp.asarray(top_c), nlist, p_cap)
    probers = np.asarray(probers).reshape(nlist, p_cap)
    ppos = np.asarray(ppos)
    counts: dict = {}
    for q in range(q_n):
        for j in range(nprobe):
            c = top_c[q, j]
            r = counts.get(c, 0)
            if r < p_cap:
                assert ppos[q, j] == r
                assert probers[c, r] == q
            else:
                assert ppos[q, j] == -1  # dropped, query loses the cluster
            counts[c] = r + 1


def test_balanced_layout_host_and_device_agree_on_properties():
    rng = np.random.default_rng(1)
    m, nlist, cap, a_n = 5000, 8, 768, 4
    choices = rng.integers(0, nlist, (m, a_n)).astype(np.int32)
    valid = np.ones(m, bool)
    valid[::17] = False
    slots = np.arange(m)
    live = slots[valid]
    p_host, sp_host = ivf_scan.build_balanced_layout(
        choices[valid], live, nlist, cap)
    p_dev, s2p, sp_dev = ivf_scan.balanced_layout_dev(
        jnp.asarray(choices), jnp.asarray(valid), nlist, cap)
    p_dev, s2p = np.asarray(p_dev), np.asarray(s2p)
    for p2s, spilled in ((p_host, sp_host), (p_dev, int(sp_dev))):
        placed = p2s[p2s >= 0]
        assert sorted(placed) == sorted(live)  # every live row exactly once
        per_cluster = (p2s.reshape(nlist, cap) >= 0).sum(1)
        assert (per_cluster <= cap).all()
        assert spilled == 0  # uniform choices + slack never spill
    # device slot2pos is the exact inverse of pos2slot
    pos = s2p[live]
    assert (pos >= 0).all()
    assert (p_dev[pos] == live).all()
    assert (s2p[~valid] == -1).all()


def test_balanced_layout_spills_when_choices_exhaust():
    # every row prefers cluster 0 only -> cap rows fit, rest spill
    m, nlist, cap = 300, 4, 128
    choices = np.zeros((m, 1), np.int32)
    p2s, spilled = ivf_scan.build_balanced_layout(
        choices, np.arange(m), nlist, cap)
    assert spilled == m - cap
    assert (p2s >= 0).sum() == m  # spilled rows still placed somewhere


def test_auto_ivf_geometry_respects_kernel_bounds():
    for n in (1000, 100_000, 1_000_000, 10_000_000):
        for w in (1, 2, 4):
            nlist, cap = ivf_scan.auto_ivf_geometry(n, winners=w)
            assert cap % LANES == 0
            assert w * (cap // LANES) <= IVF_PW
            assert nlist * cap >= n + nlist  # room for every row


def test_fused_ivf_pool_oracle():
    rng = np.random.default_rng(3)
    nlist, cap, p_cap, d, winners = 3, 256, 8, 16, 2
    dw = d // 4
    v8 = rng.integers(-127, 128, (nlist * cap, d), dtype=np.int8)
    q8 = rng.integers(-127, 128, (nlist * p_cap, d), dtype=np.int8)
    off = rng.normal(size=nlist * cap).astype(np.float32)
    sc = rng.uniform(0.5, 2.0, nlist * cap).astype(np.float32)

    def pack(a):
        return jax.lax.bitcast_convert_type(
            jnp.asarray(a).reshape(a.shape[0], dw, 4), jnp.int32)

    cids = jnp.array([1, 2], jnp.int32)
    vals, pos = ivf_scan.ivf_cluster_pool(
        cids, pack(q8), pack(v8), jnp.asarray(off), jnp.asarray(sc), nlist,
        cap, p_cap, winners)
    vals, pos = np.asarray(vals), np.asarray(pos)
    # both operands unpack through the same lane permutation -> dot invariant
    cross = q8.astype(np.int32) @ v8.astype(np.int32).T
    bpb = cap // LANES
    for c in (1, 2):
        for p in range(p_cap):
            row = c * p_cap + p
            dist = (off[c * cap:(c + 1) * cap]
                    + cross[row, c * cap:(c + 1) * cap]
                    * sc[c * cap:(c + 1) * cap])
            d3 = dist.reshape(bpb, LANES)
            cur = d3.copy()
            exp_v, exp_p = [], []
            for _ in range(winners):
                a = np.argmin(cur, axis=1)
                exp_v.append(cur[np.arange(bpb), a])
                exp_p.append(c * cap + np.arange(bpb) * LANES + a)
                cur[np.arange(bpb), a] = np.inf
            used = winners * bpb
            assert np.allclose(np.concatenate(exp_v), vals[row, :used],
                               rtol=1e-5)
            assert (np.concatenate(exp_p) == pos[row, :used]).all()
            assert (vals[row, used:] == np.inf).all()
            assert (pos[row, used:] == -1).all()


def test_ivf_candidates_containment_small_q():
    # Q=1 exercises the _unique_worklist < nlist path (pruned reads)
    rng = np.random.default_rng(4)
    n, d, k = 20000, 64, 10
    x, centers = _mixture(rng, n, d)
    q = (centers[rng.integers(0, 40, 1)]
         + rng.normal(size=(1, d)).astype(np.float32))
    from vector_db_tpu.ops.kmeans import kmeans_fit

    nlist, cap = ivf_scan.auto_ivf_geometry(n)
    cents, _ = kmeans_fit(jax.random.PRNGKey(43), jnp.asarray(x), k=nlist,
                          iters=8)
    choices = ivf_scan.coarse_choices(jnp.asarray(x), None, cents, "l2",
                                      8, 2500, approx=False)
    p2s, _, spilled = ivf_scan.balanced_layout_dev(
        choices, jnp.ones(n, bool), nlist, cap)
    assert int(spilled) <= n // 100  # 8 choices absorb k-means skew
    scale = np.maximum(np.abs(x).max(1), 1e-30) / 127.0
    x8 = np.clip(np.round(x / scale[:, None]), -127, 127).astype(np.int8)
    packed = jax.lax.bitcast_convert_type(
        jnp.asarray(x8).reshape(n, d // 4, 4), jnp.int32)
    safe = np.maximum(np.asarray(p2s), 0)
    live = np.asarray(p2s) >= 0
    cm = packed[jnp.asarray(safe)]
    off = jnp.asarray(np.where(live, (x ** 2).sum(1)[safe], np.inf)
                      .astype(np.float32))
    sc = jnp.asarray((np.where(live, -2.0 * scale[safe], 0.0))
                     .astype(np.float32))
    _, slots = ivf_scan.ivf_pool_candidates(
        jnp.asarray(q), cents, cm, off, sc, jnp.zeros(d), p2s,
        "l2", nprobe=8, p_cap=32, pool=128, winners=4)
    slots = np.asarray(slots)
    true = _true_topk(q, x, k)
    assert _recall(slots, true) >= 0.9


# ----------------------------------------------------------------- index


@pytest.mark.parametrize("raw", [True, False])
def test_scan_ivf_index_recall(raw):
    rng = np.random.default_rng(5)
    n, d, q_n, k = 20000, 64, 32, 10
    x, centers = _mixture(rng, n, d)
    q = (centers[rng.integers(0, 40, q_n)]
         + rng.normal(size=(q_n, d)).astype(np.float32))
    cfg = HnswPqConfig(search_mode="scan_ivf", nprobe=8, use_graph=False,
                       raw_store=raw, num_subspaces=16,
                       refine_residual=not raw)
    ix = HnswPqIndex(d, n + 1000, metric="l2", config=cfg)
    ix.bulk_load(list(range(n)), x)
    ix.build()
    assert ix.config.nlist > 0  # auto-sized at train
    ids, _ = ix.search_batch(q, k)
    true = _true_topk(q, x, k)
    # raw refine is exact; compressed with residual is effectively exact
    assert _recall(ids, true) >= 0.95


def test_scan_ivf_crud_overlay_and_relayout():
    rng = np.random.default_rng(6)
    n, d, q_n, k = 12000, 32, 16, 10
    x, centers = _mixture(rng, n, d, modes=20)
    q = (centers[rng.integers(0, 20, q_n)]
         + rng.normal(size=(q_n, d)).astype(np.float32))
    cfg = HnswPqConfig(search_mode="scan_ivf", nprobe=8, use_graph=False,
                       num_subspaces=8)
    ix = HnswPqIndex(d, n + 4000, metric="l2", config=cfg)
    ix.bulk_load(list(range(n)), x)
    ix.build()
    ix.search_batch(q, k)  # materialise the layout
    assert ix._ivf_cache is not None
    # adds after the layout land in the exact overlay, not the grid
    xa, _ = _mixture(rng, 300, d, modes=20)
    xa = xa + 0.0
    ix.add_batch(list(range(n, n + 300)), xa)
    allx = np.concatenate([x, xa])
    true = _true_topk(q, allx, k)
    ids, _ = ix.search_batch(q, k)
    assert _recall(ids, true) >= 0.9
    assert ix._ivf_overlay.size == 300
    # removing a returned neighbor takes effect immediately
    victim = int(ids[0, 0])
    assert ix.remove(victim)
    ids2, _ = ix.search_batch(q[:1], k)
    assert victim not in ids2[0]
    # crossing the overlay budget forces a relayout on the next search
    ix._IVF_OVERLAY_MAX = 64
    xb, _ = _mixture(rng, 200, d, modes=20)
    ix.add_batch(list(range(n + 300, n + 500)), xb)
    ids3, _ = ix.search_batch(q, k)
    assert ix._ivf_overlay.size == 0  # rebuilt, overlay drained
    allx2 = np.concatenate([allx, xb])
    allx2[victim] = np.inf  # removed row can't be a true neighbor
    true3 = _true_topk(q, allx2, k)
    assert _recall(ids3, true3) >= 0.9
    del ix._IVF_OVERLAY_MAX  # restore the class default


def test_scan_ivf_checkpoint_roundtrip():
    rng = np.random.default_rng(7)
    n, d, q_n, k = 8000, 32, 8, 10
    x, centers = _mixture(rng, n, d, modes=16)
    q = (centers[rng.integers(0, 16, q_n)]
         + rng.normal(size=(q_n, d)).astype(np.float32))
    cfg = HnswPqConfig(search_mode="scan_ivf", nprobe=6, use_graph=False,
                       num_subspaces=8)
    ix = HnswPqIndex(d, n + 500, metric="l2", config=cfg)
    ix.bulk_load(list(range(n)), x)
    ix.build()
    ids, _ = ix.search_batch(q, k)
    state = ix.state_arrays()
    ix2 = HnswPqIndex(d, n + 500, metric="l2", config=cfg)
    ix2.config.nlist = ix.config.nlist
    ix2.load_state_arrays(state)
    ids2, _ = ix2.search_batch(q, k)  # layout rebuilt lazily from coarse
    true = _true_topk(q, x, k)
    assert _recall(ids2, true) >= 0.95
    assert _recall(ids2, ids[:, :k]) >= 0.9  # matches the original index


def test_scan_ivf_cosine():
    rng = np.random.default_rng(8)
    n, d, q_n, k = 15000, 32, 16, 10
    x, centers = _mixture(rng, n, d, modes=20)
    x += 2.0  # offset corpus: cosine != l2
    q = (centers[rng.integers(0, 20, q_n)]
         + rng.normal(size=(q_n, d)).astype(np.float32)) + 2.0
    cfg = HnswPqConfig(search_mode="scan_ivf", nprobe=8, use_graph=False,
                       num_subspaces=8)
    ix = HnswPqIndex(d, n + 500, metric="cosine", config=cfg)
    ix.bulk_load(list(range(n)), x)
    ix.build()
    ids, _ = ix.search_batch(q, k)
    xn = x / np.linalg.norm(x, axis=1, keepdims=True)
    qn_ = q / np.linalg.norm(q, axis=1, keepdims=True)
    true = np.argsort(1.0 - qn_ @ xn.T, axis=1)[:, :k]
    assert _recall(ids, true) >= 0.9


def test_scan_ivf_untrained_raises():
    cfg = HnswPqConfig(search_mode="scan_ivf", use_graph=False)
    ix = HnswPqIndex(16, 1000, config=cfg)
    rng = np.random.default_rng(9)
    ix.bulk_load(list(range(300)), rng.normal(size=(300, 16))
                 .astype(np.float32))
    # untrained indexes fall back to the exact scan (reference semantics)
    ids, _ = ix.search_batch(rng.normal(size=(2, 16)).astype(np.float32), 5)
    assert (ids >= 0).all()


def test_kmeans_fit_blocked_matches_dense():
    # same key + random init => the blocked Lloyd is mathematically the
    # dense Lloyd (ops/kmeans.kmeans_fit plus_plus=False), modulo f32
    # accumulation order — centroids must agree to float tolerance
    import jax

    from vector_db_tpu.ops.kmeans import kmeans_fit, kmeans_fit_blocked

    rng = np.random.default_rng(11)
    x, _ = _mixture(rng, 2048, 24, modes=16)
    xj = jnp.asarray(x)
    key = jax.random.PRNGKey(5)
    dense, _ = kmeans_fit(key, xj, k=16, iters=6, plus_plus=False)
    blocked = kmeans_fit_blocked(key, xj, k=16, iters=6, chunk=256)
    np.testing.assert_allclose(np.asarray(blocked), np.asarray(dense),
                               rtol=2e-3, atol=2e-3)


def test_coarse_kmeans_blocked_route():
    # past the dense threshold the index must route through the blocked
    # Lloyd (the dense one-hot would be ~24 GB at the 10M tier's nlist)
    cfg = HnswPqConfig(search_mode="scan_ivf", nprobe=8, use_graph=False,
                       num_subspaces=8)
    ix = HnswPqIndex(16, 4096, config=cfg)
    rng = np.random.default_rng(12)
    x, _ = _mixture(rng, 3000, 16, modes=10)
    import vector_db_tpu.ops.kmeans as km

    called = {}
    orig = km.kmeans_fit_blocked

    def spy(*a, **kw):
        called["yes"] = True
        return orig(*a, **kw)

    km.kmeans_fit_blocked = spy
    try:
        # force the blocked route by shrinking the threshold via nlist:
        # rows * nlist > 1<<27 needs big inputs, so call the helper direct
        ix.bulk_load(list(range(3000)), x)
        full = jnp.asarray(x)
        big = jnp.tile(full, (45, 1))  # 135k rows x nlist 1024 > 1<<27
        cents = ix._coarse_kmeans(big, 1024)
        assert called.get("yes"), "blocked Lloyd not routed"
        assert cents.shape == (1024, 16)
    finally:
        km.kmeans_fit_blocked = orig
