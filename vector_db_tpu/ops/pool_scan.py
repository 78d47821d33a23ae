"""Strided-bucket pool scans: the candidate stage of the large-N scans.

A pool scan scores every corpus row against every query and keeps, per
query, the best row of each STRIDED bucket: bucket j of a width-``w`` pool
collects rows j, j + w, j + 2w, ...  The result is an UNRANKED pool
(selection scores [Q, w], slots [Q, w], -1 where empty); the caller ranks
it with one small select and re-scores the survivors exactly.  Strided,
not contiguous, buckets decorrelate insertion order: clustered inserts
would otherwise crowd one bucket.

Every selection score has the rank-equivalent form
``off[n] + cross(q, n) * scale``: ``off`` carries the exact f32 per-slot
term (+inf at dead slots), so quantization only perturbs the cross term.

  * `int8_pool_scan` / `packed_pool_scan`: s8 x s8 -> s32 over the raw
    tier's int8 shadow, or over the compressed store's own int32-packed
    rows (bitcast to int8; no shadow).  On the GPU one Pallas kernel
    compiled through Triton (`_int8_pool_triton`) runs it; on the CPU the
    plain XLA form (`_int8_pool_xla`) does.  `pool_scan_impl` makes that
    choice, and it is the only place that does.
  * `raw_pool_scan` (bf16 operands, f32 accumulation) and
    `int8g_pool_scan` (one global int8 scale, all-integer ranking): plain
    XLA on every backend.

The plain forms stream the corpus in chunks of passes (`lax.fori_loop`),
so the [Q, chunk, w] score intermediate stays bounded by
``_XLA_CHUNK_BYTES``.

Reference analog: the reference's blocked BLAS batch-distance scan
(native/compute/BatchDistance.cpp:20-147), with selection fused into it.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from .distance import scan_einsum

Array = jax.Array

LANES = 128    # pool widths and store capacities are multiples of this
IVF_PW = 128   # per-(cluster, prober) pool width of the IVF tier

# bound on the plain forms' [Q, passes_chunk, w] score intermediate
_XLA_CHUNK_BYTES = 1 << 30

# Triton kernel tiles: a [_BQ, _BN] int32 accumulator plus the running
# min and slot stay in registers; the corpus block is [_BN, d]
_BQ = 64
_BN = 128
_NUM_WARPS = 8


def pool_scan_impl(platform: str) -> str:
    """Which implementation of the int8 pool scan runs on ``platform``:
    the Triton kernel on ``"gpu"``, the plain XLA form on ``"cpu"``.  Any
    other platform raises; the kernel never falls back to interpret mode
    or to the plain form on the GPU."""
    if platform == "gpu":
        return "triton"
    if platform == "cpu":
        return "xla"
    raise NotImplementedError(
        f"no int8 pool scan for platform {platform!r} (gpu or cpu)")


def preserved_pool_width(n: int, max_w: int = 2048) -> int:
    """Largest pool width ``w <= max_w`` that divides ``n`` and is a
    multiple of LANES, so the pool scans keep it unchanged.

    `packed_pool_scan` refuses to pad-copy the multi-GB packed store, so
    its callers pick widths from this set.  ``n`` must be a multiple of
    LANES (every store capacity is).
    """
    if n % LANES:
        raise ValueError(f"store rows ({n}) must be a multiple of {LANES}")
    for w in range(min(max_w, n) // LANES * LANES, 0, -LANES):
        if n % w == 0:
            return w
    return LANES


def _round_width(w: int) -> int:
    return -(-w // LANES) * LANES


def quantize_rows_int8(q: Array) -> tuple[Array, Array]:
    """Per-row symmetric int8 quantization of query rows (the query-side
    analog of ops/distance.pack_int8_rows): returns (q8 int8, sq f32)."""
    sq = jnp.maximum(jnp.max(jnp.abs(q), axis=1), 1e-12) / 127.0
    q8 = jnp.clip(jnp.round(q / sq[:, None]), -127, 127).astype(jnp.int8)
    return q8, sq


def _pad_rows(x: Array, n: int, value=0) -> Array:
    pad = n - x.shape[0]
    if pad <= 0:
        return x
    widths = ((0, pad),) + ((0, 0),) * (x.ndim - 1)
    return jnp.pad(x, widths, constant_values=value)


def _finish(vals: Array, idx: Array, n: int, q_n: int):
    """Common pool epilogue: -1 at empty or padded slots, query pad cut."""
    idx = jnp.where(jnp.isfinite(vals) & (idx < n), idx, -1)
    return vals[:q_n], idx[:q_n]


# ------------------------------------------------------------ plain XLA


def _strided_min(score, passes: int, q_n: int, w: int, dtype, init_val):
    """Min-accumulate strided-bucket winners over ``passes`` passes of
    ``w`` rows.  ``score(p0, cp)`` returns the [Q, cp, w] scores of passes
    p0 .. p0+cp-1.  The last chunk's start is clamped, so it may re-scan
    passes already seen: a min cannot change on a re-scan and ties keep
    the earlier slot, so no padding copy of the corpus is needed."""
    cp = max(1, min(passes, _XLA_CHUNK_BYTES // max(q_n * w * 4, 1)))
    steps = -(-passes // cp)
    col = jax.lax.broadcasted_iota(jnp.int32, (q_n, w), 1)

    def body(i, carry):
        best, slot = carry
        p0 = jnp.minimum(i * cp, passes - cp)
        s = score(p0, cp)
        v = jnp.min(s, axis=1)
        a = jnp.argmin(s, axis=1).astype(jnp.int32)
        better = v < best
        return (jnp.where(better, v, best),
                jnp.where(better, (p0 + a) * w + col, slot))

    init = (jnp.full((q_n, w), init_val, dtype),
            jnp.full((q_n, w), -1, jnp.int32))
    return jax.lax.fori_loop(0, steps, body, init)


def _int8_pool_xla(q8, sq, base8, off, sc, w):
    """Plain XLA int8 pool scan (rows of ``base8`` a multiple of ``w``)."""
    n, d = base8.shape
    passes = n // w
    b3 = base8.reshape(passes, w, d)
    off2, sc2 = off.reshape(passes, w), sc.reshape(passes, w)

    def score(p0, cp):
        blk = jax.lax.dynamic_slice_in_dim(b3, p0, cp, axis=0)
        cross = jnp.einsum("qd,cwd->qcw", q8, blk,
                           preferred_element_type=jnp.int32)
        o = jax.lax.dynamic_slice_in_dim(off2, p0, cp, axis=0)
        s = jax.lax.dynamic_slice_in_dim(sc2, p0, cp, axis=0)
        return (o[None] + cross.astype(jnp.float32) * s[None]
                * sq[:, None, None])

    return _strided_min(score, passes, q8.shape[0], w, jnp.float32, jnp.inf)


# --------------------------------------------------------- Triton kernel


def _k_block(d: int) -> int:
    for bk in (128, 64, 32, 16):
        if d % bk == 0:
            return bk
    raise ValueError(f"d={d} must be a multiple of 16")


def _int8_pool_kernel(q_ref, sq_ref, base_ref, off_ref, sc_ref,
                      val_ref, idx_ref, *, w: int, passes: int, bk: int):
    """One program: query tile ``program_id(0)`` (the fastest grid axis,
    so programs reading the same corpus block run together and share L2)
    x pool-window block ``program_id(1)``.  It loops over the passes,
    keeping the running min and slot in registers, and stores its
    [_BQ, _BN] window once."""
    bq, bn = val_ref.shape
    d = q_ref.shape[1]
    col0 = pl.program_id(1) * bn
    qs = [q_ref[:, pl.ds(k0, bk)] for k0 in range(0, d, bk)]
    sq = sq_ref[...]
    lane = jax.lax.broadcasted_iota(jnp.int32, (bq, bn), 1)

    def body(p, carry):
        best, slot = carry
        row0 = p * w + col0
        rows = pl.ds(row0, bn)
        cross = jnp.zeros((bq, bn), jnp.int32)
        for j, k0 in enumerate(range(0, d, bk)):
            cross += pl.dot(qs[j], base_ref[rows, pl.ds(k0, bk)],
                            trans_b=True)
        dist = (off_ref[rows][None, :]
                + cross.astype(jnp.float32) * sc_ref[rows][None, :]
                * sq[:, None])
        better = dist < best
        return (jnp.where(better, dist, best),
                jnp.where(better, row0 + lane, slot))

    init = (jnp.full((bq, bn), jnp.inf, jnp.float32),
            jnp.full((bq, bn), -1, jnp.int32))
    best, slot = jax.lax.fori_loop(0, passes, body, init)
    val_ref[...] = best
    idx_ref[...] = slot


def _int8_pool_triton(q8, sq, base8, off, sc, w, interpret: bool = False):
    """Pallas/Triton int8 pool scan.  ``q8`` rows a multiple of _BQ,
    ``base8`` rows a multiple of ``w``, ``w`` a multiple of _BN."""
    n, d = base8.shape
    qp = q8.shape[0]
    kernel = functools.partial(_int8_pool_kernel, w=w, passes=n // w,
                               bk=_k_block(d))
    whole = pl.BlockSpec(memory_space=pl.ANY)
    return pl.pallas_call(
        kernel,
        grid=(qp // _BQ, w // _BN),
        in_specs=[
            pl.BlockSpec((_BQ, d), lambda i, j: (i, 0)),
            pl.BlockSpec((_BQ,), lambda i, j: (i,)),
            whole, whole, whole,
        ],
        out_specs=[
            pl.BlockSpec((_BQ, _BN), lambda i, j: (i, j)),
            pl.BlockSpec((_BQ, _BN), lambda i, j: (i, j)),
        ],
        out_shape=[
            jax.ShapeDtypeStruct((qp, w), jnp.float32),
            jax.ShapeDtypeStruct((qp, w), jnp.int32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=_NUM_WARPS,
                                             num_stages=2),
        interpret=interpret,
        name="int8_pool_scan",
    )(q8, sq, base8, off, sc)


# -------------------------------------------------------------- wrappers


@functools.partial(jax.jit, static_argnames=("w", "impl"))
def int8_pool_scan(q: Array, base8: Array, sel_off: Array, sel_scale: Array,
                   w: int, impl: str | None = None) -> tuple[Array, Array]:
    """s8 x s8 -> s32 strided-bucket pool scan over an int8 corpus.

    q [Q, d] f32, pre-centered by the caller and quantized here per row
    (sq = max|q_i| / 127); base8 [N, d] int8; sel_off [N] f32 exact
    per-slot term (+inf at dead slots); sel_scale [N] f32 the metric sign
    times the per-row corpus scale.  The selection score is
    ``off[n] + (q8 . v8_n) * sel_scale[n] * sq[i]``.  Returns the unranked
    pool (scores [Q, w'], slots [Q, w'], -1 where empty) with w' = w
    rounded up to a multiple of LANES; N is padded to a multiple of w'
    (a copy: shadow builders pre-pad).  ``impl`` ("triton", "xla" or
    "interpret", the kernel on the CPU) defaults to `pool_scan_impl`.
    """
    n, d = base8.shape
    q_n = q.shape[0]
    assert q.shape[1] == d, (q.shape, base8.shape)
    w = _round_width(w)
    n_total = -(-n // w) * w
    base8 = _pad_rows(base8, n_total)
    sel_off = _pad_rows(sel_off, n_total, jnp.inf)
    sel_scale = _pad_rows(sel_scale, n_total)
    q8, sq = quantize_rows_int8(q)
    impl = impl or pool_scan_impl(jax.default_backend())
    if impl == "xla":
        vals, idx = _int8_pool_xla(q8, sq, base8, sel_off, sel_scale, w)
    else:
        dp = -(-d // 16) * 16
        if dp != d:   # dims not a multiple of 16: zero columns (a copy)
            q8 = jnp.pad(q8, ((0, 0), (0, dp - d)))
            base8 = jnp.pad(base8, ((0, 0), (0, dp - d)))
        qp = -(-q_n // _BQ) * _BQ
        vals, idx = _int8_pool_triton(
            _pad_rows(q8, qp), _pad_rows(sq, qp, 1.0), base8, sel_off,
            sel_scale, w, interpret=impl == "interpret")
    return _finish(vals, idx, n, q_n)


@functools.partial(jax.jit, static_argnames=("w", "impl"))
def packed_pool_scan(q: Array, packed: Array, sel_off: Array,
                     sel_scale: Array, w: int,
                     impl: str | None = None) -> tuple[Array, Array]:
    """`int8_pool_scan` directly over the compressed store's int32-packed
    int8 rows ([N, d/4], ops/distance.pack_int8_rows layout; no shadow).
    The words are bitcast to int8 [N, d] in the natural dim order.

    N must be a multiple of the (LANES-rounded) ``w``: padding would copy
    the multi-GB packed store, so callers take ``w`` from
    `preserved_pool_width`.
    """
    n, dw = packed.shape
    w = _round_width(w)
    if n % w:
        raise ValueError(
            f"packed store rows ({n}) must be a multiple of the pool width "
            f"({w}); take the width from preserved_pool_width")
    base8 = jax.lax.bitcast_convert_type(packed, jnp.int8).reshape(n, dw * 4)
    return int8_pool_scan(q, base8, sel_off, sel_scale, w, impl=impl)


@functools.partial(jax.jit, static_argnames=("w",))
def raw_pool_scan(q: Array, base16: Array, sel_off: Array,
                  sel_scale: Array, w: int) -> tuple[Array, Array]:
    """bf16 strided-bucket pool scan over a raw corpus shadow (plain XLA,
    bf16 operands, f32 accumulation).

    q [Q, d] f32 pre-centered by the caller; base16 [N, d] bf16.  The
    selection score is ``sel_off[n] + (q . v_n) * sel_scale[n]`` (sq-L2:
    centered ||v - mu||^2 and -2; cosine: the centered cosine term and
    -1/|v|).  Same pool contract and padding as `int8_pool_scan`.
    """
    n, d = base16.shape
    q_n = q.shape[0]
    assert q.shape[1] == d, (q.shape, base16.shape)
    w = _round_width(w)
    n_total = -(-n // w) * w
    base16 = _pad_rows(base16, n_total)
    sel_off = _pad_rows(sel_off, n_total, jnp.inf)
    sel_scale = _pad_rows(sel_scale, n_total)
    passes = n_total // w
    b3 = base16.reshape(passes, w, d)
    off2, sc2 = sel_off.reshape(passes, w), sel_scale.reshape(passes, w)

    def score(p0, cp):
        blk = jax.lax.dynamic_slice_in_dim(b3, p0, cp, axis=0)
        cross = scan_einsum("qd,cwd->qcw", q, blk)
        o = jax.lax.dynamic_slice_in_dim(off2, p0, cp, axis=0)
        s = jax.lax.dynamic_slice_in_dim(sc2, p0, cp, axis=0)
        return o[None] + cross * s[None]

    vals, idx = _strided_min(score, passes, q_n, w, jnp.float32, jnp.inf)
    return _finish(vals, idx, n, q_n)


# "no real score reaches here" sentinel for the i32 epilogue: real scores
# are bounded by the off_i clip (2^26) + max |cross| (127*127*2048 < 2^25);
# dead slots carry 2^29, so anything >= 2^28 is dead/empty
_I32_REAL_MAX = 1 << 28


@functools.partial(jax.jit, static_argnames=("w",))
def int8g_pool_scan(q: Array, base8: Array, sel_off: Array, sv: Array,
                    sgn: float, w: int) -> tuple[Array, Array]:
    """Global-scale int8 pool scan with an all-integer epilogue (plain
    XLA; ``HnswPqConfig.int8_epilogue="global"``).

    base8 [N, d] int8 = round(ctr / sv) with ONE scale ``sv`` for the
    corpus (rows centered first: centering concentrates row ranges, which
    is what makes one scale affordable — see
    index/hnsw_pq._build_scan8g_shadow).  q [Q, d] f32 pre-centered,
    quantized here with one scale sq = max|q| / 127 over the BATCH.
    sel_off [N] f32 exact per-slot term (+inf at dead slots); ``sgn`` > 0
    the metric factor (2.0 sq-L2, 1.0 cosine).  The true score is
    ``off[n] - sgn * sv * sq * (q8 . v8_n)``; with the batch constant
    C = sgn * sv * sq that is C * (round(off / C) - cross), so ranking is
    decided in int32 and only the [Q, w] pool converts back to f32.
    Rounding off to C-units perturbs scores by <= C/2, the granularity of
    the cross term's own quantization noise.
    """
    n, d = base8.shape
    q_n = q.shape[0]
    assert q.shape[1] == d, (q.shape, base8.shape)
    w = _round_width(w)
    n_total = -(-n // w) * w
    base8 = _pad_rows(base8, n_total)
    sel_off = _pad_rows(sel_off, n_total, jnp.inf)
    sq = jnp.maximum(jnp.max(jnp.abs(q)), 1e-12) / 127.0
    q8 = jnp.clip(jnp.round(q / sq), -127, 127).astype(jnp.int8)
    c = sgn * sv * sq
    lim = float(1 << 26)
    off_i = jnp.where(jnp.isfinite(sel_off),
                      jnp.clip(jnp.round(sel_off / c), -lim, lim),
                      float(1 << 29)).astype(jnp.int32)
    passes = n_total // w
    b3 = base8.reshape(passes, w, d)
    off2 = off_i.reshape(passes, w)

    def score(p0, cp):
        blk = jax.lax.dynamic_slice_in_dim(b3, p0, cp, axis=0)
        cross = jnp.einsum("qd,cwd->qcw", q8, blk,
                           preferred_element_type=jnp.int32)
        return jax.lax.dynamic_slice_in_dim(off2, p0, cp, axis=0)[None] - cross

    vals_i, idx = _strided_min(score, passes, q_n, w, jnp.int32,
                               jnp.int32(2**31 - 1))
    real = (vals_i < _I32_REAL_MAX) & (idx < n)
    vals = jnp.where(real, vals_i.astype(jnp.float32) * c, jnp.inf)
    return vals, jnp.where(real, idx, -1)
