"""Error-free-transform (float32-pair) arithmetic — the analogue of the
reference's MPFR escape hatch.

The reference offers compile-time arbitrary precision via MPFR
(`MPREAL_SUPPORT`, upstream include/PLS/pls.h:11-28) as its numerics
escape hatch.  float64 is slow on accelerators (on the H100 it runs
outside the tensor cores), so the equivalent here is *compensated*
arithmetic: every value is carried as an unevaluated sum
`hi + lo` of two float32s (a "double-float", ~49 bits of effective
mantissa), built from error-free transforms (Knuth two-sum, Dekker
two-prod).  All operations are branch-free elementwise code, so they
jit/vmap/shard like any other jnp op.  They rely on every product and
sum being rounded on its own: a compiler that contracted a*b + c into
one fused multiply-add would change them (chip_smoke.py checks a deep-A
dd fit on the GPU against float64).

Where it matters for PLS: the cross-products XᵀX and XᵀY reduce over N.
At the north-star scale (N = 1M rows) a plain f32 tree-sum loses ~10 bits
to accumulated rounding; compensating the *chunk-level* accumulation
(each chunk partial computed at f32, chunk partials combined
with two-sum) removes the N-dependence of the error entirely — the
residual error is the single-chunk matmul rounding, independent of how many
chunks streamed past.  This is the `compensated=True` mode of
`models/streaming.StatsAccumulator` and `ops/twofloat.cross_products`.

No reference code is copied; pls.h lines are cited for capability parity
only.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

# Dekker splitting constant for a given mantissa: 2^ceil(p/2) + 1.
# float32 has p=24 -> 2^12 + 1; float64 has p=53 -> 2^27 + 1.
_SPLIT = {jnp.dtype(jnp.float32): 4097.0, jnp.dtype(jnp.float64): 134217729.0}


def two_sum(a: jnp.ndarray, b: jnp.ndarray):
    """Error-free addition (Knuth): returns (s, e) with s = fl(a+b) and
    a + b = s + e exactly.  Branch-free, 6 flops."""
    s = a + b
    bb = s - a
    e = (a - (s - bb)) + (b - bb)
    return s, e


def fast_two_sum(a: jnp.ndarray, b: jnp.ndarray):
    """Error-free addition assuming |a| >= |b| (Dekker, 3 flops)."""
    s = a + b
    e = b - (s - a)
    return s, e


def split(a: jnp.ndarray):
    """Dekker split: a = hi + lo with hi, lo each representable in half
    the mantissa (so hi*hi', hi*lo', ... products are exact)."""
    c = _SPLIT[jnp.dtype(a.dtype)] * a
    hi = c - (c - a)
    return hi, a - hi


def two_prod(a: jnp.ndarray, b: jnp.ndarray):
    """Error-free multiplication (Dekker): (p, e) with a*b = p + e exactly
    (barring overflow/underflow of the split)."""
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    e = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    return p, e


def dd_add(x_hi, x_lo, y_hi, y_lo):
    """Double-float addition: (x_hi + x_lo) + (y_hi + y_lo), renormalized."""
    s, e = two_sum(x_hi, y_hi)
    e = e + (x_lo + y_lo)
    return fast_two_sum(s, e)


def dd_add_f(x_hi, x_lo, y):
    """Double-float += single float."""
    s, e = two_sum(x_hi, y)
    return fast_two_sum(s, e + x_lo)


def dd_mul(x_hi, x_lo, y_hi, y_lo):
    """Double-float multiplication."""
    p, e = two_prod(x_hi, y_hi)
    e = e + (x_hi * y_lo + x_lo * y_hi)
    return fast_two_sum(p, e)


def dd_scale(xh, xl, s):
    """Double-float × plain float (elementwise/broadcast)."""
    p, e = two_prod(xh, s)
    return fast_two_sum(p, e + xl * s)


def dd_div(xh, xl, yh, yl):
    """Double-float division (x / y), two Newton correction terms."""
    q1 = xh / yh
    p, pe = two_prod(q1, yh)
    rh, rl = dd_add(xh, xl, -p, -(pe + q1 * yl))
    return fast_two_sum(q1, (rh + rl) / yh)


def dd_sqrt(xh, xl):
    """Double-float square root (one Newton step from the f32 root;
    xh must be non-negative)."""
    s = jnp.sqrt(xh)
    p, pe = two_prod(s, s)
    denom = jnp.where(s == 0, 1.0, 2.0 * s)
    return fast_two_sum(s, ((xh - p) - pe + xl) / denom)


def dd_reduce_sum(hi, lo, axis: int = 0):
    """Compensated reduction along `axis` by PAIRWISE halving folds —
    log2(n) vectorized dd_add sweeps instead of dd_sum's sequential
    scan, so a K=10⁴ reduction is 14 VPU passes, not 10⁴ scan steps.
    Error per output element is O(2⁻⁴⁸·log n)."""
    hi = jnp.moveaxis(hi, axis, 0)
    lo = jnp.moveaxis(lo, axis, 0)
    while hi.shape[0] > 1:
        n = hi.shape[0]
        if n % 2:
            z = jnp.zeros_like(hi[:1])
            hi = jnp.concatenate([hi, z])
            lo = jnp.concatenate([lo, z])
            n += 1
        h = n // 2
        hi, lo = dd_add(hi[:h], lo[:h], hi[h:], lo[h:])
    return hi[0], lo[0]


def _dd_prod_terms(ah, al, bh, bl):
    """Elementwise double-float product (first order): exact two_prod of
    the hi parts plus the cross terms; the al·bl term (~2⁻⁴⁸ relative)
    is below the carried precision."""
    p, e = two_prod(ah, bh)
    return p, e + (ah * bl + al * bh)


def dd_dot(ah, al, bh, bl):
    """Compensated dot product of two dd vectors: exact elementwise
    products, pairwise-compensated reduction.  Returns a scalar pair."""
    p, e = _dd_prod_terms(ah, al, bh, bl)
    return dd_reduce_sum(p, e, axis=0)


def dd_matvec(Ah, Al, xh, xl):
    """(n, m) dd matrix × (m,) dd vector → (n,) dd.  Pass Al=None for a
    plain (single-float) matrix.  Exact products + pairwise-compensated
    row reduction; materializes two (n, m) temporaries."""
    if Al is None:
        p, e = two_prod(Ah, xh[None, :])
        e = e + Ah * xl[None, :]
    else:
        p, e = _dd_prod_terms(Ah, Al, xh[None, :], xl[None, :])
    return dd_reduce_sum(p, e, axis=1)


def dd_matvec_t(Ah, Al, xh, xl):
    """(n, m) dd matrix TRANSPOSED × (n,) dd vector → (m,) dd (i.e.
    Aᵀx, reducing over rows).  Pass Al=None for a plain matrix."""
    if Al is None:
        p, e = two_prod(Ah, xh[:, None])
        e = e + Ah * xl[:, None]
    else:
        p, e = _dd_prod_terms(Ah, Al, xh[:, None], xl[:, None])
    return dd_reduce_sum(p, e, axis=0)


def dd_cross(X, Y):
    """Double-float XᵀY from plain-f32 operands with EXACT products and
    compensated reduction over rows: (K, M) pair.  Materializes an
    (N, K, M) two_prod intermediate — intended for the escape-hatch
    precision path on in-memory problems; at streaming scale use
    `cross_products` (chunk-compensated) instead."""
    p, e = two_prod(X[:, :, None], Y[:, None, :])
    return dd_reduce_sum(p, e, axis=0)


def dd_gram(X: jnp.ndarray, *, block_rows: int | None = None):
    """Double-float XᵀX from a plain-f32 (N, K) operand: exact two_prod
    products, compensated reduction over rows → (K, K) pair.

    Row-BLOCKED: the naive formulation materializes an (N, K, K)
    two_prod intermediate — 137 GB at the modest N=4096, K=2048 — so a
    lax.scan over row blocks keeps the live temporaries at
    ~(block_rows, K, K) instead (block_rows auto-sized so the pair of
    f32 temps stays ≲256 MB); zero-padded tail rows contribute exact
    zeros.  Cross-block accumulation is dd_add (renormalized two_sum),
    matching the chunk-compensated contract of `cross_products`.
    """
    import jax

    X = jnp.asarray(X)
    N, K = X.shape
    if block_rows is None:
        block_rows = max(1, (1 << 24) // (K * K))  # ~64 MB per f32 temp
    block_rows = min(block_rows, N)
    nb = -(-N // block_rows)
    pad = nb * block_rows - N
    Xb = jnp.pad(X, ((0, pad), (0, 0))).reshape(nb, block_rows, K)

    def body(carry, Xc):
        XXh, XXl = carry
        p, e = two_prod(Xc[:, :, None], Xc[:, None, :])
        h, l = dd_reduce_sum(p, e, axis=0)
        return dd_add(XXh, XXl, h, l), None

    z = jnp.zeros((K, K), X.dtype)
    (XXh, XXl), _ = jax.lax.scan(body, (z, z), Xb)
    return XXh, XXl


def dd_sum(x: jnp.ndarray, axis: int = 0):
    """Compensated reduction along `axis`: returns (hi, lo) such that
    hi + lo approximates the exact sum to ~2*p bits.  Implemented as a
    sequential two-sum scan (lax.scan keeps it a single fused loop)."""
    x = jnp.moveaxis(x, axis, 0)

    def step(carry, xi):
        hi, lo = carry
        hi, e = two_sum(hi, xi)
        return (hi, lo + e), None

    z = jnp.zeros_like(x[0])
    (hi, lo), _ = jax.lax.scan(step, (z, z), x)
    return fast_two_sum(hi, lo)


@partial(jax.jit, static_argnames=("chunk", "precision"))
def cross_products(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    *,
    chunk: int = 4096,
    precision: str | None = "highest",
):
    """Compensated XᵀX and XᵀY: per-chunk partials at f32,
    chunk partials combined with error-free two-sum.

    Returns (XX_hi, XX_lo, XY_hi, XY_lo).  The error of hi+lo is bounded
    by a single chunk's matmul rounding — independent of N — versus the
    O(log(N/chunk)) (tree) or O(N/chunk) (sequential) growth of a plain
    f32 accumulation.  Use `fit_from_stats(XX_hi + ...)` — for PLS the
    downstream component loop is f32; what matters is that the statistics
    entering it are correctly rounded.
    """
    N, K = X.shape
    M = Y.shape[1]
    dtype = X.dtype
    pad = (-N) % chunk
    if pad:
        X = jnp.concatenate([X, jnp.zeros((pad, K), dtype)])
        Y = jnp.concatenate([Y, jnp.zeros((pad, M), dtype)])
    n_chunks = (N + pad) // chunk
    Xc = X.reshape(n_chunks, chunk, K)
    Yc = Y.reshape(n_chunks, chunk, M)

    prec = precision  # dot_general accepts the string form directly

    def step(carry, xy):
        xx_hi, xx_lo, xy_hi, xy_lo = carry
        x, y = xy
        pxx = jax.lax.dot_general(
            x, x, (((0,), (0,)), ((), ())), precision=prec
        )
        pxy = jax.lax.dot_general(
            x, y, (((0,), (0,)), ((), ())), precision=prec
        )
        xx_hi, xx_lo = dd_add_f(xx_hi, xx_lo, pxx)
        xy_hi, xy_lo = dd_add_f(xy_hi, xy_lo, pxy)
        return (xx_hi, xx_lo, xy_hi, xy_lo), None

    zxx = jnp.zeros((K, K), dtype)
    zxy = jnp.zeros((K, M), dtype)
    (xx_hi, xx_lo, xy_hi, xy_lo), _ = jax.lax.scan(
        step, (zxx, zxx, zxy, zxy), (Xc, Yc)
    )
    return xx_hi, xx_lo, xy_hi, xy_lo
