"""Full double-float (f32-pair) kernel-PLS component loop — the
complete analogue of the reference's MPFR escape hatch
(`MPREAL_SUPPORT`, upstream include/PLS/pls.h:11-28).

`precision="compensated"` (models/kernel_pls.py) carries only the XY
deflation as a pair; deep-A fits then stay at ~0.1 relative error
(the A=50 case of tests/test_fit_parity.py, on CPU) because the per-component
quantities w/r/p/q round to f32 each step — the error sources are
co-dominant (step isolation: f64 XY carry alone 0.053, f64 GS +
X-passes alone 0.057, all-f32 0.32).  This module closes that gap:
EVERY per-component quantity — w, its normalization, the Gram-Schmidt
correction, t/tt/p (or XX·r), q, and the deflation — is carried as an
unevaluated f32 pair (~49 mantissa bits) built from error-free
transforms (ops/twofloat.py), including the X contractions themselves
(exact two_prod products + pairwise-compensated reductions).

Cost model: each X contraction materializes two (N, K) temporaries and
runs as elementwise code instead of a matmul — expected to be an order
of magnitude slower than the plain f32 fit (not measured on the GPU).  This is the *numerics escape hatch*,
priced like the reference's MPFR build (which is orders of magnitude
slower than its double build): use it for deep-A fits in
noise-dominated regimes, conditioning studies, and ground-truthing;
production fits stay f32/bf16.  Measured accuracy at the A=50
noise-spectrum stress where plain f32 sits at ~0.11-0.35:
≤1e-5 relative vs the f64 reference (tests/test_fit_parity.py
TestFullDoubleFloat, docs/PERF.md).

Reference per-component math: /root/reference/src/pls.cpp:400-435.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.ops.eigen import dominant_eigenvector
from pls_tpu.ops.twofloat import (
    dd_add,
    dd_cross,
    dd_div,
    dd_dot,
    dd_matvec,
    dd_matvec_t,
    dd_mul,
    dd_sqrt,
)
from pls_tpu.types import METHOD, PLSFit


def _dd_w_from_xy(XYh, XYl, power_iters):
    """w = XY (M==1) or XY·q₀ with q₀ the dominant eigenvector of
    XYᵀXY — eigensolve on the hi part (direction seed), then two
    double-float power-iteration refinements so the direction carries
    pair precision into w."""
    M = XYh.shape[1]
    if M == 1:
        return XYh[:, 0], XYl[:, 0]
    # C = XYᵀXY in dd (M×M, reduce over K)
    Ch, Cl = _dd_gram_t(XYh, XYl)
    q0h = dominant_eigenvector(Ch, power_iters)
    q0l = jnp.zeros_like(q0h)
    for _ in range(2):
        vh, vl = dd_matvec(Ch, Cl, q0h, q0l)
        nh, nl = dd_dot(vh, vl, vh, vl)
        sh, sl = dd_sqrt(nh, nl)
        q0h, q0l = dd_div(vh, vl, sh, sl)
    return dd_matvec(XYh, XYl, q0h, q0l)


def _dd_gram_t(Ah, Al):
    """AᵀA for a (K, M) dd matrix → (M, M) dd, column-pair dots."""
    M = Ah.shape[1]
    cols = [
        [dd_dot(Ah[:, i], Al[:, i], Ah[:, j], Al[:, j]) for j in range(M)]
        for i in range(M)
    ]
    Ch = jnp.stack([jnp.stack([cols[i][j][0] for j in range(M)]) for i in range(M)])
    Cl = jnp.stack([jnp.stack([cols[i][j][1] for j in range(M)]) for i in range(M)])
    return Ch, Cl


@partial(jax.jit, static_argnames=("A", "type1", "power_iters"))
def _fit_kernel_dd(
    X: jnp.ndarray | None,
    XXh: jnp.ndarray | None,
    XXl: jnp.ndarray | None,
    XYh: jnp.ndarray,
    XYl: jnp.ndarray,
    Y: jnp.ndarray | None,
    A: int,
    type1: bool,
    power_iters: int | None,
) -> PLSFit:
    """Shared dd component loop.  type1 streams X (exact-product
    contractions t = Xr, p = Xᵀt); type2 uses the dd Gram matrix
    (XXh, XXl).  XY enters as a pair (from dd_cross or a compensated
    StatsAccumulator)."""
    K = XYh.shape[0]
    dtype = XYh.dtype

    def step(carry, a):
        XYh, XYl, Pbh, Pbl, Rbh, Rbl = carry
        wh, wl = _dd_w_from_xy(XYh, XYl, power_iters)
        # normalize in dd
        nh, nl = dd_dot(wh, wl, wh, wl)
        sh, sl = dd_sqrt(nh, nl)
        wh, wl = dd_div(wh, wl, sh, sl)

        # Gram-Schmidt vs previous loadings (rows >= a are zero), twice
        def gs(rh, rl):
            ch, cl = dd_matvec(Pbh, Pbl, rh, rl)  # (A,)
            dh, dl = dd_matvec_t(Rbh, Rbl, ch, cl)  # (K,)
            return dd_add(rh, rl, -dh, -dl)

        rh, rl = gs(wh, wl)
        rh, rl = gs(rh, rl)

        if type1:
            th, tl = dd_matvec(X, None, rh, rl)  # (N,)
            tth, ttl = dd_dot(th, tl, th, tl)
            ph, pl = dd_matvec_t(X, None, th, tl)  # (K,)
        else:
            ph, pl = dd_matvec(XXh, XXl, rh, rl)  # v = XX r
            tth, ttl = dd_dot(rh, rl, ph, pl)
            th = jnp.zeros((0,), dtype)
        ph, pl = dd_div(ph, pl, tth, ttl)
        qh, ql = dd_matvec_t(XYh, XYl, rh, rl)  # (M,)
        qh, ql = dd_div(qh, ql, tth, ttl)
        Pbh = Pbh.at[a].set(ph)
        Pbl = Pbl.at[a].set(pl)
        Rbh = Rbh.at[a].set(rh)
        Rbl = Rbl.at[a].set(rl)
        # deflate XY -= (p qᵀ)·tt, all pairs
        tqh, tql = dd_mul(qh, ql, tth, ttl)
        Dh, Dl = dd_mul(ph[:, None], pl[:, None], tqh[None, :], tql[None, :])
        XYh, XYl = dd_add(XYh, XYl, -Dh, -Dl)
        return (XYh, XYl, Pbh, Pbl, Rbh, Rbl), (wh, qh, th)

    zb = jnp.zeros((A, K), dtype)
    carry0 = (XYh, XYl, zb, zb, zb, zb)
    carry, (Ws, Qs, Ts) = jax.lax.scan(step, carry0, jnp.arange(A))
    _, _, Pbh, _, Rbh, _ = carry
    return PLSFit(
        W=Ws.T,
        P=Pbh.T,
        Q=Qs.T,
        R=Rbh.T,
        T=Ts.T if type1 else jnp.zeros((0, A), dtype),
        method=METHOD.KERNEL_TYPE1 if type1 else METHOD.KERNEL_TYPE2,
    )


def fit_dd(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    type1: bool = True,
    *,
    power_iters: int | None = None,
) -> PLSFit:
    """Full double-float fit from in-memory (N, K) data — routed from
    ``fit(..., precision="dd")``.  XY (and XX for type2) are built with
    exact products + compensated reductions, then the dd component loop
    runs.  Memory note: dd_cross materializes (N, K, M); for large
    streams build compensated statistics instead
    (StatsAccumulator(compensated=True)) and call fit_from_stats_dd."""
    X = jnp.asarray(X, jnp.float32)
    Y = jnp.asarray(Y, jnp.float32)
    if Y.ndim == 1:
        Y = Y[:, None]
    XYh, XYl = dd_cross(X, Y)
    if type1:
        return _fit_kernel_dd(X, None, None, XYh, XYl, Y, A, True, power_iters)
    # type2: dd Gram matrix, row-blocked exact products (dd_gram scans
    # row blocks so the live two_prod temporary is ~(block, K, K), not
    # the (N, K, K) that would OOM at even modest N·K²)
    from pls_tpu.ops.twofloat import dd_gram

    XXh, XXl = dd_gram(X)
    return _fit_kernel_dd(None, XXh, XXl, XYh, XYl, Y, A, False, power_iters)


def fit_from_stats_dd(
    XX: jnp.ndarray,
    XY: jnp.ndarray,
    A: int,
    *,
    XX_lo: jnp.ndarray | None = None,
    XY_lo: jnp.ndarray | None = None,
    power_iters: int | None = None,
) -> PLSFit:
    """Double-float kernel-2 fit from (possibly pair-valued) statistics —
    pass the lo parts from ``StatsAccumulator(compensated=True)`` /
    ``ops.twofloat.cross_products`` to keep the N-independent reduction
    precision through the whole component loop."""
    XX = jnp.asarray(XX, jnp.float32)
    XY = jnp.asarray(XY, jnp.float32)
    if XY.ndim == 1:
        XY = XY[:, None]
    XXl = jnp.zeros_like(XX) if XX_lo is None else jnp.asarray(XX_lo, jnp.float32)
    XYl = jnp.zeros_like(XY) if XY_lo is None else jnp.asarray(XY_lo, jnp.float32)
    return _fit_kernel_dd(None, XX, XXl, XY, XYl, None, A, False, power_iters)
