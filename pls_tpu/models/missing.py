"""Missing-data PLS: NaN-tolerant NIPALS and iterative PLS imputation.

The reference cannot represent missing values at all (its CSV reader
`stod`-parses every cell and its algebra is dense — /root/reference/
src/pls.cpp:37-67); real spectroscopic/industrial data routinely has
gaps, so a production framework needs both:

1. `fit_nipals_missing` — the classical missing-data NIPALS (Wold;
   analysis in Nelson, Taylor & MacGregor 1996, "Missing data methods in
   PCA and PLS"): every inner regression is computed over the *present*
   entries only.  With mask m (1 = observed) and zero-filled data the
   per-component updates stay dense matmuls:

       w = (Xdᵀ u)  / (mXᵀ u²)        (elementwise quotient over K)
       t = (Xd w)   / (mX  w²)        (over N)
       q = (Ydᵀ t)  / (mYᵀ t²)        (over M)
       p = (Xdᵀ t)  / (mXᵀ t²)
       deflate:  Xd ← mX ∘ (Xd − t pᵀ),  Yd ← mY ∘ (Yd − t qᵀ)

   — each a matmul pair (data and mask), so missing support costs exactly
   2× the dense NIPALS FLOPs and stays jit/vmap/shard-friendly.  With no
   missing entries every denominator equals the dense one (mᵀv² = Σv²
   after w-normalization) and the fit reduces EXACTLY to `fit_nipals`
   (property-tested).

2. `impute_pls` — EM-style imputation: alternate a dense fit on the
   current completion with replacing the missing entries by the model
   reconstruction X̂ = T Pᵀ (in centered coordinates).  Converges to a
   self-consistent completion; the final dense fit is returned alongside.

`nan_column_stats` provides the NaN-aware mean/stdev needed to z-score
gappy data (unbiased N−1 over the per-column present counts, with the
zero-stdev guard of ops/stats.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.types import METHOD, PLSFit


def nan_column_stats(X: jnp.ndarray) -> tuple[jnp.ndarray, jnp.ndarray]:
    """(mean, stdev) per column over present entries only.

    Unbiased (count−1) stdev, like ops/stats.colwise_stdev; columns with
    fewer than 2 present values or zero variance get stdev 1 (the
    zero-guard the reference intended — SURVEY.md component #5).
    """
    m = jnp.isfinite(X)
    X0 = jnp.where(m, X, 0.0)
    cnt = jnp.sum(m, axis=0)
    mean = jnp.sum(X0, axis=0) / jnp.maximum(cnt, 1)
    dev = jnp.where(m, X0 - mean[None, :], 0.0)
    var = jnp.sum(dev * dev, axis=0) / jnp.maximum(cnt - 1, 1)
    sd = jnp.sqrt(var)
    sd = jnp.where((cnt < 2) | (sd == 0), 1.0, sd)
    return mean, sd


def _masked(X):
    m = jnp.isfinite(X)
    return m.astype(X.dtype), jnp.where(m, X, 0.0)


@partial(jax.jit, static_argnames=("A", "max_iter"))
def fit_nipals_missing(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    *,
    tol: float = 1e-12,
    max_iter: int = 500,
) -> PLSFit:
    """NaN-tolerant NIPALS PLS2.  X (N,K) / Y (N,M) may contain NaNs
    (pre-centered/scaled, e.g. via `nan_column_stats`); returns a standard
    `PLSFit` usable with the whole predict/CV stack on complete new data.
    """
    N, K = X.shape
    M = Y.shape[1]
    dtype = X.dtype
    eps = jnp.finfo(dtype).tiny
    mX, X0 = _masked(X)
    mY, Y0 = _masked(Y)

    def component(carry, _):
        Xd, Yd = carry
        u0 = Yd[:, 0]

        def inner(state):
            w_prev, u, it, _ = state
            w = (Xd.T @ u) / (mX.T @ (u * u) + eps)
            w = w / jnp.sqrt(w @ w)
            t = (Xd @ w) / (mX @ (w * w) + eps)
            qn = (Yd.T @ t) / (mY.T @ (t * t) + eps)
            qn = qn / jnp.sqrt(qn @ qn)
            u_new = (Yd @ qn) / (mY @ (qn * qn) + eps)
            delta = jnp.sqrt(jnp.sum((w - w_prev) ** 2))
            return (w, u_new, it + 1, delta)

        def cond(state):
            _w, _u, it, delta = state
            return jnp.logical_and(it < max_iter, delta > tol)

        w0 = jnp.zeros((K,), dtype)
        w, _u, _, _ = jax.lax.while_loop(
            cond, inner, (w0, u0, jnp.array(0), jnp.array(jnp.inf, dtype))
        )
        t = (Xd @ w) / (mX @ (w * w) + eps)
        p = (Xd.T @ t) / (mX.T @ (t * t) + eps)
        q = (Yd.T @ t) / (mY.T @ (t * t) + eps)
        Xd = mX * (Xd - jnp.outer(t, p))
        Yd = mY * (Yd - jnp.outer(t, q))
        return (Xd, Yd), (w, p, q, t)

    (_, _), (Ws, Ps, Qs, Ts) = jax.lax.scan(component, (X0, Y0), None, length=A)
    W, P, Q, T = Ws.T, Ps.T, Qs.T, Ts.T
    R = W @ jnp.linalg.pinv(P.T @ W)
    return PLSFit(W=W, P=P, Q=Q, R=R, T=T, method=METHOD.NIPALS)


def scores_missing(fit: PLSFit, X_new: jnp.ndarray) -> jnp.ndarray:
    """Scores of new data that may itself contain NaNs.

    Sequential single-component projections with per-sample present-entry
    denominators and interleaved deflation (the standard way to score a
    gappy sample against a fitted model)."""
    m, X0 = _masked(jnp.asarray(X_new))

    def step(Xd, a):
        w, p = fit.W[:, a], fit.P[:, a]
        t = (Xd @ w) / (m @ (w * w) + jnp.finfo(Xd.dtype).tiny)
        Xd = m * (Xd - jnp.outer(t, p))
        return Xd, t

    _, ts = jax.lax.scan(step, X0, jnp.arange(fit.A))
    return ts.T  # (n, A)


def predict_missing(fit: PLSFit, X_new: jnp.ndarray) -> jnp.ndarray:
    """Ŷ for (possibly gappy) new data: masked scores × y-loadings."""
    return scores_missing(fit, X_new) @ fit.Q.T


@partial(jax.jit, static_argnames=("A", "n_outer", "method"))
def impute_pls(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    *,
    n_outer: int = 30,
    method: METHOD = METHOD.NIPALS,
) -> tuple[jnp.ndarray, PLSFit]:
    """EM-style completion of missing X entries against a PLS model.

    Starts from column-mean imputation, then alternates a dense NIPALS
    fit with replacing the missing entries by the reconstruction T Pᵀ.
    X/Y are assumed centered/scaled (NaNs only in X).  Returns
    (X_completed, final dense fit).
    """
    from pls_tpu.models.nipals import fit_nipals

    del method  # NIPALS reconstruction is the one with X-deflation geometry
    m = jnp.isfinite(X)
    Xc = jnp.where(m, X, 0.0)  # centered data ⇒ mean imputation = 0-fill

    def outer(Xc, _):
        f = fit_nipals(Xc, Y, A)
        Xhat = f.T @ f.P.T
        Xc = jnp.where(m, Xc, Xhat)
        return Xc, None

    Xc, _ = jax.lax.scan(outer, Xc, None, length=n_outer)
    return Xc, fit_nipals(Xc, Y, A)
