"""Sparse PLS — variable-selecting PLS via soft-thresholded weights
(Lê Cao et al. 2008, Stat. Appl. Genet. Mol. Biol. 7:35, the mixOmics
formulation; soft-thresholding per Shen & Huang 2008).

Capability extension beyond the reference (strictly dense).  Per
component, the X-weight (and optionally the Y-weight) is soft-thresholded
so that exactly `keep_x` (`keep_y`) variables survive — the "keepX"
interface of mixOmics — then X and Y are NIPALS-deflated.

Design notes:
- the alternating w/c inner iteration runs a FIXED number of steps
  (static `n_iter`, default 20 — convergence is typically <5 iterations),
  so the whole fit is a `lax.scan` over components with no data-dependent
  control flow;
- the keep→threshold conversion is a `jnp.sort` (top-k magnitude): the
  (keep+1)-th largest |w| becomes the soft threshold, so exactly `keep`
  coordinates survive (modulo exact ties);
- the direct-score weights R (T = X_orig R) are built with the same
  Gram–Schmidt recurrence as kernel PLS (r = w − Σ_{j<a}(pⱼᵀw) rⱼ —
  /root/reference/src/pls.cpp:414-416), which is exact for ANY rank-1
  X-deflation scheme, so the shared prediction stack (models/predict.py,
  B = R Qᵀ) applies unchanged.

With keep_x = K and keep_y = M this reduces exactly to classical NIPALS
PLS2 (property-tested).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.models.kernel_pls import _prec_ctx
from pls_tpu.types import METHOD, PLSFit


def _soft_keep(v: jnp.ndarray, keep: int) -> jnp.ndarray:
    """Soft-threshold v so that the `keep` largest-|v| coordinates survive.
    keep >= len(v) means no thresholding."""
    n = v.shape[0]
    if keep >= n:
        return v
    absv = jnp.abs(v)
    thr = jnp.sort(absv)[n - keep - 1]  # (keep+1)-th largest magnitude
    return jnp.sign(v) * jnp.maximum(absv - thr, 0.0)


@partial(jax.jit, static_argnames=("A", "keep_x", "keep_y", "n_iter", "precision"))
def fit_spls(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    keep_x: int | tuple[int, ...],
    keep_y: int | tuple[int, ...] | None = None,
    *,
    n_iter: int = 20,
    precision: str | None = "highest",
) -> PLSFit:
    """Fit an A-component sparse PLS model (regression mode).

    keep_x: number of X variables retained per component — a single int
      (same for every component) or a length-A tuple.
    keep_y: same for Y variables (default: all M, i.e. no Y sparsity).

    Returns a standard PLSFit (method=SPLS): W holds the sparse weights
    (use `selected_variables` for the support), and the whole prediction /
    CV / diagnostics stack applies unchanged.
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N, K = X.shape
    M = Y.shape[1]
    dtype = X.dtype
    kx = (keep_x,) * A if isinstance(keep_x, int) else tuple(keep_x)
    if keep_y is None:
        keep_y = M
    ky = (keep_y,) * A if isinstance(keep_y, int) else tuple(keep_y)
    if len(kx) != A or len(ky) != A:
        raise ValueError(f"keep_x/keep_y must have length A={A}")
    if min(kx) < 1 or min(ky) < 1:
        raise ValueError("keep_x/keep_y entries must be >= 1")

    # per-component keeps differ → unrolled Python loop over components
    # (A is static; each iteration is the same fused XLA program shape)
    with _prec_ctx(precision):
        Xd, Yd = X, Y
        Ws, Ps, Qs, Ts, Rs = [], [], [], [], []
        for a in range(A):
            u = Yd[:, 0]
            w = jnp.zeros((K,), dtype)
            c = jnp.zeros((M,), dtype)

            def inner(_, state, _kx=kx[a], _ky=ky[a]):
                w, c, u = state
                w = _soft_keep(Xd.T @ u, _kx)
                w = w / jnp.maximum(jnp.sqrt(w @ w), 1e-30)
                t = Xd @ w
                c = _soft_keep(Yd.T @ t, _ky)
                c = c / jnp.maximum(jnp.sqrt(c @ c), 1e-30)
                u = Yd @ c
                return (w, c, u)

            w, c, u = jax.lax.fori_loop(0, n_iter, inner, (w, c, u))
            t = Xd @ w
            tt = t @ t
            p = (Xd.T @ t) / tt
            q = (Yd.T @ t) / tt
            # exact direct-score weight: r = w − Σ_{j<a}(pⱼᵀw) rⱼ
            r = w
            for pj, rj in zip(Ps, Rs):
                r = r - (pj @ w) * rj
            Xd = Xd - jnp.outer(t, p)
            Yd = Yd - jnp.outer(t, q)
            Ws.append(w)
            Ps.append(p)
            Qs.append(q)
            Ts.append(t)
            Rs.append(r)

    return PLSFit(
        W=jnp.stack(Ws, axis=1),
        P=jnp.stack(Ps, axis=1),
        Q=jnp.stack(Qs, axis=1),
        R=jnp.stack(Rs, axis=1),
        T=jnp.stack(Ts, axis=1),
        method=METHOD.SPLS,
    )


def selected_variables(fit: PLSFit, comp: int | None = None) -> jnp.ndarray:
    """(K,) boolean mask of X variables with a nonzero weight in any of the
    first `comp` components (the sPLS support)."""
    c = fit.A if comp is None else int(comp)
    return jnp.any(fit.W[:, :c] != 0, axis=1)
