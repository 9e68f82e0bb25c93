"""Prediction and diagnostics on a fitted PLS model.

Reference analogues — upstream src/pls.cpp:439-467:
  scores(Xn, c)        = Xn · R[:, :c]
  coefficients(c)      = R[:, :c] · Q[:, :c]ᵀ
  fitted_values(Xn, c) = Xn · B(c)
  residuals(Xn, Yn, c) = Yn − Ŷ
  SSE                  = colwise squared norm of residuals
  explained_variance   = 1 − SSE / SST(Yn)
plus loadings_x / loadings_y, which the reference *declares* but never
defines (/root/reference/include/PLS/pls.h:207-211 — a link error if
called; gap closed here).

`residuals_all_components` is the vectorized workhorse the reference
lacks: because Ŷ(c) = Σ_{j<c} (Xn rⱼ) qⱼᵀ is a prefix sum over components,
residuals for *every* truncation 1..A come from one matmul plus a cumsum —
O(n·A·M) instead of A separate predictions.  All cross-validators are
built on it.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pls_tpu.ops.stats import sst
from pls_tpu.types import PLSFit


def _mm(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """a @ b at HIGHEST precision: at the default precision an NVIDIA GPU
    rounds f32 operands to TF32 (~1e-4 relative error in every product
    with the data or the model)."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _check_comp(fit: PLSFit, comp: int | None) -> int:
    """Resolve/validate a truncation count (the reference asserts
    A >= comp, pls.cpp:440,445 — silent clipping would mislabel results)."""
    if comp is None:
        return fit.A
    if not (0 < comp <= fit.A):
        raise ValueError(f"comp={comp} outside 1..A={fit.A}")
    return comp


def scores(fit: PLSFit, X_new: jnp.ndarray, comp: int | None = None) -> jnp.ndarray:
    """Latent-space scores T = Xn · R[:, :comp] (reference pls.cpp:439-442)."""
    comp = _check_comp(fit, comp)
    return _mm(X_new, fit.R[:, :comp])


def loadings_x(fit: PLSFit, comp: int | None = None) -> jnp.ndarray:
    """X loadings P[:, :comp] (declared-but-undefined in the reference,
    pls.h:207-208)."""
    comp = _check_comp(fit, comp)
    return fit.P[:, :comp]


def loadings_y(fit: PLSFit, comp: int | None = None) -> jnp.ndarray:
    """Y loadings Q[:, :comp] (declared-but-undefined in the reference,
    pls.h:210-211)."""
    comp = _check_comp(fit, comp)
    return fit.Q[:, :comp]


def coefficients(fit: PLSFit, comp: int | None = None) -> jnp.ndarray:
    """Regression coefficients B = R[:, :c] · Q[:, :c]ᵀ, (K, M)
    (reference pls.cpp:444-447)."""
    comp = _check_comp(fit, comp)
    return _mm(fit.R[:, :comp], fit.Q[:, :comp].T)


def fitted_values(
    fit: PLSFit, X_new: jnp.ndarray, comp: int | None = None
) -> jnp.ndarray:
    """Ŷ = Xn · B (reference pls.cpp:449-451)."""
    return _mm(X_new, coefficients(fit, comp))


def residuals(
    fit: PLSFit, X_new: jnp.ndarray, Y_new: jnp.ndarray, comp: int | None = None
) -> jnp.ndarray:
    """Yn − Ŷ (reference pls.cpp:453-455)."""
    return Y_new - fitted_values(fit, X_new, comp)


def residuals_all_components(
    fit: PLSFit, X_new: jnp.ndarray, Y_new: jnp.ndarray
) -> jnp.ndarray:
    """Residuals for every component truncation 1..A in one pass.

    Returns (n, A, M): residual of observation i under the c-component
    sub-model at [:, c-1, :].  Uses the prefix-sum identity
    Ŷ(c) = Σ_{j<c} sⱼ qⱼᵀ with s = Xn R.
    """
    S = _mm(X_new, fit.R)  # (n, A)
    contrib = S[:, :, None] * fit.Q.T[None, :, :]  # (n, A, M)
    fitted_cum = jnp.cumsum(contrib, axis=1)  # (n, A, M)
    return Y_new[:, None, :] - fitted_cum


def coefficients_all_components(fit: PLSFit) -> jnp.ndarray:
    """Coefficients for EVERY truncation 1..A in one pass: (A, K, M)
    with B(c) = Σ_{j<c} rⱼ qⱼᵀ at [c-1] (prefix sums of the rank-1
    contributions; one A-fit serves every sub-model, reference
    pls.cpp:444-447 + the sequential-components property)."""
    contrib = fit.R.T[:, :, None] * fit.Q.T[:, None, :]  # (A, K, M)
    return jnp.cumsum(contrib, axis=0)


def vip(
    fit: PLSFit, X: jnp.ndarray | None = None, comp: int | None = None
) -> jnp.ndarray:
    """Variable Importance in Projection, (K,).

    Not in the reference; the standard chemometrics screening statistic:
        VIPⱼ = sqrt( K · Σₐ SSYₐ (wⱼₐ/‖wₐ‖)² / Σₐ SSYₐ ),
    with SSYₐ = ‖qₐ‖² tₐᵀtₐ the Y-variance captured by component a
    (our Q columns are regression loadings: Ŷ = Σ tₐ qₐᵀ).  Mean of VIP²
    is 1 by construction; variables with VIP < 1 are candidates to drop.

    Needs the scores T; for fits without stored T (KERNEL_TYPE2 /
    from-stats) pass the training X so T = X R can be formed.
    """
    comp = _check_comp(fit, comp)
    if fit.T.size:
        T = fit.T[:, :comp]
    else:
        if X is None:
            raise ValueError(
                "fit has no stored scores (type-2/from-stats); pass X"
            )
        T = _mm(X, fit.R[:, :comp])
    tt = jnp.sum(T * T, axis=0)  # (comp,)
    qq = jnp.sum(fit.Q[:, :comp] ** 2, axis=0)  # (comp,)
    ssy = tt * qq
    W = fit.W[:, :comp]
    wnorm2 = jnp.sum(W * W, axis=0)
    frac = (W * W) / wnorm2[None, :]
    K = fit.K
    return jnp.sqrt(K * (frac @ ssy) / jnp.sum(ssy))


def target_projection(
    fit: PLSFit, X: jnp.ndarray, comp: int | None = None, y_col: int = 0
):
    """Target projection (Kvalheim & Karstang 1989, Chemom. Intell. Lab.
    Syst. 7:39): rotate the PLS solution onto the single predictive
    direction for one response.

        w_TP = b / ‖b‖   (b = regression coefficients for response y_col)
        t_TP = X w_TP ;  p_TP = Xᵀ t_TP / (t_TPᵀ t_TP)

    Returns (t_TP (N,), p_TP (K,)).  X must be the (centered) training
    matrix the fit was built on."""
    comp = _check_comp(fit, comp)
    b = coefficients(fit, comp)[:, y_col]
    w_tp = b / jnp.sqrt(b @ b)
    t_tp = _mm(X, w_tp)
    p_tp = _mm(X.T, t_tp) / (t_tp @ t_tp)
    return t_tp, p_tp


def selectivity_ratio(
    fit: PLSFit, X: jnp.ndarray, comp: int | None = None, y_col: int = 0
) -> jnp.ndarray:
    """Selectivity ratio per variable (Rajalahti et al. 2009, Chemom.
    Intell. Lab. Syst. 95:35), (K,):

        SRⱼ = ‖t_TP p_TP,ⱼ‖² / ‖xⱼ − t_TP p_TP,ⱼ‖²

    — explained over residual variance of each X column under the
    target-projection model.  Larger = more selective for the response;
    an F-test on SR is the usual discriminating-variable screen (a
    sharper alternative to VIP)."""
    t_tp, p_tp = target_projection(fit, X, comp, y_col)
    tt = t_tp @ t_tp
    ss_exp = tt * p_tp**2  # (K,)
    resid = X - jnp.outer(t_tp, p_tp)
    ss_res = jnp.sum(resid * resid, axis=0)
    return ss_exp / jnp.where(ss_res == 0, jnp.ones_like(ss_res), ss_res)


def sse(
    fit: PLSFit, X_new: jnp.ndarray, Y_new: jnp.ndarray, comp: int | None = None
) -> jnp.ndarray:
    """Column-wise sum of squared residuals, (M,) (reference pls.cpp:457-459)."""
    r = residuals(fit, X_new, Y_new, comp)
    return jnp.sum(r * r, axis=0)


def explained_variance(
    fit: PLSFit, X_new: jnp.ndarray, Y_new: jnp.ndarray, comp: int | None = None
) -> jnp.ndarray:
    """1 − SSE/SST per response, (M,) (reference pls.cpp:461-467).

    SST uses Y_new's own column means, exactly as the reference calls
    `SST(Y_new)`."""
    return 1.0 - sse(fit, X_new, Y_new, comp) / sst(Y_new)
