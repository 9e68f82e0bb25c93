"""OPLS — Orthogonal Projections to Latent Structures (Trygg & Wold 2002,
J. Chemometrics 16:119-128).

Capability extension beyond the reference (tjhladish/PLS has no OPLS; this
rounds out the chemometrics toolkit alongside NIPALS/SIMPLS — SURVEY.md §7
step 7).  OPLS splits X-variation into a part predictive of Y and a part
orthogonal to Y: per orthogonal component,

    w   = predictive weight of current X   (Xᵀy direction; M>1 via the
                                            dominant eigenvector of XYᵀXY)
    t   = X w ;  p = Xᵀt / tᵀt
    w_o = p − (wᵀp) w          (the Y-orthogonal part of the loading)
    t_o = X w_o ;  p_o = Xᵀt_o / t_oᵀt_o
    X  ← X − t_o p_oᵀ          (strip the orthogonal variation)

then fits an ordinary PLS model on the filtered X.  Prediction applies the
same sequential filter to new data before the predictive model.

Design: the orthogonal-component loop is a `lax.scan` carrying X
(static shapes; the two X-matvecs per step are the same streaming pattern
as the kernel-PLS hot loop and shard row-wise identically), and the filter
for new data is a second scan over the stored (w_o, p_o) pairs.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.models.kernel_pls import _prec_ctx, fit
from pls_tpu.models.predict import fitted_values
from pls_tpu.ops.eigen import dominant_eigenvector
from pls_tpu.types import METHOD, PLSFit


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class OPLSFit:
    """Immutable OPLS model state.

    W_o, P_o : (K, n_ortho) orthogonal weights / loadings
    T_o      : (N, n_ortho) orthogonal scores of the training data
    r2x_o    : (n_ortho,)   fraction of total X sum-of-squares removed by
                            each orthogonal component (diagnostic)
    pls      : predictive PLSFit on the orthogonality-filtered X
    """

    W_o: jax.Array
    P_o: jax.Array
    T_o: jax.Array
    r2x_o: jax.Array
    pls: PLSFit = field()

    @property
    def n_ortho(self) -> int:
        return self.W_o.shape[-1]


def _predictive_weight(X, Y, power_iters, M):
    XY = X.T @ Y
    if M == 1:
        w = XY[:, 0]
    else:
        w = XY @ dominant_eigenvector(XY.T @ XY, power_iters)
    return w / jnp.sqrt(w @ w)


@partial(jax.jit, static_argnames=("n_ortho", "power_iters", "precision"))
def _ortho_filter_fit(X, Y, n_ortho, power_iters, precision):
    N, K = X.shape
    M = Y.shape[1]
    ssx_total = jnp.sum(X * X)

    with _prec_ctx(precision):

        def step(Xc, _):
            w = _predictive_weight(Xc, Y, power_iters, M)
            t = Xc @ w
            p = (Xc.T @ t) / (t @ t)
            w_o = p - (w @ p) * w
            w_o = w_o / jnp.sqrt(w_o @ w_o)
            t_o = Xc @ w_o
            p_o = (Xc.T @ t_o) / (t_o @ t_o)
            Xc = Xc - jnp.outer(t_o, p_o)
            ssx_removed = (t_o @ t_o) * (p_o @ p_o)
            return Xc, (w_o, p_o, t_o, ssx_removed / ssx_total)

        Xf, (W_o, P_o, T_o, r2x) = jax.lax.scan(step, X, None, length=n_ortho)
    return Xf, W_o.T, P_o.T, T_o.T, r2x


def fit_opls(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    n_ortho: int,
    A: int = 1,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> OPLSFit:
    """Fit an OPLS model: `n_ortho` orthogonal components stripped from X,
    then an `A`-component predictive PLS fit (any METHOD) on the filtered X.

    X must be centered (z-scored, as for `fit`).  For the classic single-y
    OPLS of Trygg & Wold use A=1; the span of {predictive + orthogonal}
    scores then equals that of an (n_ortho+A)-component PLS model, so
    training-set predictions agree with plain PLS (tested) while the
    orthogonal variation is isolated and interpretable.
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    if X.shape[0] != Y.shape[0]:
        raise ValueError(f"X has {X.shape[0]} rows but Y has {Y.shape[0]}")
    if n_ortho < 0:
        raise ValueError(f"n_ortho={n_ortho} must be >= 0")

    Xf, W_o, P_o, T_o, r2x = _ortho_filter_fit(
        X, Y, n_ortho, power_iters, precision
    )
    pfit = fit(Xf, Y, A, method, power_iters=power_iters, precision=precision)
    return OPLSFit(W_o=W_o, P_o=P_o, T_o=T_o, r2x_o=r2x, pls=pfit)


@jax.jit
def correct(ofit: OPLSFit, X_new: jnp.ndarray):
    """Apply the orthogonal filter to new data.

    Returns (X_filtered, T_o_new): the Y-orthogonal variation is removed
    from X_new sequentially (component order matters — each w_o was
    derived from the X deflated by its predecessors), and the orthogonal
    scores are returned for diagnostics (e.g. DModX-style outlier checks).
    """
    X_new = jnp.asarray(X_new)

    def step(Xc, wp):
        w_o, p_o = wp
        t_o = Xc @ w_o
        return Xc - jnp.outer(t_o, p_o), t_o

    Xf, T_o = jax.lax.scan(step, X_new, (ofit.W_o.T, ofit.P_o.T))
    return Xf, T_o.T


def predict(
    ofit: OPLSFit, X_new: jnp.ndarray, comp: int | None = None
) -> jnp.ndarray:
    """Predicted Y for new X: orthogonal filter, then the predictive model."""
    Xf, _ = correct(ofit, X_new)
    return fitted_values(ofit.pls, Xf, comp)
