"""PLS-GLM: PLS regression for generalized-linear responses (logistic /
Poisson) — Bastien, Esposito Vinzi & Tenenhaus (2005), "PLS generalised
linear regression", Comput. Stat. Data Anal. 48:17, in the iteratively
reweighted formulation (Marx 1996 IRPLS).

Capability extension beyond the reference (least-squares only): binary
or count responses need a link function, and ordinary PLS on 0/1 labels
(PLS-DA) is a classifier heuristic, not a likelihood model.  PLS-GLM
embeds the PLS dimension reduction inside GLM IRLS:

    repeat n_irls times:
        η  = offset + current linear predictor
        μ  = g⁻¹(η)               (inverse link)
        W  = working weights       (μ(1−μ) binomial; μ poisson)
        z  = η + (y − μ)/W         (working response)
        fit A-component **weighted** PLS of z on X with sample_weight W
        η  = PLS fitted values

At convergence the coefficients are a rank-A GLM estimate: with A = K
(full rank) this IS Fisher scoring, so it matches an unregularized GLM
(tested against sklearn's LogisticRegression); with A < K the PLS
truncation regularizes exactly the way PLS does for least squares.

Design: the IRLS loop is a `lax.scan` whose body is the jitted
weighted kernel fit (the same sample_weight path the robust and
bootstrap modules ride) — one XLA program, no host round trips.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.models.kernel_pls import fit as _fit
from pls_tpu.models.predict import coefficients
from pls_tpu.types import KERNEL_TYPE1, METHOD, PLSFit

__all__ = ["PLSGLMFit", "fit_plsglm", "predict_plsglm"]

_EPS = 1e-6


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PLSGLMFit:
    """Immutable PLS-GLM state.

    pls       : the final weighted PLSFit (on centered X, working scale)
    coef      : (K,) coefficients on the standardized X scale
    intercept : () linear-predictor intercept
    deviance  : () final model deviance
    family    : 'binomial' | 'poisson' (static)
    """

    pls: PLSFit
    coef: jax.Array
    intercept: jax.Array
    deviance: jax.Array
    family: str = field(metadata=dict(static=True), default="binomial")


def _inv_link(eta, family):
    if family == "binomial":
        return jax.nn.sigmoid(eta)
    return jnp.exp(jnp.clip(eta, -30.0, 30.0))  # poisson


def _deviance(y, mu, family):
    if family == "binomial":
        ll = y * jnp.log(jnp.clip(mu, _EPS, 1.0)) + (1 - y) * jnp.log(
            jnp.clip(1 - mu, _EPS, 1.0)
        )
        return -2.0 * jnp.sum(ll)
    # poisson (dropping the data-only y! term, standard deviance form)
    term = jnp.where(y > 0, y * jnp.log(jnp.clip(y / mu, _EPS, None)), 0.0)
    return 2.0 * jnp.sum(term - (y - mu))


@partial(
    jax.jit,
    static_argnames=("A", "method", "family", "n_irls", "precision"),
)
def fit_plsglm(
    X: jnp.ndarray,
    y: jnp.ndarray,
    A: int,
    family: str = "binomial",
    method: METHOD = KERNEL_TYPE1,
    *,
    n_irls: int = 25,
    precision: str | None = "highest",
) -> PLSGLMFit:
    """Fit a PLS-GLM.

    X: (N, K) predictors, centered/standardized by the caller (as for
       `fit`); y: (N,) binary {0,1} labels (binomial) or counts (poisson).
    A: PLS components per IRLS step (A=K reproduces full Fisher scoring /
       an unregularized GLM — tested).
    """
    if family not in ("binomial", "poisson"):
        raise ValueError(f"unknown family {family!r}")
    X = jnp.asarray(X)
    y = jnp.asarray(y, X.dtype).reshape(-1)
    N, K = X.shape

    ybar = jnp.clip(jnp.mean(y), _EPS, None)
    if family == "binomial":
        ybar = jnp.clip(ybar, _EPS, 1 - _EPS)
        eta0 = jnp.log(ybar / (1 - ybar))
    else:
        eta0 = jnp.log(ybar)

    def irls_once(eta):
        mu = _inv_link(eta, family)
        if family == "binomial":
            w = jnp.clip(mu * (1 - mu), _EPS, None)
        else:
            w = jnp.clip(mu, _EPS, None)
        z = eta + (y - mu) / w
        # weighted least squares of z on [1, X]: the intercept is the
        # weighted mean of z minus the fit at the weighted X-mean; fold it
        # out by weighted-centering both sides (X is caller-centered but
        # the WEIGHTED mean is nonzero once w varies).
        sw = jnp.sum(w)
        xbar = (w @ X) / sw
        zbar = (w @ z) / sw
        f = _fit(
            X - xbar[None, :], (z - zbar)[:, None], A, method,
            sample_weight=w, precision=precision,
        )
        b = coefficients(f)[:, 0]
        b0 = zbar - xbar @ b
        return f, b, b0, b0 + X @ b

    # first IRLS step outside the scan (gives the carry its PLSFit
    # structure); the stored fit is CARRIED so pls/coef/intercept/eta all
    # describe the same final iterate — no trailing half-step refit
    f, b, b0, eta = irls_once(jnp.full((N,), eta0, X.dtype))

    def step(carry, _):
        eta, _, _, _ = carry
        f, b, b0, eta_new = irls_once(eta)
        return (eta_new, f, b, b0), None

    (eta, f, b, b0), _ = jax.lax.scan(
        step, (eta, f, b, b0), None, length=max(n_irls - 1, 0)
    )
    mu = _inv_link(eta, family)
    return PLSGLMFit(
        pls=f, coef=b, intercept=b0,
        deviance=_deviance(y, mu, family), family=family,
    )


def predict_plsglm(
    fit: PLSGLMFit, X_new: jnp.ndarray, *, linear: bool = False
) -> jnp.ndarray:
    """Predicted mean response (probability / rate) for new standardized
    X; `linear=True` returns the linear predictor η instead."""
    eta = fit.intercept + jnp.asarray(X_new) @ fit.coef
    return eta if linear else _inv_link(eta, fit.family)
