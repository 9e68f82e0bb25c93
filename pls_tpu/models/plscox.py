"""PLS-Cox: PLS dimension reduction for right-censored survival
outcomes — the two-stage formulation of Nguyen & Rocke (2002,
Bioinformatics 18:1625) with the component construction of Bastien &
Tenenhaus's PLS-Cox line of work:

  1. fit the NULL Cox model's Breslow cumulative hazard Λ₀(tᵢ) and form
     martingale residuals  Mᵢ = δᵢ − Λ₀(tᵢ)  (the survival analogue of
     a centered response);
  2. extract A ordinary PLS components of M on the standardized X
     (models/kernel_pls.py — all the batching/sharding machinery
     applies unchanged);
  3. fit a Cox proportional-hazards model on the A scores by Newton
     iterations on the Breslow partial likelihood (A is small, so the
     Hessian is an (A, A) solve per step).

The composite coefficient vector β = R γ (PLS rotation × Cox
coefficients on scores) gives a linear risk score η = Xβ for new
samples.  Typical genomics setting: K ≫ N, where a direct Cox fit is
impossible and ridge/lasso are the alternatives.

Design notes: the partial-likelihood terms need risk-set sums
Σ_{t_k ≥ t} f(k); with samples sorted by time these are suffix cumulative
sums — `jnp.cumsum` on reversed arrays, fully jittable (no Python over
risk sets, unlike classic implementations).  Ties are handled by the
Breslow approximation.  The Newton loop is a `lax.scan` with fixed
iteration count.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.models.kernel_pls import fit as _fit
from pls_tpu.types import KERNEL_TYPE1, PLSFit

__all__ = ["PLSCoxFit", "fit_plscox", "predict_plscox", "concordance_index"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PLSCoxFit:
    """Immutable PLS-Cox state.

    pls       : PLSFit of the martingale residuals on X (scores = X R)
    gamma     : (A,) Cox coefficients on the PLS scores
    coef      : (K,) composite risk coefficients β = R γ
    loglik    : () final Breslow partial log-likelihood
    score_norm: () ‖∂ℓ/∂γ‖∞ at the solution (convergence diagnostic)
    """

    pls: PLSFit
    gamma: jax.Array
    coef: jax.Array
    loglik: jax.Array
    score_norm: jax.Array


def _sort_by_time(time, event, *arrays):
    order = jnp.argsort(time)
    return (time[order], event[order]) + tuple(a[order] for a in arrays)


def _suffix_cumsum(v):
    """sᵢ = Σ_{j ≥ i} vⱼ along axis 0."""
    return jnp.flip(jnp.cumsum(jnp.flip(v, 0), axis=0), 0)


def _breslow_cumhaz(time_s, event_s, eta_s):
    """Breslow Λ₀ at each (sorted) sample's own time, tie-grouped."""
    w = jnp.exp(eta_s)
    risk = _suffix_cumsum(w)  # Σ_{t_k >= t_i} w_k at sorted position i
    # group ties: every member of a tie block must use the FIRST (largest)
    # risk-set sum of the block, and hazard increments accumulate per block
    first_of_block = jnp.concatenate(
        [jnp.array([True]), time_s[1:] != time_s[:-1]]
    )
    block_id = jnp.cumsum(first_of_block) - 1
    risk_first = risk[jnp.searchsorted(block_id, block_id, side="left")]
    # deaths per block spread over members → per-position increment uses
    # the block risk; increments happen once per death AT that time
    dLam = event_s / risk_first
    # cumulative hazard evaluated at each position's own time = cumsum of
    # all increments at times <= t_i (i.e. through the END of its block)
    cum = jnp.cumsum(dLam)
    last_of_block = jnp.concatenate(
        [time_s[1:] != time_s[:-1], jnp.array([True])]
    )
    idx_last = jnp.searchsorted(
        block_id, block_id, side="right"
    ) - 1
    return cum[idx_last]


def _cox_loglik_grad_hess(gamma, T_s, event_s, time_s):
    """Breslow partial log-likelihood, gradient, Hessian on scores T_s
    (sorted by time), all via suffix cumsums."""
    eta = T_s @ gamma
    w = jnp.exp(eta)[:, None]  # (N, 1)
    s0 = _suffix_cumsum(w)[:, 0]  # (N,)
    s1 = _suffix_cumsum(w * T_s)  # (N, A)
    s2 = _suffix_cumsum(w[:, :, None] * T_s[:, :, None] * T_s[:, None, :])
    # tie blocks share the block-first risk sums (Breslow)
    first = jnp.concatenate([jnp.array([True]), time_s[1:] != time_s[:-1]])
    block = jnp.cumsum(first) - 1
    fidx = jnp.searchsorted(block, block, side="left")
    s0b, s1b, s2b = s0[fidx], s1[fidx], s2[fidx]
    d = event_s
    ll = jnp.sum(d * (eta - jnp.log(s0b)))
    xbar = s1b / s0b[:, None]  # (N, A)
    grad = jnp.sum(d[:, None] * (T_s - xbar), axis=0)
    V = s2b / s0b[:, None, None] - xbar[:, :, None] * xbar[:, None, :]
    hess = -jnp.sum(d[:, None, None] * V, axis=0)
    return ll, grad, hess


@partial(jax.jit, static_argnames=("A", "n_newton", "precision"))
def _fit_plscox(X, time, event, A, n_newton, precision):
    time = jnp.asarray(time)
    event = jnp.asarray(event, X.dtype).reshape(-1)
    time_s, event_s, X_s = _sort_by_time(time, event, X)

    # stage 1: null-model martingale residuals
    lam0 = _breslow_cumhaz(time_s, event_s, jnp.zeros_like(time_s, X.dtype))
    M = event_s - lam0  # (N,) martingale residuals, mean ~0

    # stage 2: PLS of M on X
    f = _fit(X_s, (M - jnp.mean(M))[:, None], A, KERNEL_TYPE1,
             precision=precision)
    T_s = X_s @ f.R  # (N, A) scores, sorted by time

    # stage 3: Newton on the Breslow partial likelihood over the scores
    def newton(gamma, _):
        ll, g, H = _cox_loglik_grad_hess(gamma, T_s, event_s, time_s)
        step = jnp.linalg.solve(H - 1e-10 * jnp.eye(A, dtype=X.dtype), g)
        return gamma - step, None

    gamma0 = jnp.zeros((A,), X.dtype)
    gamma, _ = jax.lax.scan(newton, gamma0, None, length=n_newton)
    ll, g, _ = _cox_loglik_grad_hess(gamma, T_s, event_s, time_s)
    return PLSCoxFit(
        pls=f,
        gamma=gamma,
        coef=f.R @ gamma,
        loglik=ll,
        score_norm=jnp.max(jnp.abs(g)),
    )


def fit_plscox(
    X,
    time,
    event,
    A: int = 2,
    *,
    n_newton: int = 20,
    precision: str | None = "highest",
) -> PLSCoxFit:
    """Fit a PLS-Cox survival model.

    X: (N, K) standardized covariates; time: (N,) follow-up times;
    event: (N,) 1 = event observed, 0 = right-censored; A: number of PLS
    components (keep small — they're Cox covariates in stage 3)."""
    X = jnp.asarray(X)
    time = jnp.asarray(time)
    event = jnp.asarray(event).reshape(-1)
    if X.shape[0] != time.shape[0]:
        raise ValueError("X and time disagree on N")
    if event.shape[0] != time.shape[0]:
        # must be validated HERE: inside jit the event[order] gather would
        # silently clamp out-of-range indices and train on garbage
        raise ValueError("event and time disagree on N")
    if not (1 <= A <= X.shape[1]):
        raise ValueError(f"A={A} out of range")
    return _fit_plscox(X, time, event, A, int(n_newton), precision)


def predict_plscox(fit: PLSCoxFit, X_new) -> jnp.ndarray:
    """Linear risk score η = X β (higher = higher hazard)."""
    return jnp.asarray(X_new) @ fit.coef


def concordance_index(time, event, risk) -> float:
    """Harrell's C-index of a risk score (higher risk should fail
    earlier).  O(N²) pairwise — fine for evaluation-sized N."""
    import numpy as np

    t = np.asarray(time)
    d = np.asarray(event).astype(bool)
    r = np.asarray(risk)
    num = den = 0.0
    comparable = (t[:, None] < t[None, :]) & d[:, None]
    num = np.sum(comparable * (r[:, None] > r[None, :])) + 0.5 * np.sum(
        comparable * (r[:, None] == r[None, :])
    )
    den = np.sum(comparable)
    return float(num / den) if den else 0.5
