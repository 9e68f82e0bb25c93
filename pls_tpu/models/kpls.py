"""Nonlinear kernel PLS (dual / Gram-matrix PLS) — Rosipal & Trejo 2001,
"Kernel Partial Least Squares Regression in RKHS", JMLR 2:97-123.

Capability extension beyond the reference (which is strictly linear).
Works in the dual: an N×N Gram matrix Kg[i,j] = k(xᵢ, xⱼ) replaces X, so
nonlinear feature maps (RBF, polynomial) come for free and the component
loop is independent of K (the number of predictors) — the natural regime
for K ≫ N spectra or explicit feature engineering.

Per component (NIPALS fixed point, computed directly instead of iterated):
    c  = dominant eigenvector of the M×M symmetric PSD matrix Yᵀ Kc Y
    t  = Kc Y c, normalized            (score — the fixed point of the
                                        t → Kc Y Yᵀ t iteration)
    u  = Y c                           (Y-space score)
    Kc ← (I − ttᵀ) Kc (I − ttᵀ) ;  Y ← Y − t (tᵀY)       (deflation)

Prediction (paper eq. 12): Ŷ = K̃_test · U (Tᵀ Kc₀ U)⁻¹ Tᵀ Y₀ with Kc₀ the
centered training Gram matrix and K̃_test the test kernel centered against
the training distribution.

Design notes: the Gram build is one (n, K) × (K, N) matmul; the
component loop is a `lax.scan` over the N×N carry (two rank-1-bordered
GEMMs per step); everything is static-shaped and jit-compiled.  Cost is
O(N²) memory — the right tool for N up to a few thousand; for tall-N
linear problems use the primal kernel algorithms (models/kernel_pls.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.models.kernel_pls import _prec_ctx
from pls_tpu.ops.eigen import dominant_eigenvector


def kernel_matrix(
    X1: jnp.ndarray,
    X2: jnp.ndarray,
    kernel: str = "rbf",
    *,
    gamma: float | None = None,
    degree: int = 3,
    coef0: float = 1.0,
) -> jnp.ndarray:
    """(n1, n2) Gram matrix between rows of X1 and X2.

    kernel: "linear" (x·z), "poly" ((γ x·z + coef0)^degree),
    "rbf" (exp(−γ ‖x−z‖²)).  gamma defaults to 1/K (sklearn's "auto").
    """
    X1 = jnp.asarray(X1)
    X2 = jnp.asarray(X2)
    if gamma is None:
        gamma = 1.0 / X1.shape[1]
    if kernel == "linear":
        return X1 @ X2.T
    if kernel == "poly":
        return (gamma * (X1 @ X2.T) + coef0) ** degree
    if kernel == "rbf":
        sq = (
            jnp.sum(X1 * X1, axis=1)[:, None]
            - 2.0 * (X1 @ X2.T)
            + jnp.sum(X2 * X2, axis=1)[None, :]
        )
        return jnp.exp(-gamma * jnp.maximum(sq, 0.0))
    raise ValueError(f"unknown kernel {kernel!r}")


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class KPLSFit:
    """Dual-space PLS state.

    T, U   : (N, A) kernel-space / Y-space score matrices
    Kg     : (N, N) UNcentered training Gram matrix (needed to center
             test kernels against the training distribution)
    Y      : (N, M) training responses (pre-centered by the caller)
    X      : (N, K) training predictors (for building test kernels)
    kernel hyper-parameters are static aux data.
    """

    T: jax.Array
    U: jax.Array
    Kg: jax.Array
    Y: jax.Array
    X: jax.Array
    kernel: str = field(metadata=dict(static=True), default="rbf")
    gamma: float | None = field(metadata=dict(static=True), default=None)
    degree: int = field(metadata=dict(static=True), default=3)
    coef0: float = field(metadata=dict(static=True), default=1.0)

    @property
    def A(self) -> int:
        return self.T.shape[-1]


def _center_train(Kg):
    rm = jnp.mean(Kg, axis=1, keepdims=True)
    cm = jnp.mean(Kg, axis=0, keepdims=True)
    gm = jnp.mean(Kg)
    return Kg - rm - cm + gm


def _center_test(Kt, Kg):
    """Center a test kernel block against the training distribution:
    K̃_t = (Kt − (1/N)1 1ᵀKg)(I − (1/N)11ᵀ)."""
    n_mean = jnp.mean(Kg, axis=0, keepdims=True)  # (1, N) col means of Kg
    A = Kt - n_mean
    return A - jnp.mean(A, axis=1, keepdims=True)


@partial(jax.jit, static_argnames=("A", "power_iters", "precision"))
def _kpls_scan(Kc, Y, A, power_iters, precision):
    M = Y.shape[1]

    with _prec_ctx(precision):

        def step(carry, _):
            Kd, Yd = carry
            if M == 1:
                t = Kd @ Yd[:, 0]
            else:
                C = Yd.T @ (Kd @ Yd)
                c = dominant_eigenvector(C, power_iters)
                t = Kd @ (Yd @ c)
            t = t / jnp.sqrt(t @ t)
            u = Yd @ (Yd.T @ t)  # Y-space score for the SAME component
            # deflate: Kd ← (I − ttᵀ) Kd (I − ttᵀ);  Yd ← Yd − t tᵀYd
            Kt_ = Kd - jnp.outer(t, t @ Kd)
            Kd = Kt_ - jnp.outer(Kt_ @ t, t)
            Yd = Yd - jnp.outer(t, t @ Yd)
            return (Kd, Yd), (t, u)

        (_, _), (Ts, Us) = jax.lax.scan(step, (Kc, Y), None, length=A)
    return Ts.T, Us.T


def fit_kpls(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    kernel: str = "rbf",
    *,
    gamma: float | None = None,
    degree: int = 3,
    coef0: float = 1.0,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> KPLSFit:
    """Fit an A-component kernel PLS model.  Y must be centered (as for
    `fit`); X need not be centered — the Gram matrix is feature-space
    centered internally."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    if not (0 < A < N):
        raise ValueError(f"A={A} must satisfy 0 < A < N={N}")
    Kg = kernel_matrix(X, X, kernel, gamma=gamma, degree=degree, coef0=coef0)
    T, U = _kpls_scan(_center_train(Kg), Y, A, power_iters, precision)
    return KPLSFit(
        T=T, U=U, Kg=Kg, Y=Y, X=X,
        kernel=kernel, gamma=gamma, degree=degree, coef0=coef0,
    )


def predict_kpls(
    fit: KPLSFit, X_new: jnp.ndarray, comp: int | None = None
) -> jnp.ndarray:
    """Predicted Y for new X (Rosipal & Trejo eq. 12), at component
    truncation `comp` (default: all A)."""
    c = fit.A if comp is None else int(comp)
    if not (0 < c <= fit.A):
        raise ValueError(f"comp={c} out of range 1..{fit.A}")
    Tc = fit.T[:, :c]
    Uc = fit.U[:, :c]
    Kc0 = _center_train(fit.Kg)
    Kt = kernel_matrix(
        jnp.asarray(X_new), fit.X, fit.kernel,
        gamma=fit.gamma, degree=fit.degree, coef0=fit.coef0,
    )
    Ktc = _center_test(Kt, fit.Kg)
    # dual coefficients: U (Tᵀ Kc₀ U)⁻¹ Tᵀ Y
    G = Tc.T @ (Kc0 @ Uc)
    rhs = Tc.T @ fit.Y
    return Ktc @ (Uc @ jnp.linalg.solve(G, rhs))
