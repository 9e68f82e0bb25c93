"""O2PLS — bidirectional orthogonal PLS (Trygg 2003, J. Chemometrics
17:53-64; algorithm as consolidated in el Bouhaddani et al. 2016, BMC
Bioinformatics 17:S11 / the OmicsPLS R package's `o2m`).

Capability extension beyond the reference: O2PLS decomposes TWO data
blocks symmetrically into a joint part (X↔Y covariation), block-specific
orthogonal parts, and noise:

    X = T Wᵀ + T_Yosc P_Yoscᵀ + E        Y = U Cᵀ + U_Xosc Q_Xoscᵀ + F

with inner relations U ≈ T B_T and T ≈ U B_U, so prediction runs in BOTH
directions (Ŷ from X, X̂ from Y) — the data-integration workhorse for
paired omics blocks, where OPLS (models/opls.py) only filters X.

Algorithm (nx X-orthogonal, ny Y-orthogonal, n joint components):
  repeat nx times:  W ← svdₙ(XᵀY).u ;  T ← XW ;  E ← X − TWᵀ
                    w⊥ ← dominant left singular vector of EᵀT
                    t⊥ ← Xw⊥ ;  p⊥ ← Xᵀt⊥/t⊥ᵀt⊥ ;  X ← X − t⊥p⊥ᵀ
  repeat ny times:  symmetric on Y with F = Y − UCᵀ, FᵀU
  finally:          W, C ← svdₙ(XᵀY) on the filtered blocks; T = XW,
                    U = YC;  B_T = (TᵀT)⁻¹TᵀU;  B_U = (UᵀU)⁻¹UᵀT

Design notes: the only large contractions are XᵀY (one all-reduce
when row-sharded, like the kernel-PLS fit) and the X/Y matvecs; the
dominant left singular vector of the skinny EᵀT (K×n) is computed via
the n×n Gram matrix + ops/eigen.dominant_eigenvector — no K×K work.
The svdₙ(XᵀY) runs on a (K, M) matrix, independent of N.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.models.kernel_pls import _prec_ctx
from pls_tpu.ops.eigen import dominant_eigenvector

__all__ = ["O2PLSFit", "fit_o2pls", "predict_y", "predict_x", "transform"]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class O2PLSFit:
    """Immutable O2PLS model state.

    Joint:      W (K, n), C (M, n), scores T = X_f W, U = Y_f C on the
                filtered training blocks; inner regressions B_T, B_U (n, n).
    X-orth:     W_Yosc, P_Yosc (K, nx), scores T_Yosc (N, nx).
    Y-orth:     C_Xosc, Q_Xosc (M, ny), scores U_Xosc (N, ny).
    Diagnostics: r2 dict-like fields — fractions of each block's total
                sum of squares captured by the joint and orthogonal parts.
    """

    W: jax.Array
    C: jax.Array
    T: jax.Array
    U: jax.Array
    B_T: jax.Array
    B_U: jax.Array
    W_Yosc: jax.Array
    P_Yosc: jax.Array
    T_Yosc: jax.Array
    C_Xosc: jax.Array
    Q_Xosc: jax.Array
    U_Xosc: jax.Array
    r2x_joint: jax.Array
    r2y_joint: jax.Array
    r2x_orth: jax.Array
    r2y_orth: jax.Array

    @property
    def n_joint(self) -> int:
        return self.W.shape[-1]


def _svd_joint(XY, n):
    """Leading n left/right singular vectors of the K×M cross-product."""
    u, _, vt = jnp.linalg.svd(XY, full_matrices=False)
    return u[:, :n], vt[:n, :].T


def _dominant_left(G, power_iters):
    """Dominant left singular vector of skinny G (K, n) via the n×n Gram."""
    v = dominant_eigenvector(G.T @ G, power_iters)
    w = G @ v
    return w / jnp.sqrt(w @ w)


@partial(
    jax.jit, static_argnames=("n", "nx", "ny", "power_iters", "precision")
)
def _fit_o2pls(X, Y, n, nx, ny, power_iters, precision):
    ssx_total = jnp.sum(X * X)
    ssy_total = jnp.sum(Y * Y)

    with _prec_ctx(precision):
        # ---- X-orthogonal filtering (variation in X not related to Y)
        W_Yosc, P_Yosc, T_Yosc = [], [], []
        for _ in range(nx):
            W, _C = _svd_joint(X.T @ Y, n)
            T = X @ W
            G = (X - T @ W.T).T @ T  # EᵀT, (K, n)
            w_o = _dominant_left(G, power_iters)
            t_o = X @ w_o
            p_o = (X.T @ t_o) / (t_o @ t_o)
            X = X - jnp.outer(t_o, p_o)
            W_Yosc.append(w_o)
            P_Yosc.append(p_o)
            T_Yosc.append(t_o)

        # ---- Y-orthogonal filtering (variation in Y not related to X)
        C_Xosc, Q_Xosc, U_Xosc = [], [], []
        for _ in range(ny):
            _W, C = _svd_joint(X.T @ Y, n)
            U = Y @ C
            G = (Y - U @ C.T).T @ U  # FᵀU, (M, n)
            c_o = _dominant_left(G, power_iters)
            u_o = Y @ c_o
            q_o = (Y.T @ u_o) / (u_o @ u_o)
            Y = Y - jnp.outer(u_o, q_o)
            C_Xosc.append(c_o)
            Q_Xosc.append(q_o)
            U_Xosc.append(u_o)

        # ---- joint model on the filtered blocks
        W, C = _svd_joint(X.T @ Y, n)
        T = X @ W
        U = Y @ C
        B_T = jnp.linalg.solve(T.T @ T, T.T @ U)
        B_U = jnp.linalg.solve(U.T @ U, U.T @ T)

    K, M = X.shape[1], Y.shape[1]
    dt = X.dtype
    stack = lambda vs, d: (
        jnp.stack(vs, axis=-1) if vs else jnp.zeros((d, 0), dt)
    )
    T_Yosc_m = (
        jnp.stack(T_Yosc, axis=-1) if T_Yosc else jnp.zeros((X.shape[0], 0), dt)
    )
    U_Xosc_m = (
        jnp.stack(U_Xosc, axis=-1) if U_Xosc else jnp.zeros((Y.shape[0], 0), dt)
    )
    return O2PLSFit(
        W=W, C=C, T=T, U=U, B_T=B_T, B_U=B_U,
        W_Yosc=stack(W_Yosc, K), P_Yosc=stack(P_Yosc, K), T_Yosc=T_Yosc_m,
        C_Xosc=stack(C_Xosc, M), Q_Xosc=stack(Q_Xosc, M), U_Xosc=U_Xosc_m,
        r2x_joint=jnp.sum(T * T) / ssx_total,
        r2y_joint=jnp.sum(U * U) / ssy_total,
        r2x_orth=jnp.sum(T_Yosc_m * T_Yosc_m, axis=0)
        * jnp.sum(stack(P_Yosc, K) ** 2, axis=0)
        / ssx_total,
        r2y_orth=jnp.sum(U_Xosc_m * U_Xosc_m, axis=0)
        * jnp.sum(stack(Q_Xosc, M) ** 2, axis=0)
        / ssy_total,
    )


def fit_o2pls(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    n: int,
    nx: int = 0,
    ny: int = 0,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> O2PLSFit:
    """Fit an O2PLS model: `n` joint components plus `nx` X-orthogonal and
    `ny` Y-orthogonal components.  Both blocks must be centered (z-scored)
    by the caller, as for `fit`.  nx=ny=0 reduces to the PLS-SVD joint
    model (tested against models/crossdecomp.py)."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    if X.shape[0] != Y.shape[0]:
        raise ValueError(f"X has {X.shape[0]} rows but Y has {Y.shape[0]}")
    if not (1 <= n <= min(X.shape[1], Y.shape[1])):
        raise ValueError(
            f"n={n} must be in [1, min(K={X.shape[1]}, M={Y.shape[1]})]"
        )
    if nx < 0 or ny < 0:
        raise ValueError("nx and ny must be >= 0")
    return _fit_o2pls(X, Y, n, nx, ny, power_iters, precision)


@jax.jit
def _correct_x(f: O2PLSFit, X_new):
    def step(Xc, wp):
        w_o, p_o = wp
        return Xc - jnp.outer(Xc @ w_o, p_o), None

    Xf, _ = jax.lax.scan(step, X_new, (f.W_Yosc.T, f.P_Yosc.T))
    return Xf


@jax.jit
def _correct_y(f: O2PLSFit, Y_new):
    def step(Yc, cq):
        c_o, q_o = cq
        return Yc - jnp.outer(Yc @ c_o, q_o), None

    Yf, _ = jax.lax.scan(step, Y_new, (f.C_Xosc.T, f.Q_Xosc.T))
    return Yf


def transform(f: O2PLSFit, X_new=None, Y_new=None):
    """Joint scores of new data after orthogonal correction: returns
    (T_new, U_new); either may be None if the block wasn't given."""
    T_new = U_new = None
    if X_new is not None:
        T_new = _correct_x(f, jnp.asarray(X_new)) @ f.W
    if Y_new is not None:
        U_new = _correct_y(f, jnp.asarray(Y_new)) @ f.C
    return T_new, U_new


def predict_y(f: O2PLSFit, X_new) -> jnp.ndarray:
    """Ŷ = T_new B_T Cᵀ with T_new the corrected joint X-scores."""
    T_new, _ = transform(f, X_new=X_new)
    return T_new @ f.B_T @ f.C.T


def predict_x(f: O2PLSFit, Y_new) -> jnp.ndarray:
    """X̂ = U_new B_U Wᵀ — the symmetric, Y→X direction."""
    _, U_new = transform(f, Y_new=Y_new)
    return U_new @ f.B_U @ f.W.T
