"""Cross-decomposition family: PLS-canonical (mode A), CCA (mode B), PLS-SVD.

Beyond-reference model families (the reference implements only regression-
mode PLS — /root/reference/src/pls.cpp:387-437); these complete the
classical cross-decomposition quartet users expect from a PLS framework
(the scikit-learn `cross_decomposition` surface: PLSRegression ≡ our
kernel/NIPALS fits, plus PLSCanonical, CCA, PLSSVD implemented here).
Numerics follow the standard two-block power-method formulation (Wegelin
2000 survey; Wold mode A / mode B), matching scikit-learn's conventions —
including its per-component sign fix (largest-|coefficient| element of the
x-weight vector made positive) — so results are directly comparable
(property-tested against sklearn in tests/test_crossdecomp.py).

Design: the component loop is a `lax.scan` carrying the deflated
(Xd, Yd) pair; the inner power iteration is a `lax.while_loop` with a
static iteration cap; mode B's per-component pseudo-inverses are
`jnp.linalg.pinv` (SVD) on the deflated blocks.  Everything is jittable
end-to-end and all state is real-valued.

Mode semantics per component (on deflated Xd, Yd):
    mode A (PLSCanonical):  w ∝ Xdᵀu,  c ∝ Ydᵀt   (covariance direction)
    mode B (CCA):           w ∝ Xd⁺u,  c ∝ Yd⁺t   (correlation direction)
  then t = Xd w, u = Yd c, and BOTH blocks deflate by their own scores:
    Xd ← Xd − t pᵀ   with  p = Xdᵀt / tᵀt
    Yd ← Yd − u qᵀ   with  q = Ydᵀu / uᵀu
PLS-SVD is the one-shot variant: the top-A singular triplets of XᵀY give
all weight vectors at once; no deflation, scores are X W and Y C.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.utils.checkpoint import register_checkpointable


@register_checkpointable
@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class CDFit:
    """Result of a two-block cross-decomposition fit.

    W : (K, A) x-weights        C : (M, A) y-weights
    P : (K, A) x-loadings       Q : (M, A) y-loadings
    T : (N, A) x-scores         U : (N, A) y-scores
    R : (K, A) x-rotations  (new-data scores: Xn R)
    Ry: (M, A) y-rotations  (new-data y-scores: Yn Ry)
    """

    W: jax.Array
    C: jax.Array
    P: jax.Array
    Q: jax.Array
    T: jax.Array
    U: jax.Array
    R: jax.Array
    Ry: jax.Array
    mode: str = field(metadata=dict(static=True), default="canonical")

    @property
    def A(self) -> int:
        return self.W.shape[-1]


def _sign_fix(w, c):
    """Make the largest-|coefficient| element of w positive (the sign
    convention sklearn applies per component), flipping c to match."""
    s = jnp.sign(w[jnp.argmax(jnp.abs(w))])
    s = jnp.where(s == 0, 1.0, s).astype(w.dtype)
    return w * s, c * s


def _power_pair(Xd, Yd, mode_b: bool, tol: float, max_iter: int):
    """Dominant two-block weight pair (w, c) by power iteration.

    Mode A contracts with the raw blocks (covariance criterion); mode B
    with their pseudo-inverses (correlation criterion).  Both normalize
    w and c to unit length each iteration; converged when the squared
    change in w drops below tol.
    """
    K = Xd.shape[1]
    dtype = Xd.dtype
    eps = jnp.finfo(dtype).eps
    if mode_b:
        Xc, Yc = jnp.linalg.pinv(Xd), jnp.linalg.pinv(Yd)
    else:
        Xc, Yc = Xd.T, Yd.T

    def body(state):
        _w_old, w_prev, _c, u, it = state
        # eps guards keep the mode-A quotients finite if a score collapses
        # to zero (e.g. a constant Y column) instead of emitting NaNs
        w = Xc @ u if mode_b else Xc @ u / (u @ u + eps)
        w = w / (jnp.sqrt(w @ w) + eps)
        t = Xd @ w
        c = Yc @ t if mode_b else Yc @ t / (t @ t + eps)
        c = c / (jnp.sqrt(c @ c) + eps)
        u = Yd @ c / (c @ c + eps)
        return (w_prev, w, c, u, it + 1)

    def cond(state):
        w_old, w, _c, _u, it = state
        d = w - w_old
        return jnp.logical_and(it < max_iter, d @ d > tol)

    # w_old sentinel (100s, sklearn's convention) guarantees the loop
    # cannot converge against the initializer

    w0 = jnp.full((K,), jnp.asarray(100.0, dtype))
    # seed from the FIRST Y column with non-negligible entries (sklearn's
    # convention): a constant (centered-to-zero) column would make u0 = 0
    # and poison the whole iteration with NaNs
    live = jnp.any(jnp.abs(Yd) > jnp.finfo(dtype).eps, axis=0)
    u0 = Yd[:, jnp.argmax(live)]
    state = body((w0, w0, jnp.zeros((Yd.shape[1],), dtype), u0, jnp.array(0)))
    _, w, c, _, _ = jax.lax.while_loop(cond, body, state)
    return w, c


@partial(jax.jit, static_argnames=("A", "mode_b", "max_iter"))
def _fit_cd(X, Y, A: int, mode_b: bool, tol: float, max_iter: int) -> CDFit:
    N, K = X.shape
    M = Y.shape[1]

    def component(carry, _):
        Xd, Yd = carry
        w, c = _power_pair(Xd, Yd, mode_b, tol, max_iter)
        w, c = _sign_fix(w, c)
        t = Xd @ w
        u = Yd @ c
        eps = jnp.finfo(X.dtype).eps
        p = (Xd.T @ t) / (t @ t + eps)
        q = (Yd.T @ u) / (u @ u + eps)
        Xd = Xd - jnp.outer(t, p)
        Yd = Yd - jnp.outer(u, q)
        return (Xd, Yd), (w, c, p, q, t, u)

    (_, _), (Ws, Cs, Ps, Qs, Ts, Us) = jax.lax.scan(
        component, (X, Y), None, length=A
    )
    W, C, P, Q = Ws.T, Cs.T, Ps.T, Qs.T
    T, U = Ts.T, Us.T
    # rotations map ORIGINAL (centered) data to scores: T = X R, U = Y Ry
    R = W @ jnp.linalg.pinv(P.T @ W)
    Ry = C @ jnp.linalg.pinv(Q.T @ C)
    return CDFit(
        W=W, C=C, P=P, Q=Q, T=T, U=U, R=R, Ry=Ry,
        mode="cca" if mode_b else "canonical",
    )


def fit_plscanonical(
    X, Y, A: int, *, tol: float = 1e-6, max_iter: int = 500
) -> CDFit:
    """Two-block mode-A PLS with symmetric (canonical) deflation.

    X, Y must be centered (the estimator facade handles scaling).
    A ≤ min(N, K, M).
    """
    return _fit_cd(jnp.asarray(X), jnp.asarray(Y), A, False, tol, max_iter)


def fit_cca(X, Y, A: int, *, tol: float = 1e-6, max_iter: int = 500) -> CDFit:
    """Canonical correlation analysis via mode-B two-block power iteration
    (weights through the blocks' pseudo-inverses). A ≤ min(N, K, M)."""
    return _fit_cd(jnp.asarray(X), jnp.asarray(Y), A, True, tol, max_iter)


@partial(jax.jit, static_argnames=("A",))
def fit_plssvd(X, Y, A: int) -> CDFit:
    """One-shot PLS-SVD: top-A singular triplets of the K×M cross-product
    XᵀY.  No deflation; loadings equal weights; rotations equal weights
    (the weight columns are orthonormal)."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    Uc, _s, Vt = jnp.linalg.svd(X.T @ Y, full_matrices=False)
    W = Uc[:, :A]
    C = Vt[:A].T
    # sklearn-style sign convention, vectorized across components
    idx = jnp.argmax(jnp.abs(W), axis=0)
    s = jnp.sign(W[idx, jnp.arange(A)])
    s = jnp.where(s == 0, 1.0, s).astype(W.dtype)
    W = W * s
    C = C * s
    return CDFit(
        W=W, C=C, P=W, Q=C, T=X @ W, U=Y @ C, R=W, Ry=C, mode="svd"
    )


def cd_coefficients(fit: CDFit) -> jax.Array:
    """(K, M) regression coefficients B with Ŷ = X B for centered X/Y
    (the standard x_rotations · y_loadingsᵀ composition)."""
    return fit.R @ fit.Q.T


def cd_transform(fit: CDFit, Xn, Yn=None):
    """Scores of new (centered) data: Xn R (and Yn Ry when Yn given)."""
    xs = jnp.asarray(Xn) @ fit.R
    if Yn is None:
        return xs
    return xs, jnp.asarray(Yn) @ fit.Ry


def cd_predict(fit: CDFit, Xn) -> jax.Array:
    """Ŷ for new (centered) data via the fitted coefficients."""
    return jnp.asarray(Xn) @ cd_coefficients(fit)
