"""N-PLS: trilinear (three-way) partial least squares (Bro 1996).

Beyond-reference model family: the reference handles only matrix X
(/root/reference/include/PLS/pls.h:21-33).  Three-way arrays are routine
in chemometrics (fluorescence EEMs: samples × emission × excitation;
batch processes: batches × variables × time); unfolding them to a matrix
and running ordinary PLS ignores the trilinear structure and overfits.
N-PLS (Bro, J. Chemometrics 10:47-61, 1996) constrains each component's
X-weight to a rank-1 outer product wᴶ ⊗ wᴷ:

    per component a (on the deflated Eᵢⱼₖ, working response u):
        S = Σᵢ uᵢ Eᵢ··           (J × K covariance slab)
        wᴷ = dominant right singular vector of S  (power iteration on SᵀS)
        wᴶ = S wᴷ / ‖S wᴷ‖
        tᵢ = Σⱼₖ Eᵢⱼₖ wᴶⱼ wᴷₖ    (one matvec on the unfolded tensor)
        [M > 1] q = Yᵀt/‖Yᵀt‖, u = Yq, iterate     (NIPALS-style)
        deflate E ← E − t ∘ (wᴶ ∘ wᴷ);  regress Y on T so far

    Ŷ = T B with B the running least-squares inner relation (solved once
    per component on the small (a × a) Gram matrix).

Design: the tensor never changes layout — all contractions are
einsums on the (I, J, K) array (lowered to matmuls); the component loop is a
`lax.scan`; the SVD is a fixed-iteration power method on the K × K SᵀS
(J, K are modest in practice; the scan stays compile-friendly).

New-data scores replay the same sequential contract-and-deflate with the
stored weight pairs, exactly like NIPALS scoring.
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
class NPLSFit:
    """Trilinear PLS fit.

    WJ : (J, A) second-mode weights     WK : (K, A) third-mode weights
    T  : (I, A) sample scores           Q  : (M, A) y-weights
    B  : (A, M) inner regression (Ŷ = T B)
    """

    WJ: jax.Array
    WK: jax.Array
    T: jax.Array
    Q: jax.Array
    B: jax.Array
    method: str = field(metadata=dict(static=True), default="npls")

    @property
    def A(self) -> int:
        return self.WJ.shape[-1]


def _dominant_pair(S: jnp.ndarray, n_iter: int) -> tuple[jnp.ndarray, jnp.ndarray]:
    """Leading singular pair of S (J, K) by power iteration on SᵀS."""
    eps = jnp.finfo(S.dtype).tiny
    v0 = jnp.sum(S * S, axis=0)  # deterministic, SᵀS-aligned start
    v0 = v0 / (jnp.linalg.norm(v0) + eps)

    def body(v, _):
        v = S.T @ (S @ v)
        return v / (jnp.linalg.norm(v) + eps), None

    wk, _ = jax.lax.scan(body, v0, None, length=n_iter)
    wj = S @ wk
    wj = wj / (jnp.linalg.norm(wj) + eps)
    return wj, wk


@partial(jax.jit, static_argnames=("A", "n_iter", "u_iter"))
def fit_npls(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    *,
    n_iter: int = 30,
    u_iter: int = 10,
) -> NPLSFit:
    """Fit trilinear PLS.  X (I, J, K) and Y (I, M) centered along mode 0
    (z-score the unfolded X columns or center slabs; the estimator-level
    convention is the caller's choice, as everywhere in this package)."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    I, J, K = X.shape
    M = Y.shape[1]
    eps = jnp.finfo(X.dtype).tiny

    def component(carry, a):
        E, Yd, T_prev = carry

        def u_step(u, _):
            S = jnp.einsum("i,ijk->jk", u, E)
            wj, wk = _dominant_pair(S, n_iter)
            t = jnp.einsum("ijk,j,k->i", E, wj, wk)
            q = Yd.T @ t
            q = q / (jnp.linalg.norm(q) + eps)
            return Yd @ q, (wj, wk, t, q)

        u0 = Yd[:, 0]
        # M == 1 converges in one pass; M > 1 runs the NIPALS-style
        # u-iteration a fixed number of rounds (compile-friendly)
        _, (wjs, wks, ts, qs) = jax.lax.scan(
            u_step, u0, None, length=(1 if M == 1 else u_iter)
        )
        wj, wk, t, q = wjs[-1], wks[-1], ts[-1], qs[-1]
        # deflate X by the rank-1 trilinear component
        E = E - jnp.einsum("i,j,k->ijk", t, wj, wk)
        # inner relation: regress Y on all scores so far (zero-padded
        # T buffer; solve on the small (A, A) Gram with ridge for the
        # not-yet-filled rows)
        T_prev = T_prev.at[:, a].set(t)
        G = T_prev.T @ T_prev + jnp.eye(A, dtype=X.dtype) * 1e-12
        Bc = jnp.linalg.solve(G, T_prev.T @ Y)
        Yd = Y - T_prev @ Bc
        return (E, Yd, T_prev), (wj, wk, t, q, Bc)

    T0 = jnp.zeros((I, A), X.dtype)
    (_, _, _), (WJs, WKs, Ts, Qs, Bcs) = jax.lax.scan(
        component, (X, Y, T0), jnp.arange(A)
    )
    return NPLSFit(
        WJ=WJs.T, WK=WKs.T, T=Ts.T, Q=Qs.T, B=Bcs[-1]
    )


def scores_npls(fit: NPLSFit, X_new: jnp.ndarray) -> jnp.ndarray:
    """(n, A) scores of new (centered) tensors: sequential contract-and-
    deflate with the stored weight pairs (NIPALS-style scoring)."""
    X_new = jnp.asarray(X_new)

    def step(E, a):
        wj, wk = fit.WJ[:, a], fit.WK[:, a]
        t = jnp.einsum("ijk,j,k->i", E, wj, wk)
        E = E - jnp.einsum("i,j,k->ijk", t, wj, wk)
        return E, t

    _, ts = jax.lax.scan(step, X_new, jnp.arange(fit.A))
    return ts.T


def predict_npls(fit: NPLSFit, X_new: jnp.ndarray) -> jnp.ndarray:
    """Ŷ = T(X_new) B for new (centered) tensors."""
    return scores_npls(fit, X_new) @ fit.B
