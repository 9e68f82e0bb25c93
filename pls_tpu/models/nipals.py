"""Classical NIPALS PLS2 with X- and Y-deflation.

Not present in the reference (which only implements the Dayal–MacGregor
kernel algorithms, /root/reference/src/pls.cpp:387-437); required by the
north-star spec (BASELINE.json: "NIPALS power-iteration component
extraction ... rank-1 deflation of X and Y").

Algorithm (per component, on deflated Xd/Yd):
    u ← first column of Yd
    repeat:  w = Xdᵀu/‖Xdᵀu‖ ;  t = Xd w ;  qn = Ydᵀt/‖Ydᵀt‖ ;  u = Yd qn
    until w converges (tol) or max_iter
    p = Xdᵀt/tᵀt ;  q = Ydᵀt/tᵀt  (regression loading)
    Xd ← Xd − t pᵀ ;  Yd ← Yd − t qᵀ
Afterwards R = W (PᵀW)⁻¹ maps *original* X to scores (T = X R), so the
shared prediction stack (models/predict.py: B = R Qᵀ) applies unchanged.

Design notes: the inner iteration is a `lax.while_loop` with a static
iteration cap; the component loop is a `lax.scan` carrying the deflated
matrices — X-deflation makes this O(A·N·K) HBM traffic either way, which
is exactly why the kernel algorithms (which deflate only the K×M XY) are
the preferred production path; NIPALS is kept for cross-validation of the
algebra and for users expecting the classical algorithm.

For M == 1 NIPALS converges in a single iteration and produces the same
model as kernel PLS (property-tested in tests/test_variants.py).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.types import METHOD, PLSFit


@partial(jax.jit, static_argnames=("A", "max_iter", "precision"))
def fit_nipals(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    *,
    tol: float = 1e-12,
    max_iter: int = 500,
    precision: str | None = "highest",
) -> PLSFit:
    from pls_tpu.models.kernel_pls import _prec_ctx

    N, K = X.shape
    M = Y.shape[1]
    dtype = X.dtype

    with _prec_ctx(precision):

        def component(carry, _):
            Xd, Yd = carry
            u0 = Yd[:, 0]

            def inner(state):
                w_prev, u, _it, _ = state
                w = Xd.T @ u
                w = w / jnp.sqrt(w @ w)
                t = Xd @ w
                qn = Yd.T @ t
                qn = qn / jnp.sqrt(qn @ qn)
                u_new = Yd @ qn
                delta = jnp.sqrt(jnp.sum((w - w_prev) ** 2))
                return (w, u_new, _it + 1, delta)

            def cond(state):
                _w, _u, it, delta = state
                return jnp.logical_and(it < max_iter, delta > tol)

            w0 = jnp.zeros((K,), dtype)
            w, u, _, _ = jax.lax.while_loop(
                cond, inner, (w0, u0, jnp.array(0), jnp.array(jnp.inf, dtype))
            )
            t = Xd @ w
            tt = t @ t
            p = (Xd.T @ t) / tt
            q = (Yd.T @ t) / tt
            Xd = Xd - jnp.outer(t, p)
            Yd = Yd - jnp.outer(t, q)
            return (Xd, Yd), (w, p, q, t)

        (_, _), (Ws, Ps, Qs, Ts) = jax.lax.scan(component, (X, Y), None, length=A)
        W = Ws.T  # (K, A)
        P = Ps.T
        Q = Qs.T  # (M, A)
        T = Ts.T  # (N, A)
        # R maps original X to scores: T = X R with R = W (PᵀW)⁻¹
        PtW = P.T @ W  # (A, A), upper triangular with unit diagonal
        R = jax.scipy.linalg.solve_triangular(PtW.T, W.T, lower=True).T

    return PLSFit(W=W, P=P, Q=Q, R=R, T=T, method=METHOD.NIPALS)
