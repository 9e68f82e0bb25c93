"""SIMPLS (de Jong 1993, "SIMPLS: an alternative approach to partial least
squares regression", Chemometrics Intell. Lab. Syst. 18:251-263).

Not present in the reference; required by the north-star spec
(BASELINE.json: "Kernel-PLS/SIMPLS variants").

SIMPLS computes weights applying directly to the original (centered) X —
like the kernel algorithms' R — by deflating the K×M covariance S = XᵀY
against an orthonormal basis V of the X-loading space:

    per component:  q₀ = dom.eigvec(SᵀS) ;  r = S q₀ ;  t = X r
                    normalize t (and r by the same factor)
                    p = Xᵀt ;  q = Yᵀt
                    v = p orthogonalized against previous V, normalized
                    S ← S − v (vᵀ S)

Scores are orthonormal (TᵀT = I); predictions use the shared stack
B = R Qᵀ (models/predict.py).  For M == 1 SIMPLS produces the same fitted
sub-space — and therefore identical predictions — as NIPALS/kernel PLS
(property-tested in tests/test_variants.py).

Design notes: same scan-with-zero-buffers pattern as kernel_pls.py; the
orthogonalization v −= V(Vᵀp) is two fixed-shape GEMMs.  Only S (K×M) is
deflated, so like the kernel algorithms this streams X twice per component
and is compatible with row-sharded X (contractions reduce over rows).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.ops.eigen import dominant_eigenvector
from pls_tpu.types import METHOD, PLSFit


@partial(jax.jit, static_argnames=("A", "power_iters", "precision"))
def fit_simpls(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> PLSFit:
    from pls_tpu.models.kernel_pls import _prec_ctx

    N, K = X.shape
    M = Y.shape[1]
    dtype = X.dtype

    with _prec_ctx(precision):
        S0 = X.T @ Y

        def step(carry, a):
            S, Vb = carry  # Vb: (A, K) orthonormal basis rows (zeros beyond a)
            if M == 1:
                r = S[:, 0]
            else:
                q0 = dominant_eigenvector(S.T @ S, power_iters)
                r = S @ q0
            t = X @ r
            tnorm = jnp.sqrt(t @ t)
            t = t / tnorm
            r = r / tnorm
            p = X.T @ t
            q = Y.T @ t
            v = p - Vb.T @ (Vb @ p)
            v = v / jnp.sqrt(v @ v)
            S = S - jnp.outer(v, v @ S)
            Vb = Vb.at[a].set(v)
            return (S, Vb), (r, p, q, t)

        # data-derived zeros: see kernel_pls._fit_kernel (shard_map varying axes)
        zbuf = jnp.zeros((A, K), dtype) + S0[0, 0] * 0
        (_, _), (Rs, Ps, Qs, Ts) = jax.lax.scan(step, (S0, zbuf), jnp.arange(A))

    R = Rs.T
    return PLSFit(W=R, P=Ps.T, Q=Qs.T, R=R, T=Ts.T, method=METHOD.SIMPLS)
