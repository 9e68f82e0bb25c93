"""Robust PLS via iteratively reweighted fitting (IRPLS).

Least-squares PLS (all the reference offers) lets a single gross outlier
drag every component.  IRPLS (Cummins & Andrews 1995, J. Chemometrics
9:489) downweights samples by their residuals and refits to convergence:

    repeat n_irls times:
        f   = weighted PLS fit(X, Y, w)            (sample_weight path)
        rᵢ  = ‖Yᵢ − Ŷᵢ‖ / √M                       (row residual norm)
        uᵢ  = rᵢ / (1.4826·median|r − med r|)       (MAD-standardized)
        wᵢ  = ψ(uᵢ)/uᵢ                              (Huber or bisquare)

Design: the IRLS loop is a `lax.scan` whose body is the already-jitted
weighted kernel fit — fixed iteration count, fixed shapes, no host
round-trips; the whole robust fit is one XLA program.  Weight functions:

    huber    : w = min(1, c/|u|),            c = 1.345 (95% efficiency)
    bisquare : w = (1 − (u/c)²)² for |u|<c,  c = 4.685 (hard rejection)

Returns (fit, weights); weights ≈ 0 identify the outlying samples — a
useful screening output in its own right.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.models.kernel_pls import fit as _fit
from pls_tpu.models.predict import fitted_values
from pls_tpu.types import KERNEL_TYPE1, METHOD, PLSFit

_DEFAULT_C = {"huber": 1.345, "bisquare": 4.685}


def _weights(u: jnp.ndarray, loss: str, c: float) -> jnp.ndarray:
    au = jnp.abs(u)
    if loss == "huber":
        return jnp.minimum(1.0, c / jnp.maximum(au, 1e-12))
    if loss == "bisquare":
        z = jnp.clip(au / c, 0.0, 1.0)
        return (1.0 - z * z) ** 2
    raise ValueError(f"unknown loss {loss!r}")


@partial(jax.jit, static_argnames=("A", "method", "loss", "n_irls", "precision"))
def fit_robust(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    method: METHOD = KERNEL_TYPE1,
    *,
    loss: str = "huber",
    c: float | None = None,
    n_irls: int = 10,
    precision: str | None = "highest",
) -> tuple[PLSFit, jnp.ndarray]:
    """Iteratively reweighted robust PLS.  X/Y centered/scaled as usual.

    Returns (fit, weights): `fit` from the final weighted pass; `weights`
    (N,) in [0, 1] — small/zero for samples the fit rejected.
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N, M = Y.shape[0], Y.shape[1]
    if loss not in _DEFAULT_C:
        raise ValueError(f"unknown loss {loss!r}; expected huber|bisquare")
    cc = _DEFAULT_C[loss] if c is None else c

    def irls_step(w, _):
        f = _fit(X, Y, A, method, sample_weight=w, precision=precision)
        r = Y - fitted_values(f, X)
        rn = jnp.sqrt(jnp.sum(r * r, axis=1) / M)  # (N,)
        med = jnp.median(rn)
        mad = jnp.median(jnp.abs(rn - med))
        scale = jnp.maximum(1.4826 * mad, 1e-12)
        w_new = _weights(rn / scale, loss, cc)
        return w_new, None

    w0 = jnp.ones((N,), X.dtype)
    w, _ = jax.lax.scan(irls_step, w0, None, length=n_irls)
    f = _fit(X, Y, A, method, sample_weight=w, precision=precision)
    return f, w
