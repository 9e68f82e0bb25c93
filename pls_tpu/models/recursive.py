"""Recursive (online-adaptive) PLS with exponential forgetting.

Production processes drift; a calibration fitted once goes stale.  The
reference has no notion of updating a model (its `Model` refits from
scratch — /root/reference/src/pls.cpp:340-359).  Recursive PLS (Qin 1998,
Comput. Chem. Eng. 22:503, block formulation) keeps the model current
from streaming data at O(c·K²) per chunk:

    XX ← λ·XX + XcᵀXc         (0 < λ ≤ 1 the forgetting factor)
    XY ← λ·XY + XcᵀYc
    refit from statistics      (X-free kernel type-2 component loop)

λ = 1 recovers the exact growing-window batch fit (identical to
StatsAccumulator — property-tested); λ < 1 gives an exponentially
weighted window of effective length 1/(1−λ), letting the coefficients
track drift.  The update is one jitted FMA pair (matmuls); the refit
is the same `fit_from_stats` used everywhere else, so all prediction/
validation/monitoring machinery applies to the refreshed model.

The effective sample count n_eff = Σ λ^i·cᵢ is carried for diagnostics
(an EW window's variance bookkeeping).  Data is assumed pre-scaled, like
every fitter in this package; for drifting scale, re-estimate scalers on
a window and fold the change into the incoming chunks.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.models.kernel_pls import fit_from_stats
from pls_tpu.types import PLSFit


@partial(jax.jit, static_argnames=())
def _rupdate(XX, XY, n_eff, lam, Xc, Yc):
    return (
        lam * XX + Xc.T @ Xc,
        lam * XY + Xc.T @ Yc,
        lam * n_eff + Xc.shape[0],
    )


@dataclass
class RecursivePLS:
    """Streaming adaptive PLS: update(chunk) → fit() at any point.

    K, M   : design/response widths
    lam    : forgetting factor (1 = growing window / batch-equivalent;
             e.g. 0.99 ≈ 100-sample effective memory per unit chunk row)
    """

    K: int
    M: int
    lam: float = 1.0
    dtype: object = jnp.float32
    XX: jax.Array = field(init=False)
    XY: jax.Array = field(init=False)
    n_eff: jax.Array = field(init=False)

    def __post_init__(self):
        if not (0.0 < self.lam <= 1.0):
            raise ValueError(f"lam must be in (0, 1], got {self.lam}")
        self.XX = jnp.zeros((self.K, self.K), self.dtype)
        self.XY = jnp.zeros((self.K, self.M), self.dtype)
        self.n_eff = jnp.zeros((), self.dtype)

    def update(self, X_chunk, Y_chunk) -> "RecursivePLS":
        X_chunk = jnp.asarray(X_chunk, self.dtype)
        Y_chunk = jnp.asarray(Y_chunk, self.dtype)
        if Y_chunk.ndim == 1:
            Y_chunk = Y_chunk[:, None]
        lam = jnp.asarray(self.lam, self.dtype)
        self.XX, self.XY, self.n_eff = _rupdate(
            self.XX, self.XY, self.n_eff, lam, X_chunk, Y_chunk
        )
        return self

    def fit(self, A: int, **kw) -> PLSFit:
        """Refit from the current (forgetting-weighted) statistics."""
        return fit_from_stats(self.XX, self.XY, A, **kw)
