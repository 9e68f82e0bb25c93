"""Core types: method enums, fit-state pytree, residual pytree.

Reference analogues:
- `PLS::METHOD {KERNEL_TYPE1, KERNEL_TYPE2}` — /root/reference/include/PLS/pls.h:131
  (extended here with NIPALS and SIMPLS, demanded by the north-star spec).
- `PLS::VALIDATION_OUTPUT {RESS, MSE}` — /root/reference/include/PLS/pls.h:143
- `struct PLS::Model`'s private state (P, W, R, Q, T, A, method) —
  /root/reference/include/PLS/pls.h:250-254 — becomes the immutable
  `PLSFit` pytree here; fitting is a pure function (models/kernel_pls.py).
- `PLS::Residual` — /root/reference/include/PLS/pls.h:44-53 — becomes the
  `Residual` pytree: a dense [M, n_obs, A] error tensor plus a method label.

Design notes:
- The reference stores W/P/Q/R/T as complex matrices because Eigen's general
  `EigenSolver` may return complex eigenvectors (pls.h:253, pls.cpp:138-141).
  We extract the dominant eigenvector of the *symmetric PSD* matrix XYᵀXY,
  which is real by construction, so all state is real — no complex plumbing.
- `PLSFit` and `Residual` are registered pytrees, so they flow through
  `jit` / `vmap` / `scan` / shardings untouched.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import jax
import jax.numpy as jnp


class METHOD(enum.Enum):
    """PLS fitting algorithm.

    KERNEL_TYPE1 / KERNEL_TYPE2 are the Dayal–MacGregor improved kernel
    algorithms (the reference's only methods, pls.h:131).  Type 1 streams X
    per component (best for tall X, N >> K); Type 2 precomputes XᵀX so the
    component loop never touches X (best for wide-ish X or huge N).
    NIPALS is the classical X-deflating algorithm; SIMPLS is de Jong (1993).
    SPLS tags fits produced by the sparse-PLS extension (models/sparse.py).
    """

    KERNEL_TYPE1 = "kernel1"
    KERNEL_TYPE2 = "kernel2"
    NIPALS = "nipals"
    SIMPLS = "simpls"
    SPLS = "spls"


KERNEL_TYPE1 = METHOD.KERNEL_TYPE1
KERNEL_TYPE2 = METHOD.KERNEL_TYPE2
NIPALS = METHOD.NIPALS
SIMPLS = METHOD.SIMPLS
SPLS = METHOD.SPLS


class VALIDATION_OUTPUT(enum.Enum):
    """How to summarize CV errors (reference pls.h:143)."""

    RESS = "ress"  # residual error sum of squares (== PRESS for CV errors)
    MSE = "mse"  # mean squared error (RESS / n_observations)


RESS = VALIDATION_OUTPUT.RESS
MSE = VALIDATION_OUTPUT.MSE


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PLSFit:
    """Immutable result of a PLS fit.

    Shapes follow the Dayal–MacGregor paper's naming, as documented in the
    reference at /root/reference/include/PLS/pls.h:161-183:
        W : (K, A)  PLS weights for X
        P : (K, A)  PLS loadings for X
        Q : (M, A)  PLS loadings for Y
        R : (K, A)  weights mapping original X directly to scores (T = X R)
        T : (N, A)  X scores (only materialized for KERNEL_TYPE1 / NIPALS;
                    zeros-shaped (0, A) otherwise, matching the reference
                    where T is only set for type 1 — pls.cpp:394,434)
    `method` and `A` are static (aux) fields.
    """

    W: jax.Array
    P: jax.Array
    Q: jax.Array
    R: jax.Array
    T: jax.Array
    method: METHOD = field(metadata=dict(static=True), default=METHOD.KERNEL_TYPE1)

    @property
    def A(self) -> int:
        """Number of components fit."""
        return self.W.shape[-1]

    @property
    def K(self) -> int:
        """Number of predictor variables."""
        return self.W.shape[-2]

    @property
    def M(self) -> int:
        """Number of response variables."""
        return self.Q.shape[-2]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class Residual:
    """Cross-validation residuals.

    `errors` is a dense tensor of shape (M, n_obs, A): per Y-variable, per
    held-out observation, per component-count 1..A — the same indexing as the
    reference's `std::vector<Mat2D>` (pls.h:41, populated at pls.cpp:475-481).
    `method` is the provenance label ("LOO" / "LSO" / "NEW DATA") that the
    reference threads through `Residual::method()` into report headers
    (pls.cpp:296).
    """

    errors: jax.Array
    method: str = field(metadata=dict(static=True), default="")

    @property
    def n_obs(self) -> int:
        return self.errors.shape[-2]

    @property
    def A(self) -> int:
        return self.errors.shape[-1]

    @property
    def M(self) -> int:
        return self.errors.shape[-3]


def default_float_dtype() -> jnp.dtype:
    """The working precision: float64 when x64 is enabled (CPU parity runs),
    else float32 (accelerator runs).  Mirrors the reference's compile-time
    `float_type` switch (pls.h:11-28) as a runtime policy."""
    return jnp.float64 if jax.config.jax_enable_x64 else jnp.float32
