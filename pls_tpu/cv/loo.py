"""Leave-one-out cross-validation, batched.

Reference analogue: `Model::cv_LOO` (/root/reference/src/pls.cpp:469-491)
— N *sequential* from-scratch refits (each wastefully computing K
components; SURVEY.md §3.3).  Here folds are a pure batch axis:

- `cv_loo` (all methods): fold i fits with row i's mask zeroed.  Because
  every use of X/Y in the kernel algorithms is a masked reduction, a
  masked fit is arithmetically identical to fitting on the N−1 surviving
  rows, so folds vmap.  `jax.lax.map(..., batch_size=...)` chunks the vmap
  to bound memory; chunks can additionally be sharded over a mesh 'folds'
  axis (parallel/sharded.py).
- `cv_loo_downdate` (KERNEL_TYPE2): computes XX = XᵀX and XY = XᵀY once,
  then per fold applies exact rank-1 downdates XXᵢ = XX − xᵢxᵢᵀ,
  XYᵢ = XY − xᵢyᵢᵀ and refits from the statistics — O(K²) per fold
  instead of O(N·K²), the scalable path for the 1000-fold-on-1M×10k
  north-star workload.

Both record, per fold, the held-out residual under every component
truncation 1..A (one matmul + cumsum via residuals_all_components), into
the same (M, N, A) layout as the reference's error tensor.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pls_tpu.models.kernel_pls import fit, fit_from_stats_downdated
from pls_tpu.utils.batching import padded_map
from pls_tpu.models.predict import residuals_all_components
from pls_tpu.types import METHOD, Residual


def make_loo_fold_fn(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
):
    """Fold body shared by every LOO flavor (local, sharded, resumable):
    given a row index, fit with that row masked out and return its
    residuals under every component truncation, shape (A, M).
    x_storage="bf16" applies the narrow-X/f32-accumulation policy to
    every fold's refit (fit() docs)."""
    N = X.shape[0]

    def fold(i):
        mask = (jnp.arange(N) != i).astype(X.dtype)
        f = fit(
            X, Y, A, method,
            row_mask=mask, power_iters=power_iters, precision=precision,
            x_storage=x_storage,
        )
        return residuals_all_components(f, X[i][None, :], Y[i][None, :])[0]

    return fold


def cv_loo(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """LOO CV by vmapped masked refits. Returns Residual with errors (M, N, A)."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    if batch_size is None:
        batch_size = min(N, 64)

    fold = make_loo_fold_fn(
        X, Y, A, method, power_iters=power_iters, precision=precision,
        x_storage=x_storage,
    )
    errs = padded_map(fold, jnp.arange(N), batch_size)  # (N, A, M)
    return Residual(errors=jnp.transpose(errs, (2, 0, 1)), method="LOO")


def cv_loo_downdate(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    *,
    fold_indices: jnp.ndarray | None = None,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """LOO CV via exact rank-1 downdates of XᵀX / XᵀY (KERNEL_TYPE2 only).

    The downdate is applied IMPLICITLY inside the matvec
    ((XX − xxᵀ) r = XX r − x (xᵀr), models/kernel_pls.py:
    fit_from_stats_downdated), so no fold ever materializes a K×K matrix
    and the vmapped folds' XX·r products fuse into one batched matmul
    against the single shared XX — this is what makes 1000-fold LOO on a
    10k-wide design tractable (docs/PARALLELISM.md).

    Exactness vs. brute-force refits is validated in tests/test_cv.py.

    x_storage="bf16": the one X-sized operation — the global XᵀX/XᵀY
    pass — streams X in bfloat16 with f32 accumulation; the per-fold
    rank-1 vectors are O(K) and stay f32 (narrowing them saves no
    bandwidth and costs precision).
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    if fold_indices is None:
        fold_indices = jnp.arange(N)  # classic LOO: every row once
    fold_indices = jnp.asarray(fold_indices)
    if batch_size is None:
        batch_size = min(int(fold_indices.shape[0]), 64)

    if x_storage is not None:
        if x_storage not in ("bf16", "bfloat16"):
            raise ValueError(f"unknown x_storage {x_storage!r} (use 'bf16')")
        acc = X.dtype if X.dtype.itemsize >= 4 else jnp.float32
        Xn = X.astype(jnp.bfloat16)
        XX = jax.lax.dot_general(
            Xn, Xn, (((0,), (0,)), ((), ())), preferred_element_type=acc
        )
        XY = jax.lax.dot_general(
            Xn, Y.astype(jnp.bfloat16), (((0,), (0,)), ((), ())),
            preferred_element_type=acc,
        )
        X = X.astype(acc)
        Y = Y.astype(acc)
    else:
        XX = X.T @ X
        XY = X.T @ Y

    def fold(i):
        x = X[i]
        y = Y[i]
        f = fit_from_stats_downdated(
            XX, XY, x, y, A, power_iters=power_iters, precision=precision
        )
        res = residuals_all_components(f, x[None, :], y[None, :])
        return res[0]  # (A, M)

    errs = padded_map(fold, fold_indices, batch_size)
    return Residual(errors=jnp.transpose(errs, (2, 0, 1)), method="LOO")


def cv_loo_from_stats(
    XX: jnp.ndarray,
    XY: jnp.ndarray,
    fold_X: jnp.ndarray,
    fold_Y: jnp.ndarray,
    A: int,
    *,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> Residual:
    """Batched LOO directly from global statistics — for designs too large
    to materialize (models/streaming.py builds XX = XᵀX, XY = XᵀY in one
    streaming pass; only the F held-out rows are kept).

    fold_X: (F, K) held-out observations (must be included in XX/XY);
    fold_Y: (F, M) their responses.  Returns Residual errors (M, F, A).
    This is the execution path for the 1M×10k / 1000-fold north star:
    after the single X pass, no fold touches X again.
    """
    fold_X = jnp.asarray(fold_X)
    fold_Y = jnp.asarray(fold_Y)
    if fold_Y.ndim == 1:
        fold_Y = fold_Y[:, None]
    F = fold_X.shape[0]
    if batch_size is None:
        batch_size = min(F, 128)

    def fold(xy):
        x, y = xy
        f = fit_from_stats_downdated(
            XX, XY, x, y, A, power_iters=power_iters, precision=precision
        )
        return residuals_all_components(f, x[None, :], y[None, :])[0]  # (A, M)

    errs = padded_map(fold, (fold_X, fold_Y), batch_size)
    return Residual(errors=jnp.transpose(errs, (2, 0, 1)), method="LOO")
