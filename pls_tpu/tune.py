"""Hyper-parameter tuning: k-fold grid search over estimator parameters.

Not in the reference (whose only model-selection tool is the Wilcoxon
component test, /root/reference/src/pls.cpp:263-289 — kept as
cv/validation.optimal_num_components).  This module covers the knobs the
extended families add: keep_x for sparse PLS, (gamma, n_components) for
kernel PLS, n_ortho for OPLS — anything speaking the estimator protocol
(fit/predict/get_params/set_params, estimator.py).

Folds reuse one shuffled permutation (explicit PRNG key), and every fold
has the SAME train/test sizes (remainder rows join the last fold's train
side), so each (param, fold) fit hits the same jit cache entry — the
compile cost is paid once per parameter setting, not once per fold.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass

import jax
import numpy as np


def kfold_split(n: int, n_folds: int, key: jax.Array | None = None):
    """List of (train_idx, test_idx) numpy index arrays.  Equal-size test
    folds of n // n_folds rows (shuffled when a key is given); the n %
    n_folds leftover rows are always in training."""
    if not (2 <= n_folds <= n):
        raise ValueError(f"need 2 <= n_folds <= N, got {n_folds} / {n}")
    perm = (
        np.asarray(jax.random.permutation(key, n))
        if key is not None
        else np.arange(n)
    )
    fold_size = n // n_folds
    splits = []
    for f in range(n_folds):
        test = perm[f * fold_size : (f + 1) * fold_size]
        train = np.setdiff1d(perm, test)
        splits.append((train, test))
    return splits


@dataclass
class GridResult:
    """One grid point: its parameters, per-fold RMSE, and the mean."""

    params: dict
    fold_rmse: np.ndarray
    rmse: float


from functools import partial as _partial


@_partial(
    jax.jit,
    static_argnames=(
        "A", "method", "scale", "power_iters", "precision", "x_storage",
    ),
)
def _fold_errors_batched(
    X, Y, masks, test_idx, A, method, scale, power_iters, precision,
    x_storage,
):
    """All folds of one parameter setting as ONE vmapped masked-fit
    program: per fold, masked z-scoring (matching ZScorer's train-rows
    statistics: N−1 denominator, zero-stdev guard), a masked fit at
    A_max, and raw-unit residuals at EVERY truncation 1..A_max
    (residuals_all_components) — so a whole n_components grid costs one
    program.  Returns (F, T, A, M) raw-unit test errors."""
    import jax.numpy as jnp

    from pls_tpu.models.kernel_pls import fit
    from pls_tpu.models.predict import residuals_all_components

    def one(mask, tidx):
        if scale:
            m = mask[:, None]
            cnt = jnp.sum(mask)
            mx = jnp.sum(X * m, axis=0) / cnt
            my = jnp.sum(Y * m, axis=0) / cnt
            sdx = jnp.sqrt(jnp.sum(((X - mx) * m) ** 2, axis=0) / (cnt - 1))
            sdy = jnp.sqrt(jnp.sum(((Y - my) * m) ** 2, axis=0) / (cnt - 1))
            sdx = jnp.where(sdx == 0, 1.0, sdx)
            sdy = jnp.where(sdy == 0, 1.0, sdy)
            Xz = (X - mx) / sdx
            Yz = (Y - my) / sdy
        else:
            Xz, Yz = X, Y
            sdy = jnp.ones((Y.shape[1],), Y.dtype)
        f = fit(
            Xz, Yz, A, method, row_mask=mask, power_iters=power_iters,
            precision=precision, x_storage=x_storage,
        )
        err_z = residuals_all_components(f, Xz[tidx], Yz[tidx])  # (T, A, M)
        return err_z * sdy  # affine transform cancels: raw = z · sd_y

    return jax.vmap(one)(masks, test_idx)


def _grid_search_cv_batched(make_estimator, param_grid, X, Y, splits):
    """Fast path of grid_search_cv for plain PLSRegressor factories: one
    vmapped program per non-n_components parameter combination (folds
    batched; every n_components value read off the same fit via the
    truncation-nesting property).  Numerically equivalent to the slow
    path — tests/test_tune.py pins the agreement."""
    import jax.numpy as jnp

    N = X.shape[0]
    F = len(splits)
    T = splits[0][1].shape[0]
    masks = np.zeros((F, N), np.float32)
    test_idx = np.zeros((F, T), np.int32)
    for f, (train, test) in enumerate(splits):
        masks[f, train] = 1.0
        test_idx[f] = test
    Xj = jnp.asarray(X)
    Yj = jnp.asarray(Y)
    masks = jnp.asarray(masks, Xj.dtype)
    test_idx = jnp.asarray(test_idx)

    names = list(param_grid)
    a_values = [v for v in param_grid.get("n_components", [])]
    other_names = [n for n in names if n != "n_components"]
    by_params: dict[tuple, GridResult] = {}
    for combo in itertools.product(*(param_grid[n] for n in other_names)):
        base = dict(zip(other_names, combo))
        est = make_estimator().set_params(**base)
        A_list = a_values or [est.n_components]
        A_max = max(A_list)
        errs = _fold_errors_batched(
            Xj, Yj, masks, test_idx, A_max, est.method, est.scale,
            est.power_iters, est.precision, est.x_storage,
        )  # (F, T, A_max, M)
        rmse_fa = np.asarray(
            jnp.sqrt(jnp.mean(errs * errs, axis=(1, 3)))
        )  # (F, A_max)
        for A in A_list:
            params = dict(base)
            if a_values:
                params["n_components"] = A
            keyt = tuple(params[n] for n in names)
            fold_rmse = rmse_fa[:, A - 1]
            by_params[keyt] = GridResult(
                params, fold_rmse, float(fold_rmse.mean())
            )
    results = [
        by_params[values]
        for values in itertools.product(*(param_grid[n] for n in names))
    ]
    best = min(results, key=lambda r: r.rmse)
    return best, results


def grid_search_cv(
    make_estimator,
    param_grid: dict,
    X,
    Y,
    *,
    n_folds: int = 5,
    key: jax.Array | None = None,
    batched: bool | None = None,
):
    """Exhaustive k-fold CV over the cartesian product of `param_grid`.

    make_estimator: zero-arg factory returning a fresh estimator
      (anything with set_params/fit/predict — estimator.py facades).
    param_grid: {name: [values...]}.
    batched: None (auto) runs the fast path when the factory produces a
      plain PLSRegressor — all folds of a parameter setting evaluate as
      one vmapped masked-fit program, and an n_components grid costs a
      single fit per fold at max(A) (truncation nesting).  False forces
      the generic estimator loop (any fit/predict object).

    Returns (best: GridResult, results: list[GridResult]) with results in
    grid order; best minimizes mean RMSE over folds.
    """
    X = np.asarray(X)
    Y = np.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    splits = kfold_split(X.shape[0], n_folds, key)

    if batched is None:
        from pls_tpu.estimator import PLSRegressor

        # exact-type check: subclasses may override fit/predict semantics
        batched = type(make_estimator()) is PLSRegressor
    if batched:
        return _grid_search_cv_batched(make_estimator, param_grid, X, Y, splits)

    names = list(param_grid)
    results: list[GridResult] = []
    for values in itertools.product(*(param_grid[n] for n in names)):
        params = dict(zip(names, values))
        fold_rmse = []
        for train, test in splits:
            est = make_estimator().set_params(**params)
            est.fit(X[train], Y[train])
            pred = np.asarray(est.predict(X[test])).reshape(Y[test].shape)
            fold_rmse.append(float(np.sqrt(np.mean((pred - Y[test]) ** 2))))
        fold_rmse = np.asarray(fold_rmse)
        results.append(GridResult(params, fold_rmse, float(fold_rmse.mean())))
    best = min(results, key=lambda r: r.rmse)
    return best, results


@dataclass
class NestedCVResult:
    """Nested (double) CV outcome.

    chosen     : (k_outer,) inner-loop selection per outer fold
    fold_rmsep : (k_outer, M) outer-test RMSEP at each fold's chosen value
    rmsep      : (M,) pooled outer RMSEP (over all held-out rows) — the
                 honest generalization estimate
    """

    chosen: np.ndarray
    fold_rmsep: np.ndarray
    rmsep: np.ndarray


def nested_cv_components(
    X,
    Y,
    A_max: int,
    *,
    k_outer: int = 5,
    k_inner: int = 7,
    method=None,
    select: str = "wilcoxon",
    alpha: float = 0.1,
    key: jax.Array | int | None = 0,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> NestedCVResult:
    """Nested (double) CV for the number of PLS components.

    The single-loop selector (`cv/validation.optimal_num_components`,
    mirroring the reference /root/reference/src/pls.cpp:263-289) reuses
    the same folds for selection and error estimation, which biases the
    reported error optimistically.  Nested CV removes that bias: for
    each of `k_outer` outer folds, an inner `k_inner`-fold CV on the
    outer-TRAIN rows picks A*, then a fresh A*-component fit on the
    outer-train rows is scored on the outer-TEST rows — data never seen
    by the selection.  The pooled outer RMSEP is the honest estimate.

    Device shape: each inner CV is ONE vmapped masked-fit program (all
    A_max truncations from a single fit per fold — the kernel-PLS
    nesting property), so the total work is k_outer compiled programs,
    not k_outer × k_inner × A_max.

    select: "wilcoxon" — per-y-var parsimony rule at `alpha`, taking the
    max over y-vars (one shared model must serve all responses);
    "min" — fewest components minimizing PRESS summed over y-vars.

    X/Y are used as given (pre-scaled by the caller, the reference CLI
    convention — /root/reference/src/main.cpp:24-25; fold-internal
    rescaling is intentionally NOT performed, matching how the
    reference's own CV methods consume already-scaled data).
    """
    import jax.numpy as jnp

    from pls_tpu.cv.kfold import cv_kfold
    from pls_tpu.cv.validation import optimal_num_components, validation
    from pls_tpu.models.kernel_pls import fit
    from pls_tpu.models.predict import residuals
    from pls_tpu.types import METHOD, RESS

    method = METHOD.KERNEL_TYPE1 if method is None else method
    X = np.asarray(X)
    Y = np.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N, M = X.shape[0], Y.shape[1]
    if select not in ("wilcoxon", "min"):
        raise ValueError(f"unknown select {select!r} ('wilcoxon' | 'min')")

    if isinstance(key, int):
        key = jax.random.key(key)
    k_out, k_in = jax.random.split(key)
    splits = kfold_split(N, k_outer, k_out)
    inner_keys = jax.random.split(k_in, k_outer)

    chosen = np.zeros(k_outer, dtype=int)
    fold_rmsep = np.zeros((k_outer, M))
    sq_sum = np.zeros(M)
    n_test_total = 0
    for o, (train, test) in enumerate(splits):
        Xtr, Ytr = jnp.asarray(X[train]), jnp.asarray(Y[train])
        inner = cv_kfold(
            Xtr, Ytr, A_max, k_inner, method,
            key=inner_keys[o], power_iters=power_iters, precision=precision,
        )
        if select == "wilcoxon":
            a_star = int(np.max(np.asarray(optimal_num_components(inner, alpha))))
        else:
            press = np.asarray(validation(inner, RESS)).sum(axis=0)  # (A,)
            a_star = int(np.argmin(press)) + 1
        f = fit(
            Xtr, Ytr, a_star, method,
            power_iters=power_iters, precision=precision,
        )
        err = np.asarray(residuals(f, jnp.asarray(X[test]), jnp.asarray(Y[test])))
        chosen[o] = a_star
        fold_rmsep[o] = np.sqrt(np.mean(err**2, axis=0))
        sq_sum += np.sum(err**2, axis=0)
        n_test_total += len(test)

    return NestedCVResult(
        chosen=chosen,
        fold_rmsep=fold_rmsep,
        rmsep=np.sqrt(sq_sum / n_test_total),
    )


def nested_grid_search_cv(
    make_estimator,
    param_grid: dict,
    X,
    Y,
    *,
    k_outer: int = 5,
    k_inner: int = 5,
    key: jax.Array | int | None = 0,
) -> NestedCVResult:
    """Generic nested CV over an estimator parameter grid: per outer
    fold, `grid_search_cv` on the outer-train rows picks the parameters,
    a fresh fit is scored on the outer-test rows.  `chosen` holds the
    per-fold winning parameter dicts (object array)."""
    X = np.asarray(X)
    Y = np.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    if isinstance(key, int):
        key = jax.random.key(key)
    k_out, k_in = jax.random.split(key)
    splits = kfold_split(X.shape[0], k_outer, k_out)
    inner_keys = jax.random.split(k_in, k_outer)

    chosen = np.empty(k_outer, dtype=object)
    M = Y.shape[1]
    fold_rmsep = np.zeros((k_outer, M))
    sq_sum = np.zeros(M)
    n_test_total = 0
    for o, (train, test) in enumerate(splits):
        best, _ = grid_search_cv(
            make_estimator, param_grid, X[train], Y[train],
            n_folds=k_inner, key=inner_keys[o],
        )
        est = make_estimator().set_params(**best.params)
        est.fit(X[train], Y[train])
        pred = np.asarray(est.predict(X[test])).reshape(Y[test].shape)
        err = pred - Y[test]
        chosen[o] = best.params
        fold_rmsep[o] = np.sqrt(np.mean(err**2, axis=0))
        sq_sum += np.sum(err**2, axis=0)
        n_test_total += len(test)

    return NestedCVResult(
        chosen=chosen,
        fold_rmsep=fold_rmsep,
        rmsep=np.sqrt(sq_sum / n_test_total),
    )


def tune_spls_keepx(
    X, Y, A: int, keep_grid, *, n_folds: int = 5, key: jax.Array | None = None
):
    """Select sparse-PLS keep_x by k-fold RMSE.  Returns (best, results)."""
    from pls_tpu.estimator import SPLSRegressor

    return grid_search_cv(
        lambda: SPLSRegressor(n_components=A),
        {"keep_x": list(keep_grid)},
        X, Y, n_folds=n_folds, key=key,
    )


def tune_kpls(
    X, Y, *, gamma_grid, ncomp_grid, kernel: str = "rbf",
    n_folds: int = 5, key: jax.Array | None = None,
):
    """Joint (gamma, n_components) selection for kernel PLS."""
    from pls_tpu.estimator import KPLSRegressor

    return grid_search_cv(
        lambda: KPLSRegressor(kernel=kernel),
        {"gamma": list(gamma_grid), "n_components": list(ncomp_grid)},
        X, Y, n_folds=n_folds, key=key,
    )
