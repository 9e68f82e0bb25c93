"""Leave-some-out (Monte-Carlo) cross-validation, batched.

Reference analogue: `Model::cv_LSO` (/root/reference/src/pls.cpp:512-549)
— `num_trials` sequential shuffle-split refits.  Here the replicate axis
is a vmapped batch dimension over a precomputed (num_trials, N) partition
matrix: row r is a permutation of 0..N−1 whose first `train_size` entries
are the training rows (exactly the reference's `rand_nchoosek` layout,
pls.cpp:218-227).

Partitions come from either
- `jax.random.permutation` under an explicit PRNG key (the JAX-native path), or
- the GCC-compatibility RNG (utils/gcc_rng.py or the native extension),
  which replays std::mt19937 + libstdc++ std::shuffle bit-for-bit so LSO
  output matches the reference CLI exactly (it default-seeds its RNG —
  /root/reference/src/main.cpp:38-40 — making the reference deterministic).

Test size uses the reference's rounding: round(frac·N) via (frac·N + 0.5)
truncation (pls.cpp:516).  Error layout matches pls.cpp:520: per Y
variable, (num_trials·test_size, A) with replicate-major row blocks.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from pls_tpu.models.kernel_pls import fit
from pls_tpu.utils.batching import padded_map
from pls_tpu.models.predict import residuals_all_components
from pls_tpu.types import METHOD, Residual


def lso_sizes(n_rows: int, test_fraction: float) -> tuple[int, int]:
    """(train_size, test_size) with the reference's rounding (pls.cpp:516-518)."""
    test_size = int(test_fraction * n_rows + 0.5)
    train_size = n_rows - test_size
    if test_size == 0 or train_size == 0:
        raise ValueError(
            f"test_fraction={test_fraction} leaves an empty split for N={n_rows}"
        )
    return train_size, test_size


def random_partitions(
    key: jax.Array, n_rows: int, num_trials: int
) -> jnp.ndarray:
    """JAX-native partition matrix: (num_trials, N) of permuted indices."""
    keys = jax.random.split(key, num_trials)
    return jax.vmap(lambda k: jax.random.permutation(k, n_rows))(keys)


def cv_lso(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    test_fraction: float,
    num_trials: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    key: jax.Array | None = None,
    partitions: jnp.ndarray | None = None,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """Monte-Carlo CV.  Provide either `key` (jax PRNG) or `partitions`
    (a (num_trials, N) index matrix, e.g. from utils/gcc_rng.py for exact
    reference parity).  Returns Residual with errors
    (M, num_trials*test_size, A).  x_storage="bf16" applies the
    narrow-X/f32-accumulation policy to every replicate's refit."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    train_size, test_size = lso_sizes(N, test_fraction)

    if partitions is None:
        if key is None:
            raise ValueError("cv_lso needs either `key` or `partitions`")
        partitions = random_partitions(key, N, num_trials)
    partitions = jnp.asarray(partitions)
    if partitions.shape != (num_trials, N):
        raise ValueError(
            f"partitions shape {partitions.shape} != {(num_trials, N)}"
        )
    if batch_size is None:
        batch_size = min(num_trials, 32)

    def rep(perm):
        train_idx = perm[:train_size]
        test_idx = perm[train_size:]
        mask = jnp.zeros((N,), X.dtype).at[train_idx].set(1)
        f = fit(
            X, Y, A, method,
            row_mask=mask, power_iters=power_iters, precision=precision,
            x_storage=x_storage,
        )
        return residuals_all_components(f, X[test_idx], Y[test_idx])  # (test, A, M)

    errs = padded_map(rep, partitions, batch_size)  # (trials, test, A, M)
    M = Y.shape[1]
    errors = jnp.transpose(errs, (3, 0, 1, 2)).reshape(M, num_trials * test_size, A)
    return Residual(errors=errors, method="LSO")


def cv_lso_downdate(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    test_fraction: float,
    num_trials: int,
    *,
    key: jax.Array | None = None,
    partitions: jnp.ndarray | None = None,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """Monte-Carlo CV via implicit BLOCK downdates of XᵀX / XᵀY — the
    scalable formulation (KERNEL_TYPE2 semantics, like cv_loo_downdate).

    XX/XY are computed once; trial t refits from
    (XX − XtᵀXt, XY − XtᵀYt) where Xt is the trial's held-out test block,
    with the downdate implicit in the matvec
    (models/kernel_pls.fit_from_stats_blockdowndated).  Per trial
    O(K²·A + test_size·K·A) instead of the masked refit's O(N·K²) —
    the test block is the only X-sized object a trial touches, so this
    runs at design sizes where replicating or re-streaming X per trial
    (cv_lso / parallel.cv_lso_sharded) cannot.

    x_storage="bf16": X streams bfloat16 through the global statistics
    pass, the per-trial block downdates, and the residual matmuls, with
    f32 accumulation throughout (the fit() narrow-X policy).

    Same partition/rounding/error-layout contract as cv_lso (errors
    (M, num_trials·test_size, A), replicate-major).  Exactness vs
    brute-force masked refits: tests/test_cv.py.
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    train_size, test_size = lso_sizes(N, test_fraction)
    if partitions is None:
        if key is None:
            raise ValueError("cv_lso_downdate needs either `key` or `partitions`")
        partitions = random_partitions(key, N, num_trials)
    partitions = jnp.asarray(partitions)
    if partitions.shape != (num_trials, N):
        raise ValueError(
            f"partitions shape {partitions.shape} != {(num_trials, N)}"
        )
    test_idx = partitions[:, train_size:]  # (trials, test_size)
    if batch_size is None:
        batch_size = min(num_trials, 8)

    acc = X.dtype if X.dtype.itemsize >= 4 else jnp.float32
    Xs = X
    if x_storage is not None:
        if x_storage not in ("bf16", "bfloat16"):
            raise ValueError(f"unknown x_storage {x_storage!r} (use 'bf16')")
        Xs = X.astype(jnp.bfloat16)
    if Xs.dtype.itemsize < 4:
        XX = jax.lax.dot_general(
            Xs, Xs, (((0,), (0,)), ((), ())), preferred_element_type=acc
        )
        XY = jax.lax.dot_general(
            Xs, Y.astype(Xs.dtype), (((0,), (0,)), ((), ())),
            preferred_element_type=acc,
        )
    else:
        XX = X.T @ X
        XY = X.T @ Y

    from pls_tpu.models.kernel_pls import fit_from_stats_blockdowndated

    def rep(ti):
        Xt = Xs[ti]
        Yt = Y[ti].astype(acc)
        f = fit_from_stats_blockdowndated(
            XX, XY, Xt, Yt, A, power_iters=power_iters, precision=precision
        )
        return residuals_all_components(f, Xt.astype(acc), Yt)  # (test, A, M)

    errs = padded_map(rep, test_idx, batch_size)  # (trials, test, A, M)
    M = Y.shape[1]
    errors = jnp.transpose(errs, (3, 0, 1, 2)).reshape(
        M, num_trials * test_size, A
    )
    return Residual(errors=errors, method="LSO")
