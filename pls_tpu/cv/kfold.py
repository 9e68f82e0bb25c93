"""K-fold and leave-group-out cross-validation.

Not in the reference (tjhladish/PLS ships LOO / Monte-Carlo LSO / new-data
only — /root/reference/src/pls.cpp:469-549); standard CV flavors any
framework user expects.  Built on the same masked-fit machinery as
cv/loo.py: a fold is a {0,1} row mask, every use of X/Y in the kernel
algorithms is a masked reduction, so folds are a pure batch axis
(vmap/lax.map), chunkable and shardable over a mesh 'folds' axis.

- `cv_kfold`:   random (or caller-assigned) partition into k folds; each
  row is held out exactly once, so the error tensor has the same
  (M, N, A) layout as LOO and feeds the whole validation stack
  (PRESS/MSE/RMSE, Wilcoxon optimal-component selection) unchanged.
  k = N reproduces LOO exactly.
- `cv_group`:   leave-group-out over caller-provided integer group labels
  (e.g. batches, patients, instrument runs) — each distinct group is a
  fold.  Same (M, N, A) layout.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pls_tpu.models.kernel_pls import fit
from pls_tpu.models.predict import residuals_all_components
from pls_tpu.types import METHOD, Residual
from pls_tpu.utils.batching import padded_map


def kfold_assignments(
    n: int, k: int, key: jax.Array | int | None = None
) -> jnp.ndarray:
    """(N,) fold labels in [0, k): balanced sizes (|size_i − size_j| ≤ 1),
    shuffled with an explicit jax PRNG key (None = unshuffled blocks)."""
    base = jnp.arange(n) % k
    if key is None:
        return base
    if isinstance(key, int):
        key = jax.random.key(key)
    return jax.random.permutation(key, base)


def _cv_by_assignment(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    assign: jnp.ndarray,
    fold_ids: jnp.ndarray,
    A: int,
    method: METHOD,
    label: str,
    *,
    batch_size: int | None,
    power_iters: int | None,
    precision: str | None,
    x_storage: str | None = None,
) -> Residual:
    """Shared engine: one masked fit per fold id, residuals scattered back
    to each row's own fold. Returns Residual errors (M, N, A)."""
    N = X.shape[0]
    k = int(fold_ids.shape[0])
    if batch_size is None:
        batch_size = min(k, 32)

    def fold(fid):
        mask = (assign != fid).astype(X.dtype)
        f = fit(
            X, Y, A, method,
            row_mask=mask, power_iters=power_iters, precision=precision,
            x_storage=x_storage,
        )
        return residuals_all_components(f, X, Y)  # (N, A, M)

    errs = padded_map(fold, fold_ids, batch_size)  # (k, N, A, M)
    # row i's error comes from the fold that held it out
    pos = jnp.argmax(fold_ids[:, None] == assign[None, :], axis=0)  # (N,)
    own = jnp.take_along_axis(errs, pos[None, :, None, None], axis=0)[0]
    return Residual(errors=jnp.transpose(own, (2, 0, 1)), method=label)


def cv_kfold(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    k: int = 10,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    assignments: jnp.ndarray | None = None,
    key: jax.Array | int | None = 0,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """K-fold CV. Returns Residual with errors (M, N, A).

    assignments: optional (N,) fold labels in [0, k) (overrides key);
    key: jax PRNG key or int seed for the random balanced partition;
    x_storage="bf16": narrow-X/f32-accumulation refits (fit() docs).
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    if not (2 <= k <= N):
        raise ValueError(f"k={k} must satisfy 2 <= k <= N={N}")
    if assignments is None:
        assignments = kfold_assignments(N, k, key)
    assignments = jnp.asarray(_check_assignments(assignments, k))
    return _cv_by_assignment(
        X, Y, assignments, jnp.arange(k), A, method, f"{k}-FOLD",
        batch_size=batch_size, power_iters=power_iters, precision=precision,
        x_storage=x_storage,
    )


def _check_assignments(assign, k: int) -> np.ndarray:
    """Validate (N,) fold labels lie in [0, k).  Out-of-range labels
    would otherwise fail SILENTLY: in the masked-refit engine an
    unmatched row's argmax over an all-False row resolves to fold 0 (the
    row gets in-sample errors from a model trained on it), and in the
    one-pass scheme such rows drop out of every fold's statistics."""
    a = np.asarray(assign)
    if a.ndim != 1:
        raise ValueError(f"assignments must be 1-D, got shape {a.shape}")
    if a.size and (a.min() < 0 or a.max() >= k):
        raise ValueError(
            f"fold assignments must lie in [0, {k}); got range "
            f"[{a.min()}, {a.max()}]"
        )
    return a


def _fold_blocks(assign: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """Equal-size fold index/mask matrices from (N,) fold labels.

    Returns (idx, mask), both (k, Nf_max): row f lists fold f's row
    indices padded with 0, mask flags the real entries.  Zero-padding is
    exact for the block downdate (the padded rows are zeroed before use).
    """
    counts = np.bincount(assign, minlength=k)
    nf = int(counts.max())
    idx = np.zeros((k, nf), dtype=np.int32)
    mask = np.zeros((k, nf), dtype=bool)
    for f in range(k):
        rows = np.flatnonzero(assign == f)
        idx[f, : len(rows)] = rows
        mask[f, : len(rows)] = True
    return idx, mask


def cv_kfold_downdate(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    k: int = 10,
    *,
    assignments: jnp.ndarray | None = None,
    key: jax.Array | int | None = 0,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """K-fold CV via implicit BLOCK downdates of XᵀX / XᵀY — the scalable
    formulation (KERNEL_TYPE2 semantics, like cv_loo_downdate).

    XX = XᵀX and XY = XᵀY are computed once; fold f refits from
    (XX − XfᵀXf, XY − XfᵀYf) with the downdate applied implicitly inside
    the matvec (models/kernel_pls.fit_from_stats_blockdowndated), so no
    fold ever materializes a K×K matrix and the per-fold cost is
    O(K²·A + Nf·K·A) instead of the masked refit's O(N·K²).  Fold blocks
    are zero-padded to equal size (exact — zero rows contribute nothing
    to the downdate and have zero residuals) so folds batch via lax.map.

    x_storage="bf16": X streams bfloat16 through the global XᵀX/XᵀY pass,
    the fold-block downdates, and the residual matmuls, accumulating f32
    everywhere (the fit() narrow-X policy); statistics and model state
    stay f32.  Expected ~1e-3 relative component error (docs/PERF.md).

    Exactness vs brute-force masked refits: tests/test_cv.py.
    Returns Residual with errors (M, N, A) — same layout as cv_kfold.
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    if not (2 <= k <= N):
        raise ValueError(f"k={k} must satisfy 2 <= k <= N={N}")
    if assignments is None:
        assignments = kfold_assignments(N, k, key)
    assign_np = _check_assignments(assignments, k)
    idx_np, mask_np = _fold_blocks(assign_np, k)
    idx = jnp.asarray(idx_np)
    mask = jnp.asarray(mask_np)
    if batch_size is None:
        batch_size = min(k, 8)

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

    def fold(args):
        fi, fm = args
        m = fm.astype(acc)[:, None]
        Xf = Xs[fi] * m.astype(Xs.dtype)  # zero the padded rows (exact)
        Yf = (Y[fi] * m).astype(acc)
        f = fit_from_stats_blockdowndated(
            XX, XY, Xf, Yf, A, power_iters=power_iters, precision=precision
        )
        # held-out residuals at every truncation; padded rows yield 0
        return residuals_all_components(f, Xf.astype(acc), Yf) * m[:, None, :]

    errs = padded_map(fold, (idx, mask), batch_size)  # (k, Nf, A, M)
    A_, M = errs.shape[2], errs.shape[3]
    # each real row appears in exactly one fold: scatter-add back to rows
    # (padded entries are zeroed above, so their .at[0] adds are no-ops)
    own = jnp.zeros((N, A_, M), errs.dtype).at[idx.reshape(-1)].add(
        errs.reshape(-1, A_, M)
    )
    return Residual(errors=jnp.transpose(own, (2, 0, 1)), method=f"{k}-FOLD")


def cv_kfold_from_stats(
    XX: jnp.ndarray,
    XY: jnp.ndarray,
    folds,
    A: int,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> Residual:
    """K-fold CV directly from global statistics, fold blocks streamed —
    for designs too large to materialize (the 1M×10k north star).

    XX/XY come from one streaming pass (models/streaming.StatsAccumulator,
    possibly psum-merged across hosts); `folds` is an iterable of
    (Xf, Yf) held-out blocks (each must be contained in XX/XY), e.g.
    re-streamed from the binary ingest path (utils/binio.py) one fold at
    a time — at 1M×10k / k=10 a fold block is 4 GB, the only X-sized
    object on the device.  Fold blocks may be bfloat16 (f32 accumulation,
    see fit_from_stats_blockdowndated).

    Folds run sequentially (one jitted program, reused across folds of
    equal size).  Returns Residual errors (M, ΣNf, A) concatenated in
    iteration order — feed to cv/validation exactly like cv_kfold output.
    """
    from pls_tpu.models.kernel_pls import fit_from_stats_blockdowndated

    acc = XX.dtype
    outs = []
    for Xf, Yf in folds:
        Xf = jnp.asarray(Xf)
        Yf = jnp.asarray(Yf)
        if Yf.ndim == 1:
            Yf = Yf[:, None]
        f = fit_from_stats_blockdowndated(
            XX, XY, Xf, Yf.astype(acc), A,
            power_iters=power_iters, precision=precision,
        )
        res = residuals_all_components(f, Xf.astype(acc), Yf.astype(acc))
        # backpressure: finish this fold before pulling the next block —
        # a fold block is GBs at production scale, and async dispatch
        # would otherwise pin every block's buffers at once
        outs.append(jax.block_until_ready(res))  # (Nf, A, M)
    errs = jnp.concatenate(outs, axis=0)
    return Residual(errors=jnp.transpose(errs, (2, 0, 1)), method="K-FOLD")


@dataclass
class KFoldOnePass:
    """Result of the closed-form one-pass k-fold CV (cv_kfold_onepass).

    press/mse/rmse: (M, A) numpy float64 matrices in the same layout the
    validation summarizer produces (rows = Y variable, cols =
    truncation) — PRESS assembled on host in f64 because it is a
    difference of O(N)-sized terms (catastrophic cancellation in f32).
    B: (k, A, K, M) per-fold, per-truncation coefficients (device) —
    feed to the combined residual pass for per-row errors.
    fits: the k per-fold PLSFit states.  nf: (k,) held-out row counts.
    """

    press: np.ndarray
    mse: np.ndarray
    rmse: np.ndarray
    B: jnp.ndarray
    fits: list
    nf: np.ndarray

    @property
    def n_obs(self) -> int:
        return int(self.nf.sum())


@partial(jax.jit, static_argnames=("A", "power_iters", "precision"))
def _onepass_device(XXf, XYf, YYf, A, power_iters, precision):
    """The ENTIRE closed-form k-fold in ONE device program: lax.map over
    folds of (downdated fit → per-truncation B → PRESS contractions).
    One dispatch and small pulls, in place of ~8 dispatches per fold."""
    from pls_tpu.models.kernel_pls import _kernel2_scan

    acc = XXf.dtype
    XX = jnp.sum(XXf, axis=0)
    XY = jnp.sum(XYf, axis=0)
    K = XX.shape[0]

    def fold(f):
        XXt = XX - XXf[f]
        XYt = XY - XYf[f]
        fit = _kernel2_scan(
            lambda r: XXt @ r, XYt, A, K, acc, power_iters, precision
        )
        contrib = fit.R.T[:, :, None] * fit.Q.T[:, None, :]
        B = jnp.cumsum(contrib, axis=0)  # (A, K, M)
        u = jnp.einsum("kl,alm->akm", XXf[f], B,
                       precision=jax.lax.Precision.HIGHEST)
        cross = jnp.einsum("akm,km->am", B, XYf[f],
                           precision=jax.lax.Precision.HIGHEST)
        quad = jnp.sum(u * B, axis=1)  # (A, M)
        yy = jnp.diagonal(YYf[f])  # (M,)
        return fit.W, fit.P, fit.Q, fit.R, B, cross, quad, yy

    return jax.lax.map(fold, jnp.arange(XXf.shape[0]))


def cv_kfold_onepass(fold_stats, A: int, *,
                     power_iters: int | None = None,
                     precision: str | None = "highest") -> KFoldOnePass:
    """K-fold CV PRESS/MSE/RMSE with NO pass over the data at all —
    everything comes from the per-fold sufficient statistics a single
    streaming pass produced (models/streaming.FoldStatsAccumulator).

    Per fold f: the training statistics are (XX − XXf, XY − XYf) (exact
    — each row is in exactly one fold), the fold model is the X-free
    kernel-2 component loop, and the held-out sum of squared residuals
    at truncation c expands in the fold's own statistics:

        PRESS_f(c)[m] = YYf[m,m] − 2·B_c[:,m]·XYf[:,m]
                        + B_c[:,m]ᵀ XXf B_c[:,m]

    The K-contractions run on device (f32, `precision`); the final
    three-term combination — a small (A, M) object whose terms are
    O(N_f) while their difference is the residual SSE — is assembled on
    host in float64 so the cancellation costs no precision.  Total cost
    beyond the stats pass: k fits of O(A·K²) plus k·A K²-matvecs;
    nothing touches X.  Agreement with the residual-based
    cv_kfold_from_stats is pinned to 1e-5 by tests/test_kfold.py.

    Reference analogue: the per-fold refits + residual accumulation of
    Model::cv_LSO (/root/reference/src/pls.cpp:512-549), collapsed into
    statistics space.
    """
    from pls_tpu.types import METHOD, PLSFit

    fs = fold_stats
    k = int(fs.XXf.shape[0])
    Ws, Ps, Qs, Rs, B, cross, quad, yy = _onepass_device(
        fs.XXf, fs.XYf, fs.YYf, A, power_iters, precision
    )
    # host f64: the cancelling three-term combination, summed over folds
    press = (
        np.asarray(yy, np.float64)[:, None, :]
        - 2.0 * np.asarray(cross, np.float64)
        + np.asarray(quad, np.float64)
    ).sum(axis=0)  # (A, M)
    fits = [
        PLSFit(W=Ws[f], P=Ps[f], Q=Qs[f], R=Rs[f],
               T=jnp.zeros((0, A), B.dtype), method=METHOD.KERNEL_TYPE2)
        for f in range(k)
    ]
    nf = np.asarray(fs.nf)
    n = float(nf.sum())
    press_ma = press.T  # (M, A)
    mse = press_ma / n
    return KFoldOnePass(
        press=press_ma, mse=mse, rmse=np.sqrt(mse),
        B=B, fits=fits, nf=nf,
    )


@jax.jit
def fold_residual_chunk(B: jnp.ndarray, Xc: jnp.ndarray, Yc: jnp.ndarray,
                        assign: jnp.ndarray) -> jnp.ndarray:
    """Per-row CV residuals for ONE chunk under each row's own fold
    model, at every truncation — the combined second pass of the
    one-pass k-fold scheme (all folds applied in a single sweep, so the
    whole CV needs 2 total passes over X instead of 1+k).

    B: (k, A, K, M) per-fold per-truncation coefficients
    (KFoldOnePass.B);  Xc (n, K);  Yc (n, M);  assign (n,) fold labels.
    Returns (n, A, M) = Yc − Ŷ under fold assign[i]'s model.

    Row i's prediction is selected by masking: Σ_f 1[assign=f]·(Xc B_f),
    evaluated as a scan over folds with the mask folded into Xc — one
    (n, K)×(K, A·M) matmul per fold, no (n, k, A, M) intermediate.
    """
    n = Xc.shape[0]
    k, A, K, M = B.shape
    Bmat = jnp.transpose(B, (0, 2, 1, 3)).reshape(k, K, A * M)
    Xw = Xc.astype(Bmat.dtype)

    def body(carry, f):
        m = (assign == f).astype(Xw.dtype)
        carry = carry + (Xw * m[:, None]) @ Bmat[f]
        return carry, None

    yh0 = jnp.zeros((n, A * M), Bmat.dtype)
    yh, _ = jax.lax.scan(body, yh0, jnp.arange(k))
    return Yc.astype(Bmat.dtype)[:, None, :] - yh.reshape(n, A, M)


def cv_group(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    groups: jnp.ndarray,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> Residual:
    """Leave-group-out CV: each distinct value in `groups` (N,) is one
    fold. Returns Residual with errors (M, N, A)."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    groups_np = np.asarray(groups)
    uniq = np.unique(groups_np)
    if len(uniq) < 2:
        raise ValueError("need at least 2 distinct groups")
    # relabel to dense [0, G) so fold ids are a static iota
    dense = jnp.asarray(np.searchsorted(uniq, groups_np))
    return _cv_by_assignment(
        X, Y, dense, jnp.arange(len(uniq)), A, method, "GROUP",
        batch_size=batch_size, power_iters=power_iters, precision=precision,
    )
