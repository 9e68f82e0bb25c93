"""Interval PLS (iPLS) variable selection — Nørgaard et al. (2000),
Appl. Spectrosc. 54:413.

Not in the reference (which has no variable selection); the standard
wavelength-selection method for PLS on spectra, and the natural partner
of the nir/octane dataset the reference ships (SURVEY.md §2 #27).

The channel axis is split into contiguous intervals; each candidate
channel subset is scored by k-fold cross-validated RMSE of a PLS model
restricted to those channels.  Variants:

- `ipls`          — per-interval RMSECV table vs. the global model
                    (the classic iPLS plot).
- `ipls_forward`  — greedy synergy-iPLS: grow a set of intervals while
                    CV error improves.
- `ipls_backward` — greedy elimination: drop intervals while CV error
                    improves (or stays within `tol`).

Accelerator formulation: a channel subset is a {0,1} **column mask**.
Zeroed columns of X propagate exact zeros through XY = XᵀY, the weight
vectors and loadings (see models/kernel_pls.py), so a column-masked fit
is arithmetically identical to fitting on the channel subset — which
makes candidate subsets a pure batch axis.  Every round of the greedy
searches evaluates ALL candidate subsets as one batched program
(padded lax.map over masks × vmap-style fold loop), instead of the
reference-style nested Python loops an iPLS implementation usually is.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from pls_tpu.cv.kfold import kfold_assignments
from pls_tpu.models.kernel_pls import fit
from pls_tpu.models.predict import residuals_all_components
from pls_tpu.types import METHOD
from pls_tpu.utils.batching import padded_map

__all__ = [
    "interval_edges",
    "interval_masks",
    "ipls",
    "ipls_forward",
    "ipls_backward",
    "IPLSResult",
    "IPLSSelection",
    "uve_pls",
    "UVEResult",
]


def interval_edges(K: int, n_intervals: int) -> np.ndarray:
    """(n_intervals+1,) channel edges of a balanced contiguous split
    (interval i covers columns edges[i]:edges[i+1]; sizes differ by ≤1)."""
    if not (1 <= n_intervals <= K):
        raise ValueError(f"n_intervals={n_intervals} must be in [1, K={K}]")
    return np.linspace(0, K, n_intervals + 1).round().astype(int)


def interval_masks(K: int, n_intervals: int) -> np.ndarray:
    """(n_intervals, K) {0,1} column masks for the balanced split."""
    edges = interval_edges(K, n_intervals)
    masks = np.zeros((n_intervals, K))
    for i in range(n_intervals):
        masks[i, edges[i] : edges[i + 1]] = 1.0
    return masks


def _press_for_masks(
    X, Y, masks, A, assign, k, method, precision, batch_size
) -> jnp.ndarray:
    """k-fold CV PRESS for each candidate column mask.

    Returns (C, A, M): summed squared held-out residuals per candidate,
    component truncation, and response."""
    fold_ids = jnp.arange(k)

    def one_candidate(cmask):
        Xm = X * cmask[None, :]

        def fold(carry, fid):
            keep = (assign != fid).astype(X.dtype)
            f = fit(Xm, Y, A, method, row_mask=keep, precision=precision)
            res = residuals_all_components(f, Xm, Y)  # (N, A, M)
            held = (1.0 - keep)[:, None, None]
            return carry + jnp.sum(res * res * held, axis=0), None

        M = Y.shape[1]
        press, _ = jax.lax.scan(
            fold, jnp.zeros((A, M), X.dtype), fold_ids
        )
        return press

    return padded_map(one_candidate, jnp.asarray(masks, X.dtype), batch_size)


@dataclass(frozen=True)
class IPLSResult:
    """Per-interval iPLS table."""

    edges: np.ndarray  # (n_intervals+1,) channel edges
    rmsecv: np.ndarray  # (n_intervals, A) mean-over-M RMSECV per comps 1..A
    global_rmsecv: np.ndarray  # (A,) full-spectrum model RMSECV
    best_interval: int  # argmin over intervals of min-over-comps RMSECV
    best_ncomp: int  # 1-based comps of the winning interval model

    def summary(self) -> str:
        lines = [
            f"iPLS: {len(self.edges) - 1} intervals, global best RMSECV "
            f"{self.global_rmsecv.min():.6g}"
        ]
        for i in range(len(self.edges) - 1):
            star = " *" if i == self.best_interval else ""
            lines.append(
                f"  [{self.edges[i]:4d}:{self.edges[i + 1]:4d})  "
                f"RMSECV {self.rmsecv[i].min():.6g}{star}"
            )
        return "\n".join(lines)


def _prep(X, Y):
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    return X, Y


def ipls(
    X,
    Y,
    n_intervals: int = 10,
    A: int = 5,
    k: int = 10,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    key: jax.Array | int | None = 0,
    precision: str | None = "highest",
    batch_size: int = 8,
) -> IPLSResult:
    """Classic iPLS: k-fold RMSECV of one PLS model per channel interval,
    plus the full-spectrum model for comparison.  `A` must not exceed the
    smallest interval width."""
    X, Y = _prep(X, Y)
    N, K = X.shape
    edges = interval_edges(K, n_intervals)
    min_width = int(np.diff(edges).min())
    if A > min_width:
        raise ValueError(
            f"A={A} exceeds the smallest interval width {min_width}; "
            f"lower A or n_intervals"
        )
    masks = np.vstack([interval_masks(K, n_intervals), np.ones((1, K))])
    assign = kfold_assignments(N, k, key)
    press = _press_for_masks(
        X, Y, masks, A, assign, k, method, precision, batch_size
    )  # (C+1, A, M)
    rmse = np.asarray(jnp.sqrt(jnp.mean(press / N, axis=-1)))  # (C+1, A)
    per_interval, global_rmse = rmse[:-1], rmse[-1]
    flat_best = int(per_interval.min(axis=1).argmin())
    return IPLSResult(
        edges=edges,
        rmsecv=per_interval,
        global_rmsecv=global_rmse,
        best_interval=flat_best,
        best_ncomp=int(per_interval[flat_best].argmin()) + 1,
    )


@dataclass(frozen=True)
class IPLSSelection:
    """Result of a greedy interval search."""

    edges: np.ndarray
    selected: list[int] = field(default_factory=list)  # interval ids, pick order
    mask: np.ndarray = None  # (K,) {0,1} selected-channel mask
    rmsecv_path: np.ndarray = None  # best RMSECV after each greedy step
    ncomp: int = 0  # 1-based comps of the final model

    @property
    def n_selected_channels(self) -> int:
        return int(self.mask.sum())


def _greedy(
    X, Y, n_intervals, A, k, method, key, precision, batch_size,
    *, forward: bool, max_steps: int | None, tol: float,
) -> IPLSSelection:
    X, Y = _prep(X, Y)
    N, K = X.shape
    edges = interval_edges(K, n_intervals)
    min_width = int(np.diff(edges).min())
    if A > min_width:
        raise ValueError(
            f"A={A} exceeds the smallest interval width {min_width}; "
            f"lower A or n_intervals"
        )
    imasks = interval_masks(K, n_intervals)
    assign = kfold_assignments(N, k, key)

    def score(cands: np.ndarray) -> np.ndarray:
        press = _press_for_masks(
            X, Y, cands, A, assign, k, method, precision, batch_size
        )
        return np.asarray(jnp.sqrt(jnp.mean(press / N, axis=-1)))  # (C, A)

    if forward:
        chosen: list[int] = []
        current = np.zeros(K)
        best_rmse = np.inf
        best_ncomp = 0
        path = []
        limit = max_steps or n_intervals
        while len(chosen) < limit:
            remaining = [i for i in range(n_intervals) if i not in chosen]
            if not remaining:
                break
            cands = np.vstack(
                [np.minimum(current + imasks[i], 1.0) for i in remaining]
            )
            rmse = score(cands)  # (C, A)
            per = rmse.min(axis=1)
            j = int(per.argmin())
            if per[j] >= best_rmse * (1.0 - tol) and chosen:
                break  # no meaningful improvement
            best_rmse = float(per[j])
            best_ncomp = int(rmse[j].argmin()) + 1
            chosen.append(remaining[j])
            current = cands[j]
            path.append(best_rmse)
        return IPLSSelection(
            edges=edges, selected=chosen, mask=current,
            rmsecv_path=np.asarray(path), ncomp=best_ncomp,
        )

    # backward elimination: start from the full spectrum
    chosen = list(range(n_intervals))
    current = np.ones(K)
    base = score(current[None, :])
    best_rmse = float(base.min())
    best_ncomp = int(base[0].argmin()) + 1
    path = [best_rmse]
    limit = max_steps or (n_intervals - 1)
    steps = 0
    while len(chosen) > 1 and steps < limit:
        cands = np.vstack([current - imasks[i] for i in chosen])
        rmse = score(cands)
        per = rmse.min(axis=1)
        j = int(per.argmin())
        if per[j] > best_rmse * (1.0 + tol):
            break  # every removal hurts
        best_rmse = min(best_rmse, float(per[j]))
        best_ncomp = int(rmse[j].argmin()) + 1
        current = cands[j]
        chosen.pop(j)
        path.append(float(per[j]))
        steps += 1
    return IPLSSelection(
        edges=edges, selected=sorted(chosen), mask=current,
        rmsecv_path=np.asarray(path), ncomp=best_ncomp,
    )


def ipls_forward(
    X, Y, n_intervals: int = 10, A: int = 5, k: int = 10,
    method: METHOD = METHOD.KERNEL_TYPE1, *,
    key: jax.Array | int | None = 0, max_intervals: int | None = None,
    tol: float = 1e-4, precision: str | None = "highest",
    batch_size: int = 8,
) -> IPLSSelection:
    """Forward synergy-iPLS: greedily add the interval that most lowers
    k-fold RMSECV; stop when improvement falls below `tol` (relative) or
    `max_intervals` is reached.  Each greedy round scores all remaining
    candidate subsets as one batched device program."""
    return _greedy(
        X, Y, n_intervals, A, k, method, key, precision, batch_size,
        forward=True, max_steps=max_intervals, tol=tol,
    )


@dataclass(frozen=True)
class UVEResult:
    """UVE-PLS screening result.

    reliability : (K,) |mean/std| of each real variable's coefficient
                  across CV folds
    cutoff      : max reliability among the appended noise variables
    selected    : (K,) bool — reliability > cutoff
    """

    reliability: np.ndarray
    cutoff: float
    selected: np.ndarray


def uve_pls(
    X,
    Y,
    A: int,
    k: int | None = None,
    *,
    key: jax.Array | int = 0,
    noise_scale: float = 1e-10,
    method: METHOD = METHOD.KERNEL_TYPE1,
    precision: str | None = "highest",
    batch_size: int = 32,
) -> UVEResult:
    """Uninformative Variable Elimination (Centner et al. 1996, Anal.
    Chem. 68:3851): append K tiny random noise variables to X, jackknife
    the regression coefficients over CV folds (k=None → leave-one-out),
    and keep real variables whose coefficient stability |mean/std| beats
    the best noise variable's.  All fold refits run as one batched
    program (row-masked fits, like cv/loo.py)."""
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N, K = X.shape
    if isinstance(key, int):
        key = jax.random.key(key)
    k_noise, k_fold = jax.random.split(key)  # never reuse a jax PRNG key
    noise = noise_scale * jax.random.normal(k_noise, (N, K), X.dtype)
    Xa = jnp.concatenate([X, noise], axis=1)

    folds = N if k is None else k
    assign = kfold_assignments(N, folds, None if k is None else k_fold)

    def fold(fid):
        keep = (assign != fid).astype(X.dtype)
        f = fit(Xa, Y, A, method, row_mask=keep, precision=precision)
        from pls_tpu.models.predict import coefficients

        return coefficients(f)  # (2K, M)

    B = padded_map(fold, jnp.arange(folds), batch_size)  # (folds, 2K, M)
    mean = jnp.mean(B, axis=0)
    std = jnp.std(B, axis=0, ddof=1)
    c = jnp.abs(mean / jnp.where(std == 0, jnp.inf, std))  # (2K, M)
    # multi-response: a variable is informative if stable for ANY response
    c = jnp.max(c, axis=1)
    c_real = np.asarray(c[:K])
    cutoff = float(jnp.max(c[K:]))
    return UVEResult(
        reliability=c_real, cutoff=cutoff, selected=c_real > cutoff
    )


def ipls_backward(
    X, Y, n_intervals: int = 10, A: int = 5, k: int = 10,
    method: METHOD = METHOD.KERNEL_TYPE1, *,
    key: jax.Array | int | None = 0, max_removals: int | None = None,
    tol: float = 1e-4, precision: str | None = "highest",
    batch_size: int = 8,
) -> IPLSSelection:
    """Backward iPLS: greedily remove the interval whose removal lowers
    (or least worsens, within `tol`) the k-fold RMSECV."""
    return _greedy(
        X, Y, n_intervals, A, k, method, key, precision, batch_size,
        forward=False, max_steps=max_removals, tol=tol,
    )
