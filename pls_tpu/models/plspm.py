"""PLS path modeling (PLS-PM / PLS-SEM) — Wold's soft modeling
(H. Wold 1982, "Soft modeling: the basic design and some extensions")
as consolidated by Lohmöller (1989) and the R `plspm` package.

Capability extension beyond the reference: structural equation modeling
with latent variables estimated by partial least squares — blocks of
manifest variables (indicators) each measure one latent variable, and a
lower-triangular path matrix encodes the inner (structural) model.

Algorithm (the classic alternating estimation):
  1. outer scores   yᵦ = Xᵦ wᵦ, standardized to unit variance
  2. inner proxies  zᵦ = Σ_c eᵦ꜀ y꜀ over blocks c adjacent to b, with
       scheme='centroid'  eᵦ꜀ = sign(corr(yᵦ, y꜀))
       scheme='factorial' eᵦ꜀ = corr(yᵦ, y꜀)
       scheme='path'      predecessors: multiple-regression coefficients
                          of yᵦ on them; successors: correlations
  3. outer weights  mode A (reflective):  wᵦ ∝ Xᵦᵀ zᵦ
                    mode B (formative):   wᵦ ∝ (XᵦᵀXᵦ)⁻¹ Xᵦᵀ zᵦ
  repeat until the weights stop changing; then path coefficients are the
  per-endogenous-block OLS of its score on its predecessors' scores.

Design notes: one iteration is a handful of (N, K)·(K, L) matmuls —
the L latent scores for ALL blocks come from one X @ W̃ with W̃ the
block-masked (K, L) weight matrix, and every correlation in the inner
step is one (L, L) Gram matrix of the standardized scores.  The
fixed-point loop is a `lax.while_loop` on the (K, L) weight matrix (L
and K static), so the whole fit is ONE compiled program; mode B's
per-block solve uses the block-masked Gram with an out-of-block identity
(exactly equivalent to the per-block inverse, no ragged work).

Two-block special case (tested): mode A with any scheme converges to the
dominant singular pair of XᵀY — i.e. the first PLS/PLSSVD component.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "PLSPMFit",
    "fit_plspm",
    "plspm_scores",
    "PLSPMBootstrap",
    "bootstrap_plspm",
]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PLSPMFit:
    """Immutable PLS-PM state.

    W        : (K, L) block-masked outer weights (unit-variance scores)
    scores   : (N, L) latent variable scores (unit variance)
    loadings : (K,)   correlation of each manifest variable with its
                      block's score (reflective interpretation)
    paths    : (L, L) inner path coefficients (paths[i, j]: j → i)
    r2       : (L,)   R² of each endogenous latent variable
    communality : (K,) squared loadings (per manifest variable)
    gof      : scalar goodness-of-fit (√(mean communality · mean R²))
    n_iter   : iterations to convergence
    converged: bool
    """

    W: jax.Array
    scores: jax.Array
    loadings: jax.Array
    paths: jax.Array
    r2: jax.Array
    communality: jax.Array
    gof: jax.Array
    n_iter: jax.Array
    converged: jax.Array


def _block_mask(blocks: list[list[int]], K: int) -> np.ndarray:
    mask = np.zeros((K, len(blocks)))
    seen: set[int] = set()
    for b, cols in enumerate(blocks):
        for j in cols:
            if j in seen:
                raise ValueError(f"manifest variable {j} is in two blocks")
            if not (0 <= j < K):
                raise ValueError(f"column {j} out of range for K={K}")
            seen.add(j)
            mask[j, b] = 1.0
    return mask


@partial(
    jax.jit,
    static_argnames=("scheme", "max_iter", "tol"),
)
def _fit_plspm(
    X, mask, modeB, path, scheme: str, max_iter: int, tol: float
):
    N, K = X.shape
    L = mask.shape[1]
    dt = X.dtype
    # adjacency: blocks connected in EITHER direction participate in the
    # inner proxy (path is lower-triangular: path[i, j]=1 means j → i)
    adj = path + path.T
    sN = 1.0 / N

    XtX = X.T @ X * sN  # manifest correlation matrix (X standardized)

    def scores_of(W):
        S = X @ W  # (N, L)
        sd = jnp.sqrt(jnp.sum(S * S, axis=0) * sN)
        return S / sd[None, :], W / sd[None, :]

    def inner_weights(R):
        # R: (L, L) correlation of current scores
        if scheme == "centroid":
            E = jnp.sign(R) * adj
        elif scheme == "factorial":
            E = R * adj
        else:  # 'path'
            # successors contribute their correlation; predecessors of
            # block i contribute the multiple-regression coefficients of
            # y_i on them: solve the masked normal equations per block
            # (out-of-predecessor rows get an identity so the solve is
            # well-posed and returns 0 there).
            def reg_row(i):
                pred = path[i]  # (L,) 1 where j → i
                Rm = R * jnp.outer(pred, pred) + jnp.diag(1.0 - pred)
                rhs = R[i] * pred
                beta = jnp.linalg.solve(Rm, rhs)
                return beta * pred

            B = jax.vmap(reg_row)(jnp.arange(L))  # (L, L) rows: preds of i
            E = B + (R * path.T)  # successors (j has successor i): corr
        return E

    def body(carry):
        W, _, it = carry
        S, Wn = scores_of(W)
        R = S.T @ S * sN
        E = inner_weights(R)
        Z = S @ E.T  # (N, L) inner proxies
        # outer update: mode A — w ∝ Xᵦᵀ z; mode B — masked-Gram solve
        WA = (X.T @ Z) * sN * mask  # (K, L)

        def modeB_col(b):
            m = mask[:, b]
            G = XtX * jnp.outer(m, m) + jnp.diag(1.0 - m)
            rhs = (X.T @ Z[:, b]) * sN * m
            return jnp.linalg.solve(G, rhs) * m

        WB = jax.vmap(modeB_col, out_axes=1)(jnp.arange(L))
        Wnew = jnp.where(modeB[None, :] > 0, WB, WA)
        # normalize to unit-variance scores for the convergence test
        _, Wnew = scores_of(Wnew)
        delta = jnp.max(jnp.abs(jnp.abs(Wnew) - jnp.abs(Wn)))
        return Wnew, delta, it + 1

    def cond(carry):
        _, delta, it = carry
        return (delta > tol) & (it < max_iter)

    W0 = mask.astype(dt)
    _, W0 = scores_of(W0)
    W, delta, n_iter = jax.lax.while_loop(
        cond, body, (W0, jnp.asarray(jnp.inf, dt), jnp.asarray(0))
    )

    S, W = scores_of(W)
    R = S.T @ S * sN
    # sign convention: each score positively correlated with the majority
    # of its manifest variables (plspm's standard orientation)
    load_all = (X.T @ S) * sN  # (K, L) corr since both standardized
    sign = jnp.sign(jnp.sum(load_all * mask, axis=0))
    sign = jnp.where(sign == 0, 1.0, sign)
    S = S * sign[None, :]
    W = W * sign[None, :]
    load_all = load_all * sign[None, :]
    loadings = jnp.sum(load_all * mask, axis=1)  # (K,)

    # inner path coefficients: per endogenous block, OLS on predecessors
    def path_row(i):
        pred = path[i]
        Rm = R * jnp.outer(pred, pred) + jnp.diag(1.0 - pred)
        beta = jnp.linalg.solve(Rm, R[i] * pred) * pred
        r2_i = beta @ R[i]
        return beta, r2_i

    paths, r2 = jax.vmap(path_row)(jnp.arange(L))
    endo = jnp.sum(path, axis=1) > 0
    r2 = jnp.where(endo, r2, 0.0)
    communality = loadings**2
    # GoF averages communality over the MODEL's manifest variables only —
    # columns assigned to no block (allowed) have loading 0 and must not
    # deflate the mean
    in_block = jnp.sum(mask, axis=1) > 0
    mean_comm = jnp.sum(jnp.where(in_block, communality, 0.0)) / jnp.sum(
        in_block
    )
    gof = jnp.sqrt(
        mean_comm * (jnp.sum(r2) / jnp.maximum(jnp.sum(endo), 1))
    )
    return PLSPMFit(
        W=W, scores=S, loadings=loadings, paths=paths, r2=r2,
        communality=communality, gof=gof, n_iter=n_iter,
        converged=delta <= tol,
    )


def fit_plspm(
    X,
    blocks: list[list[int]],
    path,
    *,
    modes: str | list[str] = "A",
    scheme: str = "centroid",
    max_iter: int = 300,
    tol: float = 1e-9,
) -> PLSPMFit:
    """Fit a PLS path model.

    Args:
      X: (N, K) manifest variables, standardized by the caller (z-scores;
         use preprocess.ZScorer / colwise_z_scores).
      blocks: list of column-index lists — blocks[b] are the indicators
         of latent variable b.  Every column belongs to at most one block.
      path: (L, L) lower-triangular 0/1 matrix; path[i, j] = 1 means
         latent j → latent i.
      modes: 'A' (reflective) / 'B' (formative), one letter for all
         blocks or a per-block list.
      scheme: inner weighting — 'centroid' | 'factorial' | 'path'.
    """
    X = jnp.asarray(X)
    K = X.shape[1]
    L = len(blocks)
    mask = _block_mask(blocks, K)
    path = np.asarray(path, dtype=float)
    if path.shape != (L, L):
        raise ValueError(f"path must be ({L}, {L}), got {path.shape}")
    if np.any(np.triu(path) != 0):
        raise ValueError("path must be strictly lower-triangular (j -> i)")
    if scheme not in ("centroid", "factorial", "path"):
        raise ValueError(f"unknown scheme {scheme!r}")
    if isinstance(modes, str):
        modes = [modes] * L
    if len(modes) != L or any(m not in ("A", "B") for m in modes):
        raise ValueError("modes must be 'A'/'B' (one per block)")
    modeB = jnp.asarray([1.0 if m == "B" else 0.0 for m in modes], X.dtype)
    return _fit_plspm(
        X,
        jnp.asarray(mask, X.dtype),
        modeB,
        jnp.asarray(path, X.dtype),
        scheme,
        int(max_iter),
        float(tol),
    )


def plspm_scores(fit: PLSPMFit, X_new) -> jnp.ndarray:
    """Latent scores for new standardized manifest data."""
    return jnp.asarray(X_new) @ fit.W


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class PLSPMBootstrap:
    """Bootstrap inference for a PLS path model (plspm-package style).

    paths_se / loadings_se : standard errors over resamples
    paths_lo, paths_hi     : percentile CI bounds for the path matrix
    paths_t                : original estimate / se (0 where no path)
    samples                : (B, L, L) raw bootstrap path matrices
    """

    paths_se: jax.Array
    paths_lo: jax.Array
    paths_hi: jax.Array
    paths_t: jax.Array
    loadings_se: jax.Array
    samples: jax.Array


def bootstrap_plspm(
    X,
    blocks: list[list[int]],
    path,
    n_boot: int = 200,
    *,
    key: jax.Array | int = 0,
    alpha: float = 0.05,
    modes: str | list[str] = "A",
    scheme: str = "centroid",
    max_iter: int = 300,
    tol: float = 1e-9,
) -> PLSPMBootstrap:
    """Bootstrap standard errors and percentile CIs for the path
    coefficients (and loading SEs).  Every resample is one row-gathered,
    re-standardized refit; ALL `n_boot` refits run as a single vmapped
    device program (each refit is itself the while_loop fixed point —
    under vmap it iterates until the slowest replicate converges).

    Sign indeterminacy is handled the same way as the point fit (scores
    oriented positively toward their block's manifests), so path samples
    are directly comparable across resamples."""
    X = jnp.asarray(X)
    N, K = X.shape
    L = len(blocks)
    mask = jnp.asarray(_block_mask(blocks, K), X.dtype)
    path_np = np.asarray(path, dtype=float)
    if isinstance(modes, str):
        modes = [modes] * L
    modeB = jnp.asarray([1.0 if m == "B" else 0.0 for m in modes], X.dtype)
    pathj = jnp.asarray(path_np, X.dtype)
    if isinstance(key, int):
        key = jax.random.key(key)
    idx = jax.random.randint(key, (n_boot, N), 0, N)

    point = fit_plspm(
        X, blocks, path_np, modes=modes, scheme=scheme,
        max_iter=max_iter, tol=tol,
    )

    def one(ix):
        Xb = X[ix]
        mu = jnp.mean(Xb, axis=0)
        sd = jnp.std(Xb, axis=0)
        Xb = (Xb - mu[None, :]) / jnp.where(sd == 0, 1.0, sd)[None, :]
        f = _fit_plspm(Xb, mask, modeB, pathj, scheme, max_iter, tol)
        return f.paths, f.loadings

    paths_b, loads_b = jax.vmap(one)(idx)  # (B, L, L), (B, K)
    se = jnp.std(paths_b, axis=0, ddof=1)
    lo = jnp.quantile(paths_b, alpha / 2, axis=0)
    hi = jnp.quantile(paths_b, 1 - alpha / 2, axis=0)
    t = jnp.where(se > 0, point.paths / jnp.where(se == 0, 1.0, se), 0.0)
    return PLSPMBootstrap(
        paths_se=se,
        paths_lo=lo,
        paths_hi=hi,
        paths_t=t,
        loadings_se=jnp.std(loads_b, axis=0, ddof=1),
        samples=paths_b,
    )
