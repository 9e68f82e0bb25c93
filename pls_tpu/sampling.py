"""Calibration-set sampling: Kennard–Stone, SPXY, and duplex splits.

Not in the reference (which has no sample-selection tooling); these are
the standard chemometrics answers to "which samples go in the
calibration set" — deterministic, coverage-maximizing alternatives to
random splits, used before the fit/CV stack (docs/MIGRATION.md):

- `kennard_stone` (Kennard & Stone 1969, Technometrics 11:137): start
  from the farthest pair, then repeatedly add the candidate whose
  minimum distance to the already-selected set is largest (max-min).
- `spxy` (Galvão et al. 2005, Talanta 67:736): Kennard–Stone under the
  joint distance  d = dX/max(dX) + dY/max(dY) — Euclidean distances
  (not squared) sum across the two blocks, the paper's metric.
- `duplex` (Snee 1977, Technometrics 19:415): alternate max-min
  additions between the calibration and validation sets, giving two
  sets with matched coverage.

Accelerator formulation: the classic implementations keep an N×N distance
matrix and do Python argmax loops.  Here every method shares ONE
engine over a tuple of coordinate blocks (KS/duplex: one block; SPXY:
normalized X and Y blocks) whose joint distance is Σ_b ‖·‖_b.  The
selection state is a single N-vector `mind` (each sample's min joint
distance to the selected set), updated per pick with one matvec per
block  d²(·, new) = ‖z‖² + ‖z_new‖² − 2·Z z_new  inside a `lax.scan` —
O(N·K) per step, O(N) memory, no pairwise matrix.  The farthest-pair
seed streams row blocks of the Gram products (`lax.map`), again never
materializing N×N.  All blocks are centered first (distances are
translation-invariant; centering kills the catastrophic cancellation
the ‖z‖²-based expansion suffers when coordinates sit far from the
origin, e.g. a near-constant Y).  All jit-compiled with static
selection counts.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = ["kennard_stone", "spxy", "duplex", "ks_train_test_split"]

_BLOCK = 256  # farthest-pair row-block size (memory: 2 × BLOCK × N floats)


def _prep_blocks(*blocks):
    """Center each coordinate block (translation-invariant distances,
    cancellation-safe norms) and return (blocks, squared-norm vectors)."""
    Zs = tuple(
        (Z := jnp.atleast_2d(jnp.asarray(b))) - jnp.mean(Z, axis=0)
        for b in blocks
    )
    sqs = tuple(jnp.sum(Z * Z, axis=1) for Z in Zs)
    return Zs, sqs


def _dist_to(Zs, sqs, idx):
    """(N,) joint distance Σ_b ‖z_b − z_b[idx]‖ via one matvec per block."""
    d = 0.0
    for Z, sq in zip(Zs, sqs):
        d2 = sq + sq[idx] - 2.0 * (Z @ Z[idx])
        d = d + jnp.sqrt(jnp.maximum(d2, 0.0))
    return d


@jax.jit
def _farthest_pair(Zs, sqs, exclude=None):
    """(i, j) maximizing the joint distance, streaming row blocks; rows
    with `exclude` True never appear in the winning pair."""
    N = Zs[0].shape[0]
    bonus = (
        jnp.zeros(N)
        if exclude is None
        else jnp.where(exclude, -jnp.inf, 0.0)
    )
    pad = (-N) % _BLOCK
    idx = jnp.arange(N + pad) % N  # padding wraps onto real rows (harmless dups)

    def blk(rows):
        D = 0.0
        for Z, sq in zip(Zs, sqs):
            D2 = sq[rows][:, None] + sq[None, :] - 2.0 * (Z[rows] @ Z.T)
            D = D + jnp.sqrt(jnp.maximum(D2, 0.0))
        D = D + bonus[None, :] + bonus[rows][:, None]
        j = jnp.argmax(D, axis=1)
        return jnp.take_along_axis(D, j[:, None], axis=1)[:, 0], j

    dmax, jmax = jax.lax.map(blk, idx.reshape(-1, _BLOCK))
    dmax, jmax = dmax.reshape(-1), jmax.reshape(-1)
    i = jnp.argmax(dmax)
    return idx[i], jmax[i]


@partial(jax.jit, static_argnames=("n_select",))
def _maxmin_core(Zs, sqs, n_select: int, i0, j0):
    """Max-min selection from seed pair (i0, j0) under the joint metric."""
    sel0 = jnp.zeros(Zs[0].shape[0], bool).at[i0].set(True).at[j0].set(True)
    mind0 = jnp.minimum(_dist_to(Zs, sqs, i0), _dist_to(Zs, sqs, j0))

    def step(carry, _):
        mind, sel = carry
        nxt = jnp.argmax(jnp.where(sel, -jnp.inf, mind))
        sel = sel.at[nxt].set(True)
        mind = jnp.minimum(mind, _dist_to(Zs, sqs, nxt))
        return (mind, sel), nxt

    seed = jnp.stack([i0, j0])
    if n_select == 2:
        return seed
    _, picks = jax.lax.scan(step, (mind0, sel0), None, length=n_select - 2)
    return jnp.concatenate([seed, picks])


def kennard_stone(X, n_select: int) -> np.ndarray:
    """Kennard–Stone max-min selection.  Returns (n_select,) indices in
    pick order (the first two are the farthest pair)."""
    N = np.asarray(X).shape[0]
    if not (2 <= n_select <= N):
        raise ValueError(f"need 2 <= n_select <= N, got {n_select} / {N}")
    Zs, sqs = _prep_blocks(X)
    i0, j0 = _farthest_pair(Zs, sqs)
    return np.asarray(_maxmin_core(Zs, sqs, n_select, i0, j0))


def spxy(X, Y, n_select: int) -> np.ndarray:
    """SPXY selection (Galvão 2005): Kennard–Stone under the joint
    normalized Euclidean distance d = dX/max(dX) + dY/max(dY).  Each
    block is scaled so its max pairwise distance is 1; a degenerate
    block (constant rows, max distance 0 — e.g. a constant Y) is zeroed
    out, gracefully reducing to KS on the remaining block.  Returns
    (n_select,) indices in pick order."""
    X = np.asarray(X)
    Y = np.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    if Y.shape[0] != N:
        raise ValueError(f"X has {N} rows but Y has {Y.shape[0]}")
    if not (2 <= n_select <= N):
        raise ValueError(f"need 2 <= n_select <= N, got {n_select} / {N}")

    def _norm(Z):
        (Zc,), (sq,) = _prep_blocks(Z)
        i, j = _farthest_pair((Zc,), (sq,))
        dmax2 = jnp.sum((Zc[i] - Zc[j]) ** 2)
        scale = jnp.where(dmax2 > 0, jax.lax.rsqrt(jnp.maximum(dmax2, 1e-30)), 0.0)
        return Zc * scale

    Zs, sqs = _prep_blocks(_norm(X), _norm(Y))
    i0, j0 = _farthest_pair(Zs, sqs)
    return np.asarray(_maxmin_core(Zs, sqs, n_select, i0, j0))


@partial(jax.jit, static_argnames=("n_cal",))
def _duplex_core(Zs, sqs, n_cal: int, i0, j0, i1, j1):
    N = Zs[0].shape[0]
    assigned0 = (
        jnp.zeros(N, bool).at[i0].set(True).at[j0].set(True)
        .at[i1].set(True).at[j1].set(True)
    )
    d_i0, d_j0 = _dist_to(Zs, sqs, i0), _dist_to(Zs, sqs, j0)
    d_i1, d_j1 = _dist_to(Zs, sqs, i1), _dist_to(Zs, sqs, j1)
    mind_cal0 = jnp.minimum(d_i0, d_j0)
    mind_val0 = jnp.minimum(d_i1, d_j1)

    # static alternating schedule: cal/val while both still need points,
    # then whichever set has remaining capacity takes the leftovers
    n_more_cal, n_more_val = n_cal - 2, N - n_cal - 2
    sched = []
    while n_more_cal or n_more_val:
        if n_more_cal and (len(sched) % 2 == 0 or not n_more_val):
            sched.append(True)
            n_more_cal -= 1
        else:
            sched.append(False)
            n_more_val -= 1
    order = jnp.asarray(np.asarray(sched, bool))

    def step(carry, to_cal):
        mind_cal, mind_val, assigned = carry
        mind = jnp.where(to_cal, mind_cal, mind_val)
        nxt = jnp.argmax(jnp.where(assigned, -jnp.inf, mind))
        assigned = assigned.at[nxt].set(True)
        d = _dist_to(Zs, sqs, nxt)
        mind_cal = jnp.where(to_cal, jnp.minimum(mind_cal, d), mind_cal)
        mind_val = jnp.where(to_cal, mind_val, jnp.minimum(mind_val, d))
        return (mind_cal, mind_val, assigned), nxt

    _, picks = jax.lax.scan(step, (mind_cal0, mind_val0, assigned0), order)
    return picks, order


def duplex(X, n_cal: int) -> tuple[np.ndarray, np.ndarray]:
    """Duplex split (Snee 1977): the farthest pair seeds the calibration
    set, the farthest remaining pair seeds the validation set, then
    max-min additions alternate between the sets (calibration first;
    once one set is full the other takes the leftovers).  Returns
    (cal_idx (n_cal,), val_idx (N − n_cal,))."""
    N = np.asarray(X).shape[0]
    if not (2 <= n_cal <= N - 2):
        raise ValueError(f"need 2 <= n_cal <= N-2, got {n_cal} / N={N}")
    Zs, sqs = _prep_blocks(X)
    i0, j0 = _farthest_pair(Zs, sqs)
    excl = jnp.zeros(N, bool).at[i0].set(True).at[j0].set(True)
    i1, j1 = _farthest_pair(Zs, sqs, excl)
    picks, was_cal = _duplex_core(Zs, sqs, n_cal, i0, j0, i1, j1)
    picks, was_cal = np.asarray(picks), np.asarray(was_cal)
    cal = np.concatenate([[int(i0), int(j0)], picks[was_cal]])
    val = np.concatenate([[int(i1), int(j1)], picks[~was_cal]])
    return cal, val


def ks_train_test_split(
    X, Y=None, *, train_size: int, method: str = "kennard-stone"
) -> tuple[np.ndarray, np.ndarray]:
    """Deterministic coverage-based train/test split.  method:
    "kennard-stone" (X only), "spxy" (needs Y), or "duplex".
    Returns (train_idx, test_idx); test is the complement in original
    order for KS/SPXY, the duplex validation set for "duplex"."""
    N = np.asarray(X).shape[0]
    if method == "kennard-stone":
        train = kennard_stone(X, train_size)
    elif method == "spxy":
        if Y is None:
            raise ValueError("spxy needs Y")
        train = spxy(X, Y, train_size)
    elif method == "duplex":
        return duplex(X, train_size)
    else:
        raise ValueError(f"unknown method {method!r}")
    test = np.setdiff1d(np.arange(N), train)
    return train, test
