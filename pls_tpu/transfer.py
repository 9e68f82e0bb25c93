"""Calibration transfer: Direct Standardization (DS) and Piecewise
Direct Standardization (PDS) — Wang, Veltkamp & Kowalski (1991), Anal.
Chem. 63:2750.

Not in the reference; the standard answer to "my PLS model was calibrated
on instrument A, how do I use spectra from instrument B?".  Both methods
learn a linear map F from a small set of *transfer samples* measured on
both instruments, such that  X_slave · F ≈ X_master ; slave spectra are
then mapped into master space and fed to the existing master-calibrated
model.

- **DS**: one global (K, K) map via ridge-regularized least squares.
  Needs n_transfer ≳ rank; heavily regularized otherwise.
- **PDS**: each master channel j is predicted from a small slave window
  [j−w, j+w] with its own local PLS model — the de-facto standard since
  local windows track wavelength shifts without a K×K estimation burden.

Accelerator formulation of PDS: the K window regressions are *one*
vmapped batch of tiny PLS fits (the masked-fit machinery makes every
window a fixed-shape (n, 2w+1) problem; edge windows are zero-padded
columns, which the kernel treats exactly as absent — see
models/kernel_pls.py).  A classical implementation is a Python loop of K
NIPALS fits; here it is a single device program.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np

from pls_tpu.models.kernel_pls import fit
from pls_tpu.models.predict import coefficients

__all__ = [
    "TransferModel",
    "direct_standardization",
    "piecewise_ds",
    "apply_transfer",
    "EPOModel",
    "epo",
    "epo_difference_matrix",
]


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class TransferModel:
    """Slave→master spectral map:
        X_master ≈ (X_slave − offset) · F + intercept

    F         : (K, K) transform (banded for PDS)
    offset    : (K,) slave-side centering (transfer-set slave mean)
    intercept : (K,) master-side mean added back after the map
    """

    F: jax.Array
    offset: jax.Array
    intercept: jax.Array

    def __call__(self, X_slave) -> jnp.ndarray:
        return apply_transfer(self, X_slave)


def apply_transfer(model: TransferModel, X_slave) -> jnp.ndarray:
    """Map slave-instrument spectra into master space."""
    X_slave = jnp.atleast_2d(jnp.asarray(X_slave))
    return (X_slave - model.offset[None, :]) @ model.F + model.intercept[None, :]


@partial(jax.jit, static_argnames=("ridge",))
def _ds_fit(Sm, Ss, ridge: float):
    mu_s = jnp.mean(Ss, axis=0)
    mu_m = jnp.mean(Sm, axis=0)
    Ssc = Ss - mu_s[None, :]
    Smc = Sm - mu_m[None, :]
    K = Ss.shape[1]
    G = Ssc.T @ Ssc + ridge * jnp.eye(K, dtype=Ss.dtype)
    F = jnp.linalg.solve(G, Ssc.T @ Smc)
    # fold the master mean back in as part of the map: x·F + (mu_m − 0)
    # we keep offset on the slave side and add mu_m via F's affine trick:
    # (x − mu_s)·F + mu_m  ≡  (x − (mu_s − F⁻ᵀ…)) — simpler: stash mu_m
    return F, mu_s, mu_m


def direct_standardization(
    S_master, S_slave, ridge: float = 1e-6
) -> TransferModel:
    """Global DS map from paired transfer spectra (n_transfer, K) measured
    on both instruments.  Ridge-regularized: with few transfer samples the
    problem is underdetermined and the regularizer picks the minimum-norm
    map."""
    Sm = jnp.atleast_2d(jnp.asarray(S_master))
    Ss = jnp.atleast_2d(jnp.asarray(S_slave))
    if Sm.shape != Ss.shape:
        raise ValueError(
            f"master {Sm.shape} and slave {Ss.shape} transfer sets must "
            "be paired (same shape)"
        )
    F, mu_s, mu_m = _ds_fit(Sm, Ss, float(ridge))
    return TransferModel(F=F, offset=mu_s, intercept=mu_m)


def piecewise_ds(
    S_master,
    S_slave,
    window: int = 5,
    A: int = 2,
    *,
    precision: str | None = "highest",
) -> TransferModel:
    """PDS: banded slave→master map; master channel j is regressed on the
    slave window [j−window, j+window] with a local `A`-component PLS
    model.  All K local fits run as ONE vmapped device program.

    window: half-width (band = 2·window+1 channels).
    A: local PLS components (must be ≤ 2·window+1)."""
    Sm = jnp.atleast_2d(jnp.asarray(S_master))
    Ss = jnp.atleast_2d(jnp.asarray(S_slave))
    if Sm.shape != Ss.shape:
        raise ValueError(
            f"master {Sm.shape} and slave {Ss.shape} transfer sets must "
            "be paired (same shape)"
        )
    K = Ss.shape[1]
    w = int(window)
    width = 2 * w + 1
    if not (1 <= A <= width):
        raise ValueError(f"A={A} must be in [1, 2*window+1={width}]")

    mu_s = jnp.mean(Ss, axis=0)
    mu_m = jnp.mean(Sm, axis=0)
    Ssc = Ss - mu_s[None, :]
    Smc = Sm - mu_m[None, :]

    # gather windows: cols[j] = channels j−w..j+w, out-of-range → column 0
    # with a zero VALIDITY mask (exact-zero columns are exactly "absent"
    # in the kernel fit)
    idx = np.arange(K)[:, None] + np.arange(-w, w + 1)[None, :]  # (K, width)
    valid = (idx >= 0) & (idx < K)
    idx_c = np.clip(idx, 0, K - 1)
    Xwin = Ssc[:, idx_c] * jnp.asarray(valid, Ssc.dtype)[None, :, :]
    # (n, K, width) → vmap over channel axis
    Xb = jnp.moveaxis(Xwin, 1, 0)  # (K, n, width)
    Yb = Smc.T[:, :, None]  # (K, n, 1)

    def local_fit(Xj, yj):
        f = fit(Xj, yj, A, precision=precision)
        return coefficients(f)[:, 0]  # (width,)

    B = jax.vmap(local_fit)(Xb, Yb)  # (K, width) local coefficient rows

    # scatter the bands into the (K, K) transform: F[idx[j, k], j] = B[j, k]
    F = jnp.zeros((K, K), Ss.dtype)
    rows = jnp.asarray(idx_c.reshape(-1))
    cols = jnp.repeat(jnp.arange(K), width)
    vals = (B * jnp.asarray(valid, B.dtype)).reshape(-1)
    F = F.at[rows, cols].add(vals)
    return TransferModel(F=F, offset=mu_s, intercept=mu_m)


# ---------------------------------------------------------------------------
# EPO — External Parameter Orthogonalization (Roger, Chauchard &
# Bellon-Maurel 2003, Chemom. Intell. Lab. Syst. 66:191-204): make a
# calibration robust to an external factor (temperature, moisture,
# probe…) by projecting spectra onto the orthogonal complement of the
# factor's spectral subspace, estimated from DIFFERENCE spectra of the
# same samples measured under varying conditions.


@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class EPOModel:
    """EPO filter state.

    V        : (K, g) orthonormal basis of the external-effect subspace
               (top right singular vectors of the difference matrix)
    sv_ratio : (g,) fraction of the difference matrix's total squared
               singular value captured per component (diagnostic for
               choosing g)

    Applying the filter is  X ← X − (X V) Vᵀ  — the projector
    P = I − V Vᵀ is never materialized (two skinny matmuls instead of a
    K×K product; same streaming shape as the fit's hot loop)."""

    V: jax.Array
    sv_ratio: jax.Array

    @property
    def n_components(self) -> int:
        return self.V.shape[1]

    def __call__(self, X) -> jnp.ndarray:
        X = jnp.atleast_2d(jnp.asarray(X))
        return X - (X @ self.V) @ self.V.T


def epo_difference_matrix(*condition_matrices) -> jnp.ndarray:
    """Difference spectra for EPO from ≥2 matrices of the SAME samples
    (rows aligned) under different external conditions: each matrix
    minus the per-sample mean across conditions, stacked.  The row space
    of the result spans the external effect (sample chemistry cancels in
    the differences)."""
    mats = [jnp.atleast_2d(jnp.asarray(m)) for m in condition_matrices]
    if len(mats) < 2:
        raise ValueError("need >= 2 condition matrices")
    shape = mats[0].shape
    for m in mats[1:]:
        if m.shape != shape:
            raise ValueError(
                "condition matrices must be row-aligned with equal shapes"
            )
    mean = sum(mats) / len(mats)
    return jnp.concatenate([m - mean for m in mats], axis=0)


@partial(jax.jit, static_argnames=("n_components",))
def _epo_fit(D, n_components: int):
    # top right singular vectors of D via eigh of the K×K Gram matrix —
    # symmetric PSD, so real/orthonormal by construction (same rationale
    # as ops/eigen.py), and cheaper than SVD of (n_d, K) when n_d > K
    G = D.T @ D
    evals, evecs = jnp.linalg.eigh(G)  # ascending
    V = evecs[:, ::-1][:, :n_components]
    sv = evals[::-1][:n_components]
    return V, sv / jnp.maximum(jnp.sum(evals), 1e-30)


def epo(D, n_components: int) -> EPOModel:
    """Fit the EPO filter from difference spectra D (n_d, K) — build D
    with `epo_difference_matrix`, or pass any matrix whose rows span the
    unwanted variation.  `n_components` (g) external components are
    removed; choose g where `sv_ratio` flattens (typically 1-3).

    Workflow:  e = epo(D, g);  fit PLS on e(X_train);  predict on
    e(X_new) — new-condition spectra land on the robust subspace."""
    D = jnp.atleast_2d(jnp.asarray(D))
    K = D.shape[1]
    if not (1 <= n_components <= min(D.shape)):
        raise ValueError(
            f"need 1 <= n_components <= min(n_d, K)="
            f"{min(D.shape)}, got {n_components}"
        )
    V, ratio = _epo_fit(D, int(n_components))
    return EPOModel(V=V, sv_ratio=ratio)
