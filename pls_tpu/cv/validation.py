"""CV-error summarization and optimal-component selection.

Reference analogues — /root/reference/src/pls.cpp:229-305:
  validation(residual, out_type)    → (M, A) matrix of RESS (=PRESS) or MSE
  optimal_num_components(residual)  → per-Y 1-based optimal component count
  print_validation(...)             → the "LOO Validation:" stderr tables

Selection rule (pls.cpp:263-289): per Y variable, find the component count
with minimum PRESS, then walk to the *fewest* components whose errors are
not significantly worse under a one-sided Wilcoxon signed-rank test at
α = 0.1.  We reproduce it exactly (same A&S normal-CDF approximation, same
first-minimum tie-breaking as Eigen's minCoeff), but vectorized: all
candidate columns are tested in one vmapped Wilcoxon batch and the
earliest passing candidate selected with an argmax over a boolean mask —
no data-dependent Python control flow, so the selector can itself be
vmapped over bootstrap replicates.
"""

from __future__ import annotations

import sys

import jax
import jax.numpy as jnp
import numpy as np

from pls_tpu.ops.wilcoxon import wilcoxon
from pls_tpu.types import MSE, RESS, VALIDATION_OUTPUT, Residual


def validation(residual: Residual, out_type: VALIDATION_OUTPUT = RESS) -> jnp.ndarray:
    """Summarize CV errors into an (M, A) matrix (reference pls.cpp:235-261).

    RESS: sum of squared errors over observations (= PRESS for CV errors).
    MSE:  RESS / n_observations.  RMSE = sqrt(MSE), applied by the caller
    as in the reference printer (pls.cpp:299).
    """
    errs = residual.errors  # (M, n_obs, A)
    ssev = jnp.sum(errs * errs, axis=1)  # (M, A)
    if out_type == MSE:
        ssev = ssev / residual.n_obs
    return ssev


@jax.jit
def _optimal_from_errors(errs: jnp.ndarray, alpha: jnp.ndarray) -> jnp.ndarray:
    """Jitted core of optimal_num_components: errs (M, n_obs, A) → (M,)
    1-based counts.  One compiled program — the M·A Wilcoxon tests lower
    to a single batched stable sort — instead of O(M·A) eager dispatches
    (tools/selector_bench.py times both at the 1M-row shape)."""
    press = jnp.sum(errs * errs, axis=1)  # (M, A)

    def per_y(press_y, err_y):
        # err_y: (n_obs, A)
        ref_min = jnp.argmin(press_y)  # first minimum, like Eigen minCoeff
        err_ref = jnp.take_along_axis(err_y, ref_min[None, None], axis=1)[:, 0]
        pvals = jax.vmap(lambda e2: wilcoxon(err_ref, e2), in_axes=1)(err_y)  # (A,)
        a_idx = jnp.arange(press_y.shape[0])
        ok = (a_idx < ref_min) & (pvals > alpha)
        # earliest passing candidate, else ref_min (matches the reference's
        # break-at-first-success loop, pls.cpp:281-285)
        first_ok = jnp.argmax(ok)
        return jnp.where(jnp.any(ok), first_ok, ref_min) + 1

    return jax.vmap(per_y)(press, errs)


def optimal_num_components(residual: Residual, alpha: float = 0.1) -> jnp.ndarray:
    """Per-Y optimal number of components, 1-based (reference pls.cpp:263-289)."""
    return _optimal_from_errors(jnp.asarray(residual.errors), alpha)


def compare_models(
    residual_1: Residual, residual_2: Residual, comp_1: int, comp_2: int
) -> jnp.ndarray:
    """One-sided Wilcoxon p-values comparing two CV error sets, per
    response: P{model 1 (at comp_1 components) is NOT better than model 2
    (at comp_2)} — small values favor model 1.

    This is the general form of the Thomas (2003) comparison the
    reference embeds inside optimal_num_components (pls.cpp:283): the
    same machinery exposed for comparing *different* models (e.g. NIPALS
    vs SIMPLS, or different preprocessing) on matched CV partitions.
    Both residuals must cover the same observations in the same order.
    """
    if residual_1.n_obs != residual_2.n_obs or residual_1.M != residual_2.M:
        raise ValueError("residual sets must cover the same observations")
    e1 = residual_1.errors[:, :, comp_1 - 1]  # (M, n_obs)
    e2 = residual_2.errors[:, :, comp_2 - 1]
    return jax.vmap(wilcoxon)(e1, e2)


def q_squared(residual: Residual, Y: jnp.ndarray) -> jnp.ndarray:
    """Q² = 1 − PRESS/SST per (response, component count) — the standard
    cross-validated R² of chemometrics (derived metric the reference
    leaves to the user; PRESS from pls.cpp:235-261, SST from pls.cpp:69-77).

    `Y` is the full response matrix the CV ran over (its column SST is the
    normalizer).  Shape: (M, A).
    """
    from pls_tpu.ops.stats import sst

    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    press = validation(residual, RESS)  # (M, A)
    # LSO records test_size·trials rows (obs appear repeatedly); normalize
    # PRESS to per-observation scale against the matching SST scale
    n_y = Y.shape[0]
    scale = residual.n_obs / n_y
    return 1.0 - press / (sst(Y)[:, None] * scale)


def rmsep(residual: Residual) -> jnp.ndarray:
    """Root-mean-squared error of prediction per (response, component):
    sqrt(MSE) — the matrix the reference prints as 'RMSE' (pls.cpp:299)."""
    return jnp.sqrt(validation(residual, MSE))


def print_validation(
    residual: Residual,
    out_type: VALIDATION_OUTPUT = MSE,
    file=None,
    alpha: float = 0.1,
) -> None:
    """Print the validation table in the reference's exact layout
    (reference pls.cpp:291-305; output goes to stderr by default as in
    pls.h:158)."""
    from pls_tpu.utils.reporting import format_eigen

    file = sys.stderr if file is None else file
    em = np.asarray(validation(residual, out_type))
    label = {MSE: "RMSE ", RESS: "PRESS "}.get(out_type, "UNKNOWN ")
    if out_type == MSE:
        em = np.sqrt(em)
    print(f"{residual.method} Validation:", file=file)
    print(
        f"{label} Matrix (rows = Y variable; cols = # of components):", file=file
    )
    print(format_eigen(em), file=file)
    opt = np.asarray(optimal_num_components(residual, alpha))
    # Eigen prints the integer column vector one entry per line, with the
    # first entry following the tab (pls.cpp:304)
    body = "\n".join(str(int(v)) for v in opt)
    print(f"Optimal number of components (by Y variable):\t{body}", file=file)
