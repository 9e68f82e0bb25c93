"""Dominant-eigenvector extraction for the M×M cross-product XYᵀXY.

Reference analogue: `find_dominant_ev` / `dominant_eigenvector`
(/root/reference/src/pls.cpp:113-141), which runs Eigen's *general*
`EigenSolver` on XYᵀXY and scans for the largest purely-real eigenvalue —
forcing the whole reference model state to be complex-typed (pls.h:253).

Redesign: XYᵀXY is symmetric positive semi-definite by
construction, so its eigenpairs are real.  We use `jnp.linalg.eigh`
(ascending eigenvalues → dominant is the last column) or, for contexts
where a batched eigh is undesirable (inside tight scans / Pallas-adjacent
code), a fixed-iteration power method — both jit/vmap/scan-compatible and
entirely real-valued, eliminating the reference's complex plumbing.

Sign convention: an eigenvector's sign is arbitrary; every downstream PLS
quantity except the per-column signs of W/P/Q/R/T is invariant to it
(coefficients, predictions, CV errors — see tests/test_fit_parity.py).
"""

from __future__ import annotations

import jax
import jax.numpy as jnp


def dominant_eigenvector(C: jnp.ndarray, power_iters: int | None = None) -> jnp.ndarray:
    """Dominant eigenvector of a symmetric PSD matrix C (M, M) -> (M,).

    power_iters=None selects exact `eigh`; an integer selects that many
    power-method iterations (deterministic start vector).
    """
    if power_iters is None:
        _, vecs = jnp.linalg.eigh(C)
        return vecs[:, -1]
    return _power_iteration(C, power_iters)


def _power_iteration(C: jnp.ndarray, iters: int) -> jnp.ndarray:
    """Fixed-iteration power method on PSD C.

    Start vector: the column of C with the largest diagonal (a good
    deterministic proxy for alignment with the dominant eigenvector),
    regularized by a small uniform component so a zero column cannot stall.
    """
    m = C.shape[0]
    j = jnp.argmax(jnp.diagonal(C))
    v0 = C[:, j] + jnp.full((m,), 1e-30, dtype=C.dtype)
    v0 = v0 / jnp.linalg.norm(v0)

    def body(_, v):
        w = C @ v
        return w / jnp.linalg.norm(w)

    return jax.lax.fori_loop(0, iters, body, v0)


def dominant_eigenvalue(C: jnp.ndarray, power_iters: int | None = None) -> jnp.ndarray:
    """Largest eigenvalue of symmetric PSD C (reference pls.cpp:132-135)."""
    if power_iters is None:
        vals = jnp.linalg.eigvalsh(C)
        return jnp.abs(vals[-1])
    v = _power_iteration(C, power_iters)
    return v @ (C @ v)
