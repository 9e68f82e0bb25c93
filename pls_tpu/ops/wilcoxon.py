"""Wilcoxon signed-rank test for comparing two sets of prediction errors.

Reference analogue: `PLS::wilcoxon` (/root/reference/src/pls.cpp:162-211),
itself based on Thomas (2003), J. Chemometrics 17:653-659.  Given paired
absolute errors err_1 (the candidate/reference model) and err_2 (the
competitor), returns probw = P{V larger than observed} under the normal
asymptotic; small probw = evidence model #1 is better.

Design notes: the reference's index-sort `ordered()` (pls.h:57-69)
becomes `jnp.argsort`; the whole test is pure jnp, so it `vmap`s over
(y-variable, component) axes for batched optimal-component selection.
Tie-handling caveat: the reference uses `std::sort` (unstable), we use a
stable argsort — results differ only when |err_1|-|err_2| has exact
duplicate magnitudes with opposite signs, which does not occur for real
CV errors.
"""

from __future__ import annotations

import jax.numpy as jnp

from pls_tpu.ops.special import normalcdf


def wilcoxon(err_1: jnp.ndarray, err_2: jnp.ndarray) -> jnp.ndarray:
    """One-sided Wilcoxon signed-rank p-value, normal approximation.

    Matches /root/reference/src/pls.cpp:190-211 arithmetic exactly
    (including the A&S normal-CDF approximation).
    """
    err_1 = jnp.ravel(err_1)
    err_2 = jnp.ravel(err_2)
    n = err_1.shape[0]
    delta = jnp.abs(err_1) - jnp.abs(err_2)
    sdel = jnp.sign(delta)
    adel = jnp.abs(delta)
    order = jnp.argsort(adel, stable=True)
    ranks = jnp.arange(1, n + 1, dtype=err_1.dtype)
    d = jnp.sum(ranks * sdel[order])
    t = n * (n + 1) / 2.0
    v = (t - d) / 2.0
    ev = t / 2.0
    sv = jnp.sqrt(n * (n + 1) * (2 * n + 1) / 24.0)
    z = (v - ev) / sv
    return 1.0 - normalcdf(z)
