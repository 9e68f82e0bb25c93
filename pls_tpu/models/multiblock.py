"""Multiblock PLS (MB-PLS): multiple X blocks, one Y, with block-level
scores, weights, and importances.

Beyond-reference capability (the reference has a single X —
/root/reference/src/pls.cpp:340-359).  Multi-source calibration (e.g.
several instruments/sensor banks feeding one quality variable) is the
standard use of MB-PLS in process chemometrics.

Algorithm: Westerhuis, Kourti & MacGregor (1998, J. Chemometrics 12:301)
proved that MB-PLS *super scores* are identical to ordinary PLS on the
concatenated blocks, with block scaling applied up front.  We exploit
that accelerator-first: one concatenated kernel-PLS fit (all the fused/sharded
machinery applies untouched), then block-level quantities derived by
slicing the super weights:

    block weight  w_b  = W[k_b] / ‖W[k_b]‖   (unit, per component)
    block score   t_b  = X_b w_b
    block importance (BIP_b) = ‖W[k_b]‖²     (Σ_b BIP_b = 1 per comp.)

Block scaling: each block divided by √K_b (default), giving every block
equal a-priori total variance so one wide block cannot swamp the others;
`block_scale=False` reproduces plain PLS on np.hstack(blocks) exactly.

Block sizes are static (they define array shapes), so `MBPLSFit` carries
them as aux data and everything remains a registered pytree.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from pls_tpu.models.kernel_pls import fit as _fit_pls
from pls_tpu.models.predict import coefficients as _coefficients
from pls_tpu.types import KERNEL_TYPE1, METHOD, PLSFit
from pls_tpu.utils.checkpoint import register_checkpointable


@register_checkpointable
@jax.tree_util.register_dataclass
@dataclass(frozen=True)
class MBPLSFit:
    """Multiblock fit: the concatenated super-model plus block metadata.

    pls          : PLSFit on the (scaled) concatenated X, K = ΣK_b
    block_scales : (B,) the √K_b (or 1) factors applied per block
    block_sizes  : static tuple (K_1, …, K_B)
    """

    pls: PLSFit
    block_scales: jax.Array
    block_sizes: tuple = field(metadata=dict(static=True), default=())

    @property
    def A(self) -> int:
        return self.pls.A

    @property
    def n_blocks(self) -> int:
        return len(self.block_sizes)

    def _slices(self):
        off = np.concatenate([[0], np.cumsum(self.block_sizes)])
        return [slice(int(a), int(b)) for a, b in zip(off[:-1], off[1:])]


def _concat(Xs, scales):
    return jnp.concatenate(
        [jnp.asarray(X) / s for X, s in zip(Xs, scales)], axis=1
    )


def fit_mbpls(
    Xs,
    Y,
    A: int,
    *,
    method: METHOD = KERNEL_TYPE1,
    block_scale: bool = True,
    precision: str | None = "highest",
) -> MBPLSFit:
    """Fit MB-PLS on blocks Xs = [X_1 (N,K_1), …, X_B (N,K_B)] against Y.

    Blocks must share N and be pre-centered/scaled column-wise (the usual
    ZScorer pass); `block_scale` additionally divides block b by √K_b.
    """
    sizes = tuple(int(X.shape[1]) for X in Xs)
    dtype = jnp.asarray(Xs[0]).dtype
    if block_scale:
        scales = jnp.asarray([np.sqrt(k) for k in sizes], dtype)
    else:
        scales = jnp.ones((len(sizes),), dtype)
    Xcat = _concat(Xs, scales)
    pls = _fit_pls(Xcat, jnp.asarray(Y), A, method, precision=precision)
    return MBPLSFit(pls=pls, block_scales=scales, block_sizes=sizes)


def block_weights(fit: MBPLSFit) -> list:
    """Unit-norm block weight matrices [(K_b, A)] (super weights sliced
    per block and renormalized per component)."""
    out = []
    for sl in fit._slices():
        Wb = fit.pls.W[sl, :]
        nrm = jnp.sqrt(jnp.sum(Wb * Wb, axis=0))
        out.append(Wb / jnp.where(nrm == 0, 1.0, nrm)[None, :])
    return out


def block_scores(fit: MBPLSFit, Xs) -> jnp.ndarray:
    """(N, B, A) block scores t_b = (X_b/s_b) w_b for (centered) blocks."""
    Wbs = block_weights(fit)
    ts = [
        (jnp.asarray(X) / s) @ Wb
        for X, s, Wb in zip(Xs, fit.block_scales, Wbs)
    ]
    return jnp.stack(ts, axis=1)


def block_importance(fit: MBPLSFit) -> jnp.ndarray:
    """(B, A) block importance in projection: the fraction of each
    component's (unit) super-weight norm carried by block b; columns sum
    to 1."""
    parts = [
        jnp.sum(fit.pls.W[sl, :] ** 2, axis=0) for sl in fit._slices()
    ]
    return jnp.stack(parts, axis=0)


def predict_mbpls(fit: MBPLSFit, Xs_new, comp: int | None = None) -> jnp.ndarray:
    """Ŷ for new (centered) blocks via the super-model coefficients."""
    Xcat = _concat(Xs_new, fit.block_scales)
    return Xcat @ _coefficients(fit.pls, comp)


def super_scores(fit: MBPLSFit, Xs_new) -> jnp.ndarray:
    """(n, A) super scores of new (centered) blocks: X_cat R."""
    return _concat(Xs_new, fit.block_scales) @ fit.pls.R
