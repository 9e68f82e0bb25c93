#!/usr/bin/env python
"""End-to-end example: gasoline NIR calibration (the reference's own
flagship dataset) — coverage-based sample split, fit, validate, honest
nested-CV component selection, bootstrap CIs.

Run: python examples/nir_calibration.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax
import jax.numpy as jnp
import numpy as np

import pls_tpu as pt
from pls_tpu import datasets


def main():
    X_raw, Y_raw = datasets.load_nir()
    X = pt.colwise_z_scores(jnp.asarray(X_raw))
    Y = pt.colwise_z_scores(jnp.asarray(Y_raw))

    # --- fit + explained variance ---
    fit = pt.fit(X, Y, A=10)
    for c in (1, 3, 10):
        ev = float(pt.explained_variance(fit, X, Y, c)[0])
        print(f"R² with {c:>2} components: {ev:.4f}")

    # --- cross-validated component selection ---
    loo = pt.cv_loo(X, Y, A=10)
    rmsep = np.asarray(pt.rmsep(loo))[0]
    q2 = np.asarray(pt.q_squared(loo, Y))[0]
    opt = int(pt.optimal_num_components(loo)[0])
    print("\nLOO RMSEP by components:", np.round(rmsep, 4))
    print("LOO Q² by components:   ", np.round(q2, 4))
    print(f"optimal components (Wilcoxon α=0.1): {opt}")

    # --- Monte-Carlo CV, reference-compatible RNG ---
    from pls_tpu.utils.gcc_rng import GccRng

    lso = pt.cv_lso(X, Y, 10, 0.3, 100, partitions=GccRng().lso_partitions(60, 100))
    print("LSO RMSEP:", np.round(np.asarray(pt.rmsep(lso))[0], 4))

    # --- bootstrap coefficient intervals at the selected rank ---
    lo, hi, _ = pt.bootstrap_coefficient_intervals(
        X, Y, opt, num_replicates=64, key=jax.random.key(0)
    )
    width = np.asarray(hi - lo)[:, 0]
    print(
        f"\nbootstrap 95% CI width over {len(width)} wavelengths: "
        f"median {np.median(width):.4f}, max {width.max():.4f}"
    )

    # --- coverage-based calibration/validation split (Kennard–Stone) ---
    cal, val = pt.ks_train_test_split(np.asarray(X), train_size=45)
    f_cal = pt.fit(X[jnp.asarray(cal)], Y[jnp.asarray(cal)], opt)
    pred = pt.fitted_values(f_cal, X[jnp.asarray(val)])
    rm = float(jnp.sqrt(jnp.mean((pred - Y[jnp.asarray(val)]) ** 2)))
    print(f"\nKennard–Stone 45/15 split, RMSEP on held-out: {rm:.4f}")

    # --- honest generalization estimate: nested (double) CV ---
    res = pt.nested_cv_components(
        np.asarray(X), np.asarray(Y), A_max=10, k_outer=5, k_inner=6
    )
    print(
        f"nested CV: chosen components per outer fold {res.chosen.tolist()}, "
        f"pooled RMSEP {float(res.rmsep[0]):.4f} "
        "(selection never saw its test rows)"
    )


if __name__ == "__main__":
    main()
