"""End-to-end spectroscopy workflow on the reference's gasoline-NIR data:

  1. Savitzky–Golay first derivative + SNV preprocessing
  2. interval PLS wavelength selection (forward synergy search)
  3. final model with LOO-validated component choice
  4. selectivity-ratio variable screening
  5. piecewise-direct-standardization transfer to a simulated second
     instrument

Run:  python examples/spectroscopy_workflow.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# the walkthrough uses f64 for reference-grade numbers; pin CPU so the
# printed numbers are the same on every host
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import pls_tpu as pt  # noqa: E402

REF = os.environ.get("PLS_REF_DATA", "/root/reference")


def main() -> None:
    X_raw = np.loadtxt(os.path.join(REF, "nir.csv"), delimiter=",")
    y_raw = np.loadtxt(os.path.join(REF, "octane.csv"), delimiter=",")

    # 1. pretreatment: SG 1st derivative (window 11, quadratic), then SNV
    Xp = pt.snv(pt.savgol(X_raw, window=11, polyorder=2, deriv=1))
    X = pt.colwise_z_scores(Xp)
    y = pt.colwise_z_scores(jnp.asarray(y_raw)[:, None])

    # 2. wavelength selection: forward iPLS over 10 intervals
    sel = pt.ipls_forward(X, y, n_intervals=10, A=5, k=10)
    print(f"iPLS picked intervals {sel.selected} "
          f"({sel.n_selected_channels} channels), RMSECV path "
          f"{np.round(sel.rmsecv_path, 4)}")
    Xsel = X * jnp.asarray(sel.mask)[None, :]

    # 3. final fit + LOO component choice
    A = max(sel.ncomp, 3)
    fit = pt.fit(Xsel, y, A)
    loo = pt.cv_loo(Xsel, y, A)
    opt = pt.optimal_num_components(loo)
    print(f"explained variance @{A}: "
          f"{np.asarray(pt.explained_variance(fit, Xsel, y, A))}")
    print(f"LOO-optimal components: {np.asarray(opt)}")

    # 4. which selected channels drive the prediction?
    sr = np.asarray(pt.selectivity_ratio(fit, Xsel, comp=int(opt[0])))
    top = np.argsort(sr)[::-1][:5]
    print(f"top-5 channels by selectivity ratio: {top} (SR {sr[top].round(2)})")

    # 5. calibration transfer: simulate a drifted second instrument and
    #    bring its spectra back into master space
    rng = np.random.default_rng(0)
    slave_raw = 1.08 * X_raw + 0.05 + 0.01 * rng.normal(size=X_raw.shape)
    slave = pt.snv(pt.savgol(slave_raw, window=11, polyorder=2, deriv=1))
    tm = pt.piecewise_ds(Xp[:40], slave[:40], window=3, A=2)
    rec = pt.apply_transfer(tm, slave[40:])
    before = float(jnp.linalg.norm(slave[40:] - Xp[40:]))
    after = float(jnp.linalg.norm(rec - Xp[40:]))
    print(f"PDS transfer residual: {after:.3f} (was {before:.3f} untransferred)")


if __name__ == "__main__":
    main()
