"""Export fitted models for embedding in native (C++) consumers.

The reference is *itself* a C++ library meant to be embedded as a git
submodule of larger simulations (/root/reference/README.md:11-14).  Our
framework trains on an accelerator in Python/JAX; this module closes the loop for
native consumers: `export_model_c` writes a fitted model as a tiny flat
binary that the header-only C++ loader `native/pls_predict.hpp` reads —
so a C++ simulation can link NO Python, NO JAX, NO Eigen and still run
the calibrated model (predict + score projection + T²/SPE admission
checks).

Format PLSB (all little-endian):
    bytes 0..7   magic "PLSTPU01"
    int64        K, M, A
    float64[K]   x_mean      (raw-unit centering; zeros if unscaled)
    float64[K*M] B_raw       row-major; raw units:  ŷ = (x−x_mean)·B + b0
    float64[M]   b0          intercept
    float64[K*A] R_raw       scores of raw x:  t = (x−x_mean)·R_raw
    float64[K*A] P_mon       monitoring loadings (scaled units): with
                             xz = (x−x_mean)/x_std, SPE = ‖xz − t·P_monᵀ‖²
    float64[K]   x_std       (ones if unscaled)
    float64[A]   s2          training score variances (for T²)
    float64      t2_lim, spe_lim   (0 if no monitor attached)

Raw-unit conventions match the sklearn-compatible estimator surface
(estimator.py `_set_coef`), so exported predictions equal
`PLSRegressor.predict` bit-for-bit at f64.
"""

from __future__ import annotations

import struct

import numpy as np

_MAGIC = b"PLSTPU01"


def export_model_c(
    path: str,
    fit,
    *,
    x_scaler=None,
    y_scaler=None,
    comp: int | None = None,
    monitor=None,
) -> None:
    """Write a PLSB flat binary for the native loader.

    fit      : PLSFit (or anything with W/P/Q/R and .A)
    x_scaler / y_scaler : optional ZScorer; absent means raw = scaled
    comp     : truncation (defaults to fit.A)
    monitor  : optional MonitorModel (models/diagnostics.py) — embeds the
               T²/SPE limits so the C++ side can gate predictions.
    """
    from pls_tpu.models.predict import coefficients

    A = int(fit.A if comp is None else comp)
    B_std = np.asarray(coefficients(fit, A), dtype=np.float64)  # (K, M)
    R_std = np.asarray(fit.R[:, :A], dtype=np.float64)  # (K, A)
    P_std = np.asarray(fit.P[:, :A], dtype=np.float64)  # (K, A)
    K, M = B_std.shape

    if x_scaler is not None:
        x_mean = np.asarray(x_scaler.mean, dtype=np.float64).reshape(K)
        x_std = np.asarray(x_scaler.stdev, dtype=np.float64).reshape(K)
    else:
        x_mean, x_std = np.zeros(K), np.ones(K)
    if y_scaler is not None:
        y_mean = np.asarray(y_scaler.mean, dtype=np.float64).reshape(M)
        y_std = np.asarray(y_scaler.stdev, dtype=np.float64).reshape(M)
    else:
        y_mean, y_std = np.zeros(M), np.ones(M)

    # bake the scaling into raw-unit operators:
    #   ŷ = ((x−x_mean)/x_std) B_std · y_std + y_mean = (x−x_mean)·B_raw + b0
    B_raw = (B_std / x_std[:, None]) * y_std[None, :]
    b0 = y_mean
    R_raw = R_std / x_std[:, None]

    if monitor is not None:
        s2 = np.asarray(monitor.s2, dtype=np.float64).reshape(A)
        t2_lim = float(monitor.t2_lim)
        spe_lim = float(monitor.spe_lim)
    else:
        s2 = np.ones(A)
        t2_lim = spe_lim = 0.0

    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<qqq", K, M, A))
        for arr in (x_mean, B_raw, b0, R_raw, P_std, x_std, s2):
            f.write(np.ascontiguousarray(arr, dtype="<f8").tobytes())
        f.write(struct.pack("<dd", t2_lim, spe_lim))


def load_model_c(path: str) -> dict:
    """Read a PLSB binary back (for tests / Python-side verification)."""
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"bad magic {magic!r}")
        K, M, A = struct.unpack("<qqq", f.read(24))
        rd = lambda n: np.frombuffer(f.read(8 * n), dtype="<f8").copy()
        out = {
            "K": K,
            "M": M,
            "A": A,
            "x_mean": rd(K),
            "B_raw": rd(K * M).reshape(K, M),
            "b0": rd(M),
            "R_raw": rd(K * A).reshape(K, A),
            "P_mon": rd(K * A).reshape(K, A),
            "x_std": rd(K),
            "s2": rd(A),
        }
        out["t2_lim"], out["spe_lim"] = struct.unpack("<dd", f.read(16))
    return out
