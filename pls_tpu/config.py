"""Run configuration for the full reference pipeline.

SURVEY.md §5 config row: the reference's knobs are scattered across argv
(3 positionals, main.cpp:12-27), hardcoded CLI constants (LSO frac/trials,
main.cpp:40), API defaults (α = 0.1, pls.h:152; method, pls.h:195) and
compile-time flags (precision, pls.h:11).  Here every knob lives in one
dataclass, consumed by both the CLI (cli.py) and programmatic callers.
"""

from __future__ import annotations

import sys
from dataclasses import dataclass, field

from pls_tpu.types import KERNEL_TYPE1, METHOD


@dataclass
class PLSRunConfig:
    x_file: str
    y_file: str
    num_components: int
    method: METHOD = KERNEL_TYPE1
    dtype: str | None = None  # None = float64 on CPU, float32 on the GPU
    cv: tuple[str, ...] = ("loo", "lso")  # subset of {"loo", "lso", "kfold"}
    lso_fraction: float = 0.3
    lso_trials: int | None = None  # None = 10 * n_rows (main.cpp:40)
    kfold_k: int = 10  # folds for --cv kfold (framework extension)
    rng: str = "gcc"  # "gcc" = bit-exact reference partitions | "jax"
    seed: int | None = None  # None = 5489 (gcc) / 0 (jax)
    alpha: float = 0.1  # Wilcoxon selector level (pls.h:152)
    json_out: str | None = None
    complex_format: bool = False  # Eigen '(re,0)' tuples for byte diffing
    x_storage: str | None = None  # "bf16" = stream X narrow, f32 accumulation
    preprocess: str | None = None  # spectral chain for X, e.g. "savgol:11:2:1,snv"
    extra: dict = field(default_factory=dict)


def run_pipeline(cfg: PLSRunConfig, *, file=None) -> dict:
    """Execute the reference CLI pipeline (main.cpp:21-41) under `cfg`:
    read → z-score both → fit → print state + EV → LOO → LSO.  Returns the
    structured report dict; raises pls_tpu.utils.io errors on bad input."""
    import jax

    platform = jax.default_backend()
    dtype_name = cfg.dtype or ("float64" if platform == "cpu" else "float32")
    if dtype_name == "float64":
        jax.config.update("jax_enable_x64", True)

    import jax.numpy as jnp
    import numpy as np

    from pls_tpu import MSE, PLSModel, colwise_z_scores, print_validation
    from pls_tpu.cv.validation import optimal_num_components, validation
    from pls_tpu.utils.gcc_rng import GccRng
    from pls_tpu.utils.io import read_matrix_file

    file = sys.stderr if file is None else file
    dtype = jnp.dtype(dtype_name)

    X_raw = jnp.asarray(read_matrix_file(cfg.x_file), dtype)
    if cfg.preprocess:
        from pls_tpu.spectral import apply_chain

        X_raw = apply_chain(X_raw, cfg.preprocess)
    X = colwise_z_scores(X_raw)
    Y = colwise_z_scores(jnp.asarray(read_matrix_file(cfg.y_file), dtype))

    model = PLSModel(
        X, Y, cfg.method, cfg.num_components,
        x_storage=cfg.x_storage,
    )
    model.print_state(file=file, complex_format=cfg.complex_format)
    model.print_explained_variance(X, Y, file=file)

    _, ev_profile = model.explained_variance_profile()  # one residual pass
    report: dict = {
        "method": cfg.method.value,
        "num_components": model.A,
        "dtype": dtype_name,
        "alpha": cfg.alpha,
        "explained_variance": {
            str(c): np.asarray(ev_profile[c - 1]).tolist()
            for c in range(1, model.A + 1)
        },
    }

    if "loo" in cfg.cv:
        loo = model.cv_LOO()
        print_validation(loo, MSE, file=file, alpha=cfg.alpha)
        report["loo_rmse"] = np.sqrt(np.asarray(validation(loo, MSE))).tolist()
        report["loo_optimal_components"] = np.asarray(
            optimal_num_components(loo, cfg.alpha)
        ).tolist()

    if "lso" in cfg.cv:
        n = X.shape[0]
        trials = cfg.lso_trials if cfg.lso_trials is not None else 10 * n
        if cfg.rng == "gcc":
            rng = GccRng(cfg.seed if cfg.seed is not None else 5489)
        else:
            rng = jax.random.key(cfg.seed if cfg.seed is not None else 0)
        lso = model.cv_LSO(cfg.lso_fraction, trials, rng)
        print_validation(lso, MSE, file=file, alpha=cfg.alpha)
        report["lso_rmse"] = np.sqrt(np.asarray(validation(lso, MSE))).tolist()
        report["lso_optimal_components"] = np.asarray(
            optimal_num_components(lso, cfg.alpha)
        ).tolist()

    if "kfold" in cfg.cv:
        seed = cfg.seed if cfg.seed is not None else 0
        kf = model.cv_KFOLD(cfg.kfold_k, key=seed)
        print_validation(kf, MSE, file=file, alpha=cfg.alpha)
        report["kfold_k"] = cfg.kfold_k
        report["kfold_rmse"] = np.sqrt(np.asarray(validation(kf, MSE))).tolist()
        report["kfold_optimal_components"] = np.asarray(
            optimal_num_components(kf, cfg.alpha)
        ).tolist()

    if cfg.json_out:
        import json

        with open(cfg.json_out, "w") as f:
            json.dump(report, f, indent=2)

    return report
