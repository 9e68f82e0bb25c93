"""Command-line interface mirroring the reference executable.

Reference analogue: upstream src/main.cpp:10-44.  Contract:

    pls X.csv Y.csv num_components

- argc != 4 → usage on stderr, exit 100 (main.cpp:12-16; extra *optional*
  flags are accepted here but the three positionals are required).
- read CSVs (ragged rows → reference's exact error message, exit 1).
- z-score both X and Y (main.cpp:24-25).
- fit KERNEL_TYPE1 with the user's component count (main.cpp:29).
- print model state, explained variance per 1..A components, LOO
  validation (RMSE), then LSO validation (frac 0.3, trials = 10·N) with a
  default-seeded mt19937-compatible RNG → output deterministic and
  numerically identical to the reference CLI (main.cpp:31-41).
- all report output on stderr; stdout stays empty (pls.h:158,245,248).

Every knob beyond the positional contract is an optional flag backed by
the `PLSRunConfig` dataclass (config.py).

Deviation (DEVIATIONS.md): matrices print as real numbers, not Eigen's
complex "(re,0)" tuples — our state is real by construction.
"""

from __future__ import annotations

import argparse
import sys


USAGE = (
    "Usage: ./pls X_data.csv Y_data.csv num_components\n"
    "NB: X and Y csvs must be comma delimited, square numerical data, "
    "with no headers."
)


def build_parser() -> argparse.ArgumentParser:
    class _QuietParser(argparse.ArgumentParser):
        # reference behavior: bad argv prints only the usage block and
        # exits 100 (main.cpp:12-16) — suppress argparse's own error text
        def error(self, message):
            raise SystemExit(2)

    p = _QuietParser(prog="pls", add_help=True, usage=USAGE)
    p.add_argument("x_file")
    p.add_argument("y_file")
    p.add_argument("num_components", type=int)
    p.add_argument(
        "--method", choices=["kernel1", "kernel2", "nipals", "simpls"],
        default="kernel1",
    )
    p.add_argument(
        "--dtype", choices=["float64", "float32", "bfloat16"], default=None,
        help="working precision (default: float64 on CPU, float32 on an accelerator)",
    )
    p.add_argument(
        "--cv", choices=["both", "loo", "lso", "kfold", "all", "none"],
        default="both",
        help="which cross-validations to run (default: both = loo+lso, "
        "like the reference CLI; kfold is a framework extension, "
        "all = loo+lso+kfold)",
    )
    p.add_argument(
        "--kfold-k", type=int, default=10,
        help="folds for --cv kfold/all (default 10)",
    )
    p.add_argument("--lso-frac", type=float, default=0.3)
    p.add_argument(
        "--lso-trials", type=int, default=None, help="default: 10 * n_rows"
    )
    p.add_argument(
        "--rng", choices=["gcc", "jax"], default="gcc",
        help="gcc = bit-exact std::mt19937 reference partitions (default)",
    )
    p.add_argument("--seed", type=int, default=None)
    p.add_argument(
        "--alpha", type=float, default=0.1,
        help="Wilcoxon significance level for optimal-component selection",
    )
    p.add_argument("--json", metavar="PATH", default=None,
                   help="also write a structured JSON report")
    p.add_argument(
        "--x-storage", choices=["native", "bf16"], default="native",
        help="'bf16' streams X in bfloat16 with f32 accumulation (half "
        "the fit's memory traffic, ~1e-3 component error; "
        "models/kernel_pls.fit)",
    )
    p.add_argument(
        "--preprocess", default=None, metavar="CHAIN",
        help="spectral preprocessing for X before z-scoring, e.g. "
        "'savgol:11:2:1,snv' (tokens: snv, msc, detrend[:order], "
        "savgol:w:p[:d[:delta]], norm[:l2])",
    )
    p.add_argument(
        "--format", choices=["real", "eigen-complex"], default="real",
        dest="fmt",
        help="matrix rendering in print_state: real numbers (default) or "
        "the reference's Eigen complex '(re,0)' tuples for byte diffing",
    )
    return p


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    try:
        args = build_parser().parse_args(argv)
    except SystemExit as e:
        if e.code == 0:  # --help
            return 0
        # mirror the reference's bad-argv behavior (main.cpp:12-16)
        print(USAGE, file=sys.stderr)
        return 100

    from pls_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    from pls_tpu.config import PLSRunConfig, run_pipeline
    from pls_tpu.types import METHOD
    from pls_tpu.utils.io import RaggedMatrixError

    cv = {
        "both": ("loo", "lso"), "loo": ("loo",), "lso": ("lso",),
        "kfold": ("kfold",), "all": ("loo", "lso", "kfold"), "none": (),
    }[args.cv]
    cfg = PLSRunConfig(
        x_file=args.x_file,
        y_file=args.y_file,
        num_components=args.num_components,
        method={
            "kernel1": METHOD.KERNEL_TYPE1, "kernel2": METHOD.KERNEL_TYPE2,
            "nipals": METHOD.NIPALS, "simpls": METHOD.SIMPLS,
        }[args.method],
        dtype=args.dtype,
        cv=cv,
        lso_fraction=args.lso_frac,
        lso_trials=args.lso_trials,
        kfold_k=args.kfold_k,
        rng=args.rng,
        seed=args.seed,
        alpha=args.alpha,
        json_out=args.json,
        complex_format=(args.fmt == "eigen-complex"),
        x_storage=None if args.x_storage == "native" else args.x_storage,
        preprocess=args.preprocess,
    )

    try:
        run_pipeline(cfg)
    except RaggedMatrixError as e:
        print(str(e), file=sys.stderr)
        return e.exit_code
    except (OSError, ValueError) as e:
        print(f"Error: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
