#!/usr/bin/env python
"""MPFR-analogue demonstration at north-star N (VERDICT r02 #6).

The reference's arbitrary-precision escape hatch is MPFR
(upstream include/PLS/pls.h:11-28).  This framework's
answer is compensated (double-float) accumulation of the streaming
sufficient statistics (ops/twofloat.py, models/streaming.py).  This tool
streams up to 10⁷ synthetic rows through BOTH a plain-f32 and a
compensated-f32 `StatsAccumulator` and records the relative error of
XᵀY / XᵀX against an exact-f64 accumulation at logarithmic checkpoints:
the plain-f32 error grows with the number of accumulated chunks, the
compensated error stays at the (N-independent) per-chunk rounding floor.

Runs on CPU so the per-chunk products are true f32 (a GPU's DEFAULT
precision would add TF32 truncation orthogonal to the accumulation
question).  It measures error, not time.

Usage: python tools/precision_at_scale.py [--n 10000000] [--chunk 16384]
                                          [--k 64] [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def run(n_total: int, chunk: int, K: int, M: int = 4, seed: int = 0) -> dict:
    import jax

    jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp
    import numpy as np

    from pls_tpu.models.streaming import StatsAccumulator

    rng = np.random.default_rng(seed)
    plain = StatsAccumulator(K, M, jnp.float32, compensated=False)
    comp = StatsAccumulator(K, M, jnp.float32, compensated=True)
    XX64 = np.zeros((K, K), np.float64)
    XY64 = np.zeros((K, M), np.float64)

    n_chunks = n_total // chunk
    # ~12 log-spaced checkpoints on the chunk axis
    checks = sorted({max(1, int(round(n_chunks ** (i / 11)))) for i in range(12)})
    curves = []
    t0 = time.time()
    n = 0
    for ci in range(1, n_chunks + 1):
        Xc64 = rng.standard_normal((chunk, K))
        Yc64 = rng.standard_normal((chunk, M))
        Xc = jnp.asarray(Xc64, jnp.float32)
        Yc = jnp.asarray(Yc64, jnp.float32)
        # f64 truth accumulates the SAME f32 data (isolates accumulation
        # error from input quantization)
        Xn = np.asarray(Xc, np.float64)
        Yn = np.asarray(Yc, np.float64)
        XX64 += Xn.T @ Xn
        XY64 += Xn.T @ Yn
        plain.update(Xc, Yc)
        comp.update(Xc, Yc)
        n += chunk
        if ci in checks:
            scale_xy = np.abs(XY64).max()
            scale_xx = np.abs(XX64).max()
            rec = {
                "n_rows": n,
                "n_chunks": ci,
                "xy_err_plain": float(
                    np.abs(np.asarray(plain.XY, np.float64) - XY64).max() / scale_xy
                ),
                "xy_err_comp": float(
                    np.abs(
                        np.asarray(comp.XY, np.float64)
                        + np.asarray(comp.XYe, np.float64)
                        - XY64
                    ).max()
                    / scale_xy
                ),
                "xx_err_plain": float(
                    np.abs(np.asarray(plain.XX, np.float64) - XX64).max() / scale_xx
                ),
                "xx_err_comp": float(
                    np.abs(
                        np.asarray(comp.XX, np.float64)
                        + np.asarray(comp.XXe, np.float64)
                        - XX64
                    ).max()
                    / scale_xx
                ),
            }
            curves.append(rec)
            print(
                f"n={n:>10,}  XY err plain={rec['xy_err_plain']:.3e} "
                f"comp={rec['xy_err_comp']:.3e}   XX err plain="
                f"{rec['xx_err_plain']:.3e} comp={rec['xx_err_comp']:.3e}",
                file=sys.stderr, flush=True,
            )
    return {
        "n_total": n,
        "chunk": chunk,
        "K": K,
        "M": M,
        "seed": seed,
        "wall_sec": round(time.time() - t0, 1),
        "curves": curves,
    }


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--k", type=int, default=64)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    report = run(args.n, args.chunk, args.k, args.m)
    out = json.dumps(report, indent=2)
    if args.out:
        with open(args.out, "w") as f:
            f.write(out + "\n")
    print(out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
