#!/usr/bin/env python
"""Large-scale synthetic benchmark: streaming stats + 1000-fold batched LOO.

BASELINE.json config #4/#5 shape: a design matrix far bigger than any the
reference could touch (its nir LOO of 60 folds on 60×401 takes ~80 s
single-threaded), processed as:

  1. one streaming pass building XX = XᵀX, XY = XᵀY from on-device
     generated chunks (models/streaming.py algebra) — X itself is never
     materialized;
  2. F-fold batched LOO via implicit rank-1 downdates
     (cv/loo.py: cv_loo_from_stats) — vmapped folds share the single XX
     through batched matmuls.

Defaults: N=100k, K=5k, M=10, A=20, F=1000 (BASELINE.json config 4).
The 1M×10k recipe is the same code with a row-sharded stats pass
(docs/PARALLELISM.md).

Prints one JSON object to stdout; progress to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(m):
    print(f"[largescale {time.strftime('%T')}] {m}", file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--k", type=int, default=5_000)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--a", type=int, default=20)
    ap.add_argument("--folds", type=int, default=1000)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--fold-batch", type=int, default=125)
    args = ap.parse_args()
    # note: fold fits use power_iters=16 for the M>1 dominant eigenvector
    # in place of a batched eigh inside the component scan, at equal
    # accuracy for well-separated dominant eigenvalues
    # (tests/test_fit_parity.py pins power-iteration agreement with eigh)

    from pls_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from pls_tpu.cv.loo import cv_loo_from_stats

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default backend is {backend}")
    N, K, M, A, F = args.n, args.k, args.m, args.a, args.folds
    log(f"backend={backend} N={N} K={K} M={M} A={A} folds={F}")

    key = jax.random.key(0)
    kb, kchunks = jax.random.split(key)
    # ground-truth coefficient matrix for the synthetic linear model
    B_true = jax.random.normal(kb, (K, M), jnp.float32) / jnp.sqrt(K)

    n_chunks = N // args.chunk
    rows_done = n_chunks * args.chunk  # static shapes: drop any ragged tail

    def gen_chunk(k):
        kx, ke = jax.random.split(k)
        Xc = jax.random.normal(kx, (args.chunk, K), jnp.float32)
        Yc = Xc @ B_true + 0.1 * jax.random.normal(ke, (args.chunk, M), jnp.float32)
        return Xc, Yc

    # Per-chunk dispatches: one jitted (generate chunk → accumulate) step
    # per chunk; large chunks (default 16384 rows) keep the per-dispatch
    # overhead amortized.
    @jax.jit
    def step(XX, XY, c):
        Xc, Yc = gen_chunk(jax.random.fold_in(kchunks, c))
        return XX + Xc.T @ Xc, XY + Xc.T @ Yc

    XX = jnp.zeros((K, K), jnp.float32)
    XY = jnp.zeros((K, M), jnp.float32)
    t0 = time.perf_counter()
    XX, XY = step(XX, XY, 0)
    float(XX[0, 0])
    t_compile_and_first = time.perf_counter() - t0
    t0 = time.perf_counter()
    for c in range(1, n_chunks):
        XX, XY = step(XX, XY, c)
    float(XX[0, 0] + XY[0, 0])
    t_stats = (time.perf_counter() - t0) * n_chunks / max(n_chunks - 1, 1)
    log(f"stats pass: compile+first {t_compile_and_first:.1f}s, "
        f"steady {t_stats:.2f}s for {rows_done} rows "
        f"({rows_done * K * 4 / t_stats / 1e9:.2f} GB/s X throughput, "
        f"{2 * rows_done * float(K) * K / t_stats / 1e12:.1f} TFLOP/s) "
        f"— INCLUDES on-device synthetic chunk generation (threefry), "
        f"which dominates; see update_only below for the accumulator rate")

    # update-only rate: pre-generate the chunks once, then time ONLY the
    # XᵀX/XᵀY accumulation.  Slope between two loop lengths cancels the
    # constant dispatch/readback cost.
    upd_tflops = None
    try:
        # cap cached chunks to ~2 GB of HBM: at the north-star shape one
        # (16384, 10k) f32 chunk is 655 MB, and caching all 61 would OOM
        n_cached = max(2, min(n_chunks, int(2e9 / (args.chunk * K * 4))))
        cached = [
            gen_chunk(jax.random.fold_in(kchunks, c)) for c in range(n_cached)
        ]
        jax.block_until_ready(cached)

        @jax.jit
        def upd(XX, XY, Xc, Yc):
            return XX + Xc.T @ Xc, XY + Xc.T @ Yc

        def run(m):
            XXa = jnp.zeros((K, K), jnp.float32)
            XYa = jnp.zeros((K, M), jnp.float32)
            t0 = time.perf_counter()
            for c in range(m):
                Xc, Yc = cached[c % n_cached]
                XXa, XYa = upd(XXa, XYa, Xc, Yc)
            float(XXa[0, 0])
            return time.perf_counter() - t0

        run(1)  # compile
        short, long_ = 2, 2 * n_chunks
        per = (min(run(long_) for _ in range(3)) - min(run(short) for _ in range(3))) / (long_ - short)
        upd_tflops = 2 * args.chunk * float(K) * K / per / 1e12
        log(f"update-only: {per*1e3:.1f} ms/chunk -> "
            f"{args.chunk * K * 4 / per / 1e9:.1f} GB/s, {upd_tflops:.1f} TFLOP/s")
        del cached
    except Exception as e:  # never fail the bench over the diagnostic
        log(f"update-only measurement skipped: {e}")

    fold_X, fold_Y = gen_chunk(jax.random.fold_in(kchunks, 0))
    fold_X, fold_Y = fold_X[:F], fold_Y[:F]  # held-out rows for the folds
    if fold_X.shape[0] < F:
        log(f"WARNING: only {fold_X.shape[0]} fold rows available")
        F = fold_X.shape[0]

    # warm-up/compile one fold batch
    t0 = time.perf_counter()
    r = cv_loo_from_stats(
        XX, XY, fold_X[: args.fold_batch], fold_Y[: args.fold_batch], A,
        batch_size=args.fold_batch, precision=None, power_iters=16,
    )
    float(jnp.sum(r.errors * r.errors))
    log(f"fold-batch compile+first: {time.perf_counter()-t0:.1f}s")

    def run_loo(f_count):
        t0 = time.perf_counter()
        loo = cv_loo_from_stats(
            XX, XY, fold_X[:f_count], fold_Y[:f_count], A,
            batch_size=args.fold_batch, precision=None, power_iters=16,
        )
        press = float(jnp.sum(loo.errors * loo.errors))
        return time.perf_counter() - t0, press

    half = (F // 2 // args.fold_batch) * args.fold_batch
    device_rate = None
    if 0 < half < F:
        # warm BOTH chain lengths first: lax.map bakes the scan trip count
        # per fold count, so each length is a distinct program whose
        # compile must not leak into the timed slope
        run_loo(half)
        run_loo(F)
        t_half, _ = run_loo(half)
        t_loo, press = run_loo(F)
        delta = t_loo - t_half
        if delta > 0:
            # slope between the two fold counts cancels per-dispatch
            # constants -> pure device fold rate
            device_rate = (F - half) / delta
        else:
            log("slope estimate skipped: non-positive timing delta "
                f"({delta*1e3:.1f} ms) — timing noise exceeded device work")
    else:
        t_loo, press = run_loo(F)
        log(f"slope estimate skipped: folds={F} too small vs "
            f"fold_batch={args.fold_batch}")
    fits_per_sec = F / t_loo
    rate_txt = f"{device_rate:.0f}" if device_rate else "n/a"
    log(f"{F}-fold LOO: {t_loo:.2f}s wall -> {fits_per_sec:.1f} fits/s "
        f"(slope estimate {rate_txt} fits/s device-rate; PRESS={press:.1f})")

    print(json.dumps({
        "backend": backend,
        "shape": {"N": rows_done, "K": K, "M": M, "A": A, "folds": F},
        "stats_pass_sec": round(t_stats, 3),
        "x_throughput_gbps": round(rows_done * K * 4 / t_stats / 1e9, 2),
        "update_only_tflops": round(upd_tflops, 2) if upd_tflops else None,
        "loo_sec": round(t_loo, 3),
        "loo_fits_per_sec": round(fits_per_sec, 2),
        "loo_fits_per_sec_device_slope": round(device_rate, 2) if device_rate else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
