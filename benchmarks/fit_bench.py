#!/usr/bin/env python
"""End-to-end fit benchmark: the full kernel-PLS type-1 scan on one GPU,
with and without the fused Pallas deflation pass.

Per-component time is the slope between two component counts (A_long vs
A_short) of the jitted fit — same program structure, different scan trip
counts — cancelling dispatch/readback constants (see bench.py).

Usage: python benchmarks/fit_bench.py [--n 65536] [--k 2048] [--m 1]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(m):
    print(f"[fit_bench {time.strftime('%T')}] {m}", file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--k", type=int, default=2048)
    ap.add_argument("--m", type=int, default=1)
    ap.add_argument("--a-short", type=int, default=4)
    ap.add_argument("--a-long", type=int, default=16)
    args = ap.parse_args()

    from pls_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from pls_tpu.models.kernel_pls import fit

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default backend is {backend}")
    kind = jax.devices()[0].device_kind
    N, K, M = args.n, args.k, args.m
    gb = N * K * 4 / 1e9
    log(f"backend={backend} kind={kind} N={N} K={K} M={M}")

    kx, ky = jax.random.split(jax.random.key(0))
    X = jax.random.normal(kx, (N, K), jnp.float32)
    Y = jax.random.normal(ky, (N, M), jnp.float32)
    jax.block_until_ready((X, Y))

    def time_fit(A, use_pallas, reps=3, x_storage=None):
        def run():
            t0 = time.perf_counter()
            f = fit(X, Y, A, use_pallas=use_pallas, precision="highest",
                    power_iters=16 if M > 1 else None, x_storage=x_storage)
            float(f.R[0, 0])  # force completion
            return time.perf_counter() - t0
        run()  # compile + first
        return min(run() for _ in range(reps))

    out = {"backend": backend, "device_kind": kind, "N": N, "K": K, "M": M}
    for use_pallas, x_storage, label in [
        (None, None, "auto_default"),  # the no-flag path
        (True, None, "pallas"), (False, None, "xla"),
        (True, "bf16", "pallas_bf16"),  # x_storage speed mode
    ]:
        t_s = time_fit(args.a_short, use_pallas, x_storage=x_storage)
        t_l = time_fit(args.a_long, use_pallas, x_storage=x_storage)
        per = max((t_l - t_s) / (args.a_long - args.a_short), 1e-9)
        log(f"fit[{label}]: {per*1e3:.3f} ms/component "
            f"({gb/per:.0f} GB/s one-pass equivalent)")
        out[f"{label}_ms_per_component"] = round(per * 1e3, 3)
        out[f"{label}_onepass_gbps"] = round(gb / per, 1)

    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
