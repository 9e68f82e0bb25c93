#!/usr/bin/env python
"""Chunk-size sweep for the streaming-stats accumulator on the GPU: find
the chunk size at which the f32 and the bf16-narrow update reach the
highest rate.

Method: cached on-device chunks, dependency-chained `_update` /
`_update_narrow` dispatches, slope between two loop lengths (cancels
dispatch constants — see bench.py).  FLOPs counted as
2·chunk·K² + 2·chunk·K·M per update.

Prints one JSON object; progress to stderr.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(m):
    print(f"[accsweep {time.strftime('%T')}] {m}", file=sys.stderr, flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--k", type=int, default=10_000)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument(
        "--chunks", type=int, nargs="+",
        default=[4096, 8192, 16384, 32768],
    )
    ap.add_argument("--reps", type=int, default=3)
    args = ap.parse_args()

    from pls_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from pls_tpu.models.streaming import _update, _update_narrow

    K, M = args.k, args.m
    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default backend is {backend}")
    kind = jax.devices()[0].device_kind
    log(f"backend={backend} kind={kind} K={K} M={M}")

    results = {}
    key = jax.random.key(0)
    for chunk in args.chunks:
        kx, ky, key = jax.random.split(key, 3)
        Xc = jax.random.normal(kx, (chunk, K), jnp.float32)
        Yc = jax.random.normal(ky, (chunk, M), jnp.float32)
        Xb, Yb = Xc.astype(jnp.bfloat16), Yc.astype(jnp.bfloat16)
        jax.block_until_ready((Xc, Yc, Xb, Yb))
        flops = 2 * chunk * (float(K) * K + K * M)
        for label, fn, xa, ya in (
            ("f32", _update, Xc, Yc),
            ("bf16", _update_narrow, Xb, Yb),
        ):
            def run(iters):
                XX = jnp.zeros((K, K), jnp.float32)
                XY = jnp.zeros((K, M), jnp.float32)
                n = jnp.zeros((), jnp.int32)
                t0 = time.perf_counter()
                for _ in range(iters):
                    XX, XY, n = fn(XX, XY, n, xa, ya)
                float(XX[0, 0])
                return time.perf_counter() - t0

            run(1)  # compile
            short, long_ = 3, 13
            per = (
                min(run(long_) for _ in range(args.reps))
                - min(run(short) for _ in range(args.reps))
            ) / (long_ - short)
            tf = flops / per / 1e12
            gbps = chunk * K * xa.dtype.itemsize / per / 1e9
            log(f"chunk={chunk:6d} {label}: {per*1e3:7.1f} ms/update "
                f"-> {tf:6.1f} TFLOP/s, {gbps:6.1f} GB/s chunk-stream")
            results[f"{label}_{chunk}"] = {
                "ms_per_update": round(per * 1e3, 2),
                "tflops": round(tf, 1),
                "chunk_gbps": round(gbps, 1),
            }
        del Xc, Yc, Xb, Yb

    print(json.dumps({"backend": backend, "device_kind": kind, "K": K,
                      "M": M, "sweep": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
