#!/usr/bin/env python
"""Deflation-pass benchmark on one GPU.

Prints ONE JSON line on stdout:
  {"metric": ..., "value": ..., "unit": ..., "vs_baseline": ...,
   "device": {"platform", "kind", "count"}}
Diagnostics, the card's name and power limit go to stderr.  Exits
non-zero, printing no result, when JAX finds no GPU.

Metric: one-pass bandwidth of the per-component deflation update
(t = X r, tt = tᵀt, p = Xᵀ t) — the hot loop of kernel-PLS type 1
(BASELINE.json: "NIPALS deflation GB/s per chip").  Bytes are counted as
ONE logical pass of X (N·K·itemsize) per component for every
implementation, so a fused single-pass kernel can exceed the two-pass
formulation by up to 2× at the same physical bandwidth.

Method: the component update is dispatched as a chain of jitted calls
whose inputs depend on the previous call's outputs
(r_{i+1} = normalize(p_i), the dependency structure of the PLS scan), so
the device serializes them; one scalar readback ends each chain.  Timed
at two chain lengths; the per-component time is the slope, which cancels
the dispatch and readback constants.

Baseline: the reference's own hot loop (Eigen, single thread, double,
upstream src/pls.cpp:418-421) at 3.64 GB/s one-pass-equivalent
(N=20000, K=2000; see BASELINE.md).
"""

import json
import subprocess
import sys
import time

REFERENCE_ONEPASS_GBPS = 3.64  # Eigen f64 single-thread (BASELINE.md)


def log(msg: str) -> None:
    print(f"[bench {time.strftime('%T')}] {msg}", file=sys.stderr, flush=True)


def main() -> int:
    import jax

    from pls_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        log(f"no GPU: JAX's first device is {dev.platform}; nothing measured")
        return 1
    device = {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }
    log(f"device: {device}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    log(f"card: {smi.stdout.strip()}")

    import jax.numpy as jnp

    from pls_tpu.ops.deflate import _deflate_pass_pallas, deflate_pass_xla

    N, K = 131072, 2048
    gb = N * K * 4 / 1e9
    kx, kr = jax.random.split(jax.random.key(0))
    X = jax.random.normal(kx, (N, K), jnp.float32)
    r0 = jax.random.normal(kr, (K,), jnp.float32)
    jax.block_until_ready((X, r0))
    log(f"N={N} K={K} ({gb*1e3:.0f} MB operand)")

    def slope_time(pass_fn, label, operand, short=10, long=50, reps=5):
        odtype = operand.dtype

        @jax.jit
        def advance(p):
            return (p * jax.lax.rsqrt(p @ p)).astype(odtype)

        def run_chain(iters):
            r = r0.astype(odtype)
            tt = None
            for _ in range(iters):
                t, tt, p = pass_fn(operand, r)
                r = advance(p)
            return float(tt)

        t0 = time.perf_counter()
        run_chain(1)
        log(f"{label} compile+first: {time.perf_counter()-t0:.1f}s")
        times = {}
        for iters in (short, long):
            runs = []
            for _ in range(reps):
                t0 = time.perf_counter()
                run_chain(iters)
                runs.append(time.perf_counter() - t0)
            times[iters] = min(runs)
        per = (times[long] - times[short]) / (long - short)
        nbytes = operand.size * operand.dtype.itemsize
        log(f"{label}: {per*1e3:.4f} ms/component -> "
            f"{nbytes/per/1e9:.1f} GB/s one-pass ({odtype} bytes)")
        return per

    def xla_highest(X, r):
        with jax.default_matmul_precision("highest"):
            return xla(X, r)

    xla = jax.jit(deflate_pass_xla)
    results = {
        "pallas_fused": slope_time(_deflate_pass_pallas, "pallas_fused", X),
        "xla_two_pass": slope_time(xla_highest, "xla_two_pass", X),
    }
    Xb = X.astype(jnp.bfloat16)
    slope_time(_deflate_pass_pallas, "pallas_fused_bf16", Xb)

    impl = min(results, key=results.get)
    gbps = gb / results[impl]
    log(f"best={impl}")
    print(json.dumps({
        "metric": "deflation_onepass_bandwidth",
        "value": gbps,
        "unit": "GB/s",
        "vs_baseline": gbps / REFERENCE_ONEPASS_GBPS,
        "device": device,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
