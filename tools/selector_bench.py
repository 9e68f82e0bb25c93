#!/usr/bin/env python
"""Wilcoxon optimal-component selection at the north-star error shape.

Run eagerly over the 1M-row k-fold Residual (M=10 responses, A=20
truncations), the selector body is O(M·A) separate jnp ops — a dispatch
tax, not math.  cv/validation._optimal_from_errors compiles the WHOLE selection —
M·A paired Wilcoxon tests lowering to one batched stable sort — into a
single XLA program.  This tool measures that program at the same shape:

  python tools/selector_bench.py [--n 999424] [--m 10] [--a 20]
                                 [--backend cpu|gpu|both] [--out PATH]

Prints per-backend cold (compile included) and warm walls, each with the
device it ran on, and for the GPU the host→device transfer separately (errors are
host-resident after a residual sweep, so transfer is part of the honest
cost).  Reference analogue: optimal_num_components at
upstream src/pls.cpp:263-289 (sequential, per-pair std::sort).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def log(msg: str) -> None:
    print(f"[selector {time.strftime('%T')}] {msg}", file=sys.stderr, flush=True)


def synth_errors(n: int, m: int, a: int):
    """Synthetic CV error tensor (M, N, A) with a realistic profile:
    error scale shrinks to a floor at ~a/3 components then rises slightly
    (overfit tail), so min-PRESS sits mid-range and the Wilcoxon walk has
    real work to do."""
    import numpy as np

    rng = np.random.default_rng(0)
    comps = np.arange(1, a + 1, dtype=np.float64)
    opt = max(2, a // 3)
    scale = 0.15 + 1.2 * np.exp(-comps / (opt / 2.5)) + 0.004 * (comps - opt)
    errs = rng.standard_normal((m, n, a)) * scale[None, None, :]
    return errs.astype(np.float32)


def time_backend(errs_np, device, alpha: float = 0.1):
    import jax
    import numpy as np

    from pls_tpu.cv.validation import _optimal_from_errors

    out = {}
    t0 = time.perf_counter()
    errs = jax.device_put(errs_np, device)
    errs.block_until_ready()
    out["transfer_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    opt = np.asarray(_optimal_from_errors(errs, alpha))
    out["cold_s"] = round(time.perf_counter() - t0, 3)

    t0 = time.perf_counter()
    opt = np.asarray(_optimal_from_errors(errs, alpha))
    out["warm_s"] = round(time.perf_counter() - t0, 3)
    out["optimal_components"] = [int(v) for v in opt]
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=999_424)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--a", type=int, default=20)
    ap.add_argument("--backend", default="both", choices=["cpu", "gpu", "both"])
    ap.add_argument("--out", default=None)
    args = ap.parse_args()

    import jax

    log(f"building synthetic errors ({args.m}, {args.n}, {args.a}) "
        f"= {args.m * args.n * args.a * 4 / 1e9:.2f} GB f32")
    errs = synth_errors(args.n, args.m, args.a)

    results = {"n": args.n, "m": args.m, "a": args.a,
               "bytes": int(errs.nbytes), "backends": {}}
    want = ("cpu", "gpu") if args.backend == "both" else (args.backend,)

    for backend in want:
        dev = jax.local_devices(backend=backend)[0]  # raises if absent
        log(f"{backend}: running on {dev}")
        r = time_backend(errs, dev)
        r["device_kind"] = dev.device_kind
        results["backends"][backend] = r
        log(f"{backend}: transfer {r['transfer_s']} s, cold {r['cold_s']} s, "
            f"warm {r['warm_s']} s -> {r['optimal_components']}")

    print(json.dumps(results))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=2)
        log(f"wrote {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
