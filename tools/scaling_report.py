#!/usr/bin/env python
"""Scaling-efficiency report: sharded fit + CV across 1/2/4/8 devices.

On a multi-GPU host this measures the scaling of the row-sharded fit and
the fold-sharded CV over NVLink.  With --platform cpu it validates the execution paths end-to-end using XLA's
virtual host devices (numbers then reflect a single socket and are not a
hardware claim — the tool says which mode it ran in).

Usage: python tools/scaling_report.py [--devices 8] [--n 4096] [--k 512]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--n", type=int, default=4096)
    ap.add_argument("--k", type=int, default=512)
    ap.add_argument("--m", type=int, default=4)
    ap.add_argument("--a", type=int, default=8)
    ap.add_argument("--trials", type=int, default=16)
    ap.add_argument(
        "--platform", choices=["gpu", "cpu"], default="gpu",
        help="gpu: the host's cards (at least --devices of them); cpu: "
        "virtual CPU devices, to validate the paths only",
    )
    args = ap.parse_args()

    import jax

    if args.platform == "cpu":
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_num_cpu_devices", args.devices)

    import jax.numpy as jnp
    import numpy as np

    from pls_tpu.parallel.mesh import make_pls_mesh
    from pls_tpu.parallel.sharded import cv_lso_sharded, fit_sharded
    from pls_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    backend = jax.default_backend()
    devs = jax.devices()
    print(f"backend={backend} kind={devs[0].device_kind} "
          f"devices={len(devs)}", file=sys.stderr)
    if backend != args.platform or len(devs) < args.devices:
        raise SystemExit(
            f"asked for {args.devices} {args.platform} devices, found "
            f"{len(devs)} {backend} device(s)"
        )

    key = jax.random.key(0)
    kx, ky, kp = jax.random.split(key, 3)
    X = jax.random.normal(kx, (args.n, args.k), jnp.float32)
    Y = jax.random.normal(ky, (args.n, args.m), jnp.float32)
    parts = jnp.stack(
        [jax.random.permutation(jax.random.fold_in(kp, i), args.n)
         for i in range(args.trials)]
    )
    train_size = (3 * args.n) // 4

    def timed(fn, reps=5):
        out = fn()
        jax.block_until_ready(out)
        t0 = time.perf_counter()
        for _ in range(reps):
            out = fn()
        jax.block_until_ready(out)
        return (time.perf_counter() - t0) / reps

    virtual = backend == "cpu"
    report = {"backend": backend, "device_kind": devs[0].device_kind,
              "mode": "virtual-cpu" if virtual else "hw",
              "shape": [args.n, args.k, args.m, args.a], "rows_scaling": {},
              "folds_scaling": {}}
    if virtual:
        # Efficiency figures are MEANINGLESS on virtual devices (they
        # timeslice one socket), so they are omitted entirely — the run
        # only validates that the sharded execution paths work at every
        # device count.
        report["disclaimer"] = (
            "path-validation only: virtual CPU devices timeslice one "
            "socket, so per-device efficiency cannot be measured and is "
            "omitted; measure on a multi-GPU host"
        )

    sizes = [d for d in (1, 2, 4, 8) if d <= len(devs)]
    base_fit = base_cv = None
    for d in sizes:
        mesh = make_pls_mesh(rows=d, folds=1, devices=devs[:d])
        t_fit = timed(lambda: fit_sharded(X, Y, args.a, mesh=mesh, precision=None).W)
        mesh_f = make_pls_mesh(rows=1, folds=d, devices=devs[:d])
        t_cv = timed(
            lambda: cv_lso_sharded(
                X, Y, args.a, parts, train_size, mesh=mesh_f, precision=None
            ).errors,
            reps=2,
        )
        base_fit = base_fit or t_fit
        base_cv = base_cv or t_cv
        report["rows_scaling"][d] = {"sec": round(t_fit, 5)}
        report["folds_scaling"][d] = {"sec": round(t_cv, 5)}
        if not virtual:
            report["rows_scaling"][d]["efficiency"] = round(
                base_fit / (t_fit * d), 3
            )
            report["folds_scaling"][d]["efficiency"] = round(
                base_cv / (t_cv * d), 3
            )
        print(f"devices={d} fit={t_fit*1e3:.1f}ms cv={t_cv*1e3:.1f}ms",
              file=sys.stderr)

    print(json.dumps(report, indent=2))
    return 0


if __name__ == "__main__":
    sys.exit(main())
