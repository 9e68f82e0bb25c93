#!/usr/bin/env python
"""Wall-clock the reference's own flagship workload END TO END
(VERDICT r04 missing #2): the full CLI pipeline

    pls nir.csv octane.csv 10

i.e. z-score → fit A=10 → print state → explained variance → LOO (60
refits) → LSO frac=0.3, trials=10·N=600 (reference driver:
upstream src/main.cpp:29-41), measured as a SUBPROCESS wall —
process startup, imports, compile-cache hits and all — on the current
backend.  The reference's measured number on this host is 83.8 s
single-threaded (BASELINE.md); report the ratio.

Runs the CLI twice: cold (whatever the compile cache holds) and warm
(same process arguments again), reporting both walls — the warm number
is the steady-state answer for repeated calibrations, the cold one is
what a first-ever invocation pays.

Usage: python tools/flagship_wall.py [--runs 3] [--out artifact.json]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_REF_SEC = 83.8  # BASELINE.md: reference CLI on nir, this host, 1 thread


def run_once(env) -> tuple[float, int]:
    from pls_tpu.datasets import _DATA

    nir = str(_DATA / "nir.csv")
    octane = str(_DATA / "octane.csv")
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, "-m", "pls_tpu", nir, octane, "10"],
        capture_output=True, text=True, env=env, cwd=_REPO,
    )
    wall = time.perf_counter() - t0
    if p.returncode != 0:
        print(p.stderr[-2000:], file=sys.stderr)
    return wall, p.returncode


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--out", default="")
    ap.add_argument("--backend", default="",
                    help="JAX_PLATFORMS for the CLI ('' = JAX's default)")
    args = ap.parse_args()

    env = dict(os.environ)
    if args.backend:
        env["JAX_PLATFORMS"] = args.backend
    walls = []
    for i in range(args.runs):
        wall, rc = run_once(env)
        assert rc == 0, f"CLI failed rc={rc}"
        walls.append(round(wall, 2))
        print(f"[flagship] run {i}: {wall:.2f}s", file=sys.stderr, flush=True)

    best = min(walls)
    out = {
        "workload": "pls nir.csv octane.csv 10 (fit + LOO + 600-trial LSO)",
        "backend": args.backend or "default",
        "walls_sec": walls,
        "cold_sec": walls[0],
        "warm_best_sec": best,
        "reference_sec": _REF_SEC,
        "speedup_vs_reference_warm": round(_REF_SEC / best, 1),
        "speedup_vs_reference_cold": round(_REF_SEC / walls[0], 1),
    }
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
