#!/usr/bin/env python
"""North-star ingest benchmark: DISK → device → coefficients, real files.

Closes the r03 verdict's #1 gap: the 1M×10k numbers were fed by
on-device synthetic generation; this measures the production pipeline
starting where the reference's starts — at disk
(/root/reference/src/pls.cpp:37-67, main.cpp:21-22) — but with the
binary ingest path (utils/binio.py: .npy + threaded pread +
device-transfer lookahead) instead of CSV:

  1. one-time dataset generation to disk (X.npy 40 GB f32 at the
     north-star 1M×10k — or 20 GB with --dtype bf16; reused across runs);
  2. raw disk read bandwidth (the ingest lower bound);
  3. host→device transfer bandwidth (the other lower bound);
  4. end-to-end: stream X/Y from disk → StatsAccumulator → XX/XY
     → fit (A components) → 1000-fold LOO via rank-1 downdates,
     reporting X throughput, total wall, and WHICH bound applies;
  5. optionally (--kfold) k-fold CV at scale via block downdates
     (cv_kfold_from_stats), fold blocks re-streamed from disk.

Page cache: each timed read pass starts with `echo 3 >
/proc/sys/vm/drop_caches` when runnable (root), so disk numbers are
cold-cache honest; otherwise the artifact flags them warm.

Prints one JSON object to stdout; progress to stderr.  Artifact goes to
benchmarks/results/ via tools in the Makefile / by redirecting stdout.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np


def log(m):
    print(f"[ingest {time.strftime('%T')}] {m}", file=sys.stderr, flush=True)


def drop_caches() -> bool:
    """Best-effort cold-cache: sync + drop the page cache (needs root)."""
    try:
        os.sync()
        with open("/proc/sys/vm/drop_caches", "w") as f:
            f.write("3\n")
        return True
    except OSError:
        return False


def generate(datadir, N, K, M, chunk, dtype_name, seed=0):
    """Write X.npy/Y.npy once: one seeded random base block, tiles scaled
    by distinct factors (full-rank statistics, generation at memory/disk
    speed instead of RNG speed).  Returns (x_path, y_path)."""
    from pls_tpu.utils.binio import write_npy_chunked

    os.makedirs(datadir, exist_ok=True)
    tag = f"{N}x{K}_{dtype_name}"
    xp = os.path.join(datadir, f"X_{tag}.npy")
    yp = os.path.join(datadir, f"Y_{N}x{M}_f32.npy")
    if os.path.exists(xp) and os.path.exists(yp):
        log(f"reusing {xp}")
        return xp, yp
    if dtype_name == "bf16":
        import ml_dtypes

        x_dtype = np.dtype(ml_dtypes.bfloat16)
    else:
        x_dtype = np.dtype(np.float32)
    rng = np.random.default_rng(seed)
    base = rng.standard_normal((chunk, K), dtype=np.float32)
    B = rng.standard_normal((K, M)).astype(np.float32) / np.sqrt(K)
    noise = 0.1 * rng.standard_normal((chunk, M)).astype(np.float32)
    n_chunks = (N + chunk - 1) // chunk
    t0 = time.perf_counter()

    def x_chunks():
        # one reused output buffer: fresh 655 MB allocations page-fault
        # at ~50 MB/s on this VM (measured), the multiply itself runs at
        # ~1 GB/s into warm pages.  write_npy_chunked consumes each
        # yielded chunk (tofile) before requesting the next, so reuse is
        # safe.
        out32 = np.empty_like(base)
        for c in range(n_chunks):
            rows = min(chunk, N - c * chunk)
            scale = np.float32(1.0 + 0.002 * c)
            np.multiply(base[:rows], scale, out=out32[:rows])
            yield out32[:rows] if x_dtype == np.float32 else (
                out32[:rows].astype(x_dtype)
            )

    def y_chunks():
        yb = base @ B + noise
        out = np.empty_like(yb)
        for c in range(n_chunks):
            rows = min(chunk, N - c * chunk)
            scale = np.float32(1.0 + 0.002 * c)
            np.multiply(yb[:rows], scale, out=out[:rows])
            yield out[:rows]

    write_npy_chunked(xp, x_chunks())
    write_npy_chunked(yp, y_chunks())
    dt = time.perf_counter() - t0
    gb = N * K * x_dtype.itemsize / 1e9
    log(f"generated {gb:.1f} GB to disk in {dt:.0f}s ({gb/dt:.2f} GB/s write)")
    return xp, yp


def measure_disk(x_path, chunk, max_gb=None):
    """Raw threaded-pread pass over X.npy, no device involved."""
    from pls_tpu.utils.binio import npy_shape, stream_npy

    (N, K), dtype = npy_shape(x_path)
    cold = drop_caches()
    t0 = time.perf_counter()
    nbytes = 0
    for c in stream_npy(x_path, chunk, reuse_buffers=True):
        nbytes += c.nbytes
        if max_gb and nbytes > max_gb * 1e9:
            break
    dt = time.perf_counter() - t0
    gbps = nbytes / dt / 1e9
    log(f"disk read: {nbytes/1e9:.1f} GB in {dt:.1f}s -> {gbps:.2f} GB/s "
        f"({'cold' if cold else 'WARM'} page cache)")
    return gbps, cold


def measure_h2d(chunk, K, itemsize, reps=8):
    """Host→device bandwidth on one chunk-sized pinned-ish buffer."""
    import jax

    buf = np.ones((chunk, K), np.float32 if itemsize == 4 else np.float16)
    if itemsize == 2:
        import ml_dtypes

        buf = buf.astype(ml_dtypes.bfloat16)
    jax.block_until_ready(jax.device_put(buf))  # warm path + allocator
    t0 = time.perf_counter()
    for _ in range(reps):
        jax.block_until_ready(jax.device_put(buf))
    dt = (time.perf_counter() - t0) / reps
    gbps = buf.nbytes / dt / 1e9
    log(f"host->device: {buf.nbytes/1e6:.0f} MB chunk -> {gbps:.2f} GB/s")
    return gbps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--k", type=int, default=10_000)
    ap.add_argument("--m", type=int, default=10)
    ap.add_argument("--a", type=int, default=20)
    ap.add_argument("--folds", type=int, default=1000)
    ap.add_argument("--fold-batch", type=int, default=125)
    ap.add_argument("--chunk", type=int, default=16384)
    ap.add_argument("--dtype", default="f32", choices=["f32", "bf16"])
    ap.add_argument("--datadir", default=".ns_data")
    ap.add_argument("--kfold", type=int, default=0,
                    help="also run k-fold CV at scale via block downdates")
    ap.add_argument("--skip-disk-probe", action="store_true")
    ap.add_argument(
        "--phase", default="all",
        choices=["probe", "stats", "cv", "kfold", "kfold1p", "kfold2p", "all"],
        help="run one pipeline phase and exit; XX/XY persist in "
             "--datadir between phases (whether the split into processes "
             "still pays on a GPU host is not measured yet)",
    )
    ap.add_argument("--out", default="",
                    help="JSON artifact path: merge this phase's keys into it")
    args = ap.parse_args()

    from pls_tpu.utils.cache import enable_compilation_cache

    enable_compilation_cache()

    import jax
    import jax.numpy as jnp

    from pls_tpu.cv.loo import cv_loo_from_stats
    from pls_tpu.utils.binio import npy_shape, stats_from_npy, stream_npy

    backend = jax.default_backend()
    if backend != "gpu":
        raise SystemExit(f"needs a GPU; JAX's default backend is {backend}")
    N, K, M, A = args.n, args.k, args.m, args.a
    log(f"backend={backend} kind={jax.devices()[0].device_kind} N={N} K={K} "
        f"M={M} A={A} dtype={args.dtype}")

    xp, yp = generate(args.datadir, N, K, M, args.chunk, args.dtype)
    (_, _), x_dtype = npy_shape(xp)
    x_gb = N * K * x_dtype.itemsize / 1e9

    out = {
        "backend": backend,
        "shape": {"N": N, "K": K, "M": M, "A": A},
        "x_dtype": args.dtype,
        "x_file_gb": round(x_gb, 2),
    }
    if args.out and os.path.exists(args.out):
        with open(args.out) as f:
            prev = json.load(f)
        prev.update(out)
        out = prev
    phase = args.phase
    stats_npz = os.path.join(
        args.datadir, f"stats_{N}x{K}_{args.dtype}_A{A}.npz"
    )

    # absorb the per-process first-dispatch stall on a tiny program
    t0 = time.perf_counter()
    jax.block_until_ready(jnp.zeros((8,)) + 1)
    log(f"first dispatch: {time.perf_counter()-t0:.1f}s")

    if not args.skip_disk_probe and phase in ("probe", "all"):
        disk_gbps, cold = measure_disk(xp, args.chunk, max_gb=min(x_gb, 12))
        out["disk_read_gbps"] = round(disk_gbps, 2)
        out["disk_cold_cache"] = cold
        h2d_gbps = measure_h2d(args.chunk, K, x_dtype.itemsize)
        out["h2d_gbps"] = round(h2d_gbps, 2)
        bound = min(disk_gbps, h2d_gbps)
        out["ingest_bound"] = "disk" if disk_gbps < h2d_gbps else "transfer"
        log(f"ingest bound: {out['ingest_bound']} at {bound:.2f} GB/s")
    if phase == "probe":
        return _emit(out, args)

    # ---- end-to-end: disk -> stats -> fit ----
    XXa = XYa = None
    if phase in ("stats", "all"):
        cold = drop_caches()
        t0 = time.perf_counter()
        acc = stats_from_npy(xp, yp, chunk_rows=args.chunk)
        jax.block_until_ready((acc.XX, acc.XY))
        t_stats = time.perf_counter() - t0
        e2e_gbps = x_gb / t_stats
        log(f"stats pass (disk-fed, {'cold' if cold else 'WARM'}): {t_stats:.1f}s "
            f"-> {e2e_gbps:.2f} GB/s of X; n={int(acc.n)}")
        out["stats_pass_sec"] = round(t_stats, 2)
        out["e2e_x_gbps"] = round(e2e_gbps, 2)
        if "disk_read_gbps" in out:
            out["overlap_efficiency"] = round(
                e2e_gbps / min(out["disk_read_gbps"], out["h2d_gbps"]), 3
            )

        t0 = time.perf_counter()
        f = acc.fit(A, power_iters=16, precision=None)
        jax.block_until_ready(f.W)
        t_fit = time.perf_counter() - t0
        log(f"fit_from_stats A={A}: {t_fit:.2f}s")
        out["fit_sec"] = round(t_fit, 2)
        XXa, XYa = acc.XX, acc.XY
        if phase == "stats":
            np.savez(stats_npz, XX=np.asarray(XXa), XY=np.asarray(XYa))
            log(f"stats saved to {stats_npz}")
            return _emit(out, args)

    # ---- ONE-PASS k-fold CV (r05): per-fold statistics accumulated in
    # the single data pass, closed-form PRESS, then ONE combined
    # residual sweep — 2 total disk passes instead of 1+k, as two phases.
    bstack_npz = os.path.join(
        args.datadir, f"kfold1p_{N}x{K}_{args.dtype}_A{A}.npz"
    )
    foldstats_prefix = os.path.join(
        args.datadir, f"foldstats_{N}x{K}_{args.dtype}_A{A}"
    )
    if phase == "kfold1p":
        from pls_tpu.utils.binio import fold_stats_from_npy

        k = args.kfold or 10
        # contiguous-block partition — the same fold boundaries the r04
        # re-streaming benchmark used, so PRESS totals are comparable
        assign = ((np.arange(N, dtype=np.int64) * k) // N).astype(np.int32)
        # pre-compile the fold-update program outside the timed pass
        from pls_tpu.models.streaming import FoldStatsAccumulator

        (_, _), xdt = npy_shape(xp)
        narrow = xdt.itemsize < 4
        warm = FoldStatsAccumulator(
            K, M, k, x_storage="bf16" if narrow else None
        )
        wdt = np.float32 if not narrow else xdt
        warm_rows = [args.chunk] + ([N % args.chunk] if N % args.chunk else [])
        for r in warm_rows:
            # uniform assign -> single-fold fast path; alternating ->
            # the masked scan (boundary chunks) — compile BOTH
            warm.update(
                np.zeros((r, K), wdt), np.zeros((r, M), np.float32),
                np.zeros((r,), np.int32),
            )
            warm.update(
                np.zeros((r, K), wdt), np.zeros((r, M), np.float32),
                (np.arange(r) % k).astype(np.int32),
            )
        jax.block_until_ready(warm.XXf)
        # compile the batched closed-form program too (zeros stats give
        # NaN press — only the compile matters here)
        from pls_tpu.cv.kfold import cv_kfold_onepass as _ckop

        t0 = time.perf_counter()
        _ = _ckop(warm, A, power_iters=16, precision=None)
        log(f"closed-form program warm ({time.perf_counter()-t0:.1f}s)")
        del warm, _
        cold = drop_caches()
        t0 = time.perf_counter()
        facc = fold_stats_from_npy(xp, yp, assign, k, chunk_rows=args.chunk)
        jax.block_until_ready(facc.XXf)
        t_fs = time.perf_counter() - t0
        log(f"one-pass fold-stats ({'cold' if cold else 'WARM'}): {t_fs:.1f}s "
            f"-> {x_gb / t_fs:.2f} GB/s of X")
        # the ENTIRE closed form is one device program (lax.map over
        # folds) + small pulls
        from pls_tpu.cv.kfold import cv_kfold_onepass

        t0 = time.perf_counter()
        summary = cv_kfold_onepass(facc, A, power_iters=16, precision=None)
        t_close = time.perf_counter() - t0
        press_total = float(summary.press.sum())
        log(f"closed-form PRESS ({k} folds x A={A}, one program): "
            f"{t_close:.1f}s; total PRESS={press_total:.1f}")
        t0 = time.perf_counter()
        np.save(bstack_npz.replace(".npz", "_B.npy"), np.asarray(summary.B))
        np.savez(bstack_npz, assign=assign, press=summary.press,
                 nf=summary.nf)
        t_save = time.perf_counter() - t0
        log(f"B stack + press persisted: {t_save:.1f}s")
        out["kfold1p_k"] = k
        out["kfold1p_stats_sec"] = round(t_fs, 2)
        out["kfold1p_close_sec"] = round(t_close, 2)
        out["kfold1p_press_total"] = round(press_total, 1)
        out["kfold1p_save_sec"] = round(t_save, 2)
        return _emit(out, args)

    if phase == "kfold2p":
        from pls_tpu.cv.kfold import fold_residual_chunk
        from pls_tpu.utils.binio import device_stream

        zs = np.load(bstack_npz)
        assign = zs["assign"]
        press_cf = zs["press"]
        t0 = time.perf_counter()
        B = jax.device_put(
            jnp.asarray(np.load(bstack_npz.replace(".npz", "_B.npy")))
        )
        jax.block_until_ready(B)
        t_load = time.perf_counter() - t0
        log(f"B stack loaded + device-put: {t_load:.1f}s")
        out["kfold2p_load_sec"] = round(t_load, 2)
        k = B.shape[0]
        Mz = B.shape[3]
        # pre-compile the residual-chunk program outside the timed pass
        (_, _), xdt = npy_shape(xp)
        xdt_j = jnp.bfloat16 if xdt.itemsize < 4 else jnp.float32
        for r in [args.chunk] + ([N % args.chunk] if N % args.chunk else []):
            jax.block_until_ready(fold_residual_chunk(
                B, jnp.zeros((r, K), xdt_j),
                jnp.zeros((r, Mz), jnp.float32),
                jnp.zeros((r,), jnp.int32),
            ))
        log("residual-chunk program warm")
        cold = drop_caches()
        t0 = time.perf_counter()
        errs = np.empty((N, A, Mz), np.float32)
        xs = device_stream(stream_npy(xp, args.chunk, reuse_buffers=True))
        ys = device_stream(stream_npy(yp, args.chunk, threaded=False))
        start = 0
        for Xc, Yc in zip(xs, ys):
            rows = Xc.shape[0]
            e = fold_residual_chunk(
                B, Xc, Yc, jnp.asarray(assign[start : start + rows])
            )
            errs[start : start + rows] = np.asarray(e)
            start += rows
        t_resid = time.perf_counter() - t0
        log(f"combined residual pass ({'cold' if cold else 'WARM'}): "
            f"{t_resid:.1f}s -> {x_gb / t_resid:.2f} GB/s of X")
        # PRESS from per-row residuals must close the loop with the
        # closed-form matrix (f64 host sums)
        press_resid = np.einsum(
            "nam,nam->am", errs.astype(np.float64), errs.astype(np.float64)
        ).T  # (M, A)
        rel = float(
            np.abs(press_resid - press_cf).max() / np.abs(press_cf).max()
        )
        log(f"closed-form vs residual-sweep PRESS agreement: {rel:.2e}")
        # Wilcoxon optimal components: the selector is one jitted program
        # (cv/validation._optimal_from_errors), run on the GPU, counting
        # the host→device transfer of the error tensor.
        from pls_tpu.cv.validation import optimal_num_components
        from pls_tpu.types import Residual

        t0 = time.perf_counter()
        sel_dev = jax.devices()[0]
        errs_mna = jax.device_put(
            np.ascontiguousarray(np.transpose(errs, (2, 0, 1))), sel_dev
        )
        opt = np.asarray(optimal_num_components(
            Residual(errors=errs_mna, method=f"{k}-FOLD")
        ))
        del errs_mna
        t_opt = time.perf_counter() - t0
        log(f"optimal components (Wilcoxon over {N} rows): {list(opt)} "
            f"({t_opt:.1f}s, {sel_dev.platform})")
        out["kfold2p_resid_sec"] = round(t_resid, 2)
        out["kfold2p_press_agreement_rel"] = rel
        out["kfold2p_optimal_components"] = [int(v) for v in opt]
        out["kfold2p_wilcoxon_sec"] = round(t_opt, 2)
        if "kfold1p_stats_sec" in out:
            tot = out["kfold1p_stats_sec"] + out["kfold1p_close_sec"] + t_resid
            out["kfold_onepass_total_sec"] = round(tot, 2)
            if "kfold_sec" in out:
                out["kfold_onepass_speedup_vs_restream"] = round(
                    out["kfold_sec"] / tot, 1
                )
        return _emit(out, args)

    if phase in ("cv", "kfold") and XXa is None:
        z = np.load(stats_npz)
        XXa = jax.device_put(jnp.asarray(z["XX"]))
        XYa = jax.device_put(jnp.asarray(z["XY"]))
        log(f"stats loaded from {stats_npz}")

    class _AccView:
        XX, XY = XXa, XYa

    acc = _AccView()

    if phase == "kfold":
        # skip the LOO section entirely in the kfold-only process
        F = 0
    else:
        F = args.folds
    fold_rows = []
    got = 0
    for c in stream_npy(xp, args.chunk):
        fold_rows.append(c[: F - got])
        got += fold_rows[-1].shape[0]
        if got >= F:
            break
    fold_X = jnp.asarray(np.concatenate(fold_rows), jnp.float32)
    yr = []
    got = 0
    for c in stream_npy(yp, args.chunk):
        yr.append(c[: F - got])
        got += yr[-1].shape[0]
        if got >= F:
            break
    fold_Y = jnp.asarray(np.concatenate(yr), jnp.float32)

    if F:
        def run_loo(f_count):
            t0 = time.perf_counter()
            loo = cv_loo_from_stats(
                acc.XX, acc.XY, fold_X[:f_count], fold_Y[:f_count], A,
                batch_size=args.fold_batch, precision=None, power_iters=16,
            )
            press = float(jnp.sum(loo.errors * loo.errors))
            return time.perf_counter() - t0, press

        run_loo(min(args.fold_batch, F))  # compile
        t_loo, press = run_loo(F)
        log(f"{F}-fold LOO: {t_loo:.2f}s ({F/t_loo:.0f} fits/s; "
            f"PRESS={press:.1f})")
        out["loo_folds"] = F
        out["loo_sec"] = round(t_loo, 2)
        if "stats_pass_sec" in out and "fit_sec" in out:
            out["total_disk_to_loo_sec"] = round(
                out["stats_pass_sec"] + out["fit_sec"] + t_loo, 2
            )

    # ---- optional: k-fold CV at scale via block downdates ----
    if args.kfold and phase in ("kfold", "all"):
        from pls_tpu.cv.kfold import cv_kfold_from_stats
        from pls_tpu.utils.binio import npy_chunks

        k = args.kfold
        bounds = [N * f // k for f in range(k + 1)]
        per_max = max(b - a for a, b in zip(bounds, bounds[1:]))

        def fold_blocks():
            """Re-stream each contiguous fold block from disk into ONE
            preallocated staging buffer (fresh GB-sized allocations are
            mmap/page-fault-bound on this VM), transfer it, and block
            the transfer before refilling — the device array is the only
            X-sized object per fold."""
            stage = np.empty((per_max, K), np.float32)
            ystage = np.empty((per_max, M), np.float32)
            f, fill = 0, 0
            target = bounds[1] - bounds[0]
            for Xc, Yc in npy_chunks(xp, yp, args.chunk, reuse_buffers=True):
                o = 0
                while o < Xc.shape[0]:
                    take = min(target - fill, Xc.shape[0] - o)
                    stage[fill : fill + take] = Xc[o : o + take]
                    ystage[fill : fill + take] = Yc[o : o + take]
                    fill += take
                    o += take
                    if fill == target:
                        dev = jax.device_put(stage[:target])
                        devy = jax.device_put(ystage[:target])
                        jax.block_until_ready((dev, devy))
                        yield dev, devy
                        f += 1
                        if f >= k:
                            return
                        target = bounds[f + 1] - bounds[f]
                        fill = 0

        cold = drop_caches()
        t0 = time.perf_counter()
        res = cv_kfold_from_stats(
            acc.XX, acc.XY, fold_blocks(), A,
            power_iters=16, precision=None,
        )
        press_k = float(jnp.sum(res.errors * res.errors))
        t_kfold = time.perf_counter() - t0
        log(f"{k}-fold block-downdate CV (fold blocks re-streamed from "
            f"disk, {'cold' if cold else 'WARM'}): {t_kfold:.1f}s "
            f"(PRESS={press_k:.1f})")
        out["kfold_k"] = k
        out["kfold_sec"] = round(t_kfold, 2)

    return _emit(out, args)


def _emit(out, args) -> int:
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
