#!/usr/bin/env python
"""On-card check of pls-tpu's main path on NVIDIA GPUs.

    python chip_smoke.py            # one card: every phase below
    python chip_smoke.py --cards 4  # four cards: the row-sharded phase only

Phases (one card), each printed on its own line(s) with every error
beside its bound and the matmul precision it ran at:

  device  the card (JAX's platform and device kind, nvidia-smi's name and
          power limit); refuses to run unless JAX's first device is a GPU.
  cli     `pls nir.csv octane.csv 10` (fit, LOO, 600-trial LSO with the
          bit-exact RNG, seed 5489) in-process, at f32 and at f64, against
          the reference's captured output and full-precision fixtures.
  kernel  the fused deflation kernel at 131072×2048 and 131072×10000, f32
          and bf16, against a float64 NumPy truth; its time beside XLA's
          two-pass time; that `pt.fit`'s default path dispatches it.
  fit     BASELINE.json config 4 (100000×5000, M=10, A=20) through
          `pt.fit` against a plain float64 kernel-PLS type 1 computed on
          the host in row blocks; a 50-component ill-conditioned case at
          precision "dd" and "compensated".
  ingest  a 131072×10000 X.npy through stats_from_npy → fit_from_stats
          and cv_kfold_npy (k=10, Wilcoxon selector).
  modules the third-party modules the above loaded beyond numpy, scipy
          and jax: there must be none.

With --cards 4: fit_sharded and fit_rowsharded_shardmap at 1000000×10000
against a float64 kernel-PLS from XᵀX and XᵀY summed in float64 on the
cards, the fused kernel's shard_map path at 800000×10000 against the
same, and train_step against the one-card fit of the same data, on
('rows', 'folds') meshes of (4, 1) and (2, 2).

Any failed check raises, so the script exits non-zero.  The last line of
stdout is {"ok": true, "device": {"platform", "kind", "count"}}.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
GOLDEN = REPO / "tests" / "golden"
SEED = 0


def say(phase: str, msg: str) -> None:
    print(f"[{phase}] {msg}", flush=True)


def check(phase: str, what: str, err: float, bound: float, prec: str) -> None:
    ok = err <= bound
    say(phase, f"{what}: err {err:.3e} <= {bound:.0e} "
        f"(precision {prec}) {'ok' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{phase}: {what}: {err:.3e} > {bound:.0e}")


def rel(a, b) -> float:
    """max |a - b| / max |b| in float64."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


def timed(fn, *args, reps=20):
    import jax

    jax.block_until_ready(fn(*args))
    t0 = time.perf_counter()
    for _ in range(reps):
        out = fn(*args)
    jax.block_until_ready(out)
    return (time.perf_counter() - t0) / reps


# ---------------------------------------------------------------- device


def phase_device():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"chip_smoke: JAX's first device is {dev.platform!r}, not a GPU"
        )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()
    say("device", f"jax: platform={dev.platform} kind={dev.device_kind} "
        f"count={len(jax.devices())}")
    say("device", f"nvidia-smi: {smi}")
    return dev


def foreign_modules(baseline: set[str]) -> list[str]:
    """Top-level third-party packages loaded now that were not loaded by
    numpy, scipy and jax themselves (`baseline`)."""
    allowed = set(sys.stdlib_module_names) | baseline | {
        "numpy", "scipy", "jax", "jaxlib", "pls_tpu", "__main__",
    }
    return sorted({m.split(".")[0] for m in sys.modules} - allowed)


# ------------------------------------------------------------------- cli


def phase_cli():
    import jax

    from pls_tpu import cli

    data = REPO / "pls_tpu" / "data"
    gold_text = (GOLDEN / "nir_cli_stderr.txt").read_text()
    gold = {
        "loo_rmse": np.loadtxt(GOLDEN / "nir_loo_rmse.csv", delimiter=",", ndmin=2),
        "lso_rmse": np.loadtxt(GOLDEN / "nir_lso_rmse.csv", delimiter=",", ndmin=2),
        "ev": np.loadtxt(GOLDEN / "nir_ev.csv", delimiter=",").ravel(),
    }

    def tables(text):
        ev = [float(m.group(1)) for m in re.finditer(
            r"\d+ components explained variance:\s+(\S+)", text)]
        out = {"ev": np.asarray(ev)}
        for method in ("LOO", "LSO"):
            m = re.search(
                rf"{method} Validation:\nRMSE  Matrix \(rows = Y variable; "
                rf"cols = # of components\):\n(.*?)\nOptimal number of "
                rf"components \(by Y variable\):\t(\d+)", text, re.S)
            out[method] = (np.asarray([float(v) for v in m.group(1).split()]),
                           int(m.group(2)))
        return out

    ref_tab = tables(gold_text)
    # f32 first: the f64 run turns on jax_enable_x64 for the process
    # f32 bound: the printed tables carry 6 significant digits; an f32
    # pipeline (z-score, fit, 60 LOO and 600 LSO refits at HIGHEST)
    # agrees with the f64 reference to ~1e-5 relative, so 1e-4 leaves
    # an order of magnitude for summation order on the card.
    for dtype, bound in (("float32", 1e-4), ("float64", 1e-8)):
        with tempfile.TemporaryDirectory() as tmp:
            report_path = os.path.join(tmp, "report.json")
            buf = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stderr(buf):
                rc = cli.main([str(data / "nir.csv"), str(data / "octane.csv"),
                               "10", "--dtype", dtype, "--json", report_path])
            wall = time.perf_counter() - t0
            if rc != 0:
                raise AssertionError(f"cli {dtype}: exit {rc}\n{buf.getvalue()[-2000:]}")
            report = json.loads(Path(report_path).read_text())
        say("cli", f"{dtype}: pls nir.csv octane.csv 10 in {wall:.2f} s "
            "(compile included)")
        tab = tables(buf.getvalue())
        prec = "highest (library default)"
        # printed tables vs the reference's printed tables: 6 digits
        check("cli", f"{dtype} printed EV vs golden text",
              rel(tab["ev"], ref_tab["ev"]), max(bound, 1e-5), prec)
        for method in ("LOO", "LSO"):
            check("cli", f"{dtype} printed {method} RMSE vs golden text",
                  rel(tab[method][0], ref_tab[method][0]), max(bound, 1e-5), prec)
        # full-precision report vs the reference's full-precision fixtures
        ev = np.asarray([report["explained_variance"][str(c)][0]
                         for c in range(1, 11)])
        check("cli", f"{dtype} EV vs golden fixture", rel(ev, gold["ev"]),
              bound, prec)
        for cv in ("loo", "lso"):
            check("cli", f"{dtype} {cv.upper()} RMSE vs golden fixture",
                  rel(report[f"{cv}_rmse"], gold[f"{cv}_rmse"]), bound, prec)
        opt = (report["loo_optimal_components"][0],
               report["lso_optimal_components"][0])
        say("cli", f"{dtype} selected components LOO={opt[0]} LSO={opt[1]} "
            "(reference: 3, 5)")
        if opt != (3, 5) or (tab["LOO"][1], tab["LSO"][1]) != (3, 5):
            raise AssertionError(f"cli {dtype}: selected {opt}, want (3, 5)")
    jax.config.update("jax_enable_x64", False)


# ---------------------------------------------------------------- kernel


def blockwise_truth(X, r, block=16384):
    """float64 t, tt, p of X (on device) and r, in row blocks on the host."""
    rd = np.asarray(r, np.float64)
    ts, p = [], np.zeros(X.shape[1])
    for s in range(0, X.shape[0], block):
        Xd = np.asarray(X[s:s + block], np.float64)
        t = Xd @ rd
        ts.append(t)
        p += Xd.T @ t
    t = np.concatenate(ts)
    return t, float(t @ t), p


def phase_kernel(shapes=((131072, 2048), (131072, 10000))):
    import jax
    import jax.numpy as jnp

    from pls_tpu.ops.deflate import (
        _deflate_pass_pallas,
        deflate_pass_xla,
        pallas_supported,
    )

    def xla_highest(X, r):
        with jax.default_matmul_precision("highest"):
            return xla(X, r)

    xla = jax.jit(deflate_pass_xla)
    for N, K in shapes:
        kx, kr = jax.random.split(jax.random.key(SEED))
        X32 = jax.random.normal(kx, (N, K), jnp.float32)
        r = jax.random.normal(kr, (K,), jnp.float32)
        for name, dtype, bound in (("f32", jnp.float32, 1e-5),
                                   ("bf16", jnp.bfloat16, 2e-3)):
            X = X32.astype(dtype)
            if not pallas_supported(N, K, X.dtype.itemsize):
                raise AssertionError(f"kernel not supported at {N}x{K} {name}")
            t, tt, p = _deflate_pass_pallas(X, r)
            # bf16: the truth is the f64 contraction of the ROUNDED X
            td, ttd, pd = blockwise_truth(X, r)
            prec = "exact f32 FMA in the kernel; tt at HIGHEST"
            check("kernel", f"{N}x{K} {name} t", rel(t, td), bound, prec)
            check("kernel", f"{N}x{K} {name} tt", rel(tt, ttd), bound, prec)
            check("kernel", f"{N}x{K} {name} p", rel(p, pd), bound, prec)
            tk = timed(_deflate_pass_pallas, X, r)
            tx = timed(xla_highest, X, r)
            gb = N * K * X.dtype.itemsize / 1e9
            say("kernel", f"{N}x{K} {name}: kernel {tk*1e3:.4f} ms "
                f"({gb/tk:.1f} GB/s of X), XLA two-pass at HIGHEST "
                f"{tx*1e3:.4f} ms ({2*gb/tx:.1f} GB/s read), "
                f"kernel/XLA time {tk/tx:.3f}")
            del X, t, p
        del X32


def fit_dispatches_kernel(X, Y, A) -> bool:
    """Lower pt.fit's default path and look in the StableHLO JAX emits
    for the kernel: the pallas_call's name and a Triton custom call."""
    import jax

    import pls_tpu as pt

    with tempfile.TemporaryDirectory() as tmp:
        jax.config.update("jax_dump_ir_to", tmp)
        try:
            jax.block_until_ready(pt.fit(X, Y, A).W)
        finally:
            jax.config.update("jax_dump_ir_to", "")
        texts = [p.read_text(errors="replace") for p in Path(tmp).rglob("*")
                 if p.is_file() and "fit_kernel" in p.name]
    if not texts:
        raise AssertionError("no lowered _fit_kernel module was dumped")
    targets = sorted({m for t in texts
                      for m in re.findall(r"custom_call @([\w$.]+)", t)})
    say("fit", f"custom calls in the lowered default fit: {targets}")
    return any("pls_deflate" in t for t in texts) and any(
        "triton" in m for m in targets)


# ------------------------------------------------------------------- fit


def plain_kpls1(XY, A, xtx):
    """Plain float64 kernel-PLS type 1 (Dayal–MacGregor) from XᵀY (K, M)
    and `xtx`, a function r ↦ XᵀX r in float64.  Returns B (K, M)."""
    XY = np.array(XY, np.float64)
    K, M = XY.shape
    R = np.zeros((K, A))
    P = np.zeros((K, A))
    Q = np.zeros((M, A))
    for a in range(A):
        if M == 1:
            w = XY[:, 0].copy()
        else:
            vals, vecs = np.linalg.eigh(XY.T @ XY)
            w = XY @ vecs[:, -1]
        w /= np.linalg.norm(w)
        r = w - R[:, :a] @ (P[:, :a].T @ w)
        p = xtx(r)
        tt = r @ p  # = tᵀt with t = X r
        p /= tt
        q = XY.T @ r / tt
        XY -= tt * np.outer(p, q)
        R[:, a], P[:, a], Q[:, a] = r, p, q
    return R @ Q.T


def plain_kpls1_rows(X, Y, A, block=8192):
    """plain_kpls1 on host arrays, every X contraction in row blocks."""
    X = np.asarray(X, np.float64)
    Y = np.asarray(Y, np.float64)
    blocks = [(s, min(s + block, X.shape[0])) for s in range(0, X.shape[0], block)]

    def xtx(r):
        return sum(X[s:e].T @ (X[s:e] @ r) for s, e in blocks)

    return plain_kpls1(sum(X[s:e].T @ Y[s:e] for s, e in blocks), A, xtx)


def phase_fit(N=100000, K=5000, M=10, A=20):
    import jax
    import jax.numpy as jnp

    import pls_tpu as pt
    from pls_tpu.models.kernel_pls import auto_pallas

    kx, kb, ke = jax.random.split(jax.random.key(SEED + 1), 3)
    X = jax.random.normal(kx, (N, K), jnp.float32)
    Btrue = jax.random.normal(kb, (K, M), jnp.float32) / K**0.5
    with jax.default_matmul_precision("highest"):
        Y = X @ Btrue + 0.1 * jax.random.normal(ke, (N, M), jnp.float32)
    jax.block_until_ready(Y)
    say("fit", f"X {N}x{K} f32 ({N*K*4/1e9:.1f} GB), M={M}, A={A}, seed {SEED + 1}")
    t0 = time.perf_counter()
    B64 = plain_kpls1_rows(np.asarray(X), np.asarray(Y), A)
    say("fit", f"float64 host reference in {time.perf_counter()-t0:.1f} s")
    rows = 4096
    Xh = np.asarray(X[:rows], np.float64)
    Yh64 = Xh @ B64

    kernel_on = auto_pallas(N, K, 4)
    say("fit", f"default dispatch selects the kernel: {kernel_on}")
    if kernel_on:
        if not fit_dispatches_kernel(X, Y, A):
            raise AssertionError("pt.fit's default program has no pls_deflate")
        say("fit", "lowered default pt.fit program contains pls_deflate: ok")

    cases = (
        ("default", {}, 1e-4, 1e-3),
        ("use_pallas=False", {"use_pallas": False}, 1e-4, 1e-3),
        ("x_storage=bf16", {"x_storage": "bf16"}, 2e-2, 5e-2),
    )
    for label, kw, pbound, bbound in cases:
        t0 = time.perf_counter()
        f = pt.fit(X, Y, A, **kw)  # precision="highest" is the default
        jax.block_until_ready(f.W)
        say("fit", f"{label}: first call {time.perf_counter()-t0:.2f} s "
            "(compile included, or a cache hit)")
        ts = []
        for _ in range(5):
            t0 = time.perf_counter()
            f = pt.fit(X, Y, A, **kw)
            jax.block_until_ready(f.W)
            ts.append(time.perf_counter() - t0)
        B = np.asarray(pt.coefficients(f), np.float64)
        prec = "highest" + (", X in bf16" if "x_storage" in kw else "")
        check("fit", f"{label} predictions (first {rows} rows)",
              rel(Xh @ B, Yh64), pbound, prec)
        check("fit", f"{label} coefficients B", rel(B, B64), bbound, prec)
        # the library's own prediction path, on the card
        check("fit", f"{label} pt.fitted_values on the card",
              rel(pt.fitted_values(f, X[:rows]), Yh64), pbound, prec)
        if not kw:
            model = pt.PLSModel(X, Y, pt.KERNEL_TYPE1, A)
            check("fit", "PLSModel(X, Y).fitted_values on the card",
                  rel(model.fitted_values(X[:rows]), Yh64), pbound, prec)
            del model
        say("fit", f"{label}: median {np.median(ts)*1e3:.3f} ms "
            f"(runs {', '.join(f'{x*1e3:.3f}' for x in ts)} ms)")
    del X, Y

    # 50 components on an ill-conditioned spectrum: the error-free
    # transforms of precision="dd" must survive XLA's GPU code generation
    rng = np.random.default_rng(0)
    n, k, m, a = 256, 128, 3, 50
    L = rng.normal(size=(n, 60)) * (1.5 ** -np.arange(60))
    Xd = L @ rng.normal(size=(60, k)) + 0.01 * rng.normal(size=(n, k))
    Yd = L @ rng.normal(size=(60, m)) + 0.01 * rng.normal(size=(n, m))
    Bref = plain_kpls1_rows(Xd, Yd, a)
    X32 = jnp.asarray(Xd, jnp.float32)
    Y32 = jnp.asarray(Yd, jnp.float32)
    errs = {}
    for precision in ("dd", "compensated", "highest"):
        B = pt.coefficients(pt.fit(X32, Y32, a, precision=precision))
        errs[precision] = rel(B, Bref)
    # dd: the CPU suite pins 1e-4 at this case (tests/test_fit_parity.py)
    check("fit", f"A={a} ill-conditioned dd coefficients", errs["dd"], 1e-4, "dd")
    say("fit", f"A={a} compensated coefficients err {errs['compensated']:.3e}, "
        f"highest {errs['highest']:.3e} (no bound: f32 is not meant to hold here)")
    if not errs["dd"] * 10 < errs["highest"]:
        raise AssertionError(f"dd is no better than plain f32: {errs}")


# ---------------------------------------------------------------- ingest


def phase_ingest(N=131072, K=10000, M=10, A=20, k=10):
    import jax
    import jax.numpy as jnp

    import pls_tpu as pt
    from pls_tpu.models.kernel_pls import fit_from_stats
    from pls_tpu.utils.binio import cv_kfold_npy, stats_from_npy

    rng = np.random.default_rng(SEED + 2)
    Btrue = (rng.standard_normal((K, M)) / K**0.5).astype(np.float32)
    with tempfile.TemporaryDirectory() as tmp:
        xp, yp = os.path.join(tmp, "X.npy"), os.path.join(tmp, "Y.npy")
        Xm = np.lib.format.open_memmap(xp, "w+", np.float32, (N, K))
        Ym = np.lib.format.open_memmap(yp, "w+", np.float32, (N, M))
        t0 = time.perf_counter()
        for s in range(0, N, 16384):
            blk = rng.standard_normal((min(16384, N - s), K), np.float32)
            Xm[s:s + len(blk)] = blk
            Ym[s:s + len(blk)] = blk @ Btrue + 0.1 * rng.standard_normal(
                (len(blk), M), np.float32)
        Xm.flush()
        Ym.flush()
        say("ingest", f"wrote X.npy {N}x{K} f32 ({N*K*4/1e9:.2f} GB) and Y.npy "
            f"M={M} in {time.perf_counter()-t0:.1f} s")

        t0 = time.perf_counter()
        acc = stats_from_npy(xp, yp, stats_precision="highest")
        jax.block_until_ready(acc.XX)
        say("ingest", f"stats_from_npy: {time.perf_counter()-t0:.2f} s")
        XY64 = np.zeros((K, M))
        for s in range(0, N, 16384):
            XY64 += np.asarray(Xm[s:s + 16384], np.float64).T @ Ym[s:s + 16384]
        check("ingest", "XᵀY vs float64 host blocks", rel(acc.XY, XY64),
              1e-5, "highest")
        f_stats = fit_from_stats(acc.XX, acc.XY, A, precision="highest")

        X = jnp.asarray(Xm)
        Y = jnp.asarray(Ym)
        f_mem = pt.fit(X, Y, A, precision="highest")
        Xh = np.asarray(Xm[:4096], np.float64)
        yh_mem = Xh @ np.asarray(pt.coefficients(f_mem), np.float64)
        yh_stats = Xh @ np.asarray(pt.coefficients(f_stats), np.float64)
        check("ingest", "fit_from_stats vs in-memory pt.fit predictions",
              rel(yh_stats, yh_mem), 1e-4, "highest")
        del X, Y

        t0 = time.perf_counter()
        summary, res = cv_kfold_npy(
            xp, yp, A, k=k, key=SEED, precision="highest",
            stats_precision="highest",
        )
        t_cv = time.perf_counter() - t0
        errs = np.asarray(res.errors, np.float64)  # (M, N, A)
        press_sweep = np.einsum("mna,mna->ma", errs, errs)
        check("ingest", "closed-form PRESS vs residual sweep",
              rel(press_sweep, np.asarray(summary.press)), 1e-4, "highest")
        t0 = time.perf_counter()
        opt = np.asarray(pt.optimal_num_components(res))
        say("ingest", f"cv_kfold_npy k={k}: {t_cv:.2f} s; Wilcoxon selector "
            f"{time.perf_counter()-t0:.2f} s -> components {opt.tolist()}")
        if not (np.all(opt >= 1) and np.all(opt <= A)):
            raise AssertionError(f"selected components out of range: {opt}")
        del Xm, Ym


# ---------------------------------------------------------------- 4 cards


def phase_cards(n_cards: int, N=1_000_000, K=10000, M=10, A=20,
                n_kernel=800_000, n_train=131072, block=5000):
    """Row-sharded fits on `n_cards` cards.  At BASELINE.json config 5's
    N rows, fit_sharded and fit_rowsharded_shardmap are checked against a
    plain float64 kernel-PLS built from XᵀX and XᵀY, which are summed in
    float64 block by block on the cards.  The fused kernel's shard_map
    path runs at `n_kernel` rows, the most whose row shards stay under
    the kernel's 2³¹-element bound.  train_step vmaps masked refits (a
    masked copy of the shard per trial), so it runs at `n_train` rows,
    against the one-card fit of the same data."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    import pls_tpu as pt
    from pls_tpu.ops.deflate import pallas_supported
    from pls_tpu.parallel.mesh import make_pls_mesh
    from pls_tpu.parallel.sharded import (
        fit_rowsharded_shardmap,
        fit_sharded,
        train_step,
    )

    devs = jax.devices()[:n_cards]
    if len(devs) < n_cards:
        raise SystemExit(f"--cards {n_cards}: found {len(devs)} device(s)")
    kx, kb, ke = jax.random.split(jax.random.key(SEED + 3), 3)
    Btrue = jax.random.normal(kb, (K, M), jnp.float32) / K**0.5
    rows_spec = P("rows", None)

    def data(n, mesh):
        """X, Y generated where the mesh's row shards live."""
        rows = NamedSharding(mesh, rows_spec)

        @jax.jit
        def gen():
            X = jax.random.normal(kx, (n, K), jnp.float32)
            noise = jax.random.normal(ke, (n, M), jnp.float32)
            Y = jnp.dot(X, Btrue, precision="highest") + 0.1 * noise
            return jax.lax.with_sharding_constraint(X, rows), \
                jax.lax.with_sharding_constraint(Y, rows)

        return gen()

    def float64_reference(X, Y, mesh):
        """Predictions on 4096 rows and B of a plain float64 kernel-PLS
        whose XᵀX and XᵀY each card sums in float64, `block` rows at a
        time, over its own shard."""
        jax.config.update("jax_enable_x64", True)
        try:
            @jax.jit
            @jax.shard_map(mesh=mesh, in_specs=(rows_spec, rows_spec),
                           out_specs=(P(), P()))
            def cross(x, y):
                def body(acc, xy):
                    xb, yb = (v.astype(jnp.float64) for v in xy)
                    return (acc[0] + xb.T @ xb, acc[1] + xb.T @ yb), None

                zero = jax.lax.pcast((jnp.zeros((K, K), jnp.float64),
                                      jnp.zeros((K, M), jnp.float64)),
                                     ("rows",), to="varying")
                (xx, xy), _ = jax.lax.scan(
                    body, zero,
                    (x.reshape(-1, block, K), y.reshape(-1, block, M)))
                return jax.lax.psum(xx, "rows"), jax.lax.psum(xy, "rows")

            if (X.shape[0] // mesh.shape["rows"]) % block:
                raise ValueError(f"row shards of {X.shape[0]} rows are not "
                                 f"a multiple of {block}")
            t0 = time.perf_counter()
            XX, XY = (np.asarray(v) for v in cross(X, Y))
        finally:
            jax.config.update("jax_enable_x64", False)
        B64 = plain_kpls1(XY, A, lambda r: XX @ r)
        say("cards", f"float64 reference for {X.shape[0]} rows in "
            f"{time.perf_counter()-t0:.1f} s")
        Xh = np.asarray(X[:4096], np.float64)
        return Xh, Xh @ B64, B64

    def one_card_reference(X, Y):
        """The one-card fit of the same data: predictions on 4096 rows."""
        X1 = jax.device_put(X, devs[0])
        Y1 = jax.device_put(Y, devs[0])
        f1 = pt.fit(X1, Y1, A, precision="highest")
        Xh = np.asarray(X1[:4096], np.float64)
        B1 = np.asarray(pt.coefficients(f1), np.float64)
        del X1, Y1
        return Xh, Xh @ B1, B1

    def compare(label, f, ref, against):
        Xh, yh, Bref = ref
        B = np.asarray(pt.coefficients(f), np.float64)
        check("cards", f"{label} predictions vs {against}",
              rel(Xh @ B, yh), 1e-4, "highest")
        check("cards", f"{label} coefficients B vs {against}",
              rel(B, Bref), 1e-3, "highest")

    def sharded(X, mesh, rows):
        """X on `mesh`, after checking each card holds its row shard."""
        n = X.shape[0]
        Xs = jax.device_put(X, NamedSharding(mesh, rows_spec))
        shards = Xs.addressable_shards
        say("cards", f"mesh {tuple(mesh.shape.values())}: X shards on devices "
            f"{sorted(sh.device.id for sh in shards)}, rows per shard "
            f"{sorted({sh.data.shape[0] for sh in shards})}")
        if ({sh.device for sh in shards} != set(devs)
                or {sh.data.shape[0] for sh in shards} != {n // rows}):
            raise AssertionError("X is not split over the cards as the mesh says")
        for d in devs:
            stats = d.memory_stats()  # None on the CPU backend
            used = stats["bytes_in_use"] if stats else None
            say("cards", f"device {d.id}: {used} bytes in use")
            if stats and used < n // rows * K * 4:
                raise AssertionError(f"card {d.id} holds {used} B, less than its shard")
        return Xs

    def timed_fit(label, fn, *args, **kw):
        t0 = time.perf_counter()
        f = fn(*args, **kw)
        jax.block_until_ready(f.W)
        say("cards", f"{label}: {time.perf_counter()-t0:.2f} s (compile included)")
        return f

    mesh41 = make_pls_mesh(rows=n_cards, folds=1, devices=devs)
    mesh22 = make_pls_mesh(rows=n_cards // 2, folds=2, devices=devs)
    X, Y = data(N, mesh41)
    say("cards", f"X {N}x{K} f32 ({N*K*4/1e9:.0f} GB), M={M}, A={A} on "
        f"{n_cards}x {devs[0].device_kind}")
    ref = float64_reference(X, Y, mesh41)
    X = sharded(X, mesh41, n_cards)
    f = timed_fit(f"({n_cards},1) fit_sharded", fit_sharded, X, Y, A,
                  mesh=mesh41, precision="highest")
    compare(f"({n_cards},1) fit_sharded", f, ref, "float64")
    with jax.default_matmul_precision("highest"):
        f = timed_fit(f"({n_cards},1) fit_rowsharded_shardmap",
                      fit_rowsharded_shardmap, X, Y, A, mesh=mesh41)
    compare(f"({n_cards},1) fit_rowsharded_shardmap", f, ref, "float64")
    X22 = sharded(X, mesh22, n_cards // 2)
    del X
    f = timed_fit(f"({n_cards // 2},2) fit_sharded", fit_sharded, X22, Y, A,
                  mesh=mesh22, precision="highest")
    compare(f"({n_cards // 2},2) fit_sharded", f, ref, "float64")
    del X22, Y

    # the fused kernel, per shard inside shard_map
    if not pallas_supported(n_kernel // n_cards, K, 4, backend="gpu"):
        raise AssertionError(f"{n_kernel // n_cards}x{K} shards exceed the kernel")
    X, Y = data(n_kernel, mesh41)
    ref = float64_reference(X, Y, mesh41)
    X = sharded(X, mesh41, n_cards)
    with jax.default_matmul_precision("highest"):
        f = timed_fit(f"({n_cards},1) fit_rowsharded_shardmap use_pallas=True "
                      f"at {n_kernel} rows", fit_rowsharded_shardmap, X, Y, A,
                      mesh=mesh41, use_pallas=True)
    compare(f"({n_cards},1) fit_rowsharded_shardmap use_pallas=True", f, ref,
            "float64")
    del X, Y

    trials = 4
    X, Y = data(n_train, mesh41)
    parts = jnp.stack([jax.random.permutation(jax.random.key(i), n_train)
                       for i in range(trials)]).astype(jnp.int32)
    ref = one_card_reference(X, Y)
    for rows, folds in ((n_cards, 1), (n_cards // 2, 2)):
        mesh = make_pls_mesh(rows=rows, folds=folds, devices=devs)
        f, press = train_step(X, Y, A, parts, (3 * n_train) // 4, mesh=mesh,
                              precision="highest")
        jax.block_until_ready(press)
        if not bool(jnp.all(jnp.isfinite(press))):
            raise AssertionError("train_step PRESS is not finite")
        compare(f"({rows},{folds}) train_step N={n_train}", f, ref,
                "one-card fit")


# ------------------------------------------------------------------ main


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4),
                    help="4: run only the row-sharded phase on four cards")
    args = ap.parse_args()

    import jax

    dev = phase_device()
    # numpy, scipy and jax (with the Pallas modules the kernel uses) may
    # load what they need; what pls_tpu and the main path add beyond that
    # must be nothing
    import jax.experimental.pallas.triton  # noqa: F401
    import scipy  # noqa: F401

    baseline = {m.split(".")[0] for m in sys.modules}
    say("device", "third-party modules loaded by numpy, scipy and jax: "
        f"{sorted(baseline - set(sys.stdlib_module_names) - {'__main__'})}")
    import pls_tpu  # noqa: F401

    from pls_tpu.utils.cache import enable_compilation_cache

    say("device", f"compile cache: {enable_compilation_cache()}")
    if args.cards == 4:
        phase_cards(4)
    else:
        for phase in (phase_cli, phase_kernel, phase_fit, phase_ingest):
            t0 = time.perf_counter()
            phase()
            say(phase.__name__[6:], f"done in {time.perf_counter()-t0:.1f} s")
    extra = foreign_modules(baseline)
    say("modules", f"loaded beyond numpy, scipy and jax: {extra}")
    if extra:
        raise AssertionError(f"unexpected third-party modules: {extra}")
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(jax.devices()),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
