"""Sharded PLS execution: row-sharded fits and fold-sharded CV.

Two complementary formulations (both validated against the single-device
fit in tests/test_distributed.py on an 8-virtual-device CPU mesh):

1. `fit_sharded` — GSPMD: the plain functional fit (models/kernel_pls.py)
   jitted with X/Y carrying NamedSharding(P('rows', None)) and replicated
   outputs.  XLA's SPMD partitioner turns every over-rows contraction
   (XᵀY, XᵀX, Xᵀt, tᵀt) into partial-per-shard + all-reduce (NCCL over NVLink on a GPU host).
   This is the idiomatic production path: zero manual collectives.

2. `fit_rowsharded_shardmap` — explicit shard_map + psum, mirroring the
   communication schedule in SURVEY.md §2 ("comm point" at XY = XᵀY,
   pls.cpp:396, and the per-component reductions of §3.2).  Useful for
   auditing exactly which collectives run, and as the template for the
   Pallas-fused variant.

`cv_lso_sharded` shards the replicate axis over the 'folds' mesh axis:
replicates never communicate, so scaling is embarrassing; X/Y are
replicated (appropriate when X fits per-device; for huge X use
fit_sharded per fold over 'rows' instead).

`train_step` composes both axes — the "full training step" of this
framework: a row-sharded fit plus a fold-sharded CV batch in one jitted
program (exercised by __graft_entry__.dryrun_multichip).
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from pls_tpu.models.kernel_pls import fit
from pls_tpu.models.predict import residuals_all_components
from pls_tpu.ops.eigen import dominant_eigenvector
from pls_tpu.types import METHOD, PLSFit, Residual


def fit_sharded(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    mesh: Mesh,
    precision: str | None = "highest",
    power_iters: int | None = None,
    x_storage: str | None = None,
) -> PLSFit:
    """Row-sharded fit via GSPMD; outputs fully replicated.

    x_storage="bf16" applies the narrow-X/f32-accumulation policy
    (models/kernel_pls.fit) per shard — each device streams its local
    rows in bf16; the psum'd partials and all model state stay f32."""
    row_sh = NamedSharding(mesh, P("rows", None))
    rep = NamedSharding(mesh, P())
    Xs = jax.device_put(jnp.asarray(X), row_sh)
    Ys = jax.device_put(jnp.asarray(Y), row_sh)

    @partial(jax.jit, out_shardings=rep)
    def _fit(Xs, Ys):
        f = fit(Xs, Ys, A, method, precision=precision,
                power_iters=power_iters, x_storage=x_storage)
        # T is row-aligned; drop it from the replicated outputs for type1 to
        # avoid an all-gather of an N-sized matrix (recompute as X·R if needed)
        return PLSFit(W=f.W, P=f.P, Q=f.Q, R=f.R,
                      T=jnp.zeros((0, A), f.W.dtype), method=f.method)

    return _fit(Xs, Ys)


def fit_colsharded(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    mesh: Mesh,
    axis: str = "rows",
    precision: str | None = "highest",
    power_iters: int | None = None,
    x_storage: str | None = None,
) -> PLSFit:
    """COLUMN-sharded fit via GSPMD — the huge-K scaling axis (north star:
    K = 10k+ spectral channels / SNP panels).

    X is sharded over its predictor axis `P(None, axis)` (reusing the
    mesh's `axis` dimension — pass the 'rows' axis of make_pls_mesh or a
    dedicated K axis).  GSPMD keeps every K-sized object (XY, w, r, p,
    the (A, K) Gram–Schmidt buffers) sharded over the same axis: the
    per-component matvec t = X r contracts over K (one all-reduce of the
    N-vector t per component), while p = Xᵀt, the Gram–Schmidt
    corrections, and the XY deflation stay fully local per shard.  The
    communication dual of the row-sharded form: all-reduce size N instead
    of K.  Outputs are gathered to replicated (K, A) matrices.
    """
    col_sh = NamedSharding(mesh, P(None, axis))
    rep = NamedSharding(mesh, P())
    Xs = jax.device_put(jnp.asarray(X), col_sh)
    Ys = jax.device_put(jnp.asarray(Y), NamedSharding(mesh, P()))

    @partial(jax.jit, out_shardings=rep)
    def _fit(Xs, Ys):
        return fit(Xs, Ys, A, method, precision=precision,
                   power_iters=power_iters, x_storage=x_storage)

    return _fit(Xs, Ys)


def fit_rowsharded_shardmap(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    type1: bool = True,
    *,
    mesh: Mesh,
    axis: str = "rows",
    power_iters: int | None = None,
    use_pallas: bool = False,
    pallas_interpret: bool = False,
) -> PLSFit:
    """Explicit shard_map/psum formulation of the kernel algorithms.

    Collectives used (all over `axis`):
      - one all-reduce for XY = XᵀY (and XX = XᵀX for type 2)
      - type 1 only: per-component all-reduce of [Xᵀt ; tᵀt] (fused into a
        single psum of a (K+1)-vector to halve latency cost)
    Type 2's component loop is communication-free — the preferred shape
    for high-latency (DCN) meshes.

    use_pallas=True (type 1): each device streams its LOCAL row shard
    through the fused deflation kernel (ops/deflate.py — one pass over
    X per component instead of two) and contributes its partial [p ; tt]
    to the same single psum: the multi-chip composition of the
    single-chip kernel.  `pallas_interpret` runs the kernel in interpret
    mode (CPU-mesh testing).
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    N, K = X.shape
    M = Y.shape[1]
    dtype = X.dtype

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(axis, None), P(axis, None)),
        out_specs=(P(), P(), P(), P(), P(axis, None)),
        # pallas_call's output ShapeDtypeStructs carry no varying-mesh-axes
        # annotation, which the vma checker rejects inside shard_map; the
        # psum immediately after the kernel makes the sharding explicit
        # anyway, so relax the check on the fused path only
        check_vma=not use_pallas,
    )
    def _fit(Xl, Yl):
        XY0 = jax.lax.psum(Xl.T @ Yl, axis)
        XX = None if type1 else jax.lax.psum(Xl.T @ Xl, axis)

        def step(carry, a):
            XY, Pb, Rb = carry
            if M == 1:
                w = XY[:, 0]
            else:
                q0 = dominant_eigenvector(XY.T @ XY, power_iters)
                w = XY @ q0
            w = w / jnp.sqrt(w @ w)
            r = w - Rb.T @ (Pb @ w)
            if type1:
                if use_pallas:
                    from pls_tpu.ops.deflate import _deflate_pass_pallas

                    t, tt_l, p_l = _deflate_pass_pallas(
                        Xl, r, interpret=pallas_interpret
                    )
                    stats = jnp.concatenate([p_l, tt_l[None]])
                else:
                    t = Xl @ r  # local rows
                    # fuse p (=Xᵀt) and tt (=tᵀt) into one all-reduce
                    stats = jnp.concatenate([Xl.T @ t, (t @ t)[None]])
                stats = jax.lax.psum(stats, axis)
                p, tt = stats[:K], stats[K]
            else:
                v = XX @ r
                tt = r @ v
                p = v
                t = jnp.zeros((Xl.shape[0],), dtype)
            p = p / tt
            q = (XY.T @ r) / tt
            XY = XY - jnp.outer(p, q) * tt
            Pb = Pb.at[a].set(p)
            Rb = Rb.at[a].set(r)
            return (XY, Pb, Rb), (w, q, t)

        zbuf = jnp.zeros((A, K), dtype)
        (_, Pb, Rb), (Ws, Qs, Ts) = jax.lax.scan(step, (XY0, zbuf, zbuf), jnp.arange(A))
        return Ws.T, Pb.T, Qs.T, Rb.T, Ts.T

    W, Pm, Q, R, T = jax.jit(_fit)(X, Y)
    return PLSFit(
        W=W, P=Pm, Q=Q, R=R,
        T=T if type1 else jnp.zeros((0, A), dtype),
        method=METHOD.KERNEL_TYPE1 if type1 else METHOD.KERNEL_TYPE2,
    )


def cv_lso_sharded(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    partitions: jnp.ndarray,
    train_size: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    mesh: Mesh,
    precision: str | None = "highest",
) -> Residual:
    """Monte-Carlo CV with the replicate axis sharded over mesh axis 'folds'.

    `partitions` is (num_trials, N); num_trials must divide evenly over the
    'folds' axis size.  X/Y are replicated per device.
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    N = X.shape[0]
    num_trials = partitions.shape[0]
    test_size = N - train_size
    n_folds_axis = mesh.shape["folds"]
    if num_trials % n_folds_axis:
        raise ValueError(
            f"cv_lso_sharded: num_trials={num_trials} must divide evenly "
            f"over the 'folds' mesh axis (size {n_folds_axis})"
        )

    parts_sh = NamedSharding(mesh, P("folds", None))
    rep = NamedSharding(mesh, P())
    parts = jax.device_put(jnp.asarray(partitions), parts_sh)
    Xr = jax.device_put(X, rep)
    Yr = jax.device_put(Y, rep)

    @partial(jax.jit, out_shardings=NamedSharding(mesh, P(None, "folds")))
    def _cv(Xr, Yr, parts):
        def rep_fn(perm):
            mask = jnp.zeros((N,), Xr.dtype).at[perm[:train_size]].set(1)
            f = fit(Xr, Yr, A, method, row_mask=mask, precision=precision)
            return residuals_all_components(
                f, Xr[perm[train_size:]], Yr[perm[train_size:]]
            )  # (test, A, M)

        errs = jax.vmap(rep_fn)(parts)  # (trials, test, A, M)
        return jnp.transpose(errs, (3, 0, 1, 2))  # (M, trials, test, A)

    errors = _cv(Xr, Yr, parts)
    M = Y.shape[1]
    return Residual(
        errors=errors.reshape(M, num_trials * test_size, A), method="LSO"
    )


def cv_lso_rowsharded(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    partitions: jnp.ndarray,
    train_size: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    mesh: Mesh,
    axis: str = "rows",
    trial_batch: int = 1,
    precision: str | None = "highest",
    x_storage: str | None = None,
) -> Residual:
    """Monte-Carlo CV with X ROW-SHARDED over the mesh — the huge-X
    LSO path (closes the r03 gap: cv_lso_sharded replicates X per
    device, impossible at the 40 GB north-star design).

    X/Y carry NamedSharding(P(axis, None)) and never exist replicated;
    trials run sequentially (in `trial_batch`-sized groups via lax.map)
    inside ONE jitted GSPMD program: each trial applies its {0,1} train
    mask to the sharded rows, refits (psums inserted by the SPMD
    partitioner exactly as in fit_sharded), and gathers only the
    (test_size, K) held-out block for residuals — the only cross-shard
    X movement.  Memory per device: the X shard plus `trial_batch`
    masked shard copies in flight.

    For KERNEL_TYPE2 workloads, the block-downdate formulation is
    cheaper still: build XX/XY once with fit_sharded's statistics pass
    and run cv/lso.cv_lso_downdate on them — per trial O(K²·A)
    replicated compute, no per-trial pass over X at all.

    Same partition layout and error tensor ((M, trials·test, A),
    replicate-major) as cv_lso; exact agreement with the local cv_lso is
    pinned by tests/test_distributed.py.
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    num_trials = partitions.shape[0]
    test_size = N - train_size

    row_sh = NamedSharding(mesh, P(axis, None))
    rep = NamedSharding(mesh, P())
    Xs = jax.device_put(X, row_sh)
    Ys = jax.device_put(Y, row_sh)
    parts = jax.device_put(jnp.asarray(partitions), rep)

    from pls_tpu.utils.batching import padded_map

    @partial(jax.jit, out_shardings=rep)
    def _cv(Xs, Ys, parts):
        def trial(perm):
            mask = jnp.zeros((N,), jnp.float32).at[perm[:train_size]].set(1)
            f = fit(
                Xs, Ys, A, method, row_mask=mask,
                precision=precision, x_storage=x_storage,
            )
            return residuals_all_components(
                f, Xs[perm[train_size:]], Ys[perm[train_size:]]
            )  # (test, A, M)

        return padded_map(trial, parts, trial_batch)

    errs = _cv(Xs, Ys, parts)  # (trials, test, A, M)
    M = Y.shape[1]
    return Residual(
        errors=jnp.transpose(errs, (3, 0, 1, 2)).reshape(
            M, num_trials * test_size, A
        ),
        method="LSO",
    )


def cv_loo_sharded(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    mesh: Mesh,
    batch_size: int | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> Residual:
    """LOO CV with the fold axis sharded over mesh axis 'folds'.

    X/Y replicated per device; each device runs its N/devices folds in
    `batch_size` chunks (same memory bound as the local cv_loo — a masked
    X copy exists per *in-flight* fold, not per fold).  Appropriate when X
    fits per-device; for huge designs use cv_loo_from_stats on psum'd
    statistics instead.  N must divide evenly over the 'folds' axis size.
    """
    from pls_tpu.cv.loo import make_loo_fold_fn
    from pls_tpu.utils.batching import padded_map

    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N = X.shape[0]
    n_folds_axis = mesh.shape["folds"]
    if N % n_folds_axis:
        raise ValueError(
            f"cv_loo_sharded: N={N} must divide evenly over the 'folds' "
            f"mesh axis (size {n_folds_axis}); pad the data or use cv_loo"
        )
    if batch_size is None:
        batch_size = min(N // n_folds_axis, 64)

    @partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=(P(), P(), P("folds")),
        out_specs=P(None, "folds", None),
    )
    def _cv(Xr, Yr, idx_local):
        fold = make_loo_fold_fn(
            Xr, Yr, A, method, power_iters=power_iters, precision=precision
        )
        errs = padded_map(fold, idx_local, batch_size)  # (N/D, A, M)
        return jnp.transpose(errs, (2, 0, 1))  # (M, N/D, A)

    errors = jax.jit(_cv)(X, Y, jnp.arange(N))
    return Residual(errors=errors, method="LOO")


def train_step(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    partitions: jnp.ndarray,
    train_size: int,
    *,
    mesh: Mesh,
    method: METHOD = METHOD.KERNEL_TYPE1,
    precision: str | None = "highest",
):
    """The framework's full multi-chip "training step", as one jitted
    program over both mesh axes:

      1. row-sharded global fit (data parallel over 'rows'; psums for the
         cross-products) →
      2. fold-sharded Monte-Carlo CV replicates (scenario parallel over
         'folds') →
      3. replicated PRESS summary per component.

    Returns (PLSFit with replicated W/P/Q/R, press (M, A)).
    Used by __graft_entry__.dryrun_multichip for the multi-chip compile
    validation.
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    N = X.shape[0]

    row_sh = NamedSharding(mesh, P("rows", None))
    folds_sh = NamedSharding(mesh, P("folds", None))
    rep = NamedSharding(mesh, P())
    Xs = jax.device_put(X, row_sh)
    Ys = jax.device_put(Y, row_sh)
    parts = jax.device_put(jnp.asarray(partitions), folds_sh)

    @partial(jax.jit, out_shardings=(rep, rep))
    def _step(Xs, Ys, parts):
        f = fit(Xs, Ys, A, method, precision=precision)
        f = PLSFit(W=f.W, P=f.P, Q=f.Q, R=f.R,
                   T=jnp.zeros((0, A), Xs.dtype), method=f.method)

        def rep_fn(perm):
            mask = jnp.zeros((N,), Xs.dtype).at[perm[:train_size]].set(1)
            fv = fit(Xs, Ys, A, method, row_mask=mask, precision=precision)
            return residuals_all_components(
                fv, Xs[perm[train_size:]], Ys[perm[train_size:]]
            )

        errs = jax.vmap(rep_fn)(parts)  # (trials, test, A, M)
        press = jnp.sum(errs * errs, axis=(0, 1)).T  # (M, A)
        return f, press

    return _step(Xs, Ys, parts)
