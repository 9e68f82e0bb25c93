"""Out-of-core / streaming fits for N too large to materialize.

The kernel type-2 algorithm needs X and Y only through the sufficient
statistics XX = XᵀX (K, K) and XY = XᵀY (K, M) — one streaming pass.
`StatsAccumulator` builds them chunk-by-chunk (each update is a jitted
donation-friendly FMA of a (chunk, K) block), then `fit_from_stats`
(models/kernel_pls.py) runs the X-free component loop.  This is the
"blockwise X streaming" analogue demanded by SURVEY.md §5 (long-context
row) for the 1M×10k north-star scale:

    acc = StatsAccumulator(K, M)
    for Xc, Yc in chunks:          # e.g. memory-mapped or sharded loader
        acc.update(Xc, Yc)
    fit = acc.fit(A)

Statistics from different hosts/shards can be combined by addition
(`StatsAccumulator.merge`), which is exactly the psum the sharded path
performs on-device (parallel/sharded.py).

Mean/stdev for z-scoring are accumulated in the same pass (count, sum,
sum-of-squares), so preprocessing also needs no second pass:
`acc.update_raw` z-scores later chunks against running statistics is NOT
offered (it would be approximate); instead use `collect_moments` +
`finalize_zscore_and_stats` for the exact two-pass scheme, or pre-scaled
data for one pass.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import jax
import jax.numpy as jnp
import numpy as np

from pls_tpu.models.kernel_pls import fit_from_stats
from pls_tpu.types import PLSFit


@jax.jit
def _update(XX, XY, YY, sx, sy, n, Xc, Yc):
    Yf = Yc.astype(YY.dtype)
    return (
        XX + Xc.T @ Xc, XY + Xc.T @ Yc, YY + Yf.T @ Yf,
        sx + jnp.sum(Xc, axis=0), sy + jnp.sum(Yf, axis=0),
        n + Xc.shape[0],
    )


@jax.jit
def _update_narrow(XX, XY, YY, sx, sy, n, Xc, Yc):
    """Narrow-chunk update (x_storage="bf16"): the chunk streams through
    the matmul in bfloat16 — half the memory bytes and the bf16 tensor-core
    rate — while the XᵀX/XᵀY accumulators stay f32 (`preferred_element_type`).
    The f32 += is exact per chunk; only the chunk representation rounds."""
    acc = XX.dtype
    XX = XX + jax.lax.dot_general(
        Xc, Xc, (((0,), (0,)), ((), ())), preferred_element_type=acc
    )
    XY = XY + jax.lax.dot_general(
        Xc, Yc, (((0,), (0,)), ((), ())), preferred_element_type=acc
    )
    Yf = Yc.astype(acc)
    YY = YY + Yf.T @ Yf
    sx = sx + jnp.sum(Xc.astype(acc), axis=0)
    sy = sy + jnp.sum(Yf, axis=0)
    return XX, XY, YY, sx, sy, n + Xc.shape[0]


@jax.jit
def _update_compensated(XX, XXe, XY, XYe, YY, sx, sy, n, Xc, Yc):
    """Compensated update: chunk partials at HIGHEST matmul precision
    (pinned explicitly — a DEFAULT-precision f32 matmul may round its
    operands (TF32 on an NVIDIA GPU), which would put ~1e-3 error into
    the partial BEFORE dd_add_f faithfully preserves it, voiding the
    'correctly rounded XX/XY' contract; ops/twofloat.cross_products
    pins the same way)."""
    from pls_tpu.ops.twofloat import dd_add_f

    hi = jax.lax.Precision.HIGHEST
    XX, XXe = dd_add_f(XX, XXe, jnp.matmul(Xc.T, Xc, precision=hi))
    XY, XYe = dd_add_f(XY, XYe, jnp.matmul(Xc.T, Yc, precision=hi))
    YY = YY + jnp.matmul(Yc.T, Yc, precision=hi)
    sx = sx + jnp.sum(Xc, axis=0)
    sy = sy + jnp.sum(Yc, axis=0)
    return XX, XXe, XY, XYe, YY, sx, sy, n + Xc.shape[0]


@dataclass
class StatsAccumulator:
    """Accumulates XᵀX, XᵀY (and row count) over data chunks.

    compensated=True carries the accumulators as float32 pairs combined by
    error-free two-sums (ops/twofloat.py) — the analogue of the
    reference's MPFR escape hatch (upstream include/PLS/pls.h:11-28)
    for the one place large-N precision is actually lost: the reduction
    over rows.  The resulting XX/XY are correctly rounded regardless of
    how many chunks streamed past (error independent of N).

    x_storage="bf16" streams each chunk through the matmul in bfloat16
    (half the memory bytes, the bf16 tensor-core rate) while the XX/XY accumulators
    stay in `dtype` — the same narrow-X/f32-accumulation policy as
    fit(x_storage=...).  Chunks already stored bf16 pass through without
    an upcast.  Mutually exclusive with compensated (a bf16-rounded chunk
    has already lost more than compensation recovers).

    precision: matmul precision of the plain-path per-chunk Gram updates
    (None = backend default — on an NVIDIA GPU an f32 matmul then runs
    in TF32, with ~1e-3-relative operand rounding; "highest" = exact
    f32; their rates on the H100 are not measured yet).  compensated mode
    always pins HIGHEST (its whole point is the error contract);
    x_storage="bf16" ignores it (bf16 products are exact in f32)."""

    K: int
    M: int
    dtype: object = jnp.float32
    compensated: bool = False
    x_storage: str | None = None
    precision: str | None = None
    XX: jax.Array = field(init=False)
    XY: jax.Array = field(init=False)
    YY: jax.Array = field(init=False)
    sx: jax.Array = field(init=False)
    sy: jax.Array = field(init=False)
    XXe: jax.Array = field(init=False)
    XYe: jax.Array = field(init=False)
    n: int = field(init=False, default=0)

    def __post_init__(self):
        if self.x_storage is not None:
            if self.x_storage not in ("bf16", "bfloat16"):
                raise ValueError(
                    f"unknown x_storage {self.x_storage!r} (use 'bf16')"
                )
            if self.compensated:
                raise ValueError(
                    "x_storage='bf16' and compensated are mutually exclusive"
                )
        self.XX = jnp.zeros((self.K, self.K), self.dtype)
        self.XY = jnp.zeros((self.K, self.M), self.dtype)
        self.YY = jnp.zeros((self.M, self.M), self.dtype)
        self.sx = jnp.zeros((self.K,), self.dtype)
        self.sy = jnp.zeros((self.M,), self.dtype)
        # error accumulators only materialize in compensated mode (a K×K
        # f32 buffer is 400 MB at the K=10k north-star scale)
        z = jnp.zeros((0,), self.dtype)
        self.XXe = jnp.zeros((self.K, self.K), self.dtype) if self.compensated else z
        self.XYe = jnp.zeros((self.K, self.M), self.dtype) if self.compensated else z
        self.n = jnp.zeros((), jnp.int64 if jnp.array(0).dtype == jnp.int64 else jnp.int32)

    def update(self, X_chunk, Y_chunk) -> "StatsAccumulator":
        if self.x_storage is not None:
            X_chunk = jnp.asarray(X_chunk, jnp.bfloat16)
            Y_chunk = jnp.asarray(Y_chunk, jnp.bfloat16)
            if Y_chunk.ndim == 1:
                Y_chunk = Y_chunk[:, None]
            (self.XX, self.XY, self.YY, self.sx, self.sy,
             self.n) = _update_narrow(
                self.XX, self.XY, self.YY, self.sx, self.sy, self.n,
                X_chunk, Y_chunk,
            )
            return self
        X_chunk = jnp.asarray(X_chunk, self.dtype)
        Y_chunk = jnp.asarray(Y_chunk, self.dtype)
        if Y_chunk.ndim == 1:
            Y_chunk = Y_chunk[:, None]
        if self.compensated:
            (self.XX, self.XXe, self.XY, self.XYe, self.YY, self.sx,
             self.sy, self.n) = _update_compensated(
                self.XX, self.XXe, self.XY, self.XYe, self.YY, self.sx,
                self.sy, self.n, X_chunk, Y_chunk,
            )
        else:
            from pls_tpu.models.kernel_pls import _prec_ctx

            # the matmul-precision config is part of jax's trace-context
            # key, so the jitted update specializes (and caches) per
            # precision setting
            with _prec_ctx(self.precision):
                (self.XX, self.XY, self.YY, self.sx, self.sy,
                 self.n) = _update(
                    self.XX, self.XY, self.YY, self.sx, self.sy, self.n,
                    X_chunk, Y_chunk,
                )
        return self

    def merge(self, other: "StatsAccumulator") -> "StatsAccumulator":
        """Combine statistics from another shard/host (psum analogue)."""
        if self.compensated != other.compensated:
            raise ValueError("cannot merge compensated and plain accumulators")
        if self.compensated:
            from pls_tpu.ops.twofloat import dd_add

            self.XX, self.XXe = dd_add(self.XX, self.XXe, other.XX, other.XXe)
            self.XY, self.XYe = dd_add(self.XY, self.XYe, other.XY, other.XYe)
        else:
            self.XX = self.XX + other.XX
            self.XY = self.XY + other.XY
        self.YY = self.YY + other.YY
        self.sx = self.sx + other.sx
        self.sy = self.sy + other.sy
        self.n = self.n + other.n
        return self

    def zscored(self):
        """Closed-form z-scored statistics (zscore_stats docs): returns
        (XX_z, XY_z, YY_z, mx, sdx, my, sdy) — one pass over RAW data
        yields the statistics of the column-standardized data."""
        return zscore_stats(
            self.XX, self.XY, self.sx, self.sy, self.n, YY=self.YY
        )

    def fit(self, A: int, *, zscore: bool = False, **kw) -> PLSFit:
        """Fit from the accumulated statistics.  zscore=True fits the
        z-scored model from the RAW-data statistics in closed form (the
        reference CLI's preprocessing, with no second pass)."""
        if zscore:
            XX_z, XY_z, *_ = self.zscored()
            return fit_from_stats(XX_z, XY_z, A, **kw)
        return fit_from_stats(self.XX, self.XY, A, **kw)


@jax.jit
def _update_folds(XXf, XYf, YYf, sxf, syf, nf, Xc, Yc, assign):
    """Per-fold sufficient-statistics update for ONE chunk.

    For each fold f, the held-out block's cross-products are accumulated
    via the one-sided-mask identity  Xfᵀ Xf = (Xc ⊙ m_f)ᵀ Xc  with
    m_f ∈ {0,1} (idempotent diagonal), so only one operand is masked per
    fold and the other streams from HBM once per fold.  A lax.scan over
    folds keeps the masked operand a single (chunk, K) temporary.  Narrow
    (bf16) chunks accumulate f32 via preferred_element_type, matching
    StatsAccumulator's policy.
    """
    acc = XXf.dtype
    k = XXf.shape[0]
    narrow = Xc.dtype.itemsize < 4
    Ycn = Yc.astype(Xc.dtype) if narrow else Yc.astype(acc)

    def body(carry, f):
        XXf, XYf, YYf, sxf, syf, nf = carry
        m = (assign == f).astype(Xc.dtype)
        Xm = Xc * m[:, None]
        if narrow:
            xx = jax.lax.dot_general(
                Xm, Xc, (((0,), (0,)), ((), ())), preferred_element_type=acc
            )
            xy = jax.lax.dot_general(
                Xm, Ycn, (((0,), (0,)), ((), ())), preferred_element_type=acc
            )
        else:
            xx = Xm.T @ Xc
            xy = Xm.T @ Ycn
        ma = m.astype(acc)
        Ym = Yc.astype(acc) * ma[:, None]
        yy = Ym.T @ Yc.astype(acc)
        return (
            XXf.at[f].add(xx),
            XYf.at[f].add(xy),
            YYf.at[f].add(yy),
            sxf.at[f].add(jnp.sum(Xm, axis=0, dtype=acc)),
            syf.at[f].add(jnp.sum(Ym, axis=0)),
            nf.at[f].add(jnp.sum(ma).astype(nf.dtype)),
        ), None

    (XXf, XYf, YYf, sxf, syf, nf), _ = jax.lax.scan(
        body, (XXf, XYf, YYf, sxf, syf, nf), jnp.arange(k)
    )
    return XXf, XYf, YYf, sxf, syf, nf


def zscore_stats(XX, XY, sx, sy, n, *, YY=None, ddof=1):
    """Transform RAW-data cross-products into the cross-products of the
    column-z-scored data, in closed form — the algebra that makes
    one-pass-from-raw fits possible:

        Σ (x−μx)(x−μx)ᵀ = XX − n·μx μxᵀ          (since Σx = n·μx)
        Σ (x−μx)(y−μy)ᵀ = XY − n·μx μyᵀ
        z-scoring divides row i of the centered products by σ_i and
        column j by σ_j.

    σ comes from the same statistics (diag of the centered XX/YY), so
    ONE pass over the data — accumulating XX, XY, (YY,) and the column
    sums sx, sy — suffices where the naive formulation needs a moments
    pass plus a scaled-data pass.  Numerical caveat (the classic
    uncentered-sum-of-squares cancellation): entries lose ~(μ/σ)²
    relative precision in the subtraction, so this is for data whose
    column means are not enormous relative to their spreads; for
    extreme-offset data use the exact two-pass scheme
    (collect_moments + fit_streaming(zscore=True)), which is immune.

    Returns (XX_z, XY_z, YY_z | None, mx, sdx, my, sdy); zero-variance
    columns get σ=1 (the z-score guard, ops/stats.py).
    """
    n = jnp.asarray(n, XX.dtype)
    mx = sx / n
    my = sy / n
    cXX = XX - n * jnp.outer(mx, mx)
    varx = jnp.diagonal(cXX) / (n - ddof)
    sdx = jnp.sqrt(jnp.maximum(varx, 0))
    sdx = jnp.where(sdx == 0, 1.0, sdx)
    cXY = XY - n * jnp.outer(mx, my)
    if YY is not None:
        cYY = YY - n * jnp.outer(my, my)
        vary = jnp.diagonal(cYY) / (n - ddof)
        sdy = jnp.sqrt(jnp.maximum(vary, 0))
        sdy = jnp.where(sdy == 0, 1.0, sdy)
        YY_z = cYY / jnp.outer(sdy, sdy)
    else:
        sdy = jnp.ones_like(my)
        YY_z = None
    XX_z = cXX / jnp.outer(sdx, sdx)
    XY_z = cXY / jnp.outer(sdx, sdy)
    return XX_z, XY_z, YY_z, mx, sdx, my, sdy


def zscore_fold_stats(XXf, XYf, YYf, sxf, syf, nf, mx, sdx, my, sdy):
    """Per-fold analogue of `zscore_stats` under GLOBAL (mx, sdx, my,
    sdy) — the reference pipeline z-scores once globally before any CV
    (/root/reference/src/main.cpp:24-25), so fold blocks transform with
    the global location/scale but their OWN row sums:

        Σ_{i∈f} (x−μ)(x−μ)ᵀ = XXf − μ sxfᵀ − sxf μᵀ + n_f μμᵀ

    Inputs are stacked over the fold axis: XXf (k, K, K), XYf (k, K, M),
    YYf (k, M, M), sxf (k, K), syf (k, M), nf (k,).  Returns the
    z-scored (XXf_z, XYf_z, YYf_z).
    """
    nfa = nf.astype(XXf.dtype)[:, None, None]
    cXXf = (
        XXf
        - mx[None, :, None] * sxf[:, None, :]
        - sxf[:, :, None] * mx[None, None, :]
        + nfa * jnp.outer(mx, mx)[None]
    )
    cXYf = (
        XYf
        - mx[None, :, None] * syf[:, None, :]
        - sxf[:, :, None] * my[None, None, :]
        + nfa * jnp.outer(mx, my)[None]
    )
    cYYf = (
        YYf
        - my[None, :, None] * syf[:, None, :]
        - syf[:, :, None] * my[None, None, :]
        + nfa * jnp.outer(my, my)[None]
    )
    XXf_z = cXXf / jnp.outer(sdx, sdx)[None]
    XYf_z = cXYf / jnp.outer(sdx, sdy)[None]
    YYf_z = cYYf / jnp.outer(sdy, sdy)[None]
    return XXf_z, XYf_z, YYf_z


@jax.jit
def _update_single_fold(XXf, XYf, YYf, sxf, syf, nf, Xc, Yc, f):
    """Fast path when EVERY row of the chunk belongs to fold `f` (a
    traced scalar, so one compiled program serves all folds): one plain
    Gram update scattered into the fold slot — 1× flops instead of the
    masked scan's k×.  With contiguous partitions and fold sizes ≫
    chunk size, almost every chunk takes this path, so the per-chunk
    compute matches the plain StatsAccumulator and stays hidden under
    even NVMe-speed ingest."""
    acc = XXf.dtype
    narrow = Xc.dtype.itemsize < 4
    Ycn = Yc.astype(Xc.dtype) if narrow else Yc.astype(acc)
    if narrow:
        xx = jax.lax.dot_general(
            Xc, Xc, (((0,), (0,)), ((), ())), preferred_element_type=acc
        )
        xy = jax.lax.dot_general(
            Xc, Ycn, (((0,), (0,)), ((), ())), preferred_element_type=acc
        )
    else:
        xx = Xc.T @ Xc
        xy = Xc.T @ Ycn
    Ya = Yc.astype(acc)
    yy = Ya.T @ Ya
    return (
        XXf.at[f].add(xx),
        XYf.at[f].add(xy),
        YYf.at[f].add(yy),
        sxf.at[f].add(jnp.sum(Xc, axis=0, dtype=acc)),
        syf.at[f].add(jnp.sum(Ya, axis=0)),
        nf.at[f].add(jnp.int32(Xc.shape[0])),
    )


@dataclass
class FoldStatsAccumulator:
    """Per-fold sufficient statistics XXf = XfᵀXf, XYf = XfᵀYf,
    YYf = YfᵀYf (+ row counts) accumulated in the SAME single streaming
    pass as the global statistics — each row belongs to exactly one
    fold, so the global XX/XY are the fold sums and come for free.

    This is the engine of the one-pass k-fold CV (cv/kfold.py
    cv_kfold_onepass): per-fold training statistics are
    (XX − XXf, XY − XYf), and per-fold PRESS at every truncation is
    closed-form from (XXf, XYf, YYf, Bf) — no second pass over the data
    is needed for PRESS/MSE/RMSE, and only ONE combined residual pass
    (all folds at once) for the per-row errors the Wilcoxon selector
    consumes.  Contrast with re-streaming each fold's block
    (cv_kfold_from_stats): k+1 passes → 2 passes.

    Device memory: the fold accumulators are k·K² floats (k=10, K=10⁴
    → 4 GB f32) — fits one H100 (80 GB) at the north-star shape; for much
    larger k·K² fall back to cv_kfold_from_stats.  Per-chunk compute is
    k masked matmuls (k× the plain accumulator); in IO-bound ingest
    this stays hidden behind the disk/transfer stream.

    x_storage="bf16": chunks stream the matmul narrow with f32
    accumulators (StatsAccumulator policy).  precision: matmul
    precision of the f32-path Gram updates (StatsAccumulator precision
    docs; None = backend default, the production configuration).
    Reference analogue: the fold refits of Model::cv_LSO
    (/root/reference/src/pls.cpp:512-549), restructured as statistics
    accumulated in the data pass."""

    K: int
    M: int
    k: int
    dtype: object = jnp.float32
    x_storage: str | None = None
    precision: str | None = None
    XXf: jax.Array = field(init=False)
    XYf: jax.Array = field(init=False)
    YYf: jax.Array = field(init=False)
    sxf: jax.Array = field(init=False)
    syf: jax.Array = field(init=False)
    nf: jax.Array = field(init=False)

    def __post_init__(self):
        if self.x_storage is not None and self.x_storage not in (
            "bf16", "bfloat16",
        ):
            raise ValueError(f"unknown x_storage {self.x_storage!r} (use 'bf16')")
        if self.k < 2:
            raise ValueError(f"k={self.k} must be >= 2")
        self.XXf = jnp.zeros((self.k, self.K, self.K), self.dtype)
        self.XYf = jnp.zeros((self.k, self.K, self.M), self.dtype)
        self.YYf = jnp.zeros((self.k, self.M, self.M), self.dtype)
        self.sxf = jnp.zeros((self.k, self.K), self.dtype)
        self.syf = jnp.zeros((self.k, self.M), self.dtype)
        self.nf = jnp.zeros((self.k,), jnp.int32)

    def update(self, X_chunk, Y_chunk, assign_chunk) -> "FoldStatsAccumulator":
        """Accumulate one (rows, K) chunk; assign_chunk is the (rows,)
        fold label [0, k) of each row.  Chunks whose rows all share one
        fold (common with contiguous partitions) take a 1×-flops fast
        path (_update_single_fold); mixed chunks take the k-fold masked
        scan."""
        if self.x_storage is not None:
            X_chunk = jnp.asarray(X_chunk, jnp.bfloat16)
        else:
            X_chunk = jnp.asarray(X_chunk, self.dtype)
        Y_chunk = jnp.asarray(Y_chunk)
        if Y_chunk.ndim == 1:
            Y_chunk = Y_chunk[:, None]
        from pls_tpu.models.kernel_pls import _prec_ctx

        a_np = np.asarray(assign_chunk)
        with _prec_ctx(self.precision):
            if a_np.size and a_np.min() == a_np.max():
                (self.XXf, self.XYf, self.YYf, self.sxf, self.syf,
                 self.nf) = _update_single_fold(
                    self.XXf, self.XYf, self.YYf, self.sxf, self.syf, self.nf,
                    X_chunk, Y_chunk, jnp.int32(a_np[0]),
                )
                return self
            assign_chunk = jnp.asarray(assign_chunk, jnp.int32)
            (self.XXf, self.XYf, self.YYf, self.sxf, self.syf,
             self.nf) = _update_folds(
                self.XXf, self.XYf, self.YYf, self.sxf, self.syf, self.nf,
                X_chunk, Y_chunk, assign_chunk,
            )
        return self

    def merge(self, other: "FoldStatsAccumulator") -> "FoldStatsAccumulator":
        """Combine partials from another shard/host (psum analogue)."""
        self.XXf = self.XXf + other.XXf
        self.XYf = self.XYf + other.XYf
        self.YYf = self.YYf + other.YYf
        self.sxf = self.sxf + other.sxf
        self.syf = self.syf + other.syf
        self.nf = self.nf + other.nf
        return self

    def zscored(self) -> "FoldStatsAccumulator":
        """A new accumulator holding the fold statistics of the
        GLOBALLY z-scored data, in closed form from the raw-data fold
        statistics (zscore_fold_stats docs — the reference pipeline's
        z-score-then-CV order, with no extra data pass).  Also returns
        the transform via attributes `.mx/.sdx/.my/.sdy` on the result
        for use in the residual pass."""
        _, _, _, mx, sdx, my, sdy = zscore_stats(
            jnp.sum(self.XXf, axis=0), jnp.sum(self.XYf, axis=0),
            jnp.sum(self.sxf, axis=0), jnp.sum(self.syf, axis=0),
            jnp.sum(self.nf), YY=jnp.sum(self.YYf, axis=0),
        )
        XXf_z, XYf_z, YYf_z = zscore_fold_stats(
            self.XXf, self.XYf, self.YYf, self.sxf, self.syf, self.nf,
            mx, sdx, my, sdy,
        )
        out = FoldStatsAccumulator(self.K, self.M, self.k, self.dtype)
        out.XXf = XXf_z
        out.XYf = XYf_z
        out.YYf = YYf_z
        # per-fold sums of globally-z-scored rows: (sxf − n_f·μ)/σ
        # (zero only when summed over ALL folds)
        nfa = self.nf.astype(self.dtype)[:, None]
        out.sxf = (self.sxf - nfa * mx[None, :]) / sdx[None, :]
        out.syf = (self.syf - nfa * my[None, :]) / sdy[None, :]
        out.nf = self.nf
        out.mx, out.sdx, out.my, out.sdy = mx, sdx, my, sdy
        return out

    @property
    def XX(self) -> jax.Array:
        """Global XᵀX = Σ_f XXf (each row is in exactly one fold)."""
        return jnp.sum(self.XXf, axis=0)

    @property
    def XY(self) -> jax.Array:
        return jnp.sum(self.XYf, axis=0)

    @property
    def n(self):
        return jnp.sum(self.nf)

    def fit(self, A: int, **kw) -> PLSFit:
        """Full-data fit from the global statistics."""
        return fit_from_stats(self.XX, self.XY, A, **kw)


def _merge_moments(n, mean, m2, Xc):
    """Chan et al. parallel-variance merge of a chunk into running
    (count, mean, centered-sum-of-squares) — numerically stable at f32
    even for large means, unlike the sumsq − n·mean² formula (which
    cancels catastrophically: the reason this is not a naive
    sum/sum-of-squares accumulator)."""
    n_c = Xc.shape[0]
    mean_c = jnp.mean(Xc, axis=0)
    m2_c = jnp.sum((Xc - mean_c[None, :]) ** 2, axis=0)
    tot = n + n_c
    delta = mean_c - mean
    mean = mean + delta * (n_c / tot)
    m2 = m2 + m2_c + delta * delta * (n * n_c / tot)
    return tot, mean, m2


def collect_moments(chunks, K: int, M: int, dtype=jnp.float32):
    """Pass 1 of exact streaming z-scoring: per-column mean/stdev for X
    and Y over an iterable of (X_chunk, Y_chunk), via chunk-wise Welford/
    Chan merging (f32-safe; pass dtype=jnp.float64 under enabled x64 for
    CPU parity runs — note jax silently downgrades f64 to f32 when x64 is
    off)."""
    mx = jnp.zeros((K,), dtype)
    m2x = jnp.zeros((K,), dtype)
    my = jnp.zeros((M,), dtype)
    m2y = jnp.zeros((M,), dtype)
    n = 0
    for Xc, Yc in chunks:
        Xc = jnp.asarray(Xc, dtype)
        Yc = jnp.asarray(Yc, dtype)
        if Yc.ndim == 1:
            Yc = Yc[:, None]
        n_new, mx, m2x = _merge_moments(n, mx, m2x, Xc)
        _, my, m2y = _merge_moments(n, my, m2y, Yc)
        n = n_new
    # unbiased (N-1) stdev, zero-guarded as in ops/stats.py
    sd_x = jnp.sqrt(jnp.maximum(m2x / (n - 1), 0))
    sd_y = jnp.sqrt(jnp.maximum(m2y / (n - 1), 0))
    return (mx, jnp.where(sd_x == 0, 1.0, sd_x),
            my, jnp.where(sd_y == 0, 1.0, sd_y), n)


def csv_chunks(x_path, y_path, chunk_rows: int, separator: str = ","):
    """Iterate aligned (X_chunk, Y_chunk) blocks of two headerless CSVs via
    the (natively threaded, if built) chunk loader — utils/io.py.
    Raises if the files have different row counts."""
    from pls_tpu.utils.io import stream_matrix_file

    xs = stream_matrix_file(x_path, chunk_rows, separator)
    ys = stream_matrix_file(y_path, chunk_rows, separator)
    while True:
        xc = next(xs, None)
        yc = next(ys, None)
        if xc is None and yc is None:
            return
        if xc is None or yc is None or xc.shape[0] != yc.shape[0]:
            raise ValueError(
                f"{x_path} and {y_path} have different numbers of rows"
            )
        yield xc, yc


def fit_streaming_csv(
    x_path, y_path, A: int, *,
    chunk_rows: int = 8192, zscore: bool = True, separator: str = ",",
    dtype=jnp.float32, **kw
) -> PLSFit:
    """Out-of-core fit straight from CSV files: exact two-pass scheme
    (pass 1 column moments, pass 2 z-scored XᵀX/XᵀY accumulation), with X
    never resident in memory — chunks flow from the threaded native loader
    to the device accumulator.  The end-to-end streaming analogue of the
    reference CLI pipeline (/root/reference/src/main.cpp:21-29) for files
    that don't fit in host memory."""
    probe = next(iter(csv_chunks(x_path, y_path, chunk_rows, separator)))
    K, M = probe[0].shape[1], probe[1].shape[1]
    moments = None
    if zscore:
        moments = collect_moments(
            csv_chunks(x_path, y_path, chunk_rows, separator), K, M, dtype
        )
    return fit_streaming(
        csv_chunks(x_path, y_path, chunk_rows, separator), K, M, A,
        zscore=zscore, moments=moments, dtype=dtype, **kw
    )


def fit_streaming(
    chunks, K: int, M: int, A: int, *,
    zscore: bool = False, moments=None, dtype=jnp.float32,
    x_storage: str | None = None, **kw
) -> PLSFit:
    """One-call streaming fit over an iterable of (X_chunk, Y_chunk).

    zscore=True requires `moments` from collect_moments (pass 1); chunks
    are standardized exactly as the reference CLI does before the
    statistics are accumulated (pass 2).  x_storage="bf16" streams each
    chunk narrow with f32 accumulation (StatsAccumulator docs).
    """
    acc = StatsAccumulator(K, M, dtype, x_storage=x_storage)
    if zscore:
        if moments is None:
            raise ValueError("zscore=True requires moments=collect_moments(...)")
        mx, sdx, my, sdy, _ = moments
    for Xc, Yc in chunks:
        Xc = jnp.asarray(Xc, dtype)
        Yc = jnp.asarray(Yc, dtype)
        if Yc.ndim == 1:
            Yc = Yc[:, None]
        if zscore:
            Xc = (Xc - mx.astype(dtype)) / sdx.astype(dtype)
            Yc = (Yc - my.astype(dtype)) / sdy.astype(dtype)
        acc.update(Xc, Yc)
    return acc.fit(A, **kw)
