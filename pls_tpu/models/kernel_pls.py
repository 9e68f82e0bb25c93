"""Dayal–MacGregor "improved kernel" PLS.

Reference analogue: `Model::plsr` (/root/reference/src/pls.cpp:390-437),
implementing Dayal & MacGregor (1997) "Improved PLS Algorithms",
J. Chemometrics 11:73-85, kernel algorithms #1 and #2.  Only the K×M
cross-product XY = XᵀY is deflated per component; X itself is never
deflated (this is NOT classical NIPALS).

Design decisions (vs. the reference's mutable in-place loop):
- The per-component loop is a `jax.lax.scan` with carry (XY, P-buffer,
  R-buffer): static shapes, single compiled program, fully fusable by XLA.
- The Gram–Schmidt correction  r = w − Σ_{j<a} (pⱼᵀw) rⱼ  is computed as
  two dense matmuls against zero-initialized (A, K) buffers — zero rows
  beyond the current component contribute nothing, so no dynamic slicing
  is needed and the matmuls have fixed shapes.
- The dominant eigenvector of the symmetric PSD XYᵀXY is real by
  construction (ops/eigen.py), eliminating the reference's complex dtypes.
- Row masking: CV folds zero out held-out rows of X and Y *before* the
  cross-products.  Every use of X in the algorithm is a masked reduction,
  so a masked fit is arithmetically identical to fitting on the surviving
  subset — this is what makes folds a pure vmap axis.
- Multi-device: with X and Y row-sharded over a mesh axis, the
  contractions XᵀY, XᵀX, Xᵀt and tᵀt are partial-per-shard + all-reduce;
  XLA's SPMD partitioner inserts the psums automatically (see
  parallel/sharded.py).

Sub-model truncation note (SURVEY.md §3.3): kernel-PLS components are
computed sequentially, so the first A columns of an A'-component fit
(A' > A) are identical to an A-component fit.  The reference exploits the
converse wastefully (CV sub-models refit with A=K); we always fit exactly
the requested A.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp

from pls_tpu.ops.eigen import dominant_eigenvector
from pls_tpu.types import METHOD, PLSFit

# Below this many bytes of X the fit's fixed per-component cost (the
# M×M eigh, the Gram–Schmidt step) hides the kernel's saving: at A=20,
# M=10 on an H100 the two paths tie at 32 MiB and the kernel wins from
# 256 MiB with either eigenvector method (docs/PERF.md).
_AUTO_MIN_BYTES = 256 * 2**20


def auto_pallas(N: int, K: int, itemsize: int = 4) -> bool:
    """Whether `use_pallas=None` selects the fused deflation kernel: it
    compiles for this backend at this shape (ops/deflate.pallas_supported)
    and X is large enough for the kernel to pay."""
    from pls_tpu.ops.deflate import pallas_supported

    return pallas_supported(N, K, itemsize) and N * K * itemsize >= _AUTO_MIN_BYTES


def fit(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int | None = None,
    method: METHOD = METHOD.KERNEL_TYPE1,
    *,
    row_mask: jnp.ndarray | None = None,
    sample_weight: jnp.ndarray | None = None,
    power_iters: int | None = None,
    precision: str | None = "highest",
    use_pallas: bool | None = None,
    x_storage: str | None = None,
) -> PLSFit:
    """Fit a PLS model of up to `A` components.

    Args:
      X: (N, K) predictors (pre-centered/z-scored by the caller, as in the
         reference CLI — /root/reference/src/main.cpp:24-25).
      Y: (N, M) responses.
      A: number of components; defaults to K, matching the reference's
         default-constructor behavior (/root/reference/src/pls.cpp:359).
      method: KERNEL_TYPE1 | KERNEL_TYPE2 | NIPALS | SIMPLS.
      row_mask: optional (N,) {0,1} mask; masked-out rows are excluded from
         the fit exactly (used by the vmapped cross-validators).
      sample_weight: optional (N,) non-negative weights; rows are scaled
         by √w, so the fit sees the weighted cross-products XᵀWY / XᵀWX.
         Integer weights are exactly equivalent to repeating rows (the
         bootstrap, cv/bootstrap.py, relies on this).
      power_iters: if set, use fixed-iteration power method instead of eigh
         for the M>1 dominant-eigenvector step.
      x_storage: "bf16" stores X in bfloat16 for the streaming
         contractions (XᵀY, and the per-component t = Xr / p = Xᵀt
         passes), HALVING the fit's HBM traffic; every contraction
         accumulates in f32 (`preferred_element_type` on the XLA path,
         the kernel's f32 registers on the fused path) and
         all model state (W/P/Q/R/T, XY) stays f32 — the
         "narrow storage, wide accumulation" policy.  Note that the
         one XᵀY pass also rounds Y to bf16 (dot_general requires
         matching operand dtypes), so XY₀ embeds Y's bf16 rounding as
         well as X's — within the same ~1e-3 budget.  Expected
         component error ~1e-3 relative (bf16 has 8 mantissa bits;
         measured error bounds in docs/PERF.md).  None (default): X's
         own dtype end-to-end.
      precision: jax matmul precision context ("highest" for f32 parity /
         CPU; None to use the session default, e.g. TF32 on an NVIDIA
         GPU).
         "compensated" (kernel methods): exact-f32 matmuls PLUS a
         double-float (f32-pair) XY deflation carry — the sequential
         rank-1 deflations are the one recurrence where f32 drift
         accumulates with A (the reference's MPFR territory,
         /root/reference/include/PLS/pls.h:11-28); the pair state keeps
         deep-A fits at the f32 representation floor for ~2× flops on a
         K×M object (negligible vs X streaming).  NIPALS/SIMPLS treat it
         as "highest".
      use_pallas: KERNEL_TYPE1 only — run the per-component (t, tt, p)
         X-streaming pass as the fused Pallas kernel (ops/deflate.py),
         which reads X once instead of twice.  None (default): the
         kernel where it compiles and pays (see auto_pallas); False:
         plain XLA two-pass; True: the kernel (ValueError for a shape
         beyond its limits, ops/deflate.pallas_supported).

    Returns: PLSFit pytree (W, P, Q, R, T, method).
    """
    X = jnp.asarray(X)
    Y = jnp.asarray(Y)
    if Y.ndim == 1:
        Y = Y[:, None]
    N, K = X.shape
    if A is None:
        A = K
    if not (0 < A <= K):
        raise ValueError(f"A={A} must satisfy 0 < A <= K={K}")
    if X.shape[0] != Y.shape[0]:
        raise ValueError(f"X has {X.shape[0]} rows but Y has {Y.shape[0]}")

    if row_mask is not None:
        m = row_mask.astype(X.dtype)[:, None]
        X = X * m
        Y = Y * m
    if sample_weight is not None:
        w = jnp.sqrt(jnp.asarray(sample_weight, X.dtype))[:, None]
        X = X * w
        Y = Y * w
    if x_storage is not None:
        if x_storage not in ("bf16", "bfloat16"):
            raise ValueError(f"unknown x_storage {x_storage!r} (use 'bf16')")
        if method not in (METHOD.KERNEL_TYPE1, METHOD.KERNEL_TYPE2):
            raise ValueError(
                "x_storage='bf16' requires a kernel method (type 1/2); "
                f"{method} does not implement the f32-accumulation policy"
            )
        # cast AFTER masking/weighting so those multiplies stay exact
        X = X.astype(jnp.bfloat16)

    if method in (METHOD.KERNEL_TYPE1, METHOD.KERNEL_TYPE2):
        if precision == "dd":
            # full double-float escape hatch (models/kernel_dd.py):
            # every per-component quantity AND the X contractions carry
            # f32-pair precision — the complete MPFR analogue
            if x_storage is not None:
                raise ValueError(
                    "precision='dd' carries full pair precision; "
                    "x_storage='bf16' would defeat it"
                )
            from pls_tpu.models.kernel_dd import fit_dd

            return fit_dd(
                X, Y, A, type1=(method == METHOD.KERNEL_TYPE1),
                power_iters=power_iters,
            )
        if use_pallas is None:
            # Inside a trace (vmapped CV refits, user jit) stay on the XLA
            # path: the batched kernel is not the case it is sized for.
            use_pallas = (
                method == METHOD.KERNEL_TYPE1
                and not isinstance(X, jax.core.Tracer)
                and auto_pallas(N, K, X.dtype.itemsize)
            )
        return _fit_kernel(
            X, Y, A, type1=(method == METHOD.KERNEL_TYPE1),
            power_iters=power_iters, precision=precision,
            use_pallas=bool(use_pallas),
        )
    if method == METHOD.NIPALS:
        from pls_tpu.models.nipals import fit_nipals

        return fit_nipals(X, Y, A, precision=precision)
    if method == METHOD.SIMPLS:
        from pls_tpu.models.simpls import fit_simpls

        return fit_simpls(X, Y, A, power_iters=power_iters, precision=precision)
    raise ValueError(f"unknown method {method}")


def _prec_ctx(precision: str | None):
    if precision is None:
        import contextlib

        return contextlib.nullcontext()
    if precision == "compensated":
        # compensated mode implies exact-f32 matmuls; the extra
        # double-float state is handled by the component loops
        precision = "highest"
    return jax.default_matmul_precision(precision)


def _dd_deflate(XY, XYe, p, q, tt):
    """One compensated deflation step: (XY, XYe) −= tt·(p qᵀ) in
    double-float.  The rank-1 product is made error-free with Dekker
    two_prod (q·tt first, then the outer product), so the only rounding
    left in the recurrence is the renormalized two_sum — the f32 drift
    that accumulates over deep-A sequential deflations (the reference's
    MPFR territory, /root/reference/include/PLS/pls.h:11-28) is carried
    in XYe instead of lost.  ~2× flops on a K×M object: negligible next
    to the O(N·K) X streaming."""
    from pls_tpu.ops.twofloat import dd_add, two_prod

    qtt, qtt_e = two_prod(q, tt)
    D, De = two_prod(p[:, None], qtt[None, :])
    De = De + p[:, None] * qtt_e[None, :]  # second-order correction
    return dd_add(XY, XYe, -D, -De)


@partial(
    jax.jit,
    static_argnames=(
        "A", "type1", "power_iters", "precision", "use_pallas",
    ),
)
def _fit_kernel(
    X: jnp.ndarray,
    Y: jnp.ndarray,
    A: int,
    type1: bool,
    power_iters: int | None,
    precision: str | None,
    use_pallas: bool = False,
) -> PLSFit:
    """Kernel algorithms #1/#2 as a scan over components.

    Per-component math mirrors /root/reference/src/pls.cpp:400-435:
      M==1:  w = XY                     else: q₀ = dom.eigvec(XYᵀXY), w = XY q₀
      w /= ‖w‖ ;  r = w − Σ_{j<a}(pⱼᵀw) rⱼ
      type1: t = X r, tt = tᵀt, p = Xᵀt      type2: tt = rᵀ XX r, p = XX r
      p /= tt ;  q = XYᵀ r / tt ;  XY ← XY − (p qᵀ) tt
    """
    N, K = X.shape
    M = Y.shape[1]
    dtype = X.dtype
    # bf16 X storage: X streams narrow, every contraction accumulates f32
    # and all model state is f32 (see fit() x_storage docs)
    acc = jnp.float32 if dtype.itemsize < 4 else dtype

    with _prec_ctx(precision):
        if acc != dtype:
            XY0 = jax.lax.dot_general(
                X, Y.astype(dtype), (((0,), (0,)), ((), ())),
                preferred_element_type=acc,
            )
            XX = None if type1 else jax.lax.dot_general(
                X, X, (((0,), (0,)), ((), ())), preferred_element_type=acc
            )
        else:
            XY0 = X.T @ Y
            XX = None if type1 else X.T @ X
        comp = precision == "compensated"

        def step(carry, a):
            if comp:
                XY, XYe, Pb, Rb = carry
            else:
                XY, Pb, Rb = carry
            if M == 1:
                w = XY[:, 0]
            else:
                C = XY.T @ XY
                q0 = dominant_eigenvector(C, power_iters)
                w = XY @ q0
            w = w / jnp.sqrt(w @ w)
            # Gram-Schmidt vs previous loadings; rows >= a of Pb/Rb are zero
            r = w - Rb.T @ (Pb @ w)
            if comp:
                # twice-is-enough reorthogonalization: the single f32 GS
                # correction leaves O(eps)·cond residuals that compound
                # over deep-A sequential components
                r = r - Rb.T @ (Pb @ r)
            if type1:
                if use_pallas:
                    from pls_tpu.ops.deflate import deflate_pass

                    t, tt, p = deflate_pass(X, r, use_pallas=True)
                elif acc != dtype:
                    from pls_tpu.ops.deflate import deflate_pass_xla

                    t, tt, p = deflate_pass_xla(X, r)
                else:
                    t = X @ r
                    tt = t @ t
                    p = X.T @ t
            else:
                v = XX @ r
                tt = r @ v
                p = v
                t = jnp.zeros((0,), acc)
            p = p / tt
            q = (XY.T @ r) / tt
            Pb = Pb.at[a].set(p)
            Rb = Rb.at[a].set(r)
            if comp:
                XY, XYe = _dd_deflate(XY, XYe, p, q, tt)
                return (XY, XYe, Pb, Rb), (w, q, t)
            XY = XY - jnp.outer(p, q) * tt
            return (XY, Pb, Rb), (w, q, t)

        # derive the zero buffers from the data so their device-varying
        # status matches the carry updates under shard_map manual axes
        zbuf = jnp.zeros((A, K), acc) + XY0[0, 0] * 0
        carry0 = (
            (XY0, jnp.zeros_like(XY0), zbuf, zbuf) if comp
            else (XY0, zbuf, zbuf)
        )
        carry, (Ws, Qs, Ts) = jax.lax.scan(step, carry0, jnp.arange(A))
        Pb, Rb = carry[-2], carry[-1]

    return PLSFit(
        W=Ws.T,
        P=Pb.T,
        Q=Qs.T,
        R=Rb.T,
        T=Ts.T if type1 else jnp.zeros((0, A), acc),
        method=METHOD.KERNEL_TYPE1 if type1 else METHOD.KERNEL_TYPE2,
    )


def _kernel2_scan(matvec, XY, A, K, dtype, power_iters, precision) -> PLSFit:
    """Kernel algorithm #2 component loop, abstracted over the XX matvec.

    `matvec(r) -> XX·r` lets callers supply the Gram matrix implicitly:
    the plain fit passes `lambda r: XX @ r`; the LOO downdate passes
    `lambda r: XX @ r − x (xᵀ r)` so the per-fold K×K matrix is never
    materialized — and under `vmap` over folds the XX@r matvecs batch
    into a single (K, K) × (K, F) matmul.
    """
    M = XY.shape[1]
    comp = precision == "compensated"

    with _prec_ctx(precision):

        def step(carry, a):
            if comp:
                XYc, XYe, Pb, Rb = carry
            else:
                XYc, Pb, Rb = carry
            if M == 1:
                w = XYc[:, 0]
            else:
                C = XYc.T @ XYc
                q0 = dominant_eigenvector(C, power_iters)
                w = XYc @ q0
            w = w / jnp.sqrt(w @ w)
            r = w - Rb.T @ (Pb @ w)
            if comp:
                r = r - Rb.T @ (Pb @ r)  # twice-is-enough (see _fit_kernel)
            v = matvec(r)
            tt = r @ v
            p = v / tt
            q = (XYc.T @ r) / tt
            Pb = Pb.at[a].set(p)
            Rb = Rb.at[a].set(r)
            if comp:
                XYc, XYe = _dd_deflate(XYc, XYe, p, q, tt)
                return (XYc, XYe, Pb, Rb), (w, q)
            XYc = XYc - jnp.outer(p, q) * tt
            return (XYc, Pb, Rb), (w, q)

        # data-derived zeros: see _fit_kernel (shard_map varying-axis match)
        zbuf = jnp.zeros((A, K), dtype) + XY[0, 0] * 0
        carry0 = (
            (XY, jnp.zeros_like(XY), zbuf, zbuf) if comp
            else (XY, zbuf, zbuf)
        )
        carry, (Ws, Qs) = jax.lax.scan(step, carry0, jnp.arange(A))
        Pb, Rb = carry[-2], carry[-1]

    return PLSFit(
        W=Ws.T,
        P=Pb.T,
        Q=Qs.T,
        R=Rb.T,
        T=jnp.zeros((0, A), dtype),
        method=METHOD.KERNEL_TYPE2,
    )


def fit_from_stats(
    XX: jnp.ndarray,
    XY: jnp.ndarray,
    A: int,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> PLSFit:
    """Kernel algorithm #2 fit from precomputed cross-products XX = XᵀX
    (K, K) and XY = XᵀY (K, M).

    This is the scalable path for huge N: XX/XY are one streaming pass over
    the (possibly sharded) data, and the component loop never touches X.
    It is also the basis of the O(K²)-per-fold rank-1 LOO downdate
    (cv/loo.py): XXᵢ = XX − xᵢxᵢᵀ, XYᵢ = XY − xᵢyᵢᵀ.

    precision="dd" runs the full double-float component loop
    (models/kernel_dd.py) — pass pair statistics via
    fit_from_stats_dd directly to keep the accumulator's lo parts.
    """
    if precision == "dd":
        from pls_tpu.models.kernel_dd import fit_from_stats_dd

        return fit_from_stats_dd(XX, XY, A, power_iters=power_iters)
    return _fit_from_stats_jit(
        XX, XY, A, power_iters=power_iters, precision=precision
    )


@partial(jax.jit, static_argnames=("A", "power_iters", "precision"))
def _fit_from_stats_jit(
    XX: jnp.ndarray,
    XY: jnp.ndarray,
    A: int,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> PLSFit:
    return _kernel2_scan(
        lambda r: XX @ r, XY, A, XX.shape[0], XX.dtype, power_iters, precision
    )


@partial(jax.jit, static_argnames=("A", "power_iters", "precision"))
def fit_from_stats_blockdowndated(
    XX: jnp.ndarray,
    XY: jnp.ndarray,
    Xf: jnp.ndarray,
    Yf: jnp.ndarray,
    A: int,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> PLSFit:
    """Fold fit from global statistics with an IMPLICIT rank-Nf BLOCK
    downdate: behaves exactly like
    ``fit_from_stats(XX − XfᵀXf, XY − XfᵀYf, A)`` but never materializes
    the K×K downdated matrix — the matvec is
    (XX − XfᵀXf) r = XX r − Xfᵀ (Xf r).

    This is the k-fold / LSO generalization of the rank-1 LOO downdate
    (`fit_from_stats_downdated`): per fold O(K²·A) for the XX matvecs
    plus O(Nf·K·A) for the two fold-block matvecs, vs O(N·K²) per fold
    for a masked refit — at the 1M×10k north-star shape with k=10 that
    is ~100× less work per fold, and Xf (the held-out block) is the only
    X-sized object a fold ever touches.  Zero rows in Xf are exact
    padding (they contribute nothing to either downdate), so equal-size
    zero-padded fold blocks vmap (cv/kfold.cv_kfold_downdate).

    Xf may be stored bfloat16 (x_storage speed mode): both fold-block
    contractions then accumulate in f32 via `preferred_element_type`,
    matching the fit()/StatsAccumulator narrow-X policy.

    Reference analogue: the k-fold refits of Model::cv_LSO
    (/root/reference/src/pls.cpp:512-549), reformulated statistics-side.
    """
    acc = XX.dtype
    if Yf.ndim == 1:
        Yf = Yf[:, None]
    if Xf.dtype.itemsize < 4 and acc.itemsize >= 4:
        XYf = XY - jax.lax.dot_general(
            Xf, Yf.astype(Xf.dtype), (((0,), (0,)), ((), ())),
            preferred_element_type=acc,
        )

        def matvec(r):
            tr = jax.lax.dot_general(
                Xf, r.astype(Xf.dtype), (((1,), (0,)), ((), ())),
                preferred_element_type=acc,
            )
            down = jax.lax.dot_general(
                Xf, tr.astype(Xf.dtype), (((0,), (0,)), ((), ())),
                preferred_element_type=acc,
            )
            return XX @ r - down

    else:
        XYf = XY - Xf.T @ Yf

        def matvec(r):
            return XX @ r - Xf.T @ (Xf @ r)

    return _kernel2_scan(
        matvec, XYf, A, XX.shape[0], acc, power_iters, precision
    )


@partial(jax.jit, static_argnames=("A", "power_iters", "precision"))
def fit_from_stats_downdated(
    XX: jnp.ndarray,
    XY: jnp.ndarray,
    x: jnp.ndarray,
    y: jnp.ndarray,
    A: int,
    *,
    power_iters: int | None = None,
    precision: str | None = "highest",
) -> PLSFit:
    """LOO-fold fit from global statistics with an IMPLICIT rank-1
    downdate: behaves exactly like fit_from_stats(XX − xxᵀ, XY − xyᵀ, A)
    but never materializes the K×K downdated matrix — the matvec is
    (XX − xxᵀ) r = XX r − x (xᵀ r).  vmap over (x, y) to run all folds
    as batched matmuls against the single shared XX."""
    XYi = XY - jnp.outer(x, y)
    return _kernel2_scan(
        lambda r: XX @ r - x * (x @ r),
        XYi, A, XX.shape[0], XX.dtype, power_iters, precision,
    )
