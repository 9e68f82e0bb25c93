"""Fused deflation pass for kernel-PLS type 1, as a Pallas kernel for
NVIDIA Hopper (through Triton).

The reference's per-component hot loop (upstream `src/pls.cpp:418-421`)
reads X twice:  t = X r  (pass 1),  p = Xᵀ t  (pass 2), plus tt = tᵀt.
The update moves about one flop per byte, far below any accelerator's
ridge point, so its cost is the bytes of X it reads.  XLA runs it as two
dependent matrix-vector products and reads X from device memory twice.

The kernel reads X from device memory once.  A row tile (BN whole rows)
is loaded into registers, and both contractions use it there:

    tᵢ  = Σ_k Xᵢ ⊙ r           (exact f32 FMA, reduced across the block)
    acc += Σ_rows Xᵢ ⊙ tᵢ       (the program's private K-length partial)

Blocks on the GPU run in parallel and in no fixed order, so no sum can
be carried from one block to the next.  The grid is a fixed number of
persistent programs (`_PROGRAMS`); each walks row tiles pid, pid + P, ...
and keeps its partial of p in registers, written once at the end to a
(programs, K) buffer that one XLA reduce sums.  Partials, not atomics,
so that the result is the same from run to run.  tt = tᵀt is computed
outside the kernel as r·p (= rᵀXᵀXr), one K-length dot at HIGHEST.

A row is NK chunks of BK columns (BK a power of two, NK·BK ≥ K); ragged
edges are masked loads, so X is never padded or copied.  Holding whole
rows in registers bounds K at 16384 (`pallas_supported`); element
offsets are 32-bit, which bounds X at 2³¹ elements.

bf16 X is upcast in registers; t and p stay f32, so X's own rounding is
the only error the narrow storage adds.

Tile and warp counts were chosen by a sweep on an H100 SXM (docs/PERF.md):
264 programs (two per SM) with 32-64 f32 elements of the tile per thread.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

# backends whose compiler lowers this kernel (Pallas through Triton)
KERNEL_BACKENDS = frozenset({"gpu"})

# persistent programs: two per SM of the H100 (132 SMs)
_PROGRAMS = 264
# widest chunk of a row that is one masked vector load
_BK = 2048
# whole rows live in registers: at most this many columns
_MAX_K = 16384
# element offsets into X are int32
_MAX_ELEMENTS = 2**31 - 1


def _shape_fits(N: int, K: int) -> bool:
    """Whole rows fit in registers and every element offset fits int32."""
    return K <= _MAX_K and N * K <= _MAX_ELEMENTS


def _tiles(K: int, itemsize: int) -> tuple[int, int, int, int]:
    """(BN, BK, NK, warps): rows per tile, columns per chunk, chunks per
    row, warps per program.  The measured best (docs/PERF.md): a 16384-
    element tile over 8 warps, except f32 rows of at most 2048 columns
    (16 warps) and f32 rows of more than 8192 (a 32768-element tile over
    16 warps)."""
    bk = min(_BK, pl.next_power_of_2(K))
    nk = pl.cdiv(K, bk)
    width = nk * bk
    if itemsize == 4 and width > 8192:
        tile, warps = 32768, 16
    elif itemsize == 4 and width <= 2048:
        tile, warps = 16384, 16
    else:
        tile, warps = 16384, 8
    bn = max(1, tile // width)
    return 1 << (bn.bit_length() - 1), bk, nk, warps


def _deflate_kernel(x_ref, r_ref, t_ref, part_ref, *, bn, bk, nk, n_iters):
    """One persistent program: walks row tiles pid, pid + P, ...; each
    tile is read once into registers and used for both t and p."""
    N, K = x_ref.shape
    pid = pl.program_id(0)
    nprog = pl.num_programs(0)
    sub = jnp.arange(bn, dtype=jnp.int32)
    cols = [c * bk + jnp.arange(bk, dtype=jnp.int32) for c in range(nk)]
    cmask = [c < K for c in cols]
    r = [plgpu.load(r_ref.at[c], mask=m, other=0.0) for c, m in zip(cols, cmask)]

    def body(it, p_acc):
        rows = (pid + it * nprog) * bn + sub
        rmask = rows < N
        x = [
            plgpu.load(
                x_ref.at[rows[:, None], c[None, :]],
                mask=rmask[:, None] & m[None, :], other=0.0,
            ).astype(jnp.float32)
            for c, m in zip(cols, cmask)
        ]
        t = sum(jnp.sum(xc * rc[None, :], axis=1) for xc, rc in zip(x, r))
        plgpu.store(t_ref.at[rows], t, mask=rmask)
        return tuple(
            pa + jnp.sum(xc * t[:, None], axis=0) for pa, xc in zip(p_acc, x)
        )

    p_acc = jax.lax.fori_loop(
        0, n_iters, body, tuple(jnp.zeros((bk,), jnp.float32) for _ in cols)
    )
    for c, m, pa in zip(cols, cmask, p_acc):
        plgpu.store(part_ref.at[pid * K + c], pa, mask=m)


def _deflate_partials(X: jnp.ndarray, r: jnp.ndarray, interpret: bool = False):
    """The kernel itself: t (N,) and the (programs, K) partials of p."""
    N, K = X.shape
    if X.dtype not in (jnp.float32, jnp.bfloat16):
        raise ValueError(
            f"the deflation kernel supports float32/bfloat16 X, got "
            f"{X.dtype}: use deflate_pass_xla"
        )
    if not _shape_fits(N, K):
        raise ValueError(
            f"the deflation kernel needs K <= {_MAX_K} and fewer than 2^31 "
            f"elements of X, got {N}x{K}: use deflate_pass_xla"
        )
    bn, bk, nk, warps = _tiles(K, X.dtype.itemsize)
    n_tiles = pl.cdiv(N, bn)
    programs = min(_PROGRAMS, n_tiles)
    kernel = functools.partial(
        _deflate_kernel, bn=bn, bk=bk, nk=nk, n_iters=pl.cdiv(n_tiles, programs)
    )
    t, part = pl.pallas_call(
        kernel,
        grid=(programs,),
        out_shape=[
            jax.ShapeDtypeStruct((N,), jnp.float32),
            jax.ShapeDtypeStruct((programs * K,), jnp.float32),
        ],
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=warps, num_stages=2),
        interpret=interpret,
        name="pls_deflate",
        cost_estimate=pl.CostEstimate(
            flops=4 * N * K,
            bytes_accessed=N * K * X.dtype.itemsize,
            transcendentals=0,
        ),
    )(X, r.astype(jnp.float32))
    return t, part.reshape(programs, K)


@functools.partial(jax.jit, static_argnames=("interpret",))
def _deflate_pass_pallas(X: jnp.ndarray, r: jnp.ndarray, interpret: bool = False):
    """X may be float32 or bfloat16; t, tt and p are always float32."""
    t, part = _deflate_partials(X, r, interpret)
    p = jnp.sum(part, axis=0)
    tt = jax.lax.dot_general(
        r.astype(jnp.float32), p, (((0,), (0,)), ((), ())),
        precision=jax.lax.Precision.HIGHEST,
    )
    return t, tt, p


def deflate_pass_xla(X: jnp.ndarray, r: jnp.ndarray):
    """Two-matmul formulation (two X passes): the path wherever the
    kernel does not compile, and the baseline it is timed against.

    When X is stored in a sub-f32 dtype (bf16 speed mode), the matvecs
    keep X's narrow dtype on the read side and accumulate in f32
    (`preferred_element_type`); t/tt/p are always f32.

    `lax.dot_general` requires matching operand dtypes, so the f32 t is
    rounded back to bf16 for the second contraction p = Xᵀt.  The kernel
    keeps t in f32, so this path carries the larger per-component error
    of the two; both are within the ~1e-3 x_storage budget
    (tests/test_bf16.py)."""
    if X.dtype.itemsize < 4:
        acc = jnp.float32
        t = jax.lax.dot_general(
            X, r.astype(X.dtype), (((1,), (0,)), ((), ())),
            preferred_element_type=acc,
        )
        p = jax.lax.dot_general(
            X, t.astype(X.dtype), (((0,), (0,)), ((), ())),
            preferred_element_type=acc,
        )
        return t, t @ t, p
    t = X @ r
    return t, t @ t, X.T @ t


def pallas_supported(
    N: int, K: int, itemsize: int = 4, backend: str | None = None
) -> bool:
    """True when the kernel compiles for `backend` (default: JAX's
    default backend) at this shape: the backend is in KERNEL_BACKENDS,
    X is f32 or bf16 (by itemsize), K ≤ 16384 and X has fewer than 2³¹
    elements."""
    if backend is None:
        backend = jax.default_backend()
    return backend in KERNEL_BACKENDS and itemsize in (2, 4) and _shape_fits(N, K)


def deflate_pass(
    X: jnp.ndarray, r: jnp.ndarray, *, use_pallas: bool | None = None,
    interpret: bool = False,
):
    """Single-pass (t = X r, tt = tᵀt, p = Xᵀ t).

    use_pallas=None: the kernel where `pallas_supported`, XLA otherwise.
    use_pallas=True: the kernel, or ValueError where the shape is beyond
    its limits; `interpret=True` runs it in the Pallas interpreter (for
    tests on a host without a card).
    """
    N, K = X.shape
    if use_pallas is None:
        use_pallas = pallas_supported(N, K, X.dtype.itemsize)
    if use_pallas and X.dtype not in (jnp.float32, jnp.bfloat16):
        # a dtype the kernel does not implement (e.g. f64 under
        # jax_enable_x64): the exact XLA path, not a silent downgrade
        use_pallas = False
    if not use_pallas:
        return deflate_pass_xla(X, r)
    return _deflate_pass_pallas(X, r, interpret=interpret)
