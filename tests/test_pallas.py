"""Fused deflation kernel tests (Pallas interpreter on CPU).

The compiled kernel is checked on a GPU by chip_smoke.py and
tests/test_gpu_hw.py; here its semantics are pinned in interpret mode
against a float64 truth and the two-matmul XLA formulation it replaces:
ragged N, K not a multiple of the chunk, bf16 X, the per-program
partials of p, the tile rule and the dispatch rule.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from pls_tpu.ops import deflate
from pls_tpu.ops.deflate import (
    _deflate_partials,
    _deflate_pass_pallas,
    _tiles,
    deflate_pass,
    deflate_pass_xla,
    pallas_supported,
)


def _truth(X, r):
    Xd = np.asarray(X, np.float64)
    rd = np.asarray(r, np.float64)
    t = Xd @ rd
    return t, float(t @ t), Xd.T @ t


def _rel(a, b):
    a = np.asarray(a, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize(
    "N,K", [(256, 128), (300, 200), (64, 640), (1024, 512), (37, 1500), (5, 3)]
)
def test_kernel_matches_xla(N, K):
    rng = np.random.default_rng(0)
    X = jnp.asarray(rng.normal(size=(N, K)), jnp.float32)
    r = jnp.asarray(rng.normal(size=(K,)), jnp.float32)
    t, tt, p = _deflate_pass_pallas(X, r, interpret=True)
    t2, tt2, p2 = deflate_pass_xla(X, r)
    np.testing.assert_allclose(np.asarray(t), np.asarray(t2), atol=2e-4)
    assert abs(float(tt - tt2)) / float(tt2) < 1e-5
    scale = float(jnp.max(jnp.abs(p2)))
    np.testing.assert_allclose(
        np.asarray(p) / scale, np.asarray(p2) / scale, atol=1e-5
    )


@pytest.mark.parametrize("N", [1, 7, 130, 1000])
def test_ragged_rows_exact(N):
    """N not a multiple of the row tile (nor of tile × programs): the
    masked rows must not perturb t, tt or p, and t has exactly N rows."""
    rng = np.random.default_rng(1)
    K = 128
    X = jnp.asarray(rng.normal(size=(N, K)), jnp.float32)
    r = jnp.asarray(rng.normal(size=(K,)), jnp.float32)
    t, tt, p = _deflate_pass_pallas(X, r, interpret=True)
    assert t.shape == (N,)
    td, ttd, pd = _truth(X, r)
    assert _rel(t, td) < 1e-6
    assert abs(float(tt) - ttd) / ttd < 1e-6
    assert _rel(p, pd) < 1e-6


@pytest.mark.parametrize("K", [2049, 2500, 4097])
def test_k_not_multiple_of_chunk(K):
    """K spans several 2048-column chunks with a ragged last one: the
    masked columns must read as zero and never be written."""
    rng = np.random.default_rng(2)
    N = 24
    bn, bk, nk, _ = _tiles(K, 4)
    assert bk == 2048 and nk * bk > K
    X = jnp.asarray(rng.normal(size=(N, K)), jnp.float32)
    r = jnp.asarray(rng.normal(size=(K,)), jnp.float32)
    t, tt, p = _deflate_pass_pallas(X, r, interpret=True)
    assert p.shape == (K,)
    td, ttd, pd = _truth(X, r)
    assert _rel(t, td) < 1e-6
    assert _rel(p, pd) < 1e-6


def test_bf16_x_upcast_in_registers():
    """bf16 X: t and p are f32, and the only error is X's own rounding —
    against the f64 contraction of the ROUNDED X the kernel is at f32
    accuracy, far tighter than the XLA path, which rounds t to bf16."""
    rng = np.random.default_rng(3)
    X = jnp.asarray(rng.normal(size=(200, 300)), jnp.bfloat16)
    r = jnp.asarray(rng.normal(size=(300,)), jnp.float32)
    t, tt, p = _deflate_pass_pallas(X, r, interpret=True)
    assert t.dtype == tt.dtype == p.dtype == jnp.float32
    td, ttd, pd = _truth(X, r)
    assert _rel(t, td) < 1e-6
    assert _rel(p, pd) < 1e-6
    _, _, p_xla = deflate_pass_xla(X, r)
    assert _rel(p_xla, pd) > 10 * _rel(p, pd)


def test_per_program_partials():
    """Each program's row of the partials buffer is the f64 sum over the
    row tiles it owns (tiles pid, pid + P, ...), so the reduce over
    programs is the whole p."""
    rng = np.random.default_rng(4)
    N, K = 300, 64
    X = jnp.asarray(rng.normal(size=(N, K)), jnp.float32)
    r = jnp.asarray(rng.normal(size=(K,)), jnp.float32)
    t, part = _deflate_partials(X, r, interpret=True)
    bn = _tiles(K, 4)[0]
    programs = part.shape[0]
    assert programs == min(deflate._PROGRAMS, -(-N // bn))
    Xd = np.asarray(X, np.float64)
    td = Xd @ np.asarray(r, np.float64)
    tile = np.arange(N) // bn
    for pid in range(programs):
        rows = tile % programs == pid
        expect = Xd[rows].T @ td[rows]
        np.testing.assert_allclose(
            np.asarray(part[pid]), expect, rtol=1e-5, atol=1e-4
        )


@pytest.mark.parametrize("itemsize", [4, 2])
@pytest.mark.parametrize("K", [1, 3, 200, 2048, 2049, 5000, 10000, 16384])
def test_tile_rule(K, itemsize):
    """BK is a power of two ≤ 2048 and NK chunks cover K; BN is a power
    of two; a tile holds at most 32768 elements (16384 unless f32 rows
    are wider than 8192), spread over 8 or 16 warps."""
    bn, bk, nk, warps = _tiles(K, itemsize)
    assert bk & (bk - 1) == 0 and bk <= 2048
    assert nk * bk >= K > (nk - 1) * bk
    assert bn >= 1 and bn & (bn - 1) == 0
    wide_f32 = itemsize == 4 and nk * bk > 8192
    assert bn * nk * bk <= (32768 if wide_f32 else 16384) or bn == 1
    assert warps in (8, 16)


def test_auto_dispatch_on_cpu_uses_xla():
    # on CPU backends deflate_pass must transparently use the XLA path,
    # and interpret mode is never chosen for the caller
    rng = np.random.default_rng(2)
    X = jnp.asarray(rng.normal(size=(64, 32)), jnp.float32)
    r = jnp.asarray(rng.normal(size=(32,)), jnp.float32)
    t, tt, p = deflate_pass(X, r, interpret=True)  # auto
    t2, tt2, p2 = deflate_pass_xla(X, r)
    np.testing.assert_allclose(np.asarray(t), np.asarray(t2), atol=0)
    np.testing.assert_allclose(np.asarray(p), np.asarray(p2), atol=0)


def test_backend_table():
    """Dispatch is decided by what the backend can compile, from one
    table: the Triton-route kernel compiles for "gpu" only."""
    assert deflate.KERNEL_BACKENDS == frozenset({"gpu"})
    assert pallas_supported(131072, 2048, 4, backend="gpu")
    assert pallas_supported(131072, 2048, 2, backend="gpu")
    for backend in ("cpu", "rocm"):
        assert not pallas_supported(131072, 2048, 4, backend=backend)
    assert jax.default_backend() == "cpu"  # conftest forces CPU
    assert not pallas_supported(131072, 2048, 4)
    # shapes the kernel does not take: K beyond whole-row registers,
    # 2³¹ elements, f64
    assert not pallas_supported(1024, 16385, 4, backend="gpu")
    assert pallas_supported(1024, 16384, 4, backend="gpu")
    assert not pallas_supported(2**21, 1024, 4, backend="gpu")
    assert not pallas_supported(1024, 1024, 8, backend="gpu")


@pytest.mark.parametrize("N,K", [(2**21, 1024), (1024, 16385)])
@pytest.mark.parametrize("entry", ["deflate_pass", "fit", "shardmap"])
def test_explicit_kernel_rejects_shapes_beyond_its_limits(entry, N, K):
    """use_pallas=True must raise, not overflow int32 offsets or spill
    whole rows, where pallas_supported says no.  Traced shapes only: no
    2³¹-element array is made."""
    from pls_tpu.models.kernel_pls import fit
    from pls_tpu.parallel.mesh import make_pls_mesh
    from pls_tpu.parallel.sharded import fit_rowsharded_shardmap

    assert not pallas_supported(N, K, 4, backend="gpu")
    mesh = make_pls_mesh(rows=1, folds=1, devices=jax.devices()[:1])
    run = {
        "deflate_pass": lambda X, Y, r: deflate_pass(
            X, r, use_pallas=True, interpret=True),
        "fit": lambda X, Y, r: fit(X, Y, 2, use_pallas=True),
        "shardmap": lambda X, Y, r: fit_rowsharded_shardmap(
            X, Y, 2, mesh=mesh, use_pallas=True, pallas_interpret=True),
    }[entry]
    shapes = [jax.ShapeDtypeStruct(s, jnp.float32) for s in ((N, K), (N, 2), (K,))]
    with pytest.raises(ValueError, match="2\\^31 elements"):
        jax.eval_shape(run, *shapes)


class TestAutoPallas:
    """Pin the fit's use_pallas=None decision (models/kernel_pls.auto_pallas)."""

    def test_decision_table(self, monkeypatch):
        from pls_tpu.models.kernel_pls import _AUTO_MIN_BYTES, auto_pallas

        assert not auto_pallas(131072, 2048, 4)  # CPU: never
        monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
        assert auto_pallas(131072, 2048, 4)
        # X below the payoff threshold: off; the threshold is in bytes
        n_small = _AUTO_MIN_BYTES // (2048 * 4)
        assert auto_pallas(n_small, 2048, 4)
        assert not auto_pallas(n_small - 8, 2048, 4)
        assert not auto_pallas(n_small, 2048, 2)
        # shapes the kernel cannot take
        assert not auto_pallas(65536, 20000, 4)
        assert not auto_pallas(2**20, 4096, 4)

    def test_fit_auto_is_off_on_cpu_and_matches(self):
        # on this (CPU-default) test backend, auto must silently take the
        # XLA path and produce identical results to use_pallas=False
        from pls_tpu.models.kernel_pls import fit
        from pls_tpu.types import METHOD

        rng = np.random.default_rng(7)
        X = jnp.asarray(rng.normal(size=(40, 12)))
        Y = jnp.asarray(rng.normal(size=(40, 2)))
        f_auto = fit(X, Y, 3, METHOD.KERNEL_TYPE1)  # use_pallas default
        f_off = fit(X, Y, 3, METHOD.KERNEL_TYPE1, use_pallas=False)
        np.testing.assert_allclose(
            np.asarray(f_auto.W), np.asarray(f_off.W), atol=0
        )

    def test_auto_under_vmap_stays_on_xla_path(self):
        # tracer inputs (vmapped CV refits) must not flip pallas on
        from pls_tpu.models.kernel_pls import fit
        from pls_tpu.types import METHOD

        rng = np.random.default_rng(8)
        Xs = jnp.asarray(rng.normal(size=(3, 30, 8)))
        Ys = jnp.asarray(rng.normal(size=(3, 30, 1)))
        Ws = jax.vmap(lambda X, Y: fit(X, Y, 2, METHOD.KERNEL_TYPE1).W)(Xs, Ys)
        for i in range(3):
            np.testing.assert_allclose(
                np.asarray(Ws[i]),
                np.asarray(fit(Xs[i], Ys[i], 2, METHOD.KERNEL_TYPE1,
                               use_pallas=False).W),
                rtol=1e-12,
            )


def test_fit_kernel_path_interpret(monkeypatch):
    """Run the FIT's kernel branch (inside the component lax.scan) in
    interpret mode: results must match the XLA path, with T of N rows."""
    import functools

    from pls_tpu.models.kernel_pls import fit
    from pls_tpu.types import METHOD

    monkeypatch.setattr(
        deflate, "deflate_pass",
        functools.partial(deflate.deflate_pass, interpret=True),
    )
    rng = np.random.default_rng(11)
    N, K, A = 130, 96, 3  # N deliberately NOT a row-tile multiple
    X = jnp.asarray(rng.normal(size=(N, K)), jnp.float32)
    Y = jnp.asarray(rng.normal(size=(N, 2)), jnp.float32)
    f_pal = fit(X, Y, A, METHOD.KERNEL_TYPE1, use_pallas=True,
                precision="highest")
    f_xla = fit(X, Y, A, METHOD.KERNEL_TYPE1, use_pallas=False,
                precision="highest")
    assert f_pal.T.shape == (N, A)
    np.testing.assert_allclose(
        np.asarray(f_pal.W), np.asarray(f_xla.W), rtol=1e-5, atol=1e-6
    )
    np.testing.assert_allclose(
        np.asarray(f_pal.T), np.asarray(f_xla.T), rtol=1e-4, atol=1e-5
    )


def test_unsupported_dtype_falls_back_to_xla():
    """f64 X (jax_enable_x64) must never enter the kernel: explicit
    use_pallas=True takes the exact XLA path, and pallas_supported
    rejects itemsize 8."""
    assert pallas_supported(64, 2048, itemsize=8, backend="gpu") is False
    rng = np.random.default_rng(11)
    X = jnp.asarray(rng.normal(size=(64, 32)))  # f64 under x64 conftest
    r = jnp.asarray(rng.normal(size=(32,)))
    assert X.dtype == jnp.float64
    t, tt, p = deflate_pass(X, r, use_pallas=True)  # no crash, exact path
    np.testing.assert_allclose(np.asarray(t), np.asarray(X @ r), atol=1e-12)
    with pytest.raises(ValueError, match="float32/bfloat16"):
        _deflate_pass_pallas(X, r, interpret=True)
