"""Hardware parity gate: the compiled deflation kernel and the default fit
path on an NVIDIA GPU, as pass/fail tests.

Run on a GPU host with

    JAX_PLATFORMS=cuda python -m pytest -m gpu tests/test_gpu_hw.py

Without a GPU every test here skips (the `gpu` fixture decides, at run
time).  Covers, on the card:

  - the kernel's exactness: f32 ≤ 1e-5 and bf16 ≤ 2e-3 relative against
    a float64 NumPy truth (interpret-mode semantics are pinned by
    tests/test_pallas.py; this is the Triton lowering);
  - that the default fit dispatches the kernel and agrees with XLA;
  - fit parity with the reference's golden coefficients (nir, f32 floor);
  - the CV paths and the bf16 and dd fits.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def gpu():
    import jax

    if jax.devices()[0].platform != "gpu":
        pytest.skip(f"needs a GPU; JAX's first device is "
                    f"{jax.devices()[0].platform}")
    return jax.devices()[0]


@pytest.fixture(scope="module")
def operand(gpu):
    import jax
    import jax.numpy as jnp

    N, K = 16384, 2048
    kx, kr = jax.random.split(jax.random.key(0))
    X = jax.random.normal(kx, (N, K), jnp.float32)
    r = jax.random.normal(kr, (K,), jnp.float32)
    Xd = np.asarray(X, np.float64)
    rd = np.asarray(r, np.float64)
    td = Xd @ rd
    return X, r, td, Xd.T @ td, float(td @ td)


class TestKernelExactness:
    def test_f32_kernel_vs_f64_truth(self, operand):
        from pls_tpu.ops.deflate import _deflate_pass_pallas, pallas_supported

        X, r, td, pd, ttd = operand
        assert pallas_supported(*X.shape, 4)
        t, tt, p = _deflate_pass_pallas(X, r)
        err_t = float(np.abs(np.asarray(t) - td).max() / np.abs(td).max())
        err_p = float(np.abs(np.asarray(p) - pd).max() / np.abs(pd).max())
        err_tt = abs(float(tt) - ttd) / ttd
        assert err_t < 1e-5, f"t rel err {err_t:.2e}"
        assert err_p < 1e-5, f"p rel err {err_p:.2e}"
        assert err_tt < 1e-5, f"tt rel err {err_tt:.2e}"

    def test_bf16_kernel_vs_f64_truth(self, operand):
        import jax.numpy as jnp

        from pls_tpu.ops.deflate import _deflate_pass_pallas

        X, r, _, pd, _ = operand
        Xb = X.astype(jnp.bfloat16)
        # the bf16 truth is the f64 contraction of the ROUNDED X — the
        # kernel's only permitted error source is X's own representation
        Xbd = np.asarray(Xb, np.float64)
        rd = np.asarray(r, np.float64)
        tbd = Xbd @ rd
        pbd = Xbd.T @ tbd
        t, tt, p = _deflate_pass_pallas(Xb, r)
        err_p = float(np.abs(np.asarray(p) - pbd).max() / np.abs(pbd).max())
        assert err_p < 2e-3, f"bf16 p rel err {err_p:.2e}"
        err_vs_f32truth = float(
            np.abs(np.asarray(p) - pd).max() / np.abs(pd).max()
        )
        assert err_vs_f32truth < 5e-3, err_vs_f32truth

    def test_deflate_pass_auto_routes_to_kernel(self, operand):
        """deflate_pass with use_pallas=None must take the kernel path on
        this backend and agree with the explicit kernel bit-for-bit."""
        from pls_tpu.ops.deflate import _deflate_pass_pallas, deflate_pass

        X, r, *_ = operand
        t_auto, tt_auto, p_auto = deflate_pass(X, r)
        t_k, tt_k, p_k = _deflate_pass_pallas(X, r)
        np.testing.assert_array_equal(np.asarray(p_auto), np.asarray(p_k))
        np.testing.assert_array_equal(np.asarray(t_auto), np.asarray(t_k))


class TestAutoDispatchOnHardware:
    def test_decision_table_selects_kernel_here(self, gpu):
        from pls_tpu.models.kernel_pls import auto_pallas

        assert auto_pallas(131072, 2048, 4)
        assert not auto_pallas(1024, 64, 4)  # tiny operand

    def test_default_fit_equals_xla_path(self, gpu):
        """fit() with no flags (auto → kernel) vs the XLA scan.

        Y carries explicit noise so every component is well-conditioned
        (with noiseless Y = XB, components beyond rank(B) fit numerical
        noise and amplify any f32 path difference)."""
        import jax
        import jax.numpy as jnp

        import pls_tpu as pt

        kx, ky, ke = jax.random.split(jax.random.key(3), 3)
        N, K, A = 65536, 2048, 6
        X = jax.random.normal(kx, (N, K), jnp.float32)
        with jax.default_matmul_precision("highest"):
            Y = (
                X @ jax.random.normal(ky, (K, 2), jnp.float32) / K**0.5
                + 0.05 * jax.random.normal(ke, (N, 2), jnp.float32)
            )
        f_auto = pt.fit(X, Y, A)
        f_xla = pt.fit(X, Y, A, use_pallas=False)
        B_auto = np.asarray(pt.coefficients(f_auto), np.float64)
        B_xla = np.asarray(pt.coefficients(f_xla), np.float64)
        rel = np.abs(B_auto - B_xla).max() / np.abs(B_xla).max()
        assert rel < 1e-3, f"auto vs xla coefficient rel err {rel:.2e}"
        Xh = np.asarray(X[:4096], np.float64)
        yh_a, yh_x = Xh @ B_auto, Xh @ B_xla
        prel = np.abs(yh_a - yh_x).max() / np.abs(yh_x).max()
        assert prel < 1e-4, f"prediction rel err {prel:.2e}"


class TestFitParityOnHardware:
    def test_nir_coefficients_f32_floor(self, gpu, golden):
        """The reference's golden nir coefficients, reproduced on the GPU
        at the f32 representation floor (CPU x64 parity is 1e-9;
        tests/test_fit_parity.py)."""
        import jax
        import jax.numpy as jnp

        import pls_tpu as pt

        X = jnp.asarray(golden("nir_Xz"), jnp.float32)
        Y = jnp.asarray(golden("nir_Yz"), jnp.float32)
        f = pt.fit(X, Y, 10, precision="highest")
        B = np.asarray(pt.coefficients(f))
        Bg = golden("nir_B")
        rel = np.abs(B - Bg).max() / np.abs(Bg).max()
        assert rel < 5e-3, f"nir coefficient rel err vs reference {rel:.2e}"
        with jax.default_matmul_precision("highest"):
            ev = np.stack(
                [
                    np.asarray(pt.explained_variance(f, X, Y, c))
                    for c in range(1, 11)
                ]
            )
        np.testing.assert_allclose(ev, golden("nir_ev"), atol=1e-3)

    def test_loo_downdate_runs_on_hw(self, gpu, golden):
        import jax.numpy as jnp

        import pls_tpu as pt

        X = jnp.asarray(golden("nir_Xz"), jnp.float32)
        Y = jnp.asarray(golden("nir_Yz"), jnp.float32)
        res = pt.cv_loo_downdate(X, Y, 5, precision="highest")
        rmse_hw = np.asarray(pt.validation(res, pt.MSE)) ** 0.5
        rmse_ref = golden("nir_loo_rmse")[:, :5]
        rel = np.abs(rmse_hw - rmse_ref).max() / np.abs(rmse_ref).max()
        assert rel < 2e-2, f"LOO RMSE rel err vs reference {rel:.2e}"


class TestCVPathsOnHardware:
    def test_kfold_downdate_matches_bruteforce_on_hw(self, gpu, golden):
        import jax.numpy as jnp

        import pls_tpu as pt

        X = jnp.asarray(golden("nir_Xz"), jnp.float32)
        Y = jnp.asarray(golden("nir_Yz"), jnp.float32)
        brute = pt.cv_kfold(X, Y, 4, k=5, key=3, method=pt.KERNEL_TYPE2,
                            precision="highest")
        fast = pt.cv_kfold_downdate(X, Y, 4, k=5, key=3, precision="highest")
        err = np.abs(
            np.asarray(fast.errors) - np.asarray(brute.errors)
        ).max()
        # f32 floor of the statistics-side formulation: XX − XfᵀXf
        # cancels where the masked refit computes the small fold
        # statistics directly (CPU x64 parity is 1e-9, tests/test_cv.py)
        assert err < 1e-2, f"block-downdate vs brute abs err {err:.2e}"

    def test_bf16_x_storage_fit_on_hw(self, gpu):
        import jax
        import jax.numpy as jnp

        import pls_tpu as pt

        kx, ky, ke = jax.random.split(jax.random.key(7), 3)
        N, K, A = 32768, 1024, 4
        X = jax.random.normal(kx, (N, K), jnp.float32)
        with jax.default_matmul_precision("highest"):
            Y = (
                X @ jax.random.normal(ky, (K, 1), jnp.float32) / K**0.5
                + 0.05 * jax.random.normal(ke, (N, 1), jnp.float32)
            )
        f32 = pt.fit(X, Y, A)
        f16 = pt.fit(X, Y, A, x_storage="bf16")
        assert f16.W.dtype == jnp.float32
        B32 = np.asarray(pt.coefficients(f32))
        B16 = np.asarray(pt.coefficients(f16))
        rel = np.abs(B16 - B32).max() / np.abs(B32).max()
        assert rel < 2e-2, f"bf16 storage rel err {rel:.2e}"

    def test_onepass_kfold_matches_brute_on_hw(self, gpu):
        import jax
        import jax.numpy as jnp

        from pls_tpu.cv.kfold import (
            cv_kfold, cv_kfold_onepass, fold_residual_chunk,
            kfold_assignments)
        from pls_tpu.models.streaming import FoldStatsAccumulator

        kx, ky, ke = jax.random.split(jax.random.key(11), 3)
        N, K, M, A, k = 4096, 256, 3, 5, 4
        X = jax.random.normal(kx, (N, K), jnp.float32)
        with jax.default_matmul_precision("highest"):
            Y = (X @ jax.random.normal(ky, (K, M), jnp.float32) / K**0.5
                 + 0.1 * jax.random.normal(ke, (N, M), jnp.float32))
        assign = np.asarray(kfold_assignments(N, k, key=5))
        acc = FoldStatsAccumulator(K, M, k, precision="highest")
        for s in range(0, N, 1024):
            acc.update(X[s:s + 1024], Y[s:s + 1024], assign[s:s + 1024])
        summary = cv_kfold_onepass(acc, A, precision="highest")
        brute = cv_kfold(X, Y, A, k=k, assignments=assign,
                         precision="highest")
        press_brute = np.asarray(
            jnp.sum(brute.errors**2, axis=1), np.float64)
        rel = np.abs(summary.press - press_brute).max() / press_brute.max()
        assert rel < 1e-3, f"closed-form vs brute PRESS rel {rel:.2e}"
        with jax.default_matmul_precision("highest"):
            errs = np.concatenate([
                np.asarray(fold_residual_chunk(
                    summary.B, X[s:s + 1024], Y[s:s + 1024],
                    jnp.asarray(assign[s:s + 1024])))
                for s in range(0, N, 1024)
            ])
        press_sweep = np.einsum(
            "nam,nam->am", errs.astype(np.float64),
            errs.astype(np.float64)).T
        rel2 = np.abs(press_sweep - summary.press).max() / press_brute.max()
        assert rel2 < 1e-4, f"sweep vs closed-form rel {rel2:.2e}"

    def test_dd_fit_runs_and_matches_plain(self, gpu):
        import jax
        import jax.numpy as jnp

        import pls_tpu as pt

        kx, ky = jax.random.split(jax.random.key(3))
        N, K, A = 2048, 128, 4
        X = jax.random.normal(kx, (N, K), jnp.float32)
        with jax.default_matmul_precision("highest"):
            Y = X @ jax.random.normal(ky, (K, 2), jnp.float32) / K**0.5
        B_dd = np.asarray(pt.coefficients(pt.fit(X, Y, A, precision="dd")))
        B_pl = np.asarray(
            pt.coefficients(pt.fit(X, Y, A, precision="highest")))
        rel = np.abs(B_dd - B_pl).max() / np.abs(B_pl).max()
        assert rel < 1e-3, f"dd vs plain rel {rel:.2e}"
