"""bf16 X-storage speed mode: fit(x_storage="bf16") streams X in
bfloat16 (half the memory bytes per pass) while every contraction accumulates in f32 and all
model state stays f32.

Invariants:
- model arrays come back f32 (never bf16) with the right shapes;
- components/coefficients agree with the f32 fit to bf16-storage
  accuracy (~1e-2 relative: X itself is rounded to 8 mantissa bits, so
  this is the data-representation floor, not accumulation drift);
- predictions from the bf16-storage fit explain the same variance;
- type 1 and type 2 agree with each other under bf16 storage;
- deflate_pass_xla with a narrow-dtype X returns f32 and approximates
  the wide result.
"""

import jax.numpy as jnp
import numpy as np
import pytest

import pls_tpu as pt
from pls_tpu.models import kernel_pls
from pls_tpu.ops.deflate import deflate_pass_xla


def _data(seed=0, n=256, k=48, m=2, a=4):
    rng = np.random.default_rng(seed)
    L = rng.normal(size=(n, a))
    X = L @ rng.normal(size=(a, k)) + 0.1 * rng.normal(size=(n, k))
    Y = L @ rng.normal(size=(a, m)) + 0.1 * rng.normal(size=(n, m))
    X = np.asarray(pt.colwise_z_scores(jnp.asarray(X, jnp.float32)))
    Y = np.asarray(pt.colwise_z_scores(jnp.asarray(Y, jnp.float32)))
    return jnp.asarray(X, jnp.float32), jnp.asarray(Y, jnp.float32)


def _sign_align(B, B_ref):
    return B, B_ref  # coefficients are sign-invariant (B = R Qᵀ)


class TestBF16Storage:
    def test_state_dtypes_and_shapes(self):
        X, Y = _data()
        f = kernel_pls.fit(X, Y, 4, x_storage="bf16")
        for arr in (f.W, f.P, f.Q, f.R, f.T):
            assert arr.dtype == jnp.float32
        assert f.W.shape == (48, 4)
        assert f.T.shape == (256, 4)

    def test_coefficients_match_f32_fit(self):
        X, Y = _data()
        A = 4
        f32fit = kernel_pls.fit(X, Y, A)
        b16fit = kernel_pls.fit(X, Y, A, x_storage="bf16")
        B32 = np.asarray(pt.coefficients(f32fit))
        B16 = np.asarray(pt.coefficients(b16fit))
        # bf16 data floor: ~0.4% per entry; coefficient error stays at
        # that order (scale by the coefficient magnitude, not per-entry)
        err = np.abs(B16 - B32).max() / np.abs(B32).max()
        assert err < 2e-2, err

    def test_explained_variance_preserved(self):
        X, Y = _data()
        f32fit = kernel_pls.fit(X, Y, 4)
        b16fit = kernel_pls.fit(X, Y, 4, x_storage="bf16")
        ev32 = np.asarray(pt.explained_variance(f32fit, X, Y))
        ev16 = np.asarray(pt.explained_variance(b16fit, X, Y))
        np.testing.assert_allclose(ev16, ev32, atol=2e-3)

    def test_type1_type2_agree_under_bf16(self):
        X, Y = _data(seed=1)
        f1 = kernel_pls.fit(X, Y, 3, pt.KERNEL_TYPE1, x_storage="bf16")
        f2 = kernel_pls.fit(X, Y, 3, pt.KERNEL_TYPE2, x_storage="bf16")
        np.testing.assert_allclose(
            np.asarray(pt.coefficients(f1)),
            np.asarray(pt.coefficients(f2)),
            atol=5e-3,
        )

    def test_masked_rows_exact_zero_contribution(self):
        """Masking happens BEFORE the bf16 cast, so masked rows are exact
        zeros and the bf16 fit on masked data equals the bf16 fit on the
        surviving subset."""
        X, Y = _data(seed=2, n=128)
        mask = jnp.asarray(np.r_[np.ones(96), np.zeros(32)], jnp.float32)
        f_masked = kernel_pls.fit(X, Y, 3, row_mask=mask, x_storage="bf16")
        f_subset = kernel_pls.fit(X[:96], Y[:96], 3, x_storage="bf16")
        np.testing.assert_allclose(
            np.asarray(f_masked.W), np.asarray(f_subset.W), atol=1e-5
        )

    def test_bad_storage_value_raises(self):
        X, Y = _data(n=64, k=8)
        with pytest.raises(ValueError, match="x_storage"):
            kernel_pls.fit(X, Y, 2, x_storage="fp8")

    def test_non_kernel_method_raises(self):
        X, Y = _data(n=64, k=8)
        with pytest.raises(ValueError, match="kernel method"):
            kernel_pls.fit(X, Y, 2, pt.METHOD.NIPALS, x_storage="bf16")

    def test_estimator_and_model_plumbing(self):
        X, Y = _data(n=128, k=16)
        reg32 = pt.PLSRegressor(n_components=3).fit(np.asarray(X), np.asarray(Y))
        reg16 = pt.PLSRegressor(n_components=3, x_storage="bf16").fit(
            np.asarray(X), np.asarray(Y)
        )
        assert reg16.get_params()["x_storage"] == "bf16"
        p32, p16 = reg32.predict(np.asarray(X)), reg16.predict(np.asarray(X))
        assert np.abs(p16 - p32).max() / np.abs(p32).max() < 2e-2
        m = pt.PLSModel(X, Y, max_components=3, x_storage="bf16")
        assert m.W.dtype == jnp.float32

    def test_deflate_pass_xla_narrow(self):
        rng = np.random.default_rng(3)
        X = jnp.asarray(rng.normal(size=(200, 64)), jnp.float32)
        r = jnp.asarray(rng.normal(size=(64,)), jnp.float32)
        t32, tt32, p32 = deflate_pass_xla(X, r)
        t16, tt16, p16 = deflate_pass_xla(X.astype(jnp.bfloat16), r)
        assert t16.dtype == jnp.float32
        assert p16.dtype == jnp.float32
        np.testing.assert_allclose(
            np.asarray(t16), np.asarray(t32), rtol=0, atol=5e-2 * float(jnp.abs(t32).max())
        )
        np.testing.assert_allclose(float(tt16), float(tt32), rtol=2e-2)


class TestBF16CVStack:
    """x_storage="bf16" plumbed through the CV stack (r03 verdict #3):
    every CV flavor accepts bf16 X streaming, errors stay within the
    bf16-representation budget of the f32 run, and the accumulator
    accepts narrow chunks with f32 accumulation."""

    def test_cv_loo_close_to_f32(self):
        X, Y = _data(n=48, k=12, m=1, a=3)
        e32 = np.asarray(pt.cv_loo(X, Y, 3).errors)
        e16 = np.asarray(pt.cv_loo(X, Y, 3, x_storage="bf16").errors)
        # held-out residuals are O(0.1-1); bf16 X shifts them by ~1e-2
        assert np.abs(e16 - e32).max() < 5e-2, np.abs(e16 - e32).max()

    def test_cv_kfold_close_to_f32(self):
        X, Y = _data(n=60, k=12, m=2, a=3)
        e32 = np.asarray(pt.cv_kfold(X, Y, 3, k=5, key=2).errors)
        e16 = np.asarray(
            pt.cv_kfold(X, Y, 3, k=5, key=2, x_storage="bf16").errors
        )
        assert np.abs(e16 - e32).max() < 5e-2

    def test_cv_lso_close_to_f32(self):
        X, Y = _data(n=40, k=10, m=1, a=3)
        import jax

        parts = pt.cv.lso.random_partitions(jax.random.key(0), 40, 8)
        e32 = np.asarray(pt.cv_lso(X, Y, 3, 0.25, 8, partitions=parts).errors)
        e16 = np.asarray(
            pt.cv_lso(X, Y, 3, 0.25, 8, partitions=parts, x_storage="bf16").errors
        )
        assert np.abs(e16 - e32).max() < 5e-2

    def test_cv_loo_downdate_bf16_stats(self):
        X, Y = _data(n=48, k=12, m=1, a=3)
        e32 = np.asarray(pt.cv_loo_downdate(X, Y, 3).errors)
        e16 = np.asarray(pt.cv_loo_downdate(X, Y, 3, x_storage="bf16").errors)
        assert np.abs(e16 - e32).max() < 5e-2

    def test_cv_kfold_downdate_bf16(self):
        X, Y = _data(n=60, k=12, m=1, a=3)
        e32 = np.asarray(pt.cv_kfold_downdate(X, Y, 3, k=5, key=1).errors)
        e16 = np.asarray(
            pt.cv_kfold_downdate(X, Y, 3, k=5, key=1, x_storage="bf16").errors
        )
        assert np.abs(e16 - e32).max() < 5e-2

    def test_cv_lso_downdate_bf16(self):
        X, Y = _data(n=40, k=10, m=1, a=3)
        import jax

        parts = pt.cv.lso.random_partitions(jax.random.key(3), 40, 8)
        e32 = np.asarray(
            pt.cv_lso_downdate(X, Y, 3, 0.25, 8, partitions=parts).errors
        )
        e16 = np.asarray(
            pt.cv_lso_downdate(
                X, Y, 3, 0.25, 8, partitions=parts, x_storage="bf16"
            ).errors
        )
        assert np.abs(e16 - e32).max() < 5e-2

    def test_accumulator_bf16_chunks(self):
        """StatsAccumulator(x_storage="bf16"): narrow chunks, f32 stats,
        fit close to the f32-accumulated one."""
        from pls_tpu.models.streaming import StatsAccumulator

        X, Y = _data(n=256, k=16, m=1, a=3)
        a32 = StatsAccumulator(16, 1)
        a16 = StatsAccumulator(16, 1, x_storage="bf16")
        for i in range(0, 256, 64):
            a32.update(X[i : i + 64], Y[i : i + 64])
            a16.update(X[i : i + 64], Y[i : i + 64])
        assert a16.XX.dtype == jnp.float32
        assert int(a16.n) == 256
        rel = float(
            jnp.abs(a16.XX - a32.XX).max() / jnp.abs(a32.XX).max()
        )
        assert rel < 2e-2, rel
        B32 = pt.coefficients(a32.fit(3))
        B16 = pt.coefficients(a16.fit(3))
        err = float(jnp.abs(B16 - B32).max() / jnp.abs(B32).max())
        assert err < 5e-2, err

    def test_accumulator_bf16_compensated_mutually_exclusive(self):
        from pls_tpu.models.streaming import StatsAccumulator

        with pytest.raises(ValueError):
            StatsAccumulator(8, 1, compensated=True, x_storage="bf16")

    def test_resumable_forwards_x_storage(self, tmp_path):
        """ResumableCV passes x_storage through to the underlying CV."""
        from pls_tpu.cv.resumable import ResumableCV

        X, Y = _data(n=32, k=8, m=1, a=2)
        r = ResumableCV(str(tmp_path)).run_loo(
            X, Y, 2, range_size=16, x_storage="bf16"
        )
        e32 = np.asarray(pt.cv_loo(X, Y, 2).errors)
        assert np.abs(np.asarray(r.errors) - e32).max() < 5e-2

    def test_blockdowndated_bf16_fold_block(self):
        """fit_from_stats_blockdowndated accepts a bfloat16 fold block."""
        from pls_tpu.models.kernel_pls import (
            fit_from_stats,
            fit_from_stats_blockdowndated,
        )

        X, Y = _data(n=64, k=12, m=1, a=3)
        XX = X.T @ X
        XY = X.T @ Y
        Xf, Yf = X[:16], Y[:16]
        ref = pt.coefficients(
            fit_from_stats(XX - Xf.T @ Xf, XY - Xf.T @ Yf, 3)
        )
        got = pt.coefficients(
            fit_from_stats_blockdowndated(
                XX, XY, Xf.astype(jnp.bfloat16), Yf, 3
            )
        )
        err = float(jnp.abs(got - ref).max() / jnp.abs(ref).max())
        assert err < 5e-2, err
