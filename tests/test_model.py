"""PLSModel API tests (the reference `PLS::Model` façade, pls.h:184-266)."""

import io

import jax.numpy as jnp
import numpy as np
import pytest

import pls_tpu as pt
from pls_tpu.model import PLSModel


@pytest.fixture(scope="module")
def toy_model(toy):
    X, Y = toy
    return PLSModel(X, Y, pt.KERNEL_TYPE1, 2)


class TestConstruction:
    def test_default_components_is_K(self, toy):
        # reference default A = K = X.cols() (pls.cpp:359)
        X, Y = toy
        m = PLSModel(X, Y)
        assert m.A == X.shape[1]

    def test_shape_validation(self, toy):
        X, Y = toy
        with pytest.raises(ValueError):
            PLSModel(X, Y, max_components=99)  # A > K (pls.cpp:345)
        with pytest.raises(ValueError):
            PLSModel(X, Y[:5])  # row mismatch (pls.cpp:347)
        with pytest.raises(ValueError):
            PLSModel(X[:0], Y[:0])  # empty (pls.cpp:346)

    def test_1d_y_promoted(self, nir):
        X, Y = nir
        m = PLSModel(X, Y.ravel(), max_components=3)
        assert m.Q.shape == (1, 3)


class TestAccessors:
    def test_matrix_shapes(self, toy_model):
        assert toy_model.W.shape == (15, 2)
        assert toy_model.P.shape == (15, 2)
        assert toy_model.R.shape == (15, 2)
        assert toy_model.Q.shape == (2, 2)
        assert toy_model.T.shape == (10, 2)
        assert toy_model.coefficients().shape == (15, 2)
        assert toy_model.loadingsX(1).shape == (15, 1)
        assert toy_model.loadingsY().shape == (2, 2)

    def test_default_args_use_training_data(self, toy_model, golden):
        np.testing.assert_allclose(
            np.asarray(toy_model.coefficients()), golden("toy_B"), atol=1e-10
        )
        ev2 = np.asarray(toy_model.explained_variance())
        np.testing.assert_allclose(ev2[None, :], golden("toy_ev")[1:2], atol=1e-10)

    def test_residuals_roundtrip(self, toy_model):
        res = np.asarray(toy_model.residuals())
        fit = np.asarray(toy_model.fitted_values())
        np.testing.assert_allclose(
            fit + res, np.asarray(toy_model.Y), atol=1e-12
        )


class TestCV:
    def test_cv_loo_label_and_parity(self, toy_model, golden):
        loo = toy_model.cv_LOO()
        assert loo.method == "LOO"
        np.testing.assert_allclose(
            np.asarray(loo.errors[0]), golden("toy_loo_resid_y0"), atol=1e-10
        )

    def test_cv_loo_downdate_kernel2(self, toy):
        X, Y = toy
        m2 = PLSModel(X, Y, pt.KERNEL_TYPE2, 2)
        a = m2.cv_LOO()
        b = m2.cv_LOO(downdate=True)
        np.testing.assert_allclose(
            np.asarray(a.errors), np.asarray(b.errors), atol=1e-9
        )

    def test_cv_lso_gcc_rng(self, toy_model, golden):
        from pls_tpu.utils.gcc_rng import GccRng

        lso = toy_model.cv_LSO(0.3, 100, GccRng())
        np.testing.assert_allclose(
            np.asarray(lso.errors[0]), golden("toy_lso_resid_y0"), atol=1e-10
        )

    def test_cv_lso_int_seed(self, toy_model):
        lso = toy_model.cv_LSO(0.3, 5, 42)
        assert lso.errors.shape == (2, 15, 2)

    def test_cv_new_data(self, toy_model, toy):
        X, Y = toy
        nd = toy_model.cv_NEW_DATA(X[5:], Y[5:])
        assert nd.method == "NEW DATA"


class TestReports:
    def test_print_state_layout(self, toy_model):
        buf = io.StringIO()
        toy_model.print_state(file=buf)
        out = buf.getvalue()
        for label in ["P:", "W:", "R:", "Q:", "T:", "coefficients:"]:
            assert f"{label}\n" in out
        # spot value from the reference print_state (BASELINE.md): W[0,0]
        assert "-0.265544" in out or "0.265544" in out

    def test_print_explained_variance_layout(self, toy_model):
        buf = io.StringIO()
        toy_model.print_explained_variance(file=buf)
        lines = buf.getvalue().strip().split("\n")
        assert len(lines) == 2
        assert lines[0].startswith("1 components explained variance:")
        assert "- SSE:" in lines[0]

    def test_print_validation_layout(self, toy_model):
        buf = io.StringIO()
        loo = toy_model.cv_LOO()
        pt.print_validation(loo, pt.MSE, file=buf)
        out = buf.getvalue()
        assert out.startswith("LOO Validation:\n")
        assert "RMSE  Matrix (rows = Y variable; cols = # of components):" in out
        assert "Optimal number of components (by Y variable):\t2\n1" in out


class TestCheckpoint:
    def test_save_load_roundtrip_with_data(self, toy_model, tmp_path):
        p = str(tmp_path / "model.npz")
        toy_model.save(p, include_data=True)
        m2 = PLSModel.load(p)
        assert m2.A == toy_model.A
        assert m2.method == toy_model.method
        np.testing.assert_allclose(
            np.asarray(m2.coefficients()), np.asarray(toy_model.coefficients()),
            atol=0,
        )
        # loaded model can run CV (has data)
        loo = m2.cv_LOO()
        np.testing.assert_allclose(
            np.asarray(loo.errors),
            np.asarray(toy_model.cv_LOO().errors),
            atol=1e-12,
        )

    def test_default_save_is_dataless_and_small(self, toy_model, tmp_path):
        """Default checkpoints store O(K·(3A+M)) model state, not the
        training data (VERDICT r02 #7): loading predicts on new data but
        refuses no-argument diagnostics with a clear error."""
        import os

        p = str(tmp_path / "model.npz")
        pd = str(tmp_path / "model_data.npz")
        toy_model.save(p)
        toy_model.save(pd, include_data=True)
        assert os.path.getsize(p) < os.path.getsize(pd)
        m2 = PLSModel.load(p)
        assert m2.X is None and m2.Y is None
        np.testing.assert_allclose(
            np.asarray(m2.coefficients()), np.asarray(toy_model.coefficients()),
            atol=0,
        )
        Xn = np.asarray(toy_model.X)[:4]
        np.testing.assert_allclose(
            np.asarray(m2.fitted_values(Xn)),
            np.asarray(toy_model.fitted_values(Xn)),
            atol=0,
        )
        for call in (
            m2.cv_LOO,
            m2.fitted_values,
            m2.scores,
            m2.residuals,
            m2.SSE,
            m2.explained_variance,
            m2.explained_variance_profile,
            lambda: m2.cv_LSO(0.3, 4),
            m2.bootstrap_coefficient_intervals,
        ):
            with pytest.raises(ValueError, match="data-less checkpoint"):
                call()


class TestRefit:
    def test_refit_matches_fresh_model(self, toy, nir):
        X, Y = toy
        m = PLSModel(X, Y, pt.KERNEL_TYPE1, 2)
        Xn, Yn = nir
        # refit on different data with the same component budget
        m2 = m.refit(Xn[:, :15], Yn)
        fresh = PLSModel(Xn[:, :15], Yn, pt.KERNEL_TYPE1, 2)
        np.testing.assert_allclose(
            np.asarray(m2.coefficients()), np.asarray(fresh.coefficients()),
            atol=0,
        )
        # original untouched (functional semantics)
        assert m.A == 2 and m.X.shape == (10, 15)


class TestBootstrapAPI:
    def test_model_level_intervals(self, toy):
        X, Y = toy
        m = PLSModel(X, Y, pt.KERNEL_TYPE1, 2)
        lo, hi, draws = m.bootstrap_coefficient_intervals(16)
        assert lo.shape == (15, 2) and hi.shape == (15, 2)
        assert draws.shape == (16, 15, 2)
        assert np.all(np.asarray(lo) <= np.asarray(hi))


class TestFloat32:
    def test_f32_fit_close_to_f64(self, nir):
        """Accelerator production precision: f32 fit with highest-precision matmuls
        tracks the f64 reference within ~1e-3 relative on nir."""
        X, Y = nir
        m32 = PLSModel(X, Y, pt.KERNEL_TYPE1, 5, dtype=jnp.float32)
        B32 = np.asarray(m32.coefficients(), dtype=np.float64)
        m64 = PLSModel(X, Y, pt.KERNEL_TYPE1, 5)
        B64 = np.asarray(m64.coefficients())
        scale = np.abs(B64).max()
        assert np.abs(B32 - B64).max() / scale < 2e-3


class TestReviewRegressions:
    """Regression tests for bugs found in code review."""

    def test_1d_ynew_column_promotion(self, nir):
        """1-D Y_new must promote to a column; atleast_2d's (1,n) row
        silently broadcast residuals into an (n,n) matrix."""
        X, Y = nir
        m = PLSModel(X, Y, max_components=3)
        y1d = np.asarray(Y).ravel()
        res = np.asarray(m.residuals(X, y1d))
        assert res.shape == (60, 1)
        sse = np.asarray(m.SSE(X, y1d))
        assert sse.shape == (1,)
        np.testing.assert_allclose(sse, np.asarray(m.SSE()), atol=1e-9)

    def test_downdate_rejects_non_kernel_methods(self, toy):
        """cv_LOO(downdate=True) must not silently cross-validate a
        kernel model when the fitted model is SIMPLS/NIPALS."""
        X, Y = toy
        m = PLSModel(X, Y, pt.SIMPLS, 2)
        with pytest.raises(ValueError, match="downdate"):
            m.cv_LOO(downdate=True)

    def test_save_load_preserves_numerics_config(self, toy, tmp_path):
        X, Y = toy
        m = PLSModel(X, Y, pt.KERNEL_TYPE1, 2, power_iters=8, precision=None)
        p = str(tmp_path / "m.npz")
        m.save(p)
        m2 = PLSModel.load(p)
        assert m2._power_iters == 8
        assert m2._precision is None

    def test_comp_out_of_range_raises(self, toy):
        m = PLSModel(*toy, max_components=2)
        for bad in (0, 3, -1):
            with pytest.raises(ValueError):
                m.coefficients(bad)
            with pytest.raises(ValueError):
                m.scores(comp=bad)

    def test_explained_variance_profile_matches_per_comp(self, nir):
        X, Y = nir
        m = PLSModel(X, Y, max_components=5)
        sse, ev = m.explained_variance_profile()
        for c in range(1, 6):
            np.testing.assert_allclose(
                np.asarray(ev[c - 1]), np.asarray(m.explained_variance(comp=c)),
                atol=1e-9,
            )

    def test_print_state_empty_T_blank_line(self, toy):
        """Type-2 models (no T) must print a blank line after 'T:' like
        Eigen's `os << T << endl` on an empty matrix."""
        X, Y = toy
        m = PLSModel(X, Y, pt.KERNEL_TYPE2, 2)
        buf = io.StringIO()
        m.print_state(file=buf)
        assert "T:\n\ncoefficients:" in buf.getvalue()


@pytest.mark.parametrize("product", [
    "coefficients", "fitted_values", "scores", "residuals",
    "residuals_all_components", "PLSModel.fitted_values",
])
def test_coefficients_pinned_at_highest_precision(toy, product):
    """B = R Qᵀ is the model itself, and every prediction multiplies the
    data by it: no such product may inherit the session's default matmul
    precision (TF32 on an NVIDIA GPU)."""
    import jax

    from pls_tpu.models.predict import residuals_all_components

    X, Y = toy
    X = jnp.asarray(X, jnp.float32)
    Y = jnp.asarray(Y, jnp.float32)
    f = pt.fit(X, Y, 2)
    model = PLSModel(X, Y, pt.KERNEL_TYPE1, 2)
    run = {
        "coefficients": lambda X, Y: pt.coefficients(f),
        "fitted_values": lambda X, Y: pt.fitted_values(f, X),
        "scores": lambda X, Y: pt.scores(f, X),
        "residuals": lambda X, Y: pt.residuals(f, X, Y),
        "residuals_all_components":
            lambda X, Y: residuals_all_components(f, X, Y),
        "PLSModel.fitted_values": lambda X, Y: model.fitted_values(X),
    }[product]
    jaxpr = jax.make_jaxpr(run)(X, Y)
    dots = [e for e in jaxpr.eqns if e.primitive.name == "dot_general"]
    assert dots
    for e in dots:
        assert e.params["precision"] == (
            jax.lax.Precision.HIGHEST, jax.lax.Precision.HIGHEST
        )
