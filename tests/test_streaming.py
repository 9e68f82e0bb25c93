"""Streaming-stats fit tests (models/streaming.py)."""

import jax.numpy as jnp
import numpy as np

import pls_tpu as pt
from pls_tpu import datasets
from pls_tpu.models.streaming import (
    StatsAccumulator,
    collect_moments,
    fit_streaming,
)


def _chunks(X, Y, size):
    for i in range(0, X.shape[0], size):
        yield X[i : i + size], Y[i : i + size]


def test_streaming_equals_batch(nir):
    X, Y = nir
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    ref = pt.fit(Xj, Yj, 5, pt.KERNEL_TYPE2)
    acc = StatsAccumulator(401, 1, jnp.float64)
    for Xc, Yc in _chunks(Xj, Yj, 7):
        acc.update(Xc, Yc)
    f = acc.fit(5)
    np.testing.assert_allclose(
        np.asarray(pt.coefficients(f)), np.asarray(pt.coefficients(ref)),
        atol=1e-9,
    )
    assert int(acc.n) == 60


def test_merge_equals_single_pass(toy):
    X, Y = toy
    Xj, Yj = jnp.asarray(X), jnp.asarray(Y)
    a = StatsAccumulator(15, 2, jnp.float64).update(Xj[:4], Yj[:4])
    b = StatsAccumulator(15, 2, jnp.float64).update(Xj[4:], Yj[4:])
    a.merge(b)
    whole = StatsAccumulator(15, 2, jnp.float64).update(Xj, Yj)
    np.testing.assert_allclose(np.asarray(a.XX), np.asarray(whole.XX), atol=1e-10)
    np.testing.assert_allclose(np.asarray(a.XY), np.asarray(whole.XY), atol=1e-10)


def test_streaming_zscore_matches_reference_pipeline(golden):
    """Two-pass streaming z-score + fit == the CLI pipeline on raw CSVs."""
    Xraw, Yraw = datasets.load_toy()
    K, M = 15, 2
    moments = collect_moments(_chunks(Xraw, Yraw, 3), K, M, dtype=jnp.float64)
    f = fit_streaming(
        _chunks(Xraw, Yraw, 3), K, M, 2,
        zscore=True, moments=moments, dtype=jnp.float64,
    )
    np.testing.assert_allclose(
        np.asarray(pt.coefficients(f)), golden("toy_t2_B"), atol=1e-9
    )


def test_moments_f32_large_mean_stability():
    """Chan-merged moments must survive f32 with mean >> std (the naive
    sumsq − n·mean² formula cancels to zero variance)."""
    rng = np.random.default_rng(0)
    X = (1e4 + rng.normal(size=(4000, 3))).astype(np.float32)
    Y = (5e3 + rng.normal(size=(4000, 1))).astype(np.float32)
    moments = collect_moments(_chunks(X, Y, 512), 3, 1, dtype=jnp.float32)
    mx, sdx, my, sdy, n = moments
    assert n == 4000
    np.testing.assert_allclose(np.asarray(mx), X.mean(0), rtol=1e-5)
    # the whole point: stdev ~1 recovered, not clamped to the zero-guard
    np.testing.assert_allclose(np.asarray(sdx), X.std(0, ddof=1), rtol=1e-2)
    assert np.all(np.asarray(sdx) > 0.5)


class TestZscoreClosedForm:
    """zscore_stats / zscore_fold_stats: the statistics of the
    column-standardized data derived in closed form from RAW-data
    statistics — must equal explicitly z-scoring then accumulating."""

    def _data(self):
        rng = np.random.default_rng(21)
        X = (rng.normal(size=(300, 12)) * 3 + 5).astype(np.float32)
        Y = (rng.normal(size=(300, 2)) * 2 - 4).astype(np.float32)
        return X, Y

    @staticmethod
    def _zscore(A):
        m = A.mean(0)
        s = A.std(0, ddof=1)
        return (A - m) / s

    def test_global_stats_match_explicit(self):
        from pls_tpu.models.streaming import StatsAccumulator

        X, Y = self._data()
        acc = StatsAccumulator(12, 2)
        for s in range(0, 300, 77):
            acc.update(X[s:s + 77], Y[s:s + 77])
        XX_z, XY_z, YY_z, mx, sdx, my, sdy = acc.zscored()
        Xz, Yz = self._zscore(X), self._zscore(Y)
        np.testing.assert_allclose(np.asarray(mx), X.mean(0), rtol=1e-5)
        np.testing.assert_allclose(
            np.asarray(sdx), X.std(0, ddof=1), rtol=1e-4)
        scale = np.abs(Xz.T @ Xz).max()
        np.testing.assert_allclose(
            np.asarray(XX_z), Xz.T @ Xz, rtol=1e-3, atol=1e-4 * scale)
        np.testing.assert_allclose(
            np.asarray(XY_z), Xz.T @ Yz, rtol=1e-3, atol=1e-4 * scale)
        np.testing.assert_allclose(
            np.asarray(YY_z), Yz.T @ Yz, rtol=1e-3, atol=1e-4 * scale)

    def test_fit_zscore_matches_prescaled_fit(self):
        from pls_tpu.models.kernel_pls import fit_from_stats
        from pls_tpu.models.streaming import StatsAccumulator

        import pls_tpu as pt

        X, Y = self._data()
        acc = StatsAccumulator(12, 2)
        acc.update(X, Y)
        f1 = acc.fit(4, zscore=True)
        Xz, Yz = self._zscore(X), self._zscore(Y)
        f2 = fit_from_stats(
            jnp.asarray(Xz.T @ Xz), jnp.asarray(Xz.T @ Yz), 4)
        np.testing.assert_allclose(
            np.asarray(pt.coefficients(f1)), np.asarray(pt.coefficients(f2)),
            rtol=1e-3, atol=1e-4)

    def test_fold_stats_match_explicit(self):
        from pls_tpu.models.streaming import FoldStatsAccumulator

        X, Y = self._data()
        k = 4
        assign = (np.arange(300) * k // 300).astype(np.int32)
        acc = FoldStatsAccumulator(12, 2, k)
        for s in range(0, 300, 77):
            acc.update(X[s:s + 77], Y[s:s + 77], assign[s:s + 77])
        accz = acc.zscored()
        Xz, Yz = self._zscore(X), self._zscore(Y)
        for f in range(k):
            Xf, Yf = Xz[assign == f], Yz[assign == f]
            scale = np.abs(Xf.T @ Xf).max()
            np.testing.assert_allclose(
                np.asarray(accz.XXf[f]), Xf.T @ Xf,
                rtol=1e-3, atol=1e-4 * scale)
            np.testing.assert_allclose(
                np.asarray(accz.XYf[f]), Xf.T @ Yf,
                rtol=1e-3, atol=1e-4 * scale)
            np.testing.assert_allclose(
                np.asarray(accz.sxf[f]), Xf.sum(0), atol=1e-2)
