"""Unit tests for column statistics (reference pls.cpp:69-111)."""

import jax.numpy as jnp
import numpy as np
import pytest

from pls_tpu import colwise_stdev, colwise_z_scores, datasets, sst, z_scores


def test_sst_matches_numpy():
    rng = np.random.default_rng(0)
    m = rng.normal(size=(20, 5))
    expected = np.sum((m - m.mean(axis=0)) ** 2, axis=0)
    np.testing.assert_allclose(np.asarray(sst(jnp.asarray(m))), expected, rtol=1e-12)


def test_sst_given_means():
    rng = np.random.default_rng(1)
    m = rng.normal(size=(10, 3))
    means = np.array([1.0, -2.0, 0.5])
    expected = np.sum((m - means) ** 2, axis=0)
    np.testing.assert_allclose(
        np.asarray(sst(jnp.asarray(m), jnp.asarray(means))), expected, rtol=1e-12
    )


def test_sst_single_row_is_zero():
    # reference convention: N < 2 => zero row (pls.cpp:71)
    m = jnp.asarray([[1.0, 2.0, 3.0]])
    np.testing.assert_array_equal(np.asarray(sst(m)), np.zeros(3))


def test_colwise_stdev_unbiased():
    rng = np.random.default_rng(2)
    m = rng.normal(size=(31, 4))
    np.testing.assert_allclose(
        np.asarray(colwise_stdev(jnp.asarray(m))), m.std(axis=0, ddof=1), rtol=1e-12
    )


def test_z_scores_row():
    obs = jnp.asarray([2.0, 4.0])
    mean = jnp.asarray([1.0, 2.0])
    sd = jnp.asarray([0.5, 2.0])
    np.testing.assert_allclose(np.asarray(z_scores(obs, mean, sd)), [2.0, 1.0])


def test_colwise_z_scores_basic(golden):
    # parity with the reference's z-scoring of the raw toy CSVs
    raw = datasets.load_toy()[0]
    np.testing.assert_allclose(
        np.asarray(colwise_z_scores(jnp.asarray(raw))),
        golden("toy_Xz"),
        atol=1e-12,
    )


def test_zero_stdev_guard():
    """The reference *intends* constant columns to z-score to 0 but its guard
    is dead code (pls.cpp:100-103 divides by the unguarded stdev — SURVEY.md
    §2 #5).  We implement the intended behavior."""
    m = jnp.asarray([[1.0, 5.0], [1.0, 7.0], [1.0, 9.0]])
    zs = np.asarray(colwise_z_scores(m))
    assert np.all(np.isfinite(zs))
    np.testing.assert_array_equal(zs[:, 0], np.zeros(3))
    np.testing.assert_allclose(zs[:, 1], [-1.0, 0.0, 1.0])
