"""Native C++ consumer integration: export a trained model (PLSB), compile
a consumer program against native/pls_predict.hpp with g++, and verify its
predictions / T²/SPE gate against the Python estimator.

This is the working equivalent of the reference's consumer-project ctest
harness (SURVEY.md §4 — whose numeric path no longer compiles): the
reference is meant to be embedded in C++ simulations, and this proves the
accelerator-trained models can be too, with zero Python/JAX/Eigen at runtime.
"""

import shutil
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

import pls_tpu as pt
from pls_tpu.estimator import PLSRegressor

REPO = Path(__file__).resolve().parents[1]

pytestmark = pytest.mark.skipif(
    shutil.which("g++") is None, reason="no C++ toolchain"
)


@pytest.fixture(scope="module")
def consumer_bin(tmp_path_factory):
    """Compile the SHIPPED native predictor CLI (native/pls_predict_main.cpp,
    `make predictor`) — the consumer the reference's ctest harness intended
    but whose code never compiled (SURVEY.md §4)."""
    d = tmp_path_factory.mktemp("consumer")
    exe = d / "pls_predict"
    subprocess.run(
        ["g++", "-std=c++17", "-O2", f"-I{REPO}/native",
         f"{REPO}/native/pls_predict_main.cpp", "-o", str(exe)],
        check=True,
        capture_output=True,
        text=True,
    )
    return exe


def _run_consumer(exe, model_path, X):
    csv = model_path.parent / "X.csv"
    np.savetxt(csv, np.asarray(X), delimiter=",")
    r = subprocess.run(
        [str(exe), str(model_path), str(csv)],
        capture_output=True,
        text=True,
        timeout=120,
    )
    assert r.returncode == 0, r.stderr
    preds, t2s, spes, oks = [], [], [], []
    for line in r.stdout.strip().splitlines():
        left, right = line.split("|")
        preds.append([float(v) for v in left.split()])
        t2, spe, ok = right.split()
        t2s.append(float(t2))
        spes.append(float(spe))
        oks.append(bool(int(ok)))
    return np.array(preds), np.array(t2s), np.array(spes), np.array(oks)


def test_consumer_matches_estimator(consumer_bin, tmp_path):
    from pls_tpu import datasets

    X, y = datasets.load_nir()
    est = PLSRegressor(n_components=5).fit(X, y)
    est.build_monitor(X, alpha=0.05)
    model_path = tmp_path / "nir.plsb"
    est.export_c(str(model_path))

    preds, t2s, spes, oks = _run_consumer(consumer_bin, model_path, X)
    np.testing.assert_allclose(preds, np.asarray(est.predict(X)), rtol=1e-5)
    res = est.check(X)
    np.testing.assert_allclose(t2s, np.asarray(res["t2"]), rtol=1e-4)
    np.testing.assert_allclose(spes, np.asarray(res["spe"]), rtol=1e-3, atol=1e-6)
    assert (oks == np.asarray(res["ok"])).all()

    # an out-of-domain sample is rejected by the native gate too
    bad = np.asarray(X[:1]) * 3.0 + 1.0
    _, _, _, oks_bad = _run_consumer(consumer_bin, model_path, bad)
    assert not oks_bad[0]


def test_consumer_multiresponse_unscaled(consumer_bin, tmp_path):
    rng = np.random.default_rng(0)
    X = rng.normal(size=(40, 9))
    Y = X @ rng.normal(size=(9, 3)) + 0.1 * rng.normal(size=(40, 3))
    est = PLSRegressor(n_components=4, scale=False).fit(X, Y)
    model_path = tmp_path / "m3.plsb"
    est.export_c(str(model_path))
    preds, _, _, oks = _run_consumer(consumer_bin, model_path, X)
    np.testing.assert_allclose(
        preds, np.asarray(est.predict(X)), rtol=1e-6, atol=1e-9
    )
    assert oks.all()  # no monitor attached -> gate stays open


def test_python_roundtrip_loader(tmp_path):
    """load_model_c reads back exactly what export_model_c wrote."""
    import jax.numpy as jnp

    rng = np.random.default_rng(1)
    X = rng.normal(size=(30, 6))
    Y = rng.normal(size=(30, 2))
    zx, zy = pt.ZScorer.fit(jnp.asarray(X)), pt.ZScorer.fit(jnp.asarray(Y))
    fit = pt.fit(zx.transform(X), zy.transform(Y), 3)
    p = tmp_path / "rt.plsb"
    pt.export_model_c(str(p), fit, x_scaler=zx, y_scaler=zy)
    m = pt.load_model_c(str(p))
    assert (m["K"], m["M"], m["A"]) == (6, 2, 3)
    # raw-unit prediction through the exported operators == python stack
    yhat = (X - m["x_mean"]) @ m["B_raw"] + m["b0"]
    ref = np.asarray(zy.inverse(pt.fitted_values(fit, zx.transform(X))))
    np.testing.assert_allclose(yhat, ref, rtol=1e-9)
    assert m["t2_lim"] == 0.0 and m["spe_lim"] == 0.0

    # corrupt magic is rejected
    blob = bytearray(p.read_bytes())
    blob[:8] = b"NOTMAGIC"
    bad = tmp_path / "bad.plsb"
    bad.write_bytes(bytes(blob))
    with pytest.raises(ValueError):
        pt.load_model_c(str(bad))
