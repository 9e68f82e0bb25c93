"""PLS-DA: discriminant analysis on top of PLS2.

Not in the reference's surface (tjhladish/PLS is regression-only), but the
standard classification companion every PLS toolbox ships: encode class
labels as one-hot indicator columns, fit multi-response PLS2 (the same
Dayal–MacGregor kernel as /root/reference/src/pls.cpp:387-437), classify
by the largest predicted indicator.  Everything reuses the regression
machinery, so PLS-DA inherits the accelerator path (jitted scan fit, vmapped CV,
sharding) for free.

Two APIs:
- functional: `fit_plsda` / `predict_classes` / `predict_proba` on arrays
  with integer labels;
- `PLSDAClassifier`: sklearn-protocol estimator (fit/predict/
  predict_proba/score) accepting arbitrary label values.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from pls_tpu.models.kernel_pls import fit as _fit
from pls_tpu.models.predict import coefficients
from pls_tpu.preprocess import ZScorer
from pls_tpu.types import KERNEL_TYPE1, METHOD, PLSFit


def one_hot(labels: jnp.ndarray, n_classes: int, dtype=jnp.float32) -> jnp.ndarray:
    """(N,) integer labels in [0, n_classes) -> (N, n_classes) indicator."""
    return jax.nn.one_hot(jnp.asarray(labels), n_classes, dtype=dtype)


def fit_plsda(
    X: jnp.ndarray,
    labels: jnp.ndarray,
    n_classes: int,
    A: int,
    method: METHOD = KERNEL_TYPE1,
    **kw,
) -> PLSFit:
    """Fit PLS2 on the one-hot indicator matrix (X pre-scaled by caller)."""
    Y = one_hot(labels, n_classes, jnp.asarray(X).dtype)
    # center the indicators (class priors become the intercept); X is
    # assumed centered, so the fitted B maps centered X -> centered Y
    Y = Y - jnp.mean(Y, axis=0, keepdims=True)
    return _fit(X, Y, A, method, **kw)


def decision_values(f: PLSFit, Xn: jnp.ndarray, comp: int | None = None) -> jnp.ndarray:
    """Predicted (centered) indicator scores (N, n_classes)."""
    return Xn @ coefficients(f, comp)


def predict_classes(
    f: PLSFit, Xn: jnp.ndarray, priors: jnp.ndarray | None = None,
    comp: int | None = None,
) -> jnp.ndarray:
    """argmax over predicted indicators (+ class priors if given)."""
    d = decision_values(f, Xn, comp)
    if priors is not None:
        d = d + jnp.asarray(priors)[None, :]
    return jnp.argmax(d, axis=1)


def predict_proba(
    f: PLSFit, Xn: jnp.ndarray, priors: jnp.ndarray | None = None,
    comp: int | None = None,
) -> jnp.ndarray:
    """Softmax calibration of the decision values — a convention, not a
    probability model; use for ranking/thresholding, not inference."""
    d = decision_values(f, Xn, comp)
    if priors is not None:
        d = d + jnp.asarray(priors)[None, :]
    return jax.nn.softmax(d, axis=1)


class PLSDAClassifier:
    """PLS-DA with sklearn-protocol ergonomics (cf. estimator.PLSRegressor).

    Labels may be any hashable values; they are mapped to indicator
    columns in sorted order (`classes_`).  X is z-scored internally by
    default (the reference CLI's convention for predictors).
    """

    def __init__(
        self,
        n_components: int = 2,
        method: METHOD = KERNEL_TYPE1,
        scale: bool = True,
        power_iters: int | None = None,
        precision: str | None = "highest",
    ):
        self.n_components = n_components
        self.method = method
        self.scale = scale
        self.power_iters = power_iters
        self.precision = precision

    def get_params(self, deep: bool = True) -> dict:
        return {
            "n_components": self.n_components,
            "method": self.method,
            "scale": self.scale,
            "power_iters": self.power_iters,
            "precision": self.precision,
        }

    def set_params(self, **params) -> "PLSDAClassifier":
        valid = self.get_params()
        for k, v in params.items():
            # declared-parameter check (hasattr would accept method names)
            if k not in valid:
                raise ValueError(f"unknown parameter {k}")
            setattr(self, k, v)
        return self

    def fit(self, X, y) -> "PLSDAClassifier":
        X = jnp.asarray(X)
        y = np.asarray(y)
        self.classes_, idx = np.unique(y, return_inverse=True)
        n_classes = len(self.classes_)
        if n_classes < 2:
            raise ValueError("need at least 2 classes")
        if self.scale:
            self._x_scaler = ZScorer.fit(X)
            Xz = self._x_scaler.transform(X)
        else:
            self._x_scaler = None
            Xz = X
        self._priors = jnp.asarray(
            np.bincount(idx, minlength=n_classes) / len(idx), Xz.dtype
        )
        self._fit = fit_plsda(
            Xz, jnp.asarray(idx), n_classes, self.n_components, self.method,
            power_iters=self.power_iters, precision=self.precision,
        )
        return self

    def _decision(self, X) -> jnp.ndarray:
        X = jnp.asarray(X)
        if self._x_scaler is not None:
            X = self._x_scaler.transform(X)
        # add the prior back: B maps centered X to centered indicators
        return decision_values(self._fit, X) + self._priors[None, :]

    def decision_function(self, X) -> np.ndarray:
        return np.asarray(self._decision(X))

    def predict(self, X) -> np.ndarray:
        return self.classes_[np.asarray(jnp.argmax(self._decision(X), axis=1))]

    def predict_proba(self, X) -> np.ndarray:
        return np.asarray(jax.nn.softmax(self._decision(X), axis=1))

    def score(self, X, y) -> float:
        """Mean accuracy."""
        return float(np.mean(self.predict(X) == np.asarray(y)))

    def transform(self, X) -> np.ndarray:
        """Latent scores (N, n_components)."""
        X = jnp.asarray(X)
        if self._x_scaler is not None:
            X = self._x_scaler.transform(X)
        return np.asarray(X @ self._fit.R)
