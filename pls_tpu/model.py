"""High-level PLS model object mirroring the reference's `PLS::Model` API.

Reference analogue: `struct PLS::Model` (/root/reference/include/PLS/pls.h:184-266).
Where the reference couples data, fit state and CV methods in one mutable
object refit in place, this wrapper is a thin stateful façade over the
pure functional core (models/, cv/) — construction performs one jitted
fit; every method delegates to pure functions that could equally be used
directly under jit/vmap/pjit.

API mapping (reference → here):
  Model(X, Y, algorithm, max_components)  → PLSModel(X, Y, method, max_components)
  scores/coefficients/fitted_values/residuals/SSE/explained_variance(…, comp)
                                          → same names, `comp` optional
  loadingsX/loadingsY (declared but never defined in the reference —
    pls.h:207-211)                        → implemented for real
  cv_LOO / cv_NEW_DATA / cv_LSO           → same names; cv_LSO accepts a
    GccRng (bit-exact reference partitions), a jax PRNG key, or an int seed
  print_state / print_explained_variance  → same stderr tables
plus checkpointing (save/load), which the reference lacks (SURVEY.md §5).
"""

from __future__ import annotations

import json
import sys

import jax
import jax.numpy as jnp
import numpy as np

from pls_tpu.cv.loo import cv_loo, cv_loo_downdate
from pls_tpu.cv.lso import cv_lso
from pls_tpu.cv.newdata import cv_new_data
from pls_tpu.models import predict as _predict
from pls_tpu.models.kernel_pls import fit as _fit
from pls_tpu.types import METHOD, PLSFit, Residual
from pls_tpu.utils.gcc_rng import GccRng


class PLSModel:
    def __init__(
        self,
        X,
        Y,
        method: METHOD = METHOD.KERNEL_TYPE1,
        max_components: int | None = None,
        *,
        dtype=None,
        power_iters: int | None = None,
        precision: str | None = "highest",
        use_pallas: bool | None = None,
        x_storage: str | None = None,
        _fit_state: PLSFit | None = None,
    ):
        X = jnp.asarray(X, dtype=dtype)
        Y = jnp.asarray(Y, dtype=dtype)
        if Y.ndim == 1:
            Y = Y[:, None]
        if X.shape[0] == 0:
            raise ValueError("X has no rows")  # reference assert pls.cpp:346
        if X.shape[0] != Y.shape[0]:
            raise ValueError(  # reference assert pls.cpp:347
                f"X has {X.shape[0]} rows but Y has {Y.shape[0]}"
            )
        A = X.shape[1] if max_components is None else int(max_components)
        if not (0 < A <= X.shape[1]):
            raise ValueError(  # reference assert pls.cpp:345
                f"max_components={A} must be in (0, {X.shape[1]}]"
            )
        self._X = X
        self._Y = Y
        self._method = method
        self._power_iters = power_iters
        self._precision = precision
        self._fit = (
            _fit(
                X, Y, A, method,
                power_iters=power_iters, precision=precision,
                use_pallas=use_pallas, x_storage=x_storage,
            )
            if _fit_state is None
            else _fit_state
        )

    # ---------- state accessors ----------
    @property
    def X(self) -> jnp.ndarray:
        return self._X

    @property
    def Y(self) -> jnp.ndarray:
        return self._Y

    @property
    def A(self) -> int:
        return self._fit.A

    @property
    def method(self) -> METHOD:
        return self._method

    @property
    def fit_state(self) -> PLSFit:
        return self._fit

    @property
    def W(self) -> jnp.ndarray:
        return self._fit.W

    @property
    def P(self) -> jnp.ndarray:
        return self._fit.P

    @property
    def Q(self) -> jnp.ndarray:
        return self._fit.Q

    @property
    def R(self) -> jnp.ndarray:
        return self._fit.R

    @property
    def T(self) -> jnp.ndarray:
        return self._fit.T

    def refit(self, X, Y, method: METHOD | None = None) -> "PLSModel":
        """Fit the same-shape model on new data — the reference's public
        `Model::plsr(X, Y, algorithm)` re-fit entry point (pls.h:199,
        pls.cpp:390).  Functional flavor: returns a NEW PLSModel rather
        than mutating in place."""
        return PLSModel(
            X, Y, self._method if method is None else method, self.A,
            power_iters=self._power_iters, precision=self._precision,
        )

    def _require_data(self) -> None:
        if self._X is None:
            raise ValueError(
                "this model was loaded from a data-less checkpoint "
                "(save(include_data=False)); pass X/Y explicitly, or "
                "re-save the original model with include_data=True"
            )

    @staticmethod
    def _as_col(Y) -> jnp.ndarray:
        """Promote 1-D response vectors to (n, 1) columns — the convention
        __init__ uses (atleast_2d would produce a (1, n) row, silently
        broadcasting residuals into an (n, n) matrix)."""
        Y = jnp.asarray(Y)
        return Y[:, None] if Y.ndim == 1 else Y

    # ---------- prediction / diagnostics ----------
    def scores(self, X_new=None, comp: int | None = None) -> jnp.ndarray:
        if X_new is None:
            self._require_data()
            X_new = self._X
        else:
            X_new = jnp.asarray(X_new)
        return _predict.scores(self._fit, X_new, comp)

    def loadingsX(self, comp: int | None = None) -> jnp.ndarray:
        return _predict.loadings_x(self._fit, comp)

    def loadingsY(self, comp: int | None = None) -> jnp.ndarray:
        return _predict.loadings_y(self._fit, comp)

    def coefficients(self, comp: int | None = None) -> jnp.ndarray:
        return _predict.coefficients(self._fit, comp)

    def fitted_values(self, X_new=None, comp: int | None = None) -> jnp.ndarray:
        if X_new is None:
            self._require_data()
            X_new = self._X
        else:
            X_new = jnp.asarray(X_new)
        return _predict.fitted_values(self._fit, X_new, comp)

    def residuals(self, X_new=None, Y_new=None, comp: int | None = None) -> jnp.ndarray:
        if X_new is None or Y_new is None:
            self._require_data()
        X_new = self._X if X_new is None else jnp.asarray(X_new)
        Y_new = self._Y if Y_new is None else self._as_col(Y_new)
        return _predict.residuals(self._fit, X_new, Y_new, comp)

    def SSE(self, X_new=None, Y_new=None, comp: int | None = None) -> jnp.ndarray:
        if X_new is None or Y_new is None:
            self._require_data()
        X_new = self._X if X_new is None else jnp.asarray(X_new)
        Y_new = self._Y if Y_new is None else self._as_col(Y_new)
        return _predict.sse(self._fit, X_new, Y_new, comp)

    def explained_variance(
        self, X_new=None, Y_new=None, comp: int | None = None
    ) -> jnp.ndarray:
        if X_new is None or Y_new is None:
            self._require_data()
        X_new = self._X if X_new is None else jnp.asarray(X_new)
        Y_new = self._Y if Y_new is None else self._as_col(Y_new)
        return _predict.explained_variance(self._fit, X_new, Y_new, comp)

    # ---------- cross-validation ----------
    def cv_LOO(self, *, batch_size: int | None = None, downdate: bool = False) -> Residual:
        self._require_data()
        if downdate:
            if self._method not in (METHOD.KERNEL_TYPE1, METHOD.KERNEL_TYPE2):
                raise ValueError(
                    "downdate LOO computes the kernel-PLS model from "
                    "X'X/X'Y statistics; it would silently cross-validate "
                    f"a different model than {self._method} — use "
                    "cv_LOO(downdate=False)"
                )
            return cv_loo_downdate(
                self._X, self._Y, self.A,
                batch_size=batch_size,
                power_iters=self._power_iters, precision=self._precision,
            )
        return cv_loo(
            self._X, self._Y, self.A, self._method,
            batch_size=batch_size,
            power_iters=self._power_iters, precision=self._precision,
        )

    def cv_NEW_DATA(self, X_new, Y_new) -> Residual:
        return cv_new_data(self._fit, X_new, Y_new)

    def cv_KFOLD(
        self,
        k: int = 10,
        *,
        key=0,
        assignments=None,
        downdate: bool = True,
        batch_size: int | None = None,
    ) -> Residual:
        """K-fold CV (framework extension — the reference ships only
        LOO / LSO / new-data, /root/reference/src/pls.cpp:469-549).
        downdate=True (default, kernel methods) refits each fold from
        block-downdated XᵀX/XᵀY — O(K²·A + Nf·K·A) per fold; False
        runs brute-force masked refits with the model's own method."""
        self._require_data()
        from pls_tpu.cv.kfold import cv_kfold, cv_kfold_downdate

        if downdate and self._method in (
            METHOD.KERNEL_TYPE1, METHOD.KERNEL_TYPE2,
        ):
            return cv_kfold_downdate(
                self._X, self._Y, self.A, k=k, key=key,
                assignments=assignments, batch_size=batch_size,
                power_iters=self._power_iters, precision=self._precision,
            )
        return cv_kfold(
            self._X, self._Y, self.A, k=k, method=self._method, key=key,
            assignments=assignments, batch_size=batch_size,
            power_iters=self._power_iters, precision=self._precision,
        )

    def cv_LSO(
        self,
        test_fraction: float,
        num_trials: int,
        rng=None,
        *,
        batch_size: int | None = None,
    ) -> Residual:
        """Monte-Carlo CV.  `rng` may be a GccRng (bit-exact reference
        partitions; stateful across calls like the reference's
        `std::mt19937&` argument), a jax PRNG key, or an int jax seed."""
        self._require_data()
        N = self._X.shape[0]
        partitions = key = None
        if isinstance(rng, GccRng):
            partitions = rng.lso_partitions(N, num_trials)
        elif isinstance(rng, int):
            key = jax.random.key(rng)
        elif rng is not None:
            key = rng
        else:
            key = jax.random.key(0)
        return cv_lso(
            self._X, self._Y, self.A, test_fraction, num_trials, self._method,
            key=key, partitions=partitions, batch_size=batch_size,
            power_iters=self._power_iters, precision=self._precision,
        )

    def bootstrap_coefficient_intervals(
        self,
        num_replicates: int = 200,
        *,
        alpha: float = 0.05,
        key=None,
        comp: int | None = None,
        batch_size: int | None = None,
    ):
        """Percentile bootstrap CIs for the regression coefficients
        (cv/bootstrap.py).  Returns (lower, upper, draws)."""
        import jax

        from pls_tpu.cv.bootstrap import bootstrap_coefficient_intervals

        self._require_data()

        key = jax.random.key(0) if key is None else key
        A = self.A if comp is None else comp
        return bootstrap_coefficient_intervals(
            self._X, self._Y, A, num_replicates, key, self._method,
            alpha=alpha, batch_size=batch_size, precision=self._precision,
        )

    # ---------- reports (reference pls.cpp:551-580) ----------
    def explained_variance_profile(self, X=None, Y=None):
        """(sse, ev) arrays of shape (A, M): SSE and explained variance at
        every component truncation, from ONE residual pass
        (models/predict.residuals_all_components) instead of A separate
        predictions."""
        from pls_tpu.models.predict import residuals_all_components
        from pls_tpu.ops.stats import sst

        if X is None or Y is None:
            self._require_data()
        X = self._X if X is None else jnp.asarray(X)
        Y = self._Y if Y is None else self._as_col(Y)
        res = residuals_all_components(self._fit, X, Y)  # (n, A, M)
        sse = jnp.sum(res * res, axis=0)  # (A, M)
        ev = 1.0 - sse / sst(Y)[None, :]
        return sse, ev

    def print_explained_variance(self, X=None, Y=None, file=None) -> None:
        from pls_tpu.utils.reporting import format_eigen

        file = sys.stderr if file is None else file
        sse, ev = self.explained_variance_profile(X, Y)
        sse, ev = np.asarray(sse), np.asarray(ev)
        wd = max(1, int(np.ceil(np.log10(max(self.A, 2)))))
        for ncomp in range(1, self.A + 1):
            print(
                f"{ncomp:>{wd}} components explained variance: "
                f"{format_eigen(ev[ncomp - 1])}  - SSE: "
                f"{format_eigen(sse[ncomp - 1])}",
                file=file,
            )

    def print_state(self, file=None, complex_format: bool = False) -> None:
        """Dump P/W/R/Q/T/coefficients (reference pls.cpp:564-580).

        complex_format=True renders entries as Eigen complex tuples
        '(re,0)' for byte-level diffing against the reference CLI."""
        from pls_tpu.utils.reporting import format_eigen, format_eigen_complex

        fmt = format_eigen_complex if complex_format else format_eigen
        file = sys.stderr if file is None else file
        for label, mat in [
            ("P", self.P), ("W", self.W), ("R", self.R), ("Q", self.Q),
            ("T", self.T), ("coefficients", self.coefficients()),
        ]:
            print(f"{label}:", file=file)
            if mat.size:
                print(fmt(np.asarray(mat)), file=file)
            else:
                # Eigen's `os << T << endl` on an empty matrix emits just
                # the newline — keep the blank line for byte diffability
                print("", file=file)

    # ---------- checkpointing (absent in the reference; SURVEY.md §5) ----------
    def save(self, path: str, *, include_data: bool = False) -> None:
        """Serialize the fit state (W/P/Q/R/T + config) to .npz.

        By default the training data is NOT embedded: the model part is
        O(K·(3A+M)) floats, while X at framework scale (1M×10k) would be
        ~40 GB.  A model loaded without data predicts on new data but
        cannot re-run CV or no-argument diagnostics; pass
        `include_data=True` (the parity-test escape hatch) to restore the
        old everything-works-after-load behavior."""
        f = self._fit
        arrays = dict(
            W=np.asarray(f.W), P=np.asarray(f.P), Q=np.asarray(f.Q),
            R=np.asarray(f.R), T=np.asarray(f.T),
        )
        if include_data:
            arrays["X"] = np.asarray(self._X)
            arrays["Y"] = np.asarray(self._Y)
        np.savez(
            path,
            **arrays,
            meta=json.dumps({
                "method": self._method.value, "A": f.A,
                "power_iters": self._power_iters,
                "precision": self._precision,
            }),
        )

    @classmethod
    def load(cls, path: str) -> "PLSModel":
        z = np.load(path, allow_pickle=False)
        meta = json.loads(str(z["meta"]))
        method = METHOD(meta["method"])
        fit_state = PLSFit(
            W=jnp.asarray(z["W"]), P=jnp.asarray(z["P"]), Q=jnp.asarray(z["Q"]),
            R=jnp.asarray(z["R"]), T=jnp.asarray(z["T"]),
            method=method,
        )
        if "X" in z:
            return cls(
                z["X"], z["Y"], method, meta["A"],
                power_iters=meta.get("power_iters"),
                precision=meta.get("precision", "highest"),
                _fit_state=fit_state,
            )
        # data-less checkpoint: bypass __init__ (which requires X/Y)
        m = object.__new__(cls)
        m._X = None
        m._Y = None
        m._method = method
        m._power_iters = meta.get("power_iters")
        m._precision = meta.get("precision", "highest")
        m._fit = fit_state
        return m
