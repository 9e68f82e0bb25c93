"""Spectral preprocessing: the standard chemometric companions to PLS.

The reference ships the classic gasoline-NIR calibration set (nir.csv /
octane.csv — SURVEY.md §2 #27) but leaves spectral pretreatment to the
user.  Every serious PLS-on-spectra workflow applies one or more of the
transforms below before z-scoring/fitting; this module provides them as
pure jittable functions plus thin sklearn-protocol transformer facades
(usable inside `sklearn.pipeline.Pipeline` ahead of our estimators).

Implemented transforms (rows = samples, columns = channels/wavelengths):

- **SNV** — standard normal variate (Barnes, Dhanoa & Lister 1989,
  Appl. Spectrosc. 43:772): per-row centering and unit-variance scaling.
- **MSC** — multiplicative scatter correction (Geladi, MacDougall &
  Martens 1985, Appl. Spectrosc. 39:491): each spectrum is regressed on a
  reference spectrum (the training mean), then corrected to (x − a)/b.
  Stateful: the reference spectrum is learned at fit time.
- **Savitzky–Golay** smoothing/derivatives (Savitzky & Golay 1964, Anal.
  Chem. 36:1627) with scipy-compatible `mode="interp"` edge handling.
- **detrend** — subtract a per-row least-squares polynomial baseline.
- **normalize** — per-row l1/l2/max/area normalization.

Device mapping: SNV/detrend/normalize are row-wise reductions; MSC is
two matvecs against the reference spectrum; Savitzky–Golay interior
points are one `lax.conv_general_dilated` (filter length = window) and
the two edge blocks are small static matmuls — all static shapes, all
batched over N.
"""

from __future__ import annotations

from math import factorial

import jax
import jax.numpy as jnp
import numpy as np

__all__ = [
    "snv",
    "msc",
    "MSCorrection",
    "savgol",
    "savgol_coeffs",
    "detrend",
    "normalize",
    "SNV",
    "SavitzkyGolay",
    "Detrend",
]


def snv(X) -> jnp.ndarray:
    """Standard normal variate: per-row (x − mean) / stdev (ddof=1).

    Constant rows (stdev 0) map to exactly 0 (same guard convention as
    ops/stats.colwise_z_scores)."""
    X = jnp.atleast_2d(jnp.asarray(X))
    mu = jnp.mean(X, axis=1, keepdims=True)
    Xc = X - mu
    n = X.shape[1]
    sd = jnp.sqrt(jnp.sum(Xc * Xc, axis=1, keepdims=True) / max(n - 1, 1))
    return jnp.where(sd == 0, jnp.zeros_like(Xc), Xc / jnp.where(sd == 0, 1.0, sd))


@jax.jit
def _msc_apply(X: jnp.ndarray, ref: jnp.ndarray) -> jnp.ndarray:
    refc = ref - jnp.mean(ref)
    denom = refc @ refc
    mu = jnp.mean(X, axis=1, keepdims=True)
    # per-row OLS of x on [1, ref]:  b = cov(ref, x)/var(ref), a = x̄ − b·ref̄
    b = ((X - mu) @ refc) / denom  # (N,)
    # degenerate rows (near-zero slope, e.g. a dead sensor) pass through
    # UNCHANGED: an exact-zero-only guard would let b ~ 1e-12 blow the
    # row up by 1/b
    degenerate = jnp.abs(b) < 1e-8
    b = jnp.where(degenerate, 1.0, b)
    a = jnp.where(degenerate, 0.0, mu[:, 0] - b * jnp.mean(ref))
    return (X - a[:, None]) / b[:, None]


def msc(X, reference=None) -> jnp.ndarray:
    """Multiplicative scatter correction against `reference` (default:
    the column-mean spectrum of X itself).  For train/apply splits use
    `MSCorrection` so new spectra are corrected against the *training*
    mean."""
    X = jnp.atleast_2d(jnp.asarray(X))
    ref = jnp.mean(X, axis=0) if reference is None else jnp.asarray(reference)
    return _msc_apply(X, ref.astype(X.dtype))


class MSCorrection:
    """Stateful MSC (sklearn protocol): the reference spectrum is learned
    from the training set at fit time, so held-out spectra are corrected
    against the *training* mean."""

    def __init__(self):
        self.reference_: np.ndarray | None = None

    def fit(self, X, y=None) -> "MSCorrection":
        X = jnp.atleast_2d(jnp.asarray(X))
        self.reference_ = np.asarray(jnp.mean(X, axis=0))
        return self

    def transform(self, X) -> np.ndarray:
        if self.reference_ is None:
            raise RuntimeError("MSCorrection.transform called before fit")
        X = jnp.atleast_2d(jnp.asarray(X))
        return np.asarray(_msc_apply(X, jnp.asarray(self.reference_, X.dtype)))

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.fit(X).transform(X)

    def get_params(self, deep: bool = True) -> dict:
        return {}

    def set_params(self, **params) -> "MSCorrection":
        return self

    def __sklearn_tags__(self):
        return _transformer_tags()


def savgol_coeffs(
    window: int, polyorder: int, deriv: int = 0, delta: float = 1.0
) -> np.ndarray:
    """Centered Savitzky–Golay FIR coefficients (length `window`), such
    that `y[i] = c · x[i-h : i+h+1]` is the `deriv`-th derivative of the
    local degree-`polyorder` least-squares polynomial at the center.
    Matches scipy.signal.savgol_coeffs(..., use='dot')."""
    inter, _, _ = _sg_matrices(window, polyorder, deriv, delta)
    return inter


def _sg_matrices(window: int, polyorder: int, deriv: int, delta: float):
    """Static (numpy, f64) SG operators: interior centered coefficients
    (window,), and left/right edge evaluation matrices (half, window)
    implementing scipy's mode='interp' — the edge values come from the
    polynomial fit to the first/last `window` samples."""
    if window % 2 != 1 or window < 3:
        raise ValueError(f"window={window} must be odd and >= 3")
    if polyorder >= window:
        raise ValueError(f"polyorder={polyorder} must be < window={window}")
    if deriv > polyorder:
        raise ValueError(f"deriv={deriv} must be <= polyorder={polyorder}")
    half = window // 2
    # positions 0..w-1 within a window; pinv of the Vandermonde gives the
    # least-squares polynomial coefficients a_j from the window samples
    x = np.arange(window, dtype=np.float64)
    V = x[:, None] ** np.arange(polyorder + 1)[None, :]  # (w, p+1)
    Pinv = np.linalg.pinv(V)  # (p+1, w)
    # deriv-d evaluation of the fitted poly at position t:
    #   f^(d)(t) = Σ_{j>=d} a_j · j!/(j−d)! · t^(j−d)
    j = np.arange(polyorder + 1)
    fall = np.where(
        j >= deriv,
        np.array([factorial(int(jj)) / factorial(int(jj - deriv)) if jj >= deriv else 0.0 for jj in j]),
        0.0,
    )

    def eval_at(ts: np.ndarray) -> np.ndarray:
        # rows: one output position each; columns: window samples
        powers = np.where(
            (j - deriv)[None, :] >= 0,
            ts[:, None] ** np.clip(j - deriv, 0, None)[None, :],
            0.0,
        )
        return (powers * fall[None, :]) @ Pinv / (delta**deriv)

    interior = eval_at(np.array([float(half)]))[0]  # centered coefficients
    left = eval_at(np.arange(half, dtype=np.float64))  # t = 0..half-1
    right = eval_at(np.arange(half + 1, window, dtype=np.float64))  # tail
    return interior, left, right


def savgol(
    X,
    window: int,
    polyorder: int,
    deriv: int = 0,
    delta: float = 1.0,
) -> jnp.ndarray:
    """Savitzky–Golay filter / derivative along the channel axis.

    Equivalent to `scipy.signal.savgol_filter(X, window, polyorder,
    deriv=deriv, delta=delta, axis=1, mode='interp')`.  Interior points
    are one depthwise convolution; the `window//2` edge points on each
    side are evaluated from the polynomial fit to the first/last
    `window` samples (two small static matmuls)."""
    X = jnp.atleast_2d(jnp.asarray(X))
    K = X.shape[1]
    if K < window:
        raise ValueError(f"n_channels={K} must be >= window={window}")
    inter, left, right = _sg_matrices(window, polyorder, deriv, delta)
    half = window // 2
    c = jnp.asarray(inter, X.dtype)
    # valid cross-correlation over channels: (N,1,K) ⊛ (1,1,w) → (N,1,K-w+1)
    mid = jax.lax.conv_general_dilated(
        X[:, None, :],
        c[None, None, :],
        window_strides=(1,),
        padding="VALID",
    )[:, 0, :]
    lblk = X[:, :window] @ jnp.asarray(left, X.dtype).T  # (N, half)
    rblk = X[:, -window:] @ jnp.asarray(right, X.dtype).T  # (N, half)
    return jnp.concatenate([lblk, mid, rblk], axis=1)


def detrend(X, order: int = 1) -> jnp.ndarray:
    """Subtract the per-row least-squares polynomial of degree `order`
    over the channel index (order=1 removes a linear baseline)."""
    X = jnp.atleast_2d(jnp.asarray(X))
    K = X.shape[1]
    x = np.arange(K, dtype=np.float64)
    x = (x - x.mean()) / max(x.std(), 1.0)  # conditioning
    V = x[:, None] ** np.arange(order + 1)[None, :]
    Pr = V @ np.linalg.pinv(V)  # (K, K) projection onto the baseline space
    return X - X @ jnp.asarray(Pr.T, X.dtype)


def normalize(X, norm: str = "l2") -> jnp.ndarray:
    """Per-row normalization: 'l1', 'l2', 'max', or 'area' (signed sum)."""
    X = jnp.atleast_2d(jnp.asarray(X))
    if norm == "l2":
        s = jnp.sqrt(jnp.sum(X * X, axis=1, keepdims=True))
    elif norm == "l1":
        s = jnp.sum(jnp.abs(X), axis=1, keepdims=True)
    elif norm == "max":
        s = jnp.max(jnp.abs(X), axis=1, keepdims=True)
    elif norm == "area":
        s = jnp.abs(jnp.sum(X, axis=1, keepdims=True))
    else:
        raise ValueError(f"unknown norm {norm!r}")
    return X / jnp.where(s == 0, 1.0, s)


def apply_chain(X, spec: str) -> jnp.ndarray:
    """Apply a comma-separated preprocessing chain, e.g.
    ``"savgol:11:2:1,snv"`` (the CLI's --preprocess syntax).

    Tokens: ``snv`` | ``msc`` | ``detrend[:order]`` |
    ``savgol:window:polyorder[:deriv[:delta]]`` | ``norm[:l1|l2|max|area]``.
    Applied left to right to the rows of X."""
    for token in spec.split(","):
        token = token.strip()
        if not token:
            continue
        name, *ps = token.split(":")
        if name == "snv":
            X = snv(X)
        elif name == "msc":
            X = msc(X)
        elif name == "detrend":
            X = detrend(X, int(ps[0]) if ps else 1)
        elif name == "savgol":
            if len(ps) < 2:
                raise ValueError(
                    f"savgol needs window:polyorder (got {token!r})"
                )
            X = savgol(
                X, int(ps[0]), int(ps[1]),
                int(ps[2]) if len(ps) > 2 else 0,
                float(ps[3]) if len(ps) > 3 else 1.0,
            )
        elif name == "norm":
            X = normalize(X, ps[0] if ps else "l2")
        else:
            raise ValueError(f"unknown preprocessing step {name!r}")
    return X


def _transformer_tags():
    """sklearn ≥1.6 tag object for a transformer (lazy import — shared
    shim lives in estimator.py)."""
    from pls_tpu.estimator import _sklearn_tags

    return _sklearn_tags("transformer")


class _StatelessTransformer:
    """sklearn-protocol facade over a stateless row transform."""

    def fit(self, X, y=None):
        return self

    def __sklearn_tags__(self):
        return _transformer_tags()

    def fit_transform(self, X, y=None) -> np.ndarray:
        return self.transform(X)

    def get_params(self, deep: bool = True) -> dict:
        return {k: v for k, v in self.__dict__.items()}

    def set_params(self, **params):
        for k, v in params.items():
            setattr(self, k, v)
        return self


class SNV(_StatelessTransformer):
    def transform(self, X) -> np.ndarray:
        return np.asarray(snv(X))


class SavitzkyGolay(_StatelessTransformer):
    def __init__(self, window: int = 11, polyorder: int = 2, deriv: int = 0,
                 delta: float = 1.0):
        self.window = window
        self.polyorder = polyorder
        self.deriv = deriv
        self.delta = delta

    def transform(self, X) -> np.ndarray:
        return np.asarray(
            savgol(X, self.window, self.polyorder, self.deriv, self.delta)
        )


class Detrend(_StatelessTransformer):
    def __init__(self, order: int = 1):
        self.order = order

    def transform(self, X) -> np.ndarray:
        return np.asarray(detrend(X, self.order))
