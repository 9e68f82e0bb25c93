"""Data-integration + modeling workflow on synthetic paired-omics data:

  1. O2PLS joint/orthogonal decomposition of two blocks (e.g.
     transcriptomics X vs metabolomics Y) with bidirectional prediction
  2. PLS-SEM over three latent constructs with bootstrap path inference
  3. logistic PLS-GLM for a binary phenotype
  4. PLS-Cox for a survival endpoint in the K >> N regime

Run:  python examples/omics_integration.py
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# the walkthrough uses f64 for reference-grade numbers; pin CPU so the
# printed numbers are the same on every host
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402

import pls_tpu as pt  # noqa: E402


def main() -> None:
    rng = np.random.default_rng(0)
    N, Kx, Ky = 200, 60, 40
    latent = rng.normal(size=(N, 3))

    # two omics blocks sharing the latent structure + block-specific noise
    X = latent @ rng.normal(size=(3, Kx)) + rng.normal(size=(N, 1)) @ rng.normal(size=(1, Kx)) * 1.5
    Y = latent @ rng.normal(size=(3, Ky)) + rng.normal(size=(N, 1)) @ rng.normal(size=(1, Ky)) * 1.5
    X += 0.3 * rng.normal(size=X.shape)
    Y += 0.3 * rng.normal(size=Y.shape)
    Xz = pt.colwise_z_scores(jnp.asarray(X))
    Yz = pt.colwise_z_scores(jnp.asarray(Y))

    # 1. O2PLS
    f = pt.fit_o2pls(Xz, Yz, n=3, nx=1, ny=1)
    print(f"O2PLS: R2X joint {float(f.r2x_joint):.2f} / orth "
          f"{np.asarray(f.r2x_orth).sum():.2f};  R2Y joint "
          f"{float(f.r2y_joint):.2f}")
    yhat = pt.o2pls_predict_y(f, Xz)
    r2 = 1 - float(jnp.sum((yhat - Yz) ** 2) / jnp.sum(Yz**2))
    print(f"O2PLS X->Y prediction R2 (train): {r2:.2f}")

    # 2. PLS-SEM on three constructs built from the concatenated blocks
    Z = jnp.concatenate([Xz[:, :6], Yz[:, :6]], axis=1)
    blocks = [[0, 1, 2, 3], [4, 5, 6, 7], [8, 9, 10, 11]]
    path = np.zeros((3, 3))
    path[1, 0] = path[2, 0] = path[2, 1] = 1
    pm = pt.fit_plspm(Z, blocks, path)
    bs = pt.bootstrap_plspm(Z, blocks, path, n_boot=200)
    print(f"PLS-SEM paths:\n{np.asarray(pm.paths).round(2)}")
    print(f"bootstrap t-values:\n{np.asarray(bs.paths_t).round(1)}")

    # 3. binary phenotype from the first latent
    y_bin = (latent[:, 0] + 0.5 * rng.normal(size=N) > 0).astype(float)
    clf = pt.PLSGLMClassifier(n_components=3).fit(np.asarray(X), y_bin)
    print(f"logistic PLS-GLM accuracy: {clf.score(np.asarray(X), y_bin):.2f} "
          f"(deviance {clf.deviance_:.1f})")

    # 4. survival endpoint, K >> N slice
    t_fail = rng.exponential(np.exp(-latent[:, 1]))
    censor = rng.exponential(np.quantile(t_fail, 0.8), size=N)
    time_obs = np.minimum(t_fail, censor)
    event = (t_fail <= censor).astype(float)
    cox = pt.fit_plscox(Xz, jnp.asarray(time_obs), jnp.asarray(event), A=2)
    ci = pt.concordance_index(
        time_obs, event, np.asarray(pt.predict_plscox(cox, Xz))
    )
    print(f"PLS-Cox concordance index: {ci:.2f} "
          f"(score norm {float(cox.score_norm):.1e})")


if __name__ == "__main__":
    main()
