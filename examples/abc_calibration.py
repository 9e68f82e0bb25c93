#!/usr/bin/env python
"""Simulation calibration with PLS — the reference library's native
habitat.

tjhladish/PLS is designed to be embedded as a git submodule in larger
simulation projects (reference README.md:11-14): fit PLS on a Latin-
hypercube of (parameters → simulation metrics) pairs and use the inverse
mapping inside AMBC/ABC-SMC calibration loops.  This example runs that
workflow end-to-end on a synthetic stochastic epidemic model:

  1. sample a parameter design Θ (the "prior draws");
  2. run the simulator at each θ, collecting summary metrics S(θ)
     (vmapped on device — thousands of simulations in one dispatch);
  3. fit PLS metrics → parameters (the ABC regression-adjustment
     direction), choosing components by LOO PRESS + Wilcoxon exactly as
     the reference CLI does;
  4. given observed metrics s*, keep the design points nearest s* in
     PLS score space (the ABC acceptance step) and report the
     regression-adjusted posterior for θ — sharpened vs the raw
     accepted-sample posterior;
  5. show the true θ* falls inside the adjusted posterior interval.

Run: python examples/abc_calibration.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax

# pin CPU so the printed numbers are the same on every host
jax.config.update("jax_platforms", "cpu")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import pls_tpu as pt  # noqa: E402


def simulate(theta, key):
    """A stochastic SIR-flavored toy simulator.

    theta = (log_R0, log_gamma, log_i0): transmissibility, recovery
    rate, initial infected fraction.  Returns 6 summary metrics (peak
    size/time, final size, early growth rate, duration, jitter-laden
    noise channel).  Deterministic skeleton + parameter-dependent noise,
    all in lax so the whole prior design vmaps into one program.
    """
    log_r0, log_gamma, log_i0 = theta
    r0 = jnp.exp(log_r0)
    gamma = jnp.exp(log_gamma)
    beta = r0 * gamma
    i0 = jnp.exp(log_i0)

    def step(carry, k):
        s, i, r = carry
        noise = 1.0 + 0.05 * jax.random.normal(k)
        new_inf = jnp.clip(beta * s * i * noise, 0.0, s)
        new_rec = jnp.clip(gamma * i, 0.0, i + new_inf)
        s = s - new_inf
        i = i + new_inf - new_rec
        r = r + new_rec
        return (s, i, r), i

    T = 120
    keys = jax.random.split(key, T)
    (_, _, r_final), i_traj = jax.lax.scan(step, (1.0 - i0, i0, 0.0), keys)
    peak = jnp.max(i_traj)
    peak_t = jnp.argmax(i_traj).astype(jnp.float32)
    growth = jnp.log(jnp.clip(i_traj[9] / i_traj[0], 1e-6)) / 10.0
    dur = jnp.sum(i_traj > 0.5 * peak).astype(jnp.float32)
    return jnp.stack([
        peak, peak_t / T, r_final, growth, dur / T,
        jnp.log(jnp.clip(peak * r_final, 1e-9)),
    ])


def main() -> None:
    key = jax.random.key(7)
    k_design, k_sim, k_obs = jax.random.split(key, 3)

    # 1. prior design: uniform box in log space (a cheap LHS stand-in)
    n_design = 4096
    lo = jnp.array([jnp.log(1.2), jnp.log(0.05), jnp.log(1e-4)])
    hi = jnp.array([jnp.log(4.0), jnp.log(0.5), jnp.log(1e-2)])
    U = jax.random.uniform(k_design, (n_design, 3))
    Theta = lo + U * (hi - lo)

    # 2. run ALL simulations in one vmapped dispatch
    sim_keys = jax.random.split(k_sim, n_design)
    S = jax.vmap(simulate)(Theta, sim_keys)  # (n_design, 6)
    print(f"simulated {n_design} parameter sets -> metrics {S.shape}")

    # 3. PLS metrics -> parameters, reference-style component choice
    xs = pt.ZScorer.fit(S)
    ys = pt.ZScorer.fit(Theta)
    Xz = xs.transform(S)
    Yz = ys.transform(Theta)
    model = pt.PLSModel(Xz, Yz, pt.KERNEL_TYPE1, 6)
    loo = model.cv_LOO(downdate=False, batch_size=512)
    opt = pt.optimal_num_components(loo)
    A = int(np.max(np.asarray(opt)))
    print(f"LOO-optimal components per parameter: {np.asarray(opt)} -> A={A}")

    # 4. "observed" data from a hidden true parameter
    theta_true = jnp.array([jnp.log(2.2), jnp.log(0.18), jnp.log(2e-3)])
    s_obs = simulate(theta_true, k_obs)
    s_obs_z = xs.transform(s_obs[None, :])[0]

    # ABC acceptance in PLS score space (scores whiten the metric space
    # along the directions that matter for the parameters)
    t_design = np.asarray(model.scores(comp=A))
    t_obs = np.asarray(model.scores(s_obs_z[None, :], comp=A))[0]
    d = np.linalg.norm(t_design - t_obs, axis=1)
    eps_q = 0.05  # keep the closest 5%
    keep = d <= np.quantile(d, eps_q)
    acc = np.asarray(Theta)[keep]
    print(f"accepted {keep.sum()} / {n_design} draws (closest {eps_q:.0%})")

    # 5. regression adjustment (Beaumont-style, using the SAME PLS model):
    #    theta_adj = theta_i - Bhat (s_i - s_obs), in z-space
    B = np.asarray(model.coefficients(A))  # (metrics_z -> params_z)
    Sz_acc = np.asarray(Xz)[keep]
    adj_z = np.asarray(Yz)[keep] - (Sz_acc - np.asarray(s_obs_z)) @ B
    adj = np.asarray(ys.inverse(adj_z))

    names = ["log_R0", "log_gamma", "log_i0"]
    print("\nposterior (accepted raw vs regression-adjusted), truth in []:")
    inside = []
    for j, name in enumerate(names):
        raw_lo, raw_hi = np.quantile(acc[:, j], [0.025, 0.975])
        a_lo, a_hi = np.quantile(adj[:, j], [0.025, 0.975])
        tj = float(theta_true[j])
        inside.append(a_lo <= tj <= a_hi)
        print(
            f"  {name:9s} raw 95% [{raw_lo:+.3f}, {raw_hi:+.3f}]"
            f"  adj 95% [{a_lo:+.3f}, {a_hi:+.3f}]  truth [{tj:+.3f}]"
            f"  width x{(a_hi - a_lo) / (raw_hi - raw_lo):.2f}"
        )
    assert all(inside), "true parameter escaped the adjusted posterior"
    print("\nOK: truth covered by the PLS-adjusted ABC posterior")


if __name__ == "__main__":
    main()
