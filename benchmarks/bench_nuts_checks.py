"""A/B benchmark: NUTS merge-boundary U-turn checks (Stan-style) on vs off.

Measures min-bulk-ESS per gradient evaluation on hard geometries —
a 0.99-correlated 2D Gaussian (identity mass matrix keeps the geometry
hard), a banana, and a 50D correlated Gaussian — the gate for VERDICT r1
weak #3 / next-step #7: the checks must be ESS/grad equal-or-better.

Run: python benchmarks/bench_nuts_checks.py [--cpu]
"""
from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np

if "--cpu" in sys.argv:
    import jax
    jax.config.update("jax_platforms", "cpu")
import jax

from enflows_tpu.utils.compilation_cache import \
    enable_persistent_compilation_cache

enable_persistent_compilation_cache()
import jax.numpy as jnp

from enflows_tpu.mcmc.nuts import nuts_kernel
from enflows_tpu.mcmc.sample import window_adaptation, run_chains
from enflows_tpu.mcmc.hmc import init_state
from enflows_tpu.mcmc.diagnostics import bulk_ess


def corr_gauss_2d(rho=0.99):
    prec = np.linalg.inv(np.array([[1.0, rho], [rho, 1.0]]))
    P = jnp.asarray(prec, jnp.float32)
    return lambda q: -0.5 * q @ P @ q, 2


def banana():
    def logp(q):
        return (-0.5 * q[0] ** 2 / 100.0
                - 0.5 * (q[1] + 0.03 * q[0] ** 2 - 3.0) ** 2)
    return logp, 2


def corr_gauss_50d(rho=0.9):
    d = 50
    C = rho * np.ones((d, d)) + (1 - rho) * np.eye(d)
    prec = np.linalg.inv(C)
    P = jnp.asarray(prec, jnp.float32)
    return lambda q: -0.5 * q @ P @ q, d


def run(logp, dim, extra, *, chains=64, warmup=500, steps=1000, seed=0):
    kernel = nuts_kernel(logp, max_depth=10, extra_uturn_checks=extra)
    key = jax.random.PRNGKey(seed)
    k0, kw, ks = jax.random.split(key, 3)
    q0 = 0.1 * jax.random.normal(k0, (chains, dim), jnp.float32)

    @jax.jit
    def go():
        states = jax.vmap(lambda q: init_state(logp, q))(q0)
        warm = window_adaptation(kernel, states, kw, warmup)
        return run_chains(kernel, warm.states, ks, steps,
                          warm.step_size, warm.inv_mass_diag)

    qs, _, stats = jax.block_until_ready(go())
    x = np.asarray(qs, np.float64)
    ess = min(bulk_ess(x[..., d]) for d in range(min(dim, 8)))
    grads = float(np.asarray(stats.num_steps, np.float64).sum())
    div = int(np.asarray(stats.divergent).sum())
    return ess, grads, div


def main():
    print(f"backend={jax.default_backend()}")
    targets = {
        "2d_gauss_rho0.99": corr_gauss_2d(),
        "banana": banana(),
        "50d_gauss_rho0.9": corr_gauss_50d(),
    }
    for name, (logp, dim) in targets.items():
        rows = {}
        for extra in (False, True):
            ess, grads, div = run(logp, dim, extra)
            rows[extra] = (ess, grads, div)
            print(f"{name:20s} extra={extra!s:5s} minESS={ess:9.1f} "
                  f"grads={grads:12.0f} ESS/grad={ess / grads:.3e} "
                  f"div={div}")
        gain = (rows[True][0] / rows[True][1]) / \
               (rows[False][0] / rows[False][1])
        print(f"{name:20s} ESS/grad gain with checks: {gain:.3f}x")


if __name__ == "__main__":
    main()
