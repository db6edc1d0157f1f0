"""Multimodal marginals with rational-quadratic spline couplings.

A SINGLE affine coupling cannot split its transformed half's mass (per
conditional slice it only scales and shifts), and no affine/linear map
of any kind can whiten a bimodal marginal. Alternating affine stacks
(RealNVP) recover some multimodality through their conditioner
nonlinearity, but pay for it in depth; rational-quadratic splines
(bijectors/spline.py, Durkan et al. 2019 family) give every transformed
dimension a K-bin monotone free-form warp that places the split
directly. This script shows the spline tier end to end on a bimodal
target, against both the best-linear bound (decisively) and an
equal-size affine stack (measurably):

    x0 ~ 1/2 N(-2, 0.5^2) + 1/2 N(+2, 0.5^2)      (bimodal marginal)
    x1 | x0 ~ N(0.5 * x0, 0.8^2)                  (conditional shift)

1. fit a spline-coupling WHITENING flow by maximum likelihood and check
   it beats the best-LINEAR bound (the analytic optimum of every
   linear map: the Gaussian MLE negll) by a clear margin AND an affine
   coupling stack of the same size/steps by a measurable one;
2. sample the learned flow (exact parameter-sharing inverse) and verify
   the pushforward reproduces the bimodal structure: mode balance,
   mid-gap mass, moments;
3. refine the learned transport by VI with ``optimize_elbo(stl=True)``
   against the analytic log-density, WARM-STARTED from the inverted MLE
   fit. (Cold-started reverse-KL VI mode-seeks and collapses to one
   mode on this target — the caveat ``infer``'s docstring documents;
   warm-starting from the mode-covering forward-KL fit composes the two
   trainers, and near q = p is exactly where the sticking-the-landing
   estimator's variance advantage is largest.) Check both modes stay
   covered and the nELBO tail is tight.

Run: python examples/spline_multimodal_2d.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np
import optax

import enflows_tpu as ef
from enflows_tpu.train import optimize_whitening, optimize_elbo, \
    mvnormal_negll


def make_data(n, seed=0):
    rng = np.random.default_rng(seed)
    comp = rng.integers(0, 2, n)
    x0 = rng.normal(0, 0.5, n) + np.where(comp, 2.0, -2.0)
    x1 = 0.5 * x0 + rng.normal(0, 0.8, n)
    return jnp.asarray(np.stack([x0, x1], 1), jnp.float32)


def log_density(z):
    x0, x1 = z[..., 0], z[..., 1]
    m = jnp.logaddexp(-0.5 * ((x0 - 2.0) / 0.5) ** 2,
                      -0.5 * ((x0 + 2.0) / 0.5) ** 2) \
        - jnp.log(2.0) - 0.5 * jnp.log(2 * jnp.pi) - jnp.log(0.5)
    c = -0.5 * ((x1 - 0.5 * x0) / 0.8) ** 2 \
        - 0.5 * jnp.log(2 * jnp.pi) - jnp.log(0.8)
    return m + c


def main():
    X = make_data(65536)
    cov = np.cov(np.asarray(X).T)
    gauss_bound = 0.5 * 2 * (1 + np.log(2 * np.pi)) \
        + 0.5 * np.linalg.slogdet(cov)[1]

    # 1. MLE whitening: spline vs affine stacks of equal size.
    kw = dict(nbatches=64, nepochs=30)
    spl = ef.spline_coupling_stack(jax.random.PRNGKey(0), 2, n_layers=3,
                                   hidden=(32,), n_bins=8, bound=6.0)
    aff = ef.coupling_stack(jax.random.PRNGKey(0), 2, n_layers=3,
                            hidden=(32,))
    r_spl = optimize_whitening(X, spl, optax.adam(5e-3), **kw)
    r_aff = optimize_whitening(X, aff, optax.adam(5e-3), **kw)
    n_spl = float(mvnormal_negll(r_spl.result, X))
    n_aff = float(mvnormal_negll(r_aff.result, X))
    print(f"negll  spline {n_spl:.4f}  affine {n_aff:.4f}  "
          f"gaussian-bound {gauss_bound:.4f}")
    assert n_spl < gauss_bound - 0.25, "spline did not beat the linear bound"
    # Measured: spline 2.630 vs affine 2.726 at this config (the affine
    # stack's conditioner nonlinearity buys back some multimodality).
    assert n_spl < n_aff - 0.05, "spline did not beat the affine stack"

    # 2. Sampling direction: exact inverse pushes base normals to data.
    z = jax.random.normal(jax.random.PRNGKey(1), (65536, 2), jnp.float32)
    samp = np.asarray(r_spl.result.inverse().forward(z))
    bal = float((samp[:, 0] > 0).mean())
    gap = float((np.abs(samp[:, 0]) < 0.7).mean())
    print(f"pushforward: mode balance {bal:.3f}, mid-gap mass {gap:.4f}, "
          f"mean {samp.mean(0).round(3)}, sd {samp.std(0).round(3)}")
    assert 0.4 < bal < 0.6 and gap < 0.05

    # 3. VI refinement with sticking-the-landing gradients, warm-started
    # from the inverted MLE transport (base -> data direction).
    flow = ef.invert(r_spl.result)
    # Gentle refinement: reverse KL still PULLS toward one mode whenever
    # the family can't represent the target exactly, so the step budget
    # and lr are sized to polish, not to re-tilt the fit.
    r_vi = optimize_elbo(log_density, flow, optax.adam(3e-4), dim=2,
                         batch_size=512, nsteps=300, stl=True,
                         key=jax.random.PRNGKey(3))
    zvi = np.asarray(r_vi.result.forward(
        jax.random.normal(jax.random.PRNGKey(4), (65536, 2), jnp.float32)))
    bal_vi = float((zvi[:, 0] > 0).mean())
    print(f"VI(stl): tail nELBO "
          f"{float(jnp.mean(r_vi.nelbo_history[-50:])):.4f}, "
          f"mode balance {bal_vi:.3f}")
    assert 0.25 < bal_vi < 0.75, "VI collapsed to one mode"
    print("OK")


if __name__ == "__main__":
    main()
