"""HMC on a declared flow-pushforward target, preconditioned by its own
transport.

The counterpart of the reference's warped-Gaussian example targets
(/root/reference/examples/nf_example_1d.jl builds its ground truth as a
CenterStretch∘Johnson pushforward of N(0,1)): a target DECLARED as an exact
pushforward — X = T(Z), Z ~ N(mu, diag(var)) — carries its own transport
T. Sampling the flow-preconditioned density logp(T(xi)) + ladj_T(xi) with
`mcmc.sample` sees the diagonal Gaussian N(mu, var) in whitened
coordinates, and pushing the draws forward through T lands them in data
space. No VI fit is needed because the declared chain IS the exact
transport.

Run: python examples/pushforward_hmc.py
"""
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import jax
import jax.numpy as jnp
import numpy as np

import enflows_tpu as ef
from enflows_tpu.mcmc import (FlowPushforwardTarget, flow_preconditioned,
                              sample)


def main():
    dim = 8
    key = jax.random.PRNGKey(0)
    v = lambda val: jnp.full((dim,), val, jnp.float32)

    # Ground-truth transport: rotate, stretch the tails, shift/scale.
    transport = ef.compose(
        ef.ScaleShift(a=jnp.linspace(0.5, 2.0, dim),
                      b=jnp.linspace(-1.0, 1.0, dim)),
        ef.invert(ef.Johnson(gamma=v(0.0), delta=v(4.0), xi=v(0.0),
                             lam=v(4.0))),
        ef.Householder(
            V=jax.random.normal(key, (4, dim), jnp.float32)
        ).canonicalize(),
    )
    mu = 0.3 * jnp.ones((dim,), jnp.float32)
    var = jnp.linspace(0.8, 1.4, dim)

    target = FlowPushforwardTarget(transport, base_mean=mu, base_var=var)
    pre = flow_preconditioned(target, target.transport)
    white, _, stats = sample(pre.logdensity_fn, jax.random.PRNGKey(1),
                             dim=dim, num_chains=256, num_warmup=200,
                             num_samples=500, algorithm="hmc")
    draws = pre.push_forward(white)

    # Monte-Carlo truth from the generative definition.
    z = mu + jnp.sqrt(var) * jax.random.normal(
        jax.random.PRNGKey(2), (200_000, dim), jnp.float32)
    xs = np.asarray(transport.forward(z))
    got = np.asarray(draws).reshape(-1, dim)
    mean_err = np.abs(got.mean(0) - xs.mean(0)).max()
    sd_rel = np.abs(got.std(0) / xs.std(0) - 1).max()
    print(f"preconditioned HMC: mean err {mean_err:.4f}, "
          f"sd rel err {sd_rel:.4f}, "
          f"accept {float(np.asarray(stats.accept_prob).mean()):.2f}")
    assert mean_err < 0.1 and sd_rel < 0.1
    print("OK")


if __name__ == "__main__":
    main()
