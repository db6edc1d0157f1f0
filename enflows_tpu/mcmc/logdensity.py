"""Log-density API and flow-preconditioned targets.

No reference counterpart (SURVEY.md §2b "HMC/NUTS over flow-preconditioned
targets" row): the reference stops at whitening/VI; this layer turns a
trained whitening flow into an MCMC preconditioner. A target log-density is
just a function ``(dim,) -> scalar`` (vmapped over chains by the samplers).

Flow preconditioning: if ``f`` maps whitened space -> data space (the
direction the reference calls "forward" for sampling, examples/
nf_variational_1d.jl:81-86), then MCMC runs in whitened coordinates xi with

    logp_white(xi) = logp(f(xi)) + ladj(f, xi)

and samples map back through ``f``. A perfectly trained whitening flow makes
logp_white a standard normal — the ideal geometry for HMC.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp

from ..bijectors.base import Bijector


class PreconditionedTarget(NamedTuple):
    """Whitened-space log-density plus the map back to data space."""
    logdensity_fn: Callable      # (dim,) -> scalar, whitened coordinates
    push_forward: Callable       # (..., dim) whitened -> (..., dim) data


def flow_preconditioned(logdensity_fn: Callable, flow: Bijector
                        ) -> PreconditionedTarget:
    """Precondition ``logdensity_fn`` with ``flow`` (whitened -> data).

    ``logdensity_fn``: per-sample target log-density, (dim,) -> scalar.
    ``flow``: bijector mapping whitened coordinates to data coordinates —
    i.e. the *inverse* of a trained whitening transform, or the transport
    learned by VI.
    """

    def logdensity_white(xi):
        z, ladj = flow.forward_and_ladj(xi)
        return logdensity_fn(z) + ladj

    return PreconditionedTarget(
        logdensity_fn=logdensity_white,
        push_forward=flow.forward,
    )


def value_and_grad_fn(logdensity_fn: Callable) -> Callable:
    """(q) -> (logp, grad). Samplers thread both to halve density evals."""
    return jax.value_and_grad(logdensity_fn)


class FlowPushforwardTarget:
    """A target declared EXACTLY as a flow pushforward: X = T(Z) with
    Z ~ N(base_mean, diag(base_var)) and ``transport`` T base -> data.

    Callable like any log-density ((dim,) -> scalar), so it works with
    every sampler:

        logp(x) = diag_normal_logpdf(T^{-1}(x)) + ladj_{T^{-1}}(x)

    The declared transport is the exact preconditioner for this target:
    ``infer`` samples through it by default (no VI fit), and
    ``flow_preconditioned`` takes it to sample in whitened coordinates.
    """

    def __init__(self, transport: Bijector, base_mean=None,
                 base_var=None):
        from ..bijectors import invert
        self.transport = transport
        self.whiten = invert(transport)
        self.base_mean = base_mean
        self.base_var = base_var

    def __call__(self, x):
        z, ladj = self.whiten.forward_and_ladj(x)
        mu = 0.0 if self.base_mean is None else self.base_mean
        var = 1.0 if self.base_var is None else self.base_var
        d = z - mu
        lp = -0.5 * jnp.sum(d * d / var + jnp.log(2 * jnp.pi * var)
                            * jnp.ones_like(z))
        return lp + ladj
