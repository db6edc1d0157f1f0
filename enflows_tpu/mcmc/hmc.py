"""Hamiltonian Monte Carlo: leapfrog integrator and Metropolis HMC kernel.

No reference counterpart (SURVEY.md §2b): the integrator is a
`lax.fori_loop` of fused elementwise updates (fully jittable), the kernel
is pure and vmaps over a chains axis, and every draw
uses explicit `jax.random` keys so multi-chip sharding stays deterministic.

Conventions: position/momentum are (dim,) per chain; a diagonal mass matrix
is carried as ``inv_mass_diag`` (M^-1). Momentum p ~ N(0, M); kinetic energy
0.5 * p^T M^-1 p; velocity v = M^-1 p. ``step_size`` and ``inv_mass_diag``
are *traced kernel arguments* (not closure constants) so warmup adaptation
can update them inside a single jitted scan.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax


class HMCState(NamedTuple):
    q: jax.Array          # position (dim,)
    logp: jax.Array       # target log-density at q
    grad: jax.Array       # d logp / dq


class HMCInfo(NamedTuple):
    accept_prob: jax.Array
    accepted: jax.Array
    divergent: jax.Array
    energy: jax.Array
    num_steps: jax.Array


def init_state(logdensity_fn: Callable, q: jax.Array) -> HMCState:
    logp, grad = jax.value_and_grad(logdensity_fn)(q)
    return HMCState(q=q, logp=logp, grad=grad)


def sample_momentum(key, inv_mass_diag, shape, dtype):
    """p ~ N(0, M) with M = diag(1/inv_mass_diag)."""
    eps = jax.random.normal(key, shape, dtype)
    return eps * lax.rsqrt(inv_mass_diag)


def kinetic_energy(p, inv_mass_diag):
    return 0.5 * jnp.sum(p * p * inv_mass_diag, axis=-1)


def leapfrog(value_grad_fn: Callable, q, p, grad, step_size, inv_mass_diag,
             num_steps: int):
    """``num_steps`` leapfrog steps; returns (q, p, logp, grad).

    Velocity-Verlet with the half-steps fused: one gradient eval per step
    inside a `lax.fori_loop`, positions updated with the *mass-scaled*
    momentum (v = M^-1 p).
    """

    def step(_, carry):
        q, p, _, grad = carry
        p_half = p + 0.5 * step_size * grad
        q_new = q + step_size * p_half * inv_mass_diag
        logp_new, grad_new = value_grad_fn(q_new)
        p_new = p_half + 0.5 * step_size * grad_new
        return (q_new, p_new, logp_new, grad_new)

    logp0 = jnp.zeros((), q.dtype)
    return lax.fori_loop(0, num_steps, step, (q, p, logp0, grad))


def hmc_kernel(logdensity_fn: Callable, num_steps: int = 32,
               divergence_threshold: float = 1000.0):
    """Build a one-transition HMC kernel:
    (key, state, step_size, inv_mass_diag) -> (state, info).
    """
    value_grad_fn = jax.value_and_grad(logdensity_fn)

    def kernel(key, state: HMCState, step_size, inv_mass_diag):
        key_mom, key_acc = jax.random.split(key)
        p = sample_momentum(key_mom, inv_mass_diag, state.q.shape,
                            state.q.dtype)
        energy0 = -state.logp + kinetic_energy(p, inv_mass_diag)

        q_new, p_new, logp_new, grad_new = leapfrog(
            value_grad_fn, state.q, p, state.grad, step_size,
            inv_mass_diag, num_steps)

        energy1 = -logp_new + kinetic_energy(p_new, inv_mass_diag)
        delta = energy0 - energy1
        delta = jnp.where(jnp.isnan(delta), -jnp.inf, delta)
        divergent = -delta > divergence_threshold
        accept_prob = jnp.minimum(1.0, jnp.exp(delta))
        u = jax.random.uniform(key_acc, (), state.q.dtype)
        accepted = u < accept_prob

        new_state = HMCState(
            q=jnp.where(accepted, q_new, state.q),
            logp=jnp.where(accepted, logp_new, state.logp),
            grad=jnp.where(accepted, grad_new, state.grad),
        )
        info = HMCInfo(accept_prob=accept_prob, accepted=accepted,
                       divergent=divergent,
                       # H of the *accepted* state (on rejection: the
                       # initial point with its fresh momentum) — what
                       # the BFMI energy marginal is defined over.
                       energy=jnp.where(accepted, energy1, energy0),
                       num_steps=jnp.asarray(num_steps))
        return new_state, info

    return kernel
