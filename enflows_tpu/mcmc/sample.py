"""Chain drivers: windowed warmup + sampling, vmapped & shardable chains.

No reference counterpart (SURVEY.md §2b). The entire warmup and the entire
sampling phase are each ONE jitted `lax.scan`; chains are a leading vmap
axis that can be sharded over a `Mesh` axis (see parallel.sharding) — the
cross-chain means in adaptation then lower to psum collectives, keeping
every host's adaptation state identical (SURVEY.md §5 determinism).
"""
from __future__ import annotations

from functools import partial
from typing import Callable, NamedTuple

import jax
import jax.numpy as jnp
from jax import lax

from .hmc import HMCState, hmc_kernel, init_state
from .nuts import nuts_kernel
from .adaptation import (
    da_init, da_update, welford_init, welford_update_batch,
    welford_variance, build_schedule, DualAveragingState, WelfordState,
)


class WarmupResult(NamedTuple):
    states: HMCState          # (chains, ...) final warmup states
    step_size: jax.Array
    inv_mass_diag: jax.Array  # (dim,)


class SampleStats(NamedTuple):
    accept_prob: jax.Array    # (steps, chains)
    divergent: jax.Array      # (steps, chains)
    num_steps: jax.Array      # (steps, chains)
    step_size: jax.Array
    inv_mass_diag: jax.Array
    energy: jax.Array         # (chains, steps) total H at accepted states,
                              # chains-leading to feed diagnostics.bfmi


def _vmap_kernel(kernel):
    return jax.vmap(kernel, in_axes=(0, 0, None, None))


def _chain_keys(key, t, nchains, axis_name, global_chains):
    """Per-chain transition keys. Inside ``shard_map`` (axis_name set) the
    GLOBAL split is computed on every shard and the local block sliced by
    mesh position, so chain c gets the identical key whether the run is
    single-device, sharded-by-propagation, or explicit shard_map."""
    if axis_name is None:
        return jax.random.split(jax.random.fold_in(key, t), nchains)
    allk = jax.random.split(jax.random.fold_in(key, t), global_chains)
    start = lax.axis_index(axis_name) * nchains
    return lax.dynamic_slice_in_dim(allk, start, nchains)


def window_adaptation(kernel, initial_states: HMCState, key,
                      num_warmup: int, *, initial_step_size=0.1,
                      target_accept=0.8, metrics=None,
                      axis_name=None, global_chains=None) -> WarmupResult:
    """Stan-style warmup. ``kernel(key, state, step_size, inv_mass)`` is a
    single-chain transition; ``initial_states`` carries a chains axis.

    ``axis_name``/``global_chains`` (explicit-collective mode, used by
    ``parallel.sample_sharded`` under ``shard_map``): ``initial_states``
    is the local chain block of ``global_chains`` total; the cross-chain
    consensus reductions (acceptance pmean, Welford psum) run as explicit
    collectives over the named mesh axis, so every shard holds the
    identical step size and mass matrix by construction."""
    dim = initial_states.q.shape[-1]
    nchains = initial_states.q.shape[0]
    dtype = initial_states.q.dtype
    in_slow_np, window_end_np = build_schedule(num_warmup)
    in_slow = jnp.asarray(in_slow_np)
    window_end = jnp.asarray(window_end_np)
    vkernel = _vmap_kernel(kernel)

    def step(carry, xs):
        t, slow_flag, end_flag = xs
        states, da, wf, inv_mass = carry
        step_size = jnp.exp(da.log_step)
        keys = _chain_keys(key, t, nchains, axis_name, global_chains)
        states, info = vkernel(keys, states, step_size, inv_mass)

        # Cross-chain consensus BEFORE the update: one shared step size.
        accept_mean = jnp.mean(info.accept_prob)
        if axis_name is not None:
            accept_mean = lax.pmean(accept_mean, axis_name)
        da = da_update(da, accept_mean, target=target_accept)

        # Slow windows accumulate position moments over all chains.
        wf = lax.cond(slow_flag,
                      lambda w: welford_update_batch(
                          w, states.q, axis_name=axis_name),
                      lambda w: w, wf)

        # Window end: set mass matrix, restart Welford and dual averaging.
        def on_window_end(args):
            da, wf, _ = args
            new_mass = welford_variance(wf)          # variance ≈ M^-1
            step_now = jnp.exp(da.log_step)
            return (da_init(step_now, dtype), welford_init(dim, dtype),
                    new_mass)

        da, wf, inv_mass = lax.cond(
            end_flag, on_window_end, lambda a: a, (da, wf, inv_mass))

        if metrics is not None:
            metrics.from_jit(t, warmup_accept=accept_mean,
                             warmup_step_size=step_size,
                             warmup_divergences=jnp.sum(
                                 getattr(info, "divergent",
                                         jnp.zeros(()))))
        return (states, da, wf, inv_mass), None

    carry0 = (initial_states, da_init(initial_step_size, dtype),
              welford_init(dim, dtype), jnp.ones(dim, dtype))
    xs = (jnp.arange(num_warmup), in_slow, window_end)
    with jax.named_scope("enflows.mcmc.warmup"):
        (states, da, _, inv_mass), _ = lax.scan(step, carry0, xs)
    return WarmupResult(states=states,
                        step_size=jnp.exp(da.log_step_avg),
                        inv_mass_diag=inv_mass)


def run_chains(kernel, states: HMCState, key, num_samples: int,
               step_size, inv_mass_diag, metrics=None,
               axis_name=None, global_chains=None):
    """Sample ``num_samples`` transitions; returns positions + stats.
    ``axis_name``/``global_chains``: see :func:`window_adaptation`."""
    nchains = states.q.shape[0]
    vkernel = _vmap_kernel(kernel)

    def step(states, t):
        keys = _chain_keys(key, t, nchains, axis_name, global_chains)
        states, info = vkernel(keys, states, step_size, inv_mass_diag)
        if metrics is not None:
            metrics.from_jit(t, accept=jnp.mean(info.accept_prob),
                             divergences=jnp.sum(info.divergent))
        return states, (states.q, info.accept_prob, info.divergent,
                        getattr(info, "num_steps", jnp.zeros(nchains)),
                        info.energy)

    with jax.named_scope("enflows.mcmc.sampling"):
        states, (qs, acc, div, nsteps, energy) = lax.scan(
            step, states, jnp.arange(num_samples))
    stats = SampleStats(accept_prob=acc, divergent=div, num_steps=nsteps,
                        step_size=step_size, inv_mass_diag=inv_mass_diag,
                        energy=jnp.swapaxes(energy, 0, 1))
    # (steps, chains, dim) -> (chains, steps, dim)
    return jnp.swapaxes(qs, 0, 1), states, stats


@partial(jax.jit, static_argnames=("logdensity_fn", "num_warmup",
                                   "num_samples", "num_chains", "dim",
                                   "max_depth", "algorithm", "num_steps",
                                   "metrics"))
def _sample_impl(logdensity_fn, key, initial_position, *, num_warmup,
                 num_samples, num_chains, dim, max_depth, algorithm,
                 num_steps, initial_step_size, target_accept,
                 metrics=None):
    if algorithm == "nuts":
        kernel = nuts_kernel(logdensity_fn, max_depth=max_depth)
    else:
        kernel = hmc_kernel(logdensity_fn, num_steps=num_steps)
    k_init, k_warm, k_samp = jax.random.split(key, 3)
    states = jax.vmap(lambda q: init_state(logdensity_fn, q))(
        initial_position)
    warm = window_adaptation(kernel, states, k_warm, num_warmup,
                             initial_step_size=initial_step_size,
                             target_accept=target_accept, metrics=metrics)
    samples, final_states, stats = run_chains(
        kernel, warm.states, k_samp, num_samples,
        warm.step_size, warm.inv_mass_diag, metrics=metrics)
    return samples, final_states, stats


def sample(logdensity_fn: Callable, key, *, dim: int,
           num_chains: int = 8, num_warmup: int = 500,
           num_samples: int = 1000, algorithm: str = "nuts",
           max_depth: int = 10, num_steps: int = 32,
           initial_position=None, initial_step_size: float = 0.1,
           target_accept: float = 0.8, dtype=jnp.float32, metrics=None):
    """Adaptive MCMC: windowed warmup then sampling.

    Returns (samples (chains, num_samples, dim), final_states, stats).
    ``logdensity_fn``: (dim,) -> scalar.
    ``algorithm``: 'nuts' | 'hmc' | 'chees' (accelerator-native adaptive
    fixed-length HMC, see mcmc.chees — prefer it for many-chain runs;
    it uses its own optimal acceptance target 0.651, ignoring
    ``target_accept``; call chees_sample directly to override).

    ``metrics`` (optional ``utils.MetricsLogger``): streams per-transition
    acceptance/step-size/divergence records out of the compiled warmup and
    sampling scans (opt-in; the host callback serializes with the device
    stream — leave None for throughput runs).
    """
    if algorithm == "chees":
        from .chees import chees_sample
        return chees_sample(
            logdensity_fn, key, dim=dim, num_chains=num_chains,
            num_warmup=num_warmup, num_samples=num_samples,
            initial_position=initial_position,
            initial_step_size=initial_step_size, dtype=dtype)
    if initial_position is None:
        key, k0 = jax.random.split(key)
        initial_position = 0.1 * jax.random.normal(
            k0, (num_chains, dim), dtype)
    else:
        initial_position = jnp.asarray(initial_position, dtype)
    return _sample_impl(
        logdensity_fn, key, initial_position,
        num_warmup=num_warmup, num_samples=num_samples,
        num_chains=num_chains, dim=dim, max_depth=max_depth,
        algorithm=algorithm, num_steps=num_steps,
        initial_step_size=jnp.asarray(initial_step_size, dtype),
        target_accept=jnp.asarray(target_accept, dtype),
        metrics=metrics)
