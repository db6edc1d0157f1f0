"""Tempered Sequential Monte Carlo with learned annealing flow transports.

No reference counterpart (SURVEY.md §2b "SMC with learned annealing
transports" row). Geometric annealing path between a tractable base
(standard normal by default) and the target:

    log pi_beta(x) = (1 - beta) * log p0(x) + beta * log p1(x)

Each temperature step decomposes into three jitted pieces (the outer loop
over temperatures is a host loop because the number of temperatures is
adaptive):

1. **Adaptive tempering** (`compute_next_beta`): bisection (`lax.while_loop`)
   picks beta' so the incremental-weight ESS falls to ``ess_target * n``
   (just under it) — the particles set the schedule, not a fixed grid.
2. **Optional learned transport** (Annealed Flow Transport flavor, Arbel et
   al. 2021, PAPERS.md): a flow T fit between temperatures (reusing the M1
   whitening/VI trainers) moves particles with the AFT incremental weight
   ``log pi_beta'(T(x)) + ladj_T(x) - log pi_beta(x)`` — exact for any T by
   the importance-sampling identity; T's quality only affects weight
   variance. Without a transport the weight reduces to the standard
   ``(beta' - beta) * (log p1 - log p0)``.
3. **Resample + mutate** (`reweight_resample_mutate`): systematic
   resampling when ESS < threshold, then ``mutation_steps`` HMC transitions
   targeting pi_beta' with Robbins-Monro step-size adaptation toward 65%
   acceptance.

The running log-normalizing-constant estimate log Z accumulates
logsumexp(normalized prev weights + incremental weights) per step.
"""
from __future__ import annotations

import functools
import warnings
from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
from jax import lax

from ..bijectors.base import Bijector
from ..distributions.base import std_normal_logpdf_sum
from ..mcmc.hmc import hmc_kernel, init_state


# Relative slack of the resample trigger. Adaptive tempering leaves the ESS
# just under ``ess_target * n``; the step recomputes that ESS in another
# fusion, and a float32 sum over 2^18 weights can round it back over the
# threshold by ~1e-6 relative. The slack sits well above that rounding:
# resampling at 0.5005 n instead of 0.5 n changes no estimate.
ESS_TRIGGER_SLACK = 1e-3


def warn_if_unfinished(beta, n_temps: int, max_temps: int):
    """Warn when a ladder stopped at ``max_temps`` short of beta = 1: its
    particles are then draws from an intermediate temperature."""
    if float(beta) < 1.0:
        warnings.warn(
            f"SMC ladder stopped at beta {float(beta):.6g} after {n_temps} "
            f"temperatures (max_temps={max_temps}); the particles are not "
            f"posterior draws", RuntimeWarning, stacklevel=3)


class SMCState(NamedTuple):
    particles: jax.Array      # (n, dim)
    log_weights: jax.Array    # (n,) unnormalized
    beta: jax.Array           # current inverse temperature
    log_z: jax.Array          # running log normalizing-constant estimate
    step_size: jax.Array      # mutation step size (adapted)


class SMCInfo(NamedTuple):
    beta: jax.Array
    ess: jax.Array
    accept_prob: jax.Array
    resampled: jax.Array
    log_z: jax.Array


def log_ess(log_weights) -> jax.Array:
    """log ESS = 2*logsumexp(w) - logsumexp(2w)."""
    return (2.0 * jax.scipy.special.logsumexp(log_weights)
            - jax.scipy.special.logsumexp(2.0 * log_weights))


def systematic_resample(key, log_weights, particles):
    """Systematic (single-uniform stratified) resampling.

    O(n) searchsorted over the weight CDF; XLA-friendly, and the local
    building block of the distributed resampler (parallel.resample).
    """
    n = log_weights.shape[0]
    w = jax.nn.softmax(log_weights)
    cdf = jnp.cumsum(w)
    u0 = jax.random.uniform(key, (), w.dtype)
    pts = (u0 + jnp.arange(n, dtype=w.dtype)) / n
    idx = jnp.searchsorted(cdf, pts, side="left")
    idx = jnp.clip(idx, 0, n - 1)
    return particles[idx]


def make_tempered(log_base: Callable, log_target: Callable):
    def tempered(beta):
        def logp(q):
            return (1.0 - beta) * log_base(q) + beta * log_target(q)
        return logp
    return tempered


class SMCKernels(NamedTuple):
    """Explicit pre-built jitted kernels for a (base, target) pair.

    Build once via :func:`build_smc_kernels` and pass to
    ``smc_sample(kernels=...)`` when calling SMC repeatedly with targets
    constructed as fresh closures — the factory cache below is keyed on
    *callable identity*, so a fresh lambda per call silently recompiles.
    """
    compute_next_beta: Callable   # (state) -> beta'
    step: Callable                # (key, state, beta_new, lw_inc) -> ...
    tempered: Callable            # (beta) -> logp
    holdout_logz: bool
    ladder: Optional[Callable] = None  # (key, state, max_temps) -> ...


def _build_ladder(compute_next_beta, step, tempered, log_base, log_target,
                  fit_transport):
    """One-jit whole-ladder driver: `lax.while_loop` over temperatures with
    preallocated (max_temps,) info buffers.

    Removes the per-temperature host round-trips of the Python ladder
    (two dispatches and several host syncs per temperature); the Python
    ladder remains as the ``metrics=`` streaming
    variant. Identical per-temperature key stream (split(key, 3)) and
    identical math, so same-key trajectories match the host loop (tested
    in tests/test_smc.py).
    """

    @functools.partial(jax.jit, static_argnums=2)
    def ladder(key, state: SMCState, max_temps: int):
        dtype = state.particles.dtype
        infos0 = SMCInfo(
            beta=jnp.zeros(max_temps, dtype),
            ess=jnp.zeros(max_temps, dtype),
            accept_prob=jnp.zeros(max_temps, dtype),
            resampled=jnp.zeros(max_temps, bool),
            log_z=jnp.zeros(max_temps, dtype))

        def cond(c):
            _, state, t, _ = c
            return (t < max_temps) & (state.beta < 1.0)

        def body(c):
            key, state, t, infos = c
            key, k_t, k_f = jax.random.split(key, 3)
            beta_new = compute_next_beta(state)
            if fit_transport is not None:
                T = fit_transport(k_f, state.particles,
                                  state.log_weights, state.beta, beta_new)
                y, ladj = T.forward_and_ladj(state.particles)
                lw_inc = (jax.vmap(tempered(beta_new))(y) + ladj
                          - jax.vmap(tempered(state.beta))(
                              state.particles))
                state = state._replace(particles=y)
            else:
                lp0 = jax.vmap(log_base)(state.particles)
                lp1 = jax.vmap(log_target)(state.particles)
                lw_inc = (beta_new - state.beta) * (lp1 - lp0)
            state, info = step(k_t, state, beta_new, lw_inc)
            infos = jax.tree.map(lambda b, v: b.at[t].set(v), infos, info)
            return (key, state, t + 1, infos)

        key, state, t, infos = lax.while_loop(
            cond, body, (key, state, jnp.asarray(0, jnp.int32), infos0))
        return state, t, infos

    ladder.has_transport = fit_transport is not None
    return ladder


@functools.lru_cache(maxsize=8)
def make_smc_ladder(log_base: Callable, log_target: Callable,
                    fit_transport: Optional[Callable] = None, *,
                    ess_target: float = 0.5, mutation_steps: int = 5,
                    leapfrog_steps: int = 10,
                    resample_threshold: float = 0.5,
                    target_accept: float = 0.65):
    """Jitted whole-ladder driver (identity-keyed memoization — same
    caching contract as :func:`make_compute_next_beta`; use
    :func:`build_smc_kernels` for explicit control)."""
    compute_next_beta = make_compute_next_beta(log_base, log_target,
                                               ess_target)
    step = make_reweight_resample_mutate(
        log_base, log_target, mutation_steps=mutation_steps,
        leapfrog_steps=leapfrog_steps,
        resample_threshold=resample_threshold,
        target_accept=target_accept,
        holdout_logz=fit_transport is not None)
    return _build_ladder(compute_next_beta, step,
                         make_tempered(log_base, log_target),
                         log_base, log_target, fit_transport)


def build_smc_kernels(log_base: Callable, log_target: Callable, *,
                      mutation_steps: int = 5, leapfrog_steps: int = 10,
                      ess_target: float = 0.5,
                      resample_threshold: float = 0.5,
                      target_accept: float = 0.65,
                      holdout_logz: bool = False,
                      fit_transport: Optional[Callable] = None
                      ) -> SMCKernels:
    """Build the jitted SMC kernels explicitly (no identity-keyed caching).

    The kernel-builder-object alternative to the ``lru_cache``d factories:
    compile cost is paid here, once, under the caller's control; reusing
    the returned :class:`SMCKernels` across ``smc_sample`` calls never
    retraces regardless of how ``log_base``/``log_target`` were created.

    ``fit_transport`` (optional) bakes a learned-transport fitter into the
    in-graph ladder; it must be traceable (the default
    ``flow_transport.make_transport_fitter`` fitter is). When given,
    ``holdout_logz`` is forced True to keep the log Z estimate unbiased.
    """
    holdout_logz = holdout_logz or (fit_transport is not None)
    compute_next_beta = make_compute_next_beta.__wrapped__(
        log_base, log_target, ess_target)
    step = make_reweight_resample_mutate.__wrapped__(
        log_base, log_target, mutation_steps=mutation_steps,
        leapfrog_steps=leapfrog_steps,
        resample_threshold=resample_threshold,
        target_accept=target_accept, holdout_logz=holdout_logz)
    tempered = make_tempered(log_base, log_target)
    return SMCKernels(
        compute_next_beta=compute_next_beta,
        step=step,
        tempered=tempered,
        holdout_logz=holdout_logz,
        ladder=_build_ladder(compute_next_beta, step, tempered, log_base,
                             log_target, fit_transport),
    )


@functools.lru_cache(maxsize=8)
def make_compute_next_beta(log_base: Callable, log_target: Callable,
                           ess_target: float = 0.5):
    """Jitted: (state) -> beta'. Bisection on the incremental-weight ESS.

    CACHING CONTRACT: memoized on the *identity* of ``log_base`` /
    ``log_target`` (callables are unhashable by value). Module-level
    functions and reused closure objects cache-hit; a fresh lambda per
    call recompiles and briefly pins the old closure (bounded: maxsize=8).
    For repeated calls with fresh closures, use :func:`build_smc_kernels`.
    """

    @jax.jit
    def compute_next_beta(state: SMCState):
        n = state.particles.shape[0]
        dtype = state.particles.dtype
        lp0 = jax.vmap(log_base)(state.particles)
        lp1 = jax.vmap(log_target)(state.particles)
        log_ratio = lp1 - lp0
        target_log_ess = jnp.log(jnp.asarray(ess_target * n, dtype))

        def ess_at(b):
            return log_ess(state.log_weights
                           + (b - state.beta) * log_ratio)

        def cond(carry):
            lo, hi, it = carry
            return (it < 60) & (hi - lo > 1e-6)

        def body(carry):
            lo, hi, it = carry
            mid = 0.5 * (lo + hi)
            ok = ess_at(mid) >= target_log_ess
            return (jnp.where(ok, mid, lo), jnp.where(ok, hi, mid), it + 1)

        one = jnp.asarray(1.0, dtype)
        with jax.named_scope("enflows.smc.tempering"):
            full = ess_at(one) >= target_log_ess
            _, hi, _ = lax.while_loop(
                cond, body, (state.beta, one, jnp.asarray(0, jnp.int32)))
        # hi, not lo: the ESS at hi is under the target, so beta moves past
        # the current one and the step's resample trigger fires (with
        # ess_target <= resample_threshold, the default).
        return jnp.where(full, one, hi)

    return compute_next_beta


@functools.lru_cache(maxsize=8)
def make_reweight_resample_mutate(
        log_base: Callable, log_target: Callable, *,
        mutation_steps: int = 5, leapfrog_steps: int = 10,
        resample_threshold: float = 0.5, target_accept: float = 0.65,
        holdout_logz: bool = False):
    """Jitted: (key, state, beta_new, lw_inc) -> (state, info).

    Identity-keyed memoization — same caching contract as
    :func:`make_compute_next_beta`; use :func:`build_smc_kernels` for
    explicit control.

    ``holdout_logz``: estimate the log Z increment from the odd-index half
    of the population only — required when ``lw_inc`` came from a learned
    transport fit on the even-index half (see flow_transport module
    docstring for the adaptation-bias argument).
    """
    tempered = make_tempered(log_base, log_target)

    @jax.jit
    def step(key, state: SMCState, beta_new, lw_inc):
        n, dim = state.particles.shape
        dtype = state.particles.dtype
        k_res, k_mut = jax.random.split(key)

        # log Z: weighted mean of incremental weights under prev weights
        # (restricted to the held-out half when the transport was fit on
        # the training half).
        lw_prev = state.log_weights[1::2] if holdout_logz else \
            state.log_weights
        lw_i = lw_inc[1::2] if holdout_logz else lw_inc
        log_w_prev_norm = lw_prev - jax.scipy.special.logsumexp(lw_prev)
        log_z = state.log_z + jax.scipy.special.logsumexp(
            log_w_prev_norm + lw_i)

        log_weights = state.log_weights + lw_inc
        cur_ess = jnp.exp(log_ess(log_weights))
        do_resample = cur_ess <= resample_threshold * n * (
            1.0 + ESS_TRIGGER_SLACK)
        with jax.named_scope("enflows.smc.resample"):
            particles = lax.cond(
                do_resample,
                lambda: systematic_resample(k_res, log_weights,
                                            state.particles),
                lambda: state.particles)
            log_weights = jnp.where(do_resample,
                                    jnp.zeros_like(log_weights),
                                    log_weights)

        logp_fn = tempered(beta_new)
        kernel = hmc_kernel(logp_fn, num_steps=leapfrog_steps)
        states = jax.vmap(lambda q: init_state(logp_fn, q))(particles)

        # Particle-ensemble mass matrix: the weighted population variance
        # is a free preconditioner for the mutation kernel (M^-1 = var),
        # the SMC analogue of Welford warmup in mcmc.adaptation.
        w_norm = jax.nn.softmax(log_weights)
        mean_p = jnp.einsum("n,nd->d", w_norm, particles)
        var_p = jnp.einsum("n,nd->d", w_norm,
                           (particles - mean_p) ** 2)
        inv_mass = jnp.clip(var_p, 1e-6, 1e6)

        def mutate(carry, t):
            states, step_size = carry
            keys = jax.random.split(jax.random.fold_in(k_mut, t), n)
            states, info = jax.vmap(kernel, in_axes=(0, 0, None, None))(
                keys, states, step_size, inv_mass)
            acc = jnp.mean(info.accept_prob)
            step_size = step_size * jnp.exp(0.5 * (acc - target_accept))
            return (states, step_size), acc

        with jax.named_scope("enflows.smc.mutate"):
            (states, step_size), accs = lax.scan(
                mutate, (states, state.step_size),
                jnp.arange(mutation_steps))

        new_state = SMCState(particles=states.q, log_weights=log_weights,
                             beta=beta_new, log_z=log_z,
                             step_size=step_size)
        info = SMCInfo(beta=beta_new, ess=cur_ess,
                       accept_prob=jnp.mean(accs),
                       resampled=do_resample, log_z=log_z)
        return new_state, info

    return step


def smc_sample(log_target: Callable, key, *, dim: int,
               num_particles: int = 1024,
               log_base: Optional[Callable] = None,
               base_sampler: Optional[Callable] = None,
               mutation_steps: int = 5, leapfrog_steps: int = 10,
               ess_target: float = 0.5, resample_threshold: float = 0.5,
               initial_step_size: float = 0.2, max_temps: int = 200,
               fit_transport: Optional[Callable] = None,
               kernels: Optional[SMCKernels] = None,
               metrics=None,
               in_graph: Optional[bool] = None,
               dtype=jnp.float32):
    """Adaptive tempered SMC from base to ``log_target``.

    Returns (particles, log_weights, log_z, infos).

    ``fit_transport(key, particles, log_weights, beta, beta_next) ->
    Bijector`` (optional): learned annealing transport, applied with the
    AFT-corrected incremental weight (see module docstring). A trainer-
    backed implementation lives in flow_transport.py.

    ``kernels`` (optional): pre-built :class:`SMCKernels` from
    :func:`build_smc_kernels`; pass this when looping over smc_sample with
    targets built as fresh closures to avoid identity-keyed recompiles.
    When the kernels bake in a ``fit_transport``, pass the SAME fitter
    here too (presence selects the in-graph ladder; the baked one runs).

    ``metrics`` (optional ``utils.MetricsLogger``): logs one record per
    temperature (beta, ESS, acceptance, resampled, running log Z).

    ``in_graph`` (default: auto — True iff ``metrics`` is None): run the
    whole temperature ladder inside ONE jit (`lax.while_loop` +
    preallocated info buffers) instead of a Python loop with one device
    round-trip per temperature. The
    Python ladder is kept as the ``metrics=`` streaming variant; same-key
    trajectories are identical between the two (tested). Requires
    ``fit_transport`` to be traceable (the flow_transport fitter is).
    """
    if log_base is None:
        # Module-level function (stable identity) so the jitted factories
        # cache-hit across smc_sample calls.
        log_base = std_normal_logpdf_sum
        base_sampler = lambda k, n: jax.random.normal(k, (n, dim), dtype)
    assert base_sampler is not None, "custom log_base needs base_sampler"

    key, k0 = jax.random.split(key)
    particles = base_sampler(k0, num_particles)
    state = SMCState(
        particles=particles,
        log_weights=jnp.zeros(num_particles, dtype),
        beta=jnp.zeros((), dtype),
        log_z=jnp.zeros((), dtype),
        step_size=jnp.asarray(initial_step_size, dtype),
    )
    if fit_transport is not None:
        assert num_particles % 2 == 0, \
            "learned transports need an even particle count (train/" \
            "estimation split)"
    if kernels is not None:
        assert kernels.holdout_logz == (fit_transport is not None), \
            "kernels.holdout_logz must match fit_transport presence"
        compute_next_beta, step, tempered = (
            kernels.compute_next_beta, kernels.step, kernels.tempered)
        ladder = kernels.ladder
        if ladder is not None and \
                ladder.has_transport != (fit_transport is not None):
            ladder = None       # kernels built for the other mode
    else:
        compute_next_beta = make_compute_next_beta(log_base, log_target,
                                                   ess_target)
        step = make_reweight_resample_mutate(
            log_base, log_target, mutation_steps=mutation_steps,
            leapfrog_steps=leapfrog_steps,
            resample_threshold=resample_threshold,
            holdout_logz=fit_transport is not None)
        tempered = make_tempered(log_base, log_target)
        ladder = make_smc_ladder(
            log_base, log_target, fit_transport, ess_target=ess_target,
            mutation_steps=mutation_steps, leapfrog_steps=leapfrog_steps,
            resample_threshold=resample_threshold)

    use_in_graph = (metrics is None) if in_graph is None else in_graph
    if use_in_graph and metrics is not None:
        raise ValueError(
            "in_graph=True cannot stream metrics (the ladder runs in one "
            "jit); drop metrics= or pass in_graph=False")
    if use_in_graph and ladder is not None:
        with jax.named_scope("enflows.smc.ladder"):
            state, n_t, info_buf = ladder(key, state, max_temps)
        n_t = int(n_t)
        infos = [jax.tree.map(lambda b, i=i: b[i], info_buf)
                 for i in range(n_t)]
        warn_if_unfinished(state.beta, n_t, max_temps)
        return state.particles, state.log_weights, state.log_z, infos

    infos = []
    for _ in range(max_temps):
        key, k_t, k_f = jax.random.split(key, 3)
        beta_new = compute_next_beta(state)

        if fit_transport is not None:
            T: Bijector = fit_transport(k_f, state.particles,
                                        state.log_weights, state.beta,
                                        beta_new)
            y, ladj = T.forward_and_ladj(state.particles)
            lw_inc = (jax.vmap(tempered(beta_new))(y) + ladj
                      - jax.vmap(tempered(state.beta))(state.particles))
            state = state._replace(particles=y)
        else:
            lp0 = jax.vmap(log_base)(state.particles)
            lp1 = jax.vmap(log_target)(state.particles)
            lw_inc = (beta_new - state.beta) * (lp1 - lp0)

        state, info = step(k_t, state, beta_new, lw_inc)
        infos.append(info)
        if metrics is not None:
            metrics.log(len(infos) - 1, beta=float(info.beta),
                        ess=float(info.ess),
                        accept=float(info.accept_prob),
                        resampled=bool(info.resampled),
                        log_z=float(info.log_z))
        if float(state.beta) >= 1.0:
            break
    warn_if_unfinished(state.beta, len(infos), max_temps)
    return state.particles, state.log_weights, state.log_z, infos
