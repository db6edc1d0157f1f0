"""Flow-based variational inference: ELBO optimization.

Redesign of /root/reference/examples/nf_variational_1d.jl
(the reference keeps VI at example level; here it is a first-class trainer —
SURVEY.md §2b "Whitening/VI optimizer" row). For base xi ~ N(0, I_dim) and
transport z = f(xi):

    ELBO = E[ log p~(f(xi)) + ladj(f, xi) ] + H[N(0, I_dim)]
         = mean_n [ logp(z_n) + ladj_n ] + dim/2 * (log 2π + 1)

The entropy term uses the *event* dimension — fixing the reference example's
axis confusion (nf_variational_1d.jl:32-33 reads the batch axis as the
dimension; harmless there only because dim == 1, flagged in SURVEY.md §2a).

Antithetic sampling (xi, -xi) halves gradient variance exactly as in the
reference (:57). Fresh base draws per step come from folding the step index
into the RNG key inside `lax.scan` — the whole nsteps loop is one jit.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax import lax

from ..bijectors.base import Bijector

_LOG_2PI = 1.8378770664093453


def neg_elbo(flow: Bijector, logdensity_fn: Callable,
             xi: jax.Array) -> jax.Array:
    """Negative ELBO for transport ``flow`` against unnormalized logdensity.

    xi: (n, dim) base-normal draws. Counterpart of nELBO (reference :25-36)
    with the corrected entropy term.
    """
    z, ladj = flow.forward_and_ladj(xi)
    n, dim = xi.shape
    elbo = (jnp.sum(logdensity_fn(z)) + jnp.sum(ladj)) / n \
        + 0.5 * (_LOG_2PI + 1.0) * dim
    return -elbo


def neg_elbo_stl(flow: Bijector, logdensity_fn: Callable,
                 xi: jax.Array) -> jax.Array:
    """Sticking-the-landing negative ELBO (Roeder et al. 2017,
    "Sticking the Landing": path-derivative gradient estimator).

    The total-derivative ELBO gradient carries a score-function term
    ``∇θ log q_θ(z)|_z`` whose expectation is zero but whose variance is
    not — it dominates near convergence. STL evaluates the variational
    density with PARAMETER-STOPPED flow params::

        z        = f_θ(ξ)                      (differentiable path)
        log q(z) = log N(g_θ̄(z)) + ladj(g_θ̄, z),   θ̄ = stop_gradient(θ)

    where ``g = f⁻¹`` is the exact parameter-sharing inverse (reference
    convention #5 — this estimator exists in this codebase precisely
    because every bijector has one). Unbiased; per-sample ZERO gradient
    at q = p (the standard estimator only has zero mean there). The
    VALUE differs from ``neg_elbo`` per batch by the empirical-vs-
    analytic base entropy, ``-mean(log N(ξ)) - dim/2 (log 2π + 1)``
    (zero-mean, O(1/√n)); expectations coincide. Cost: one extra
    inverse pass per step (~2x forward FLOPs).
    """
    z, _ = flow.forward_and_ladj(xi)
    g_bar = jax.lax.stop_gradient(flow).inverse()
    xi_bar, ladj_inv = g_bar.forward_and_ladj(z)
    n, dim = xi.shape
    log_q = (-0.5 * jnp.sum(xi_bar * xi_bar, axis=-1)
             - 0.5 * dim * _LOG_2PI + ladj_inv)
    elbo = (jnp.sum(logdensity_fn(z)) - jnp.sum(log_q)) / n
    return -elbo


class VIResult(NamedTuple):
    result: Bijector
    optimizer_state: Any
    nelbo_history: jax.Array


def optimize_elbo(
    logdensity_fn: Callable,
    initial_flow: Bijector,
    optimizer: optax.GradientTransformation | None = None,
    *,
    dim: int,
    batch_size: int = 100,
    nsteps: int = 1000,
    antithetic: bool = True,
    key: jax.Array | None = None,
    opt_state: Any = None,
    nelbo_history: jax.Array | None = None,
    mesh=None,
    batch_axis: str = "batch",
    dtype=jnp.float32,
    metrics=None,
    stl: bool = False,
    checkpoint_every: int | None = None,
    ckpt_dir: str | None = None,
) -> VIResult:
    """Fit a flow transport to an unnormalized log-density by ELBO ascent.

    Counterpart of optimise_ELBO (reference :44-63): resumable opt_state,
    spliced history, ADAGrad default, antithetic base draws.
    ``logdensity_fn`` maps (..., dim) -> (...) log p~(z) per sample.

    ``stl=True`` switches to the sticking-the-landing path-derivative
    gradient (:func:`neg_elbo_stl`) — lower-variance near convergence at
    the cost of one extra inverse pass per step. The ``nelbo_history``
    (and streamed metrics) always record the STANDARD nELBO scale, so
    histories are step-for-step comparable across the two estimators.
    Caveat (measured): FAR from convergence the STL gradient can be
    larger than the standard one — on a spline-coupling transport at
    adagrad(0.1) the STL run diverged to NaN by step 4 where the
    standard estimator trained fine; at adagrad(0.02) both converge to
    the same nELBO. Prefer STL for REFINEMENT (warm starts, late
    training) or drop the learning rate when enabling it cold.

    ``metrics`` (optional ``utils.MetricsLogger``): streams per-step nELBO
    records out of the compiled scan (opt-in; host callback serializes
    with the device stream).

    ``checkpoint_every`` (steps) + ``ckpt_dir``: preemption-safe mode —
    the step scan runs in ``checkpoint_every``-step jitted chunks
    through ``utils.resilience.run_checkpointed``; a killed job
    restarted with the SAME call resumes bit-identically (fresh base
    draws fold the GLOBAL step index into the key, so the chunk index
    alone determines the work).
    """
    if optimizer is None:
        optimizer = optax.adagrad(1e-1)
    if key is None:
        key = jax.random.PRNGKey(0)
    if opt_state is None:
        opt_state = optimizer.init(initial_flow)

    def step(carry, i):
        flow, opt_state = carry
        k = jax.random.fold_in(key, i)
        xi = jax.random.normal(k, (batch_size, dim), dtype=dtype)
        if antithetic:
            xi = jnp.concatenate([xi, -xi], axis=0)  # reference :57
        if mesh is not None:
            # Shard the MC batch; XLA inserts the gradient psum from the
            # sharding annotations (data-parallel ELBO).
            from jax.sharding import NamedSharding, PartitionSpec as P
            xi = jax.lax.with_sharding_constraint(
                xi, NamedSharding(mesh, P(batch_axis)))
        loss = neg_elbo_stl if stl else neg_elbo
        nelbo, grads = jax.value_and_grad(loss)(flow, logdensity_fn, xi)
        if stl:
            # Record the STANDARD nELBO in the history so stl=True and
            # stl=False runs are comparable step-for-step (ADVICE r4):
            # the STL value differs from it exactly by the empirical-vs-
            # analytic base entropy, computable from xi alone —
            #   std = stl - mean(log N(xi)) - dim/2 (log 2pi + 1)
            # (exact to the round-trip roundoff; the STL value itself is
            # still the one differentiated).
            nb, nd = xi.shape
            mean_logN = (-0.5 * jnp.sum(xi * xi) / nb
                         - 0.5 * nd * _LOG_2PI)
            nelbo = nelbo - mean_logN - 0.5 * (_LOG_2PI + 1.0) * nd
        updates, opt_state = optimizer.update(grads, opt_state, flow)
        flow = optax.apply_updates(flow, updates)
        flow = flow.canonicalize()
        if metrics is not None:
            metrics.from_jit(i, nelbo=nelbo)
        return (flow, opt_state), nelbo

    def make_run(ns):
        def run_body(flow, opt_state, i0):
            with jax.named_scope("enflows.train.vi"):
                (flow, opt_state), hist = lax.scan(
                    step, (flow, opt_state), i0 + jnp.arange(ns))
            return flow, opt_state, hist

        return jax.jit(run_body)

    if checkpoint_every or ckpt_dir:
        # Preemption-safe VI (VERDICT r4 next #5) — see
        # optimize_whitening; the RNG key folds the GLOBAL step index,
        # so chunked and unchunked runs draw identical MC batches.
        from ..utils.resilience import run_checkpointed

        chunk = int(checkpoint_every or 1)
        n_chunks = -(-nsteps // chunk)
        runs = {}

        def chunk_fn(state, ci):
            flow, opt_state, hist = state
            ns = min(chunk, nsteps - ci * chunk)
            if ns not in runs:
                runs[ns] = make_run(ns)
            flow, opt_state, h = runs[ns](
                flow, opt_state, jnp.asarray(ci * chunk, jnp.int32))
            hist = jax.lax.dynamic_update_slice(
                hist, h.astype(hist.dtype),
                (jnp.asarray(ci * chunk),))
            return (flow, opt_state, hist)

        hist0 = jnp.zeros((nsteps,), dtype)
        (flow, opt_state, hist), _ = run_checkpointed(
            chunk_fn, (initial_flow, opt_state, hist0), n_chunks,
            ckpt_dir=ckpt_dir, checkpoint_every=1)
    else:
        flow, opt_state, hist = make_run(nsteps)(
            initial_flow, opt_state, jnp.asarray(0, jnp.int32))
    if nelbo_history is not None:
        hist = jnp.concatenate([jnp.asarray(nelbo_history), hist])
    return VIResult(flow, opt_state, hist)
