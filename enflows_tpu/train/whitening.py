"""Maximum-likelihood whitening trainer: fit a flow so f(X) ~ N(0, I).

Redesign of /root/reference/src/optimize_whitening.jl. The loss
is the reference's per-sample mean negative log-likelihood under the change
of variables (mvnormal_negll_trafo, reference :7-15):

    negll = -( sum(std_normal_logpdf(f(X))) + sum(ladj) ) / nsamples

Where the reference runs a Python-level epoch×batch loop with
Zygote.pullback + Optimisers.update per batch (reference :36-43), here the
whole (loss, grad, update, canonicalize) step is one jitted function and the
epoch×batch loop is a `lax.scan` inside that jit — the single biggest
structural difference from the Julia design and the reason throughput is
compiler-limited instead of interpreter-limited.

Data-parallel: if a `jax.sharding.Mesh` with a ``"batch"`` axis is supplied,
batches are sharded over it; XLA inserts the gradient `psum` automatically
from the sharding annotations (no hand-written collectives needed at this
layer — SURVEY.md §5 distributed-communication row).
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import jax
import jax.numpy as jnp
import optax
from jax import lax
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bijectors.base import Bijector
from ..distributions.base import std_normal_logpdf_sum


def mvnormal_negll(flow: Bijector, X: jax.Array) -> jax.Array:
    """Per-sample mean negative log-likelihood (reference :7-15).

    X: (..., n, dim); normalized by the total number of samples so the value
    is batch-size independent, exactly like the reference (:8).
    """
    Y, ladj = flow.forward_and_ladj(X)
    n = 1
    for s in X.shape[:-1]:
        n *= s
    ll = (jnp.sum(std_normal_logpdf_sum(Y)) + jnp.sum(ladj)) / n
    return -ll


def mvnormal_negll_grad(flow: Bijector, X: jax.Array):
    """(negll, d_flow) — counterpart of mvnormal_negll_trafograd (ref :18-22)."""
    return jax.value_and_grad(mvnormal_negll)(flow, X)


class WhiteningResult(NamedTuple):
    result: Bijector
    optimizer_state: Any
    negll_history: jax.Array


def make_train_step(optimizer: optax.GradientTransformation,
                    loss_fn: Callable = mvnormal_negll):
    """One fused (loss, grad, update, canonicalize) step, jit-compatible."""

    def step(carry, X):
        flow, opt_state = carry
        negll, grads = jax.value_and_grad(loss_fn)(flow, X)
        updates, opt_state = optimizer.update(grads, opt_state, flow)
        flow = optax.apply_updates(flow, updates)
        # Explicit-JAX replacement for the reference's renormalization inside
        # Functors reconstruction (householder_trafo.jl:141-146).
        flow = flow.canonicalize()
        return (flow, opt_state), negll

    return step


def optimize_whitening(
    samples: jax.Array,
    initial_flow: Bijector,
    optimizer: optax.GradientTransformation | None = None,
    *,
    nbatches: int = 100,
    nepochs: int = 100,
    opt_state: Any = None,
    negll_history: jax.Array | None = None,
    mesh: Mesh | None = None,
    batch_axis: str = "batch",
    metrics=None,
    checkpoint_every: int | None = None,
    ckpt_dir: str | None = None,
) -> WhiteningResult:
    """Fit ``initial_flow`` so that it whitens ``samples``.

    API mirrors the reference trainer (optimize_whitening, reference :25-45):
    resumable via ``opt_state`` / ``negll_history`` kwargs; returns
    (result, optimizer_state, negll_history) with histories spliced.

    samples: (n, dim). The n samples are split into ``nbatches`` equal
    batches (remainder dropped, matching Iterators.partition semantics
    closely enough for training); the scan runs nepochs × nbatches steps.

    ``metrics`` (optional ``utils.MetricsLogger``): streams per-step negll
    records out of the compiled scan via ``jax.debug.callback`` (SURVEY.md
    §5 metrics row). Opt-in because the host callback serializes with the
    device stream — leave None in throughput-critical runs.

    ``checkpoint_every`` (epochs) + ``ckpt_dir``: preemption-safe mode —
    the epoch scan runs in ``checkpoint_every``-epoch jitted chunks
    through ``utils.resilience.run_checkpointed``, saving (flow,
    opt_state, history) at every chunk boundary; a killed job restarted
    with the SAME call resumes from the last checkpoint bit-identically
    (tests/test_resilience.py::test_trainer_kill_resume_bit_equivalence).
    """
    if optimizer is None:
        optimizer = optax.adagrad(1e-1)
    n, dim = samples.shape
    batch_size = n // nbatches
    usable = batch_size * nbatches
    batches = samples[:usable].reshape(nbatches, batch_size, dim)

    if opt_state is None:
        opt_state = optimizer.init(initial_flow)

    if mesh is not None and batch_size % mesh.shape[batch_axis]:
        raise ValueError(
            f"batch size {batch_size} (n//nbatches) must divide over "
            f"{mesh.shape[batch_axis]} '{batch_axis}' shards")
    step = make_train_step(optimizer)

    if metrics is not None:
        inner_step = step

        def step(carry, xs):
            i, X = xs
            carry, negll = inner_step(carry, X)
            metrics.from_jit(i, negll=negll)
            return carry, negll

    def make_run(ne):
        """Jitted scan over ``ne`` epochs starting at (traced) epoch
        index e0 — e0 only matters for metrics step labels and lets the
        checkpointed chunks share one compiled executable."""

        def run_body(flow, opt_state, e0, batches):
            def epoch(carry, e):
                if metrics is None:
                    carry, neglls = lax.scan(step, carry, batches)
                else:
                    idx = e * nbatches + jnp.arange(nbatches)
                    carry, neglls = lax.scan(step, carry, (idx, batches))
                return carry, neglls

            with jax.named_scope("enflows.train.whitening"):
                (flow, opt_state), neglls = lax.scan(
                    epoch, (flow, opt_state), e0 + jnp.arange(ne))
            return flow, opt_state, neglls.reshape(-1)

        return jax.jit(run_body)

    if mesh is not None:
        batches = jax.device_put(
            batches, NamedSharding(mesh, P(None, batch_axis, None)))

    if checkpoint_every or ckpt_dir:
        # Preemption-safe training (VERDICT r4 next #5): the epoch scan
        # is chunked into ``checkpoint_every``-epoch jitted blocks driven
        # through ``utils.resilience.run_checkpointed`` — a killed job
        # restarted with the same arguments resumes from the last chunk
        # boundary BIT-IDENTICALLY (whitening has no RNG; the chunk
        # index alone determines the work). The per-step history lives
        # in a fixed-shape array inside the checkpointed state.
        from ..utils.resilience import run_checkpointed

        chunk = int(checkpoint_every or 1)
        n_chunks = -(-nepochs // chunk)
        runs = {}

        def chunk_fn(state, ci):
            flow, opt_state, hist = state
            ne = min(chunk, nepochs - ci * chunk)
            if ne not in runs:
                runs[ne] = make_run(ne)
            flow, opt_state, neglls = runs[ne](
                flow, opt_state, jnp.asarray(ci * chunk, jnp.int32),
                batches)
            hist = lax.dynamic_update_slice(
                hist, neglls.astype(hist.dtype),
                (jnp.asarray(ci * chunk * nbatches),))
            return (flow, opt_state, hist)

        hist0 = jnp.zeros((nepochs * nbatches,), samples.dtype)
        state, _ = run_checkpointed(
            chunk_fn, (initial_flow, opt_state, hist0), n_chunks,
            ckpt_dir=ckpt_dir, checkpoint_every=1)
        flow, opt_state, neglls = state
    else:
        flow, opt_state, neglls = make_run(nepochs)(
            initial_flow, opt_state, jnp.asarray(0, jnp.int32), batches)
    if negll_history is not None:
        neglls = jnp.concatenate([jnp.asarray(negll_history), neglls])
    return WhiteningResult(flow, opt_state, neglls)
