"""One-call adaptive inference: precondition -> sample -> diagnose.

The workflow the framework exists for (examples/full_pipeline.py), as a
single first-class API. No reference counterpart (the reference stops at
example scripts; SURVEY.md §2a examples rows) — this is the front door a
reference user gets instead of hand-wiring the M1-M3 subsystems:

    result = infer(logp, dim=2, key=key)            # auto-preconditioned NUTS
    result.draws                                     # (chains, steps, dim)
    result.diagnostics["rhat"]                       # rank-normalized, per dim

``precondition="auto"`` fits a flow transport to the target by ELBO ascent
(train.optimize_elbo — needs no posterior draws), then samples the
flow-preconditioned target (mcmc.logdensity) and pushes draws back to data
space. Sampling methods: 'nuts' | 'hmc' | 'chees' (accelerator-native
adaptive HMC, the preferred many-chain sampler) | 'smc' (tempered SMC,
also returns the log normalizing constant).

Everything inside is jit/scan-based; the diagnostics summary is the only
host-side (numpy) step.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp
import numpy as np

from .bijectors import (Bijector, CenterStretch, Householder, JohnsonInv,
                        ScaleShift, compose)
from .mcmc import FlowPushforwardTarget, flow_preconditioned, sample
from .mcmc.diagnostics import (bfmi, bulk_ess,
                               rank_normalized_rhat_per_dim, tail_ess)


class InferenceResult(NamedTuple):
    draws: jax.Array          # MCMC: (chains, steps, dim); SMC: (particles, dim)
    diagnostics: dict         # host-side scalars/arrays (see summarize_draws)
    stats: Any                # raw sampler stats (SampleStats/ChEES.../SMC infos)
    flow: Optional[Bijector]  # preconditioner used (whitened -> data), if any


def default_flow_template(dim: int, key, dtype=jnp.float32) -> Bijector:
    """Identity-initialized base->data transport.

    The inverse structure of the flagship whitening flow: two
    (center-stretch ∘ Johnson-inverse) blocks — sinh tails EXPAND the base
    normal outward, the direction a transport needs (asinh/contract stages
    point the whitening way) — around a Householder rotation (dim > 1),
    with affine rescales at both ends.
    """
    v = lambda val: jnp.full((dim,), val, dtype)
    tail_block = lambda: (
        CenterStretch(a=v(0.0), b=v(1.0), c=v(0.0)),
        JohnsonInv(gamma=v(0.0), delta=v(5.0), xi=v(0.0), lam=v(5.0)),
    )
    stages = [ScaleShift(a=v(1.0), b=v(0.0)), *tail_block()]
    if dim > 1:
        k = min(dim, 4)
        V = jax.random.normal(key, (k, dim), dtype)
        stages.append(Householder(V=V).canonicalize())
    stages.extend(tail_block())
    stages.append(ScaleShift(a=v(1.0), b=v(0.0)))
    return compose(*stages)


def coupling_flow_template(n_layers: int = 4, hidden=(32, 32), *,
                           tails: bool = True, kind: str = "affine",
                           n_bins: int = 8, bound: float = 5.0):
    """Template factory: a coupling-stack base->data transport.

    Returns a callable with the ``flow_template(dim, key, dtype)``
    signature ``infer`` expects. The stack (identity-initialized coupling
    layers with Permute alternation, bijectors/coupling.py + spline.py)
    expresses learnable *conditional* structure the elementwise+rotation
    default template cannot; with ``tails=True`` a sinh tail-expansion
    block wraps the stack so heavy-tailed targets stay reachable. Use for
    dim >= 2 (couplings need something to condition on)::

        ef.infer(logp, dim=16, key=key,
                 flow_template=ef.coupling_flow_template(6, (64, 64)))

    ``kind='spline'`` swaps in rational-quadratic-spline couplings
    (``n_bins`` bins on ``[-bound, bound]`` per transformed dim,
    bijectors/spline.py) — per-dimension multimodal warps where the
    affine stack can only scale and shift; prefer it for multimodal or
    sharply non-Gaussian conditionals at a ~(3*n_bins-1)/2x conditioner
    output-width cost.
    """
    from .bijectors import coupling_stack, spline_coupling_stack

    if kind not in ("affine", "spline"):
        raise ValueError(f"kind must be 'affine' or 'spline', got {kind!r}")

    def template(dim: int, key, dtype=jnp.float32) -> Bijector:
        if dim < 2:
            return default_flow_template(dim, key, dtype)
        from .bijectors.base import Chain
        v = lambda val: jnp.full((dim,), val, dtype)
        stages = [ScaleShift(a=v(1.0), b=v(0.0))]
        if tails:
            stages.append(JohnsonInv(gamma=v(0.0), delta=v(5.0),
                                     xi=v(0.0), lam=v(5.0)))
        if kind == "spline":
            stack = spline_coupling_stack(key, dim, n_layers, hidden,
                                          n_bins=n_bins, bound=bound,
                                          dtype=dtype)
        else:
            stack = coupling_stack(key, dim, n_layers, hidden, dtype=dtype)
        stages.extend(stack.stages)
        stages.append(ScaleShift(a=v(1.0), b=v(0.0)))
        # stages is in APPLY order; Chain.of states that directly (compose
        # takes math order, i.e. reversed).
        return Chain.of(*stages)

    return template


def summarize_draws(draws, stats=None) -> dict:
    """Per-dimension convergence summary of (chains, steps, dim) draws.

    Keys: mean, sd, rhat (rank-normalized split-R-hat), bulk_ess, tail_ess,
    min_bulk_ess; plus divergences / accept_prob / bfmi when the sampler
    stats carry them.
    """
    x = np.asarray(draws, np.float64)
    dim = x.shape[-1]
    out = {
        "mean": x.reshape(-1, dim).mean(axis=0),
        "sd": x.reshape(-1, dim).std(axis=0),
        "rhat": rank_normalized_rhat_per_dim(x),
        "bulk_ess": np.array([bulk_ess(x[..., d]) for d in range(dim)]),
        "tail_ess": np.array([tail_ess(x[..., d]) for d in range(dim)]),
    }
    out["min_bulk_ess"] = float(out["bulk_ess"].min())
    if stats is not None:
        div = getattr(stats, "divergent", None)
        if div is not None:
            out["divergences"] = int(np.asarray(div).sum())
        acc = getattr(stats, "accept_prob", None)
        if acc is not None:
            out["accept_prob"] = float(np.asarray(acc).mean())
        energy = getattr(stats, "energy", None)
        if energy is not None:
            e = np.asarray(energy)
            if e.ndim == 2 and e.shape[1] > 2:
                out["bfmi"] = bfmi(e)
    return out


def _transport_khat(logdensity_fn: Callable, flow: Bijector, dim: int,
                    key, dtype, n: int = 2048) -> float:
    """PSIS k-hat of the transport fit: draw z ~ q (base through flow),
    importance-weight against the target, fit the weight tail
    (mcmc.diagnostics.pareto_khat). k-hat > 0.7 = q's tail under-covers
    p WHERE q HAS SUPPORT. Blind spot (measured): HARD mode collapse —
    no q-draw lands in a missed mode, so no heavy weight ever appears
    (a fully-collapsed fit on a far-modes target scored k-hat 0.13).
    ``_transport_coverage_gap`` covers that case; use both."""
    from .distributions.base import std_normal_logpdf_sum
    from .mcmc.diagnostics import pareto_khat

    xi = jax.random.normal(key, (n, dim), dtype)
    z, ladj = flow.forward_and_ladj(xi)
    log_q = std_normal_logpdf_sum(xi) - ladj
    logp = jax.vmap(logdensity_fn)(z)
    return pareto_khat(np.asarray(logp - log_q, np.float64))


def _transport_coverage_gap(logdensity_fn: Callable, flow: Bijector,
                            dim: int, key, dtype, n: int = 2048,
                            inflate: float = 4.0) -> float:
    """Hard-mode-collapse detector: probe with the INFLATED-base
    pushforward r (base scaled ``inflate``x through the same flow — its
    density is exactly computable from the same forward pass) and
    return the p-mass-weighted standard deviation of log q - log p
    (self-normalized IS through r). If q tracks p this is ~0 nats; a
    missed mode that r reaches contributes p-mass at log q ~ -inf.
    Calibration (2D bimodal family, f64): well-fit 0.17-0.37 nats,
    usable-but-rough 1.7, hard-collapsed 10-33 -> threshold 3.0."""
    from .distributions.base import std_normal_logpdf_sum

    xi = jax.random.normal(key, (n, dim), dtype) * inflate
    z, ladj = flow.forward_and_ladj(xi)
    log_r = (-0.5 * jnp.sum((xi / inflate) ** 2, axis=-1)
             - dim * (0.5 * np.log(2 * np.pi) + np.log(inflate)) - ladj)
    log_q = std_normal_logpdf_sum(xi) - ladj
    logp = jax.vmap(logdensity_fn)(z)
    w = jax.nn.softmax(logp - log_r)
    # Probe points where the target is -inf (bounded support) carry zero
    # p-mass; mask ri there rather than evaluating 0 * inf -> NaN.
    ri = jnp.where(w > 0.0, log_q - logp, 0.0)
    mean = jnp.sum(w * ri)
    return float(jnp.sqrt(jnp.sum(w * (ri - mean) ** 2)))


def infer(logdensity_fn: Callable, *, dim: int, key,
          method: str = "nuts",
          num_chains: int = 16, num_warmup: int = 500,
          num_samples: int = 1000,
          precondition: Optional[str] = "auto",
          precondition_kind: str = "auto",
          flow: Optional[Bijector] = None,
          data: Optional[jax.Array] = None,
          flow_template: Optional[Callable] = None,
          vi_steps: int = 500, vi_batch: int = 512, vi_optimizer=None,
          whiten_batches: int = 100, whiten_epochs: int = 10,
          refine_rounds: int = 0,
          mesh=None, dtype=jnp.float32, **sampler_kw) -> InferenceResult:
    """Sample an unnormalized target density, end to end.

    ``logdensity_fn``: per-sample target, (dim,) -> scalar (any jittable
    function). ``method``: 'nuts' | 'hmc' | 'chees' | 'smc'.

    Preconditioning: ``flow`` (a whitened->data bijector, e.g. from
    ``train.optimize_whitening`` inverted or ``train.optimize_elbo``) is
    used as-is; else ``precondition='auto'`` fits a transport by
    ``vi_steps`` ELBO steps; ``precondition=None`` samples the raw
    target. A ``mcmc.FlowPushforwardTarget`` brings its own exact
    transport, used unless ``flow``, ``data`` or ``precondition=None`` say
    otherwise. Draws are always returned in DATA space.

    ``precondition_kind`` selects the transport family for the auto fit
    (VERDICT r4 next #8): 'elementwise' (default_flow_template),
    'affine' / 'spline' (coupling_flow_template), or 'auto' — an
    ESCALATION ladder: fit the cheap elementwise family; judge it with
    TWO complementary diagnostics — PSIS k-hat
    (mcmc.diagnostics.pareto_khat, <= 0.7: q's tail covers p where q
    has support) and the inflated-probe coverage gap
    (``_transport_coverage_gap``, <= 3.0 nats: no p-mass sits where q
    is absent — the HARD-mode-collapse case k-hat is measurably blind
    to). On failure refit with the spline family; if that also fails
    (cold reverse-KL VI is mode-seeking — examples/
    spline_multimodal_2d.py measures the collapse), run a tempered-SMC
    bridge and MLE-whiten a spline stack on its draws (forward-KL =
    mode-covering), taking the transport with the best severity. The
    chosen family and its diagnostics are reported as
    ``precondition_family`` / ``precondition_khat`` /
    ``precondition_coverage_gap``. A user ``flow_template`` pins the
    ladder to that template alone. Draws are always returned in DATA
    space.

    The 'auto' transport minimizes reverse KL and is therefore
    MODE-SEEKING: on multimodal targets (e.g. anything downstream of a
    CenterStretch, which pushes mass away from its center) it collapses to
    one mode and the preconditioner can mislead fixed-trajectory samplers.
    For multimodal targets use ``method='smc'`` (tempering crosses density
    holes) or pass ``data=`` (below); NUTS remains correct (if slower)
    under an imperfect preconditioner.

    ``data=`` ((n, dim) draws from — or near — the target, e.g. observed
    samples or SMC output): the preconditioner is instead fitted by MLE
    whitening on the data (``train.optimize_whitening``, forward-KL =
    MODE-COVERING, the multimodal-safe direction) and its inverse used as
    the transport; ``whiten_batches``/``whiten_epochs`` control that fit.

    For 'smc', ``num_chains*num_samples`` becomes the particle count unless
    ``num_particles`` is passed, and diagnostics include ``log_z``.

    ``mesh`` (a `jax.sharding.Mesh` with a 'chains' axis, see
    `parallel.make_mesh`): shards the whole pipeline — VI/whitening batch
    axis, MCMC chains (`parallel.sample_sharded`), SMC particles
    (`parallel.smc_sample_sharded`, incl. learned annealing transports
    fitted data-parallel via ``transport_template_fn``) — params
    replicated, reductions riding XLA collectives.

    ``refine_rounds=N`` (MCMC methods): after sampling, re-fit the
    whitening transport on the round's own draws (mode-covering) and
    re-sample, N times — adaptive preconditioning that upgrades a rough
    first pass (raw or VI-seeded) into a whitened geometry. The refinement
    inherits whatever the first round's draws cover: on multimodal targets
    start from ``precondition=None`` or SMC draws via ``data=``, not the
    mode-seeking 'auto' path.
    """
    key, k_fit, k_sample = jax.random.split(jax.random.PRNGKey(0)
                                            if key is None else key, 3)
    axis = mesh.axis_names[0] if mesh is not None else "chains"

    used_flow = flow
    if (used_flow is None and data is None and precondition is not None
            and isinstance(logdensity_fn, FlowPushforwardTarget)):
        # A declared pushforward carries its exact transport: no fit.
        used_flow = logdensity_fn.transport
    if used_flow is None and data is not None and precondition is not None:
        from .bijectors import invert
        from .train import optimize_whitening
        template_fn = flow_template or default_flow_template
        # The transport template inverted = an identity-initialized
        # whitening flow (contract/asinh stages); train data -> base,
        # then the transport is its inverse (param-sharing).
        white = invert(template_fn(dim, k_fit, dtype))
        fit = optimize_whitening(jnp.asarray(data, dtype), white,
                                 vi_optimizer, nbatches=whiten_batches,
                                 nepochs=whiten_epochs, mesh=mesh,
                                 batch_axis=axis)
        used_flow = invert(fit.result)
    pre_diag: dict = {}
    raw_sampling = False       # rescue-escalated SMC samples the raw target
    if used_flow is None and precondition == "auto":
        from .train import optimize_elbo

        def batched_logp(z):
            flat = z.reshape(-1, dim)
            vals = jax.vmap(logdensity_fn)(flat)
            return vals.reshape(z.shape[:-1])

        # Family ladder (VERDICT r4 next #8): which templates to try, in
        # cost order. A user-passed flow_template or an explicit
        # precondition_kind pins one family; the default escalates
        # elementwise -> spline, gated on the PSIS k-hat of each fit
        # (<= 0.7 = trustworthy; ELBO alone cannot flag mode collapse).
        if flow_template is not None:
            ladder = [("custom", flow_template)]
        elif precondition_kind == "elementwise" or dim < 2:
            ladder = [("elementwise", default_flow_template)]
        elif precondition_kind == "affine":
            ladder = [("affine", coupling_flow_template(kind="affine"))]
        elif precondition_kind == "spline":
            ladder = [("spline", coupling_flow_template(kind="spline"))]
        elif precondition_kind == "auto":
            ladder = [("elementwise", default_flow_template),
                      ("spline", coupling_flow_template(kind="spline"))]
        else:
            raise ValueError(
                f"precondition_kind must be 'auto'|'elementwise'|"
                f"'affine'|'spline', got {precondition_kind!r}")

        def fit_quality(fl, i):
            kh = _transport_khat(logdensity_fn, fl, dim,
                                 jax.random.fold_in(k_fit, 101 + i),
                                 dtype)
            gap = _transport_coverage_gap(
                logdensity_fn, fl, dim,
                jax.random.fold_in(k_fit, 201 + i), dtype)
            # Scale-free severity: 1.0 = at threshold on the worse of
            # the two complementary diagnostics.
            return max(kh / 0.7, gap / 3.0), kh, gap

        best = None                 # (severity, khat, gap, name, flow)
        for i, (name, template_fn) in enumerate(ladder):
            init_flow = template_fn(dim, jax.random.fold_in(k_fit, i),
                                    dtype)
            vi = optimize_elbo(batched_logp, init_flow, vi_optimizer,
                               dim=dim, batch_size=vi_batch,
                               nsteps=vi_steps, key=k_fit, mesh=mesh,
                               batch_axis=axis, dtype=dtype)
            sev, kh, gap = fit_quality(vi.result, i)
            if best is None or sev < best[0]:
                best = (sev, kh, gap, name, vi.result)
            if sev <= 1.0:
                break
        if best[0] > 1.0 and len(ladder) > 1 and method != "smc":
            # Reverse-KL VI is mode-seeking: a k-hat this bad after the
            # spline fit usually means mode collapse, which more VI
            # cannot fix. Escalate to the framework's own mode-covering
            # recipe (examples/spline_multimodal_2d.py): a tempered-SMC
            # bridge for target-covering draws, then a forward-KL
            # (MLE-whitening) spline fit on them, inverse as transport.
            from .bijectors import invert
            from .smc import smc_sample
            from .train import optimize_whitening
            parts, log_w, _lz, _ = smc_sample(
                logdensity_fn, jax.random.fold_in(k_fit, 7), dim=dim,
                num_particles=4096, dtype=dtype)
            w = np.exp(np.asarray(log_w, np.float64)
                       - np.max(np.asarray(log_w)))
            w /= w.sum()
            idx = np.random.default_rng(0).choice(
                len(w), size=len(w), p=w)
            draws_cov = jnp.asarray(np.asarray(parts)[idx], dtype)
            white = invert(coupling_flow_template(kind="spline")(
                dim, jax.random.fold_in(k_fit, 8), dtype))
            fit = optimize_whitening(draws_cov, white, vi_optimizer,
                                     nbatches=whiten_batches,
                                     nepochs=whiten_epochs, mesh=mesh,
                                     batch_axis=axis)
            rescue = invert(fit.result)
            sev, kh, gap = fit_quality(rescue, 9)
            if sev < best[0]:
                best = (sev, kh, gap, "smc+spline-whitening", rescue)
        pre_diag = {"precondition_family": best[3],
                    "precondition_khat": float(best[1]),
                    "precondition_coverage_gap": float(best[2])}
        used_flow = best[4]
        if best[3] == "smc+spline-whitening" and method in ("nuts",
                                                            "hmc",
                                                            "chees"):
            # The ladder only reaches the rescue on strong multimodality
            # evidence, and fixed-kernel MCMC cannot finish the job
            # even through a GOOD covering transport: a continuous
            # bijection represents multimodal mass via low-density
            # base-space bridges that HMC-family chains do not cross —
            # measured on the ladder-mechanism test target, a
            # 0.87-nat-gap transport still left ALL chains in one mode
            # with rhat 1.01 (the silent failure mode). The final
            # sampling therefore switches to tempered SMC on the RAW
            # target (also measured: SMC through the transport loses
            # the minority basin — the whitened pullback contorts it
            # into thin structure the HMC mutations cannot hold, log_z
            # off by exactly the majority mode's mass — while raw-space
            # SMC resolves the 0.70/0.30 weights to 3 decimals). The
            # fitted transport is still returned in ``result.flow``.
            pre_diag["method_escalated_to"] = "smc"
            method = "smc"
            raw_sampling = True

    sampling_flow = None if raw_sampling else used_flow
    if sampling_flow is not None:
        pre = flow_preconditioned(logdensity_fn, sampling_flow)
        target = pre.logdensity_fn
    else:
        pre = None
        target = logdensity_fn

    if method == "smc":
        n_particles = sampler_kw.pop("num_particles",
                                     num_chains * num_samples)
        if mesh is not None:
            from .parallel import smc_sample_sharded
            particles, log_w, log_z, infos = smc_sample_sharded(
                target, k_sample, mesh, dim=dim, axis_name=axis,
                num_particles=n_particles, dtype=dtype, **sampler_kw)
        else:
            from .smc import smc_sample
            particles, log_w, log_z, infos = smc_sample(
                target, k_sample, dim=dim, num_particles=n_particles,
                dtype=dtype, **sampler_kw)
        if pre is not None:
            particles = pre.push_forward(particles)
        x = np.asarray(particles, np.float64)
        w = np.exp(np.asarray(log_w, np.float64)
                   - np.max(np.asarray(log_w)))
        w /= w.sum()
        mean_w = (w[:, None] * x).sum(axis=0)
        # Clamp the variance radicand: near-degenerate weights can make
        # E[x^2] - E[x]^2 slightly negative in floating point.
        var_w = np.maximum((w[:, None] * x**2).sum(axis=0) - mean_w**2, 0.0)
        diagnostics = {
            "mean": mean_w,
            "sd": np.sqrt(var_w),
            "log_z": float(log_z),
            "weight_ess": float(1.0 / np.sum(w**2)),
            **pre_diag,
        }
        return InferenceResult(draws=particles, diagnostics=diagnostics,
                               stats=infos, flow=used_flow)

    if mesh is not None:
        from .parallel import sample_sharded
        draws, _final, stats = sample_sharded(
            target, k_sample, mesh, dim=dim, num_chains=num_chains,
            axis_name=axis, num_warmup=num_warmup,
            num_samples=num_samples, algorithm=method, dtype=dtype,
            **sampler_kw)
    else:
        draws, _final, stats = sample(
            target, k_sample, dim=dim, num_chains=num_chains,
            num_warmup=num_warmup, num_samples=num_samples,
            algorithm=method, dtype=dtype, **sampler_kw)
    if pre is not None:
        draws = pre.push_forward(draws)

    if refine_rounds > 0:
        return infer(logdensity_fn, dim=dim,
                     key=jax.random.fold_in(key, refine_rounds),
                     method=method, num_chains=num_chains,
                     num_warmup=num_warmup, num_samples=num_samples,
                     data=draws.reshape(-1, dim),
                     flow_template=flow_template,
                     whiten_batches=whiten_batches,
                     whiten_epochs=whiten_epochs,
                     refine_rounds=refine_rounds - 1, mesh=mesh,
                     dtype=dtype, **sampler_kw)

    diagnostics = summarize_draws(draws, stats)
    diagnostics.update(pre_diag)
    return InferenceResult(draws=draws, diagnostics=diagnostics,
                           stats=stats, flow=used_flow)
