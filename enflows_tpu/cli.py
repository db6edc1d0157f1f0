"""Thin CLI: config-driven train / sample / bench runs.

The config layer the reference lacks (SURVEY.md §5 "Config: kwargs only"):
``python -m enflows_tpu.cli train --config run.toml --train.nepochs=20``.
Library kwargs remain the primary API; the CLI just parses TOML/JSON +
dotted overrides and dispatches.
"""
from __future__ import annotations

import argparse
import sys

import jax
import jax.numpy as jnp


def _mesh_from_cfg(cfg):
    from .parallel import make_mesh
    if cfg.mesh.axes:
        return make_mesh(dict(cfg.mesh.axes), axis_name=cfg.mesh.axis_name)
    return None


def cmd_train(cfg):
    import numpy as np
    import optax
    from .utils import build_flow, MetricsLogger, save_checkpoint
    from .train import optimize_whitening, optimize_elbo

    flow = build_flow(cfg.flow)
    opt = {"adagrad": optax.adagrad, "adam": optax.adam,
           "sgd": optax.sgd}[cfg.train.optimizer](cfg.train.learning_rate)
    key = jax.random.PRNGKey(cfg.train.seed)
    # Live per-step streaming out of the compiled scans (utils.metrics).
    log = MetricsLogger(cfg.metrics_path) if cfg.metrics_path else None

    if cfg.train.objective == "whitening":
        if cfg.data_path:
            # User data: (n, dim) array from .npz/.npy (--data run.npz).
            from .utils.config import load_array
            X = jnp.asarray(load_array(cfg.data_path),
                            jnp.dtype(cfg.flow.dtype))
            if X.ndim != 2 or X.shape[1] != cfg.flow.dim:
                raise ValueError(
                    f"data {cfg.data_path}: shape {X.shape} does not match "
                    f"(n, flow.dim={cfg.flow.dim})")
        else:
            # Synthetic demo target when no data source is configured: the
            # reference 1D example's ground truth, matching examples/.
            from . import compose, CenterStretch, Johnson
            d = cfg.flow.dim
            vec = lambda v: jnp.full((d,), v, jnp.dtype(cfg.flow.dtype))
            truth = compose(CenterStretch(a=vec(4.0), b=vec(1.0), c=vec(0.0)),
                            Johnson(gamma=vec(10.0), delta=vec(3.5),
                                    xi=vec(10.0), lam=vec(1.0)))
            X = truth.forward(jax.random.normal(key, (10**5, d),
                                                jnp.dtype(cfg.flow.dtype)))
        ck = {}
        if cfg.train.checkpoint_every:
            # Preemption-safe mode: chunked scans checkpointed under a
            # 'train/' subdir (the final flow snapshot below keeps its
            # own step numbering in the parent dir).
            import os as _os
            ck = dict(checkpoint_every=cfg.train.checkpoint_every,
                      ckpt_dir=_os.path.join(cfg.checkpoint_dir, "train")
                      if cfg.checkpoint_dir else None)
        res = optimize_whitening(X, flow, opt, nbatches=cfg.train.nbatches,
                                 nepochs=cfg.train.nepochs,
                                 mesh=_mesh_from_cfg(cfg), metrics=log,
                                 **ck)
        hist = res.negll_history
    else:
        from .distributions import std_normal_logpdf_sum
        ck = {}
        if cfg.train.checkpoint_every:
            import os as _os
            ck = dict(checkpoint_every=cfg.train.checkpoint_every,
                      ckpt_dir=_os.path.join(cfg.checkpoint_dir, "train")
                      if cfg.checkpoint_dir else None)
        res = optimize_elbo(lambda z: std_normal_logpdf_sum(z), flow, opt,
                            dim=cfg.flow.dim,
                            batch_size=cfg.train.batch_size,
                            nsteps=cfg.train.nsteps,
                            antithetic=cfg.train.antithetic, key=key,
                            stl=cfg.train.stl, metrics=log, **ck)
        hist = res.nelbo_history

    if log is not None:
        jax.block_until_ready(hist)
        jax.effects_barrier()
        log.close()
    if cfg.checkpoint_dir:
        save_checkpoint(cfg.checkpoint_dir,
                        {"flow": res.result,
                         "opt_state": res.optimizer_state},
                        step=len(hist))
    print(f"final loss: {float(np.mean(np.asarray(hist[-50:]))):.4f}")
    return 0


def cmd_sample(cfg):
    import numpy as np
    from .mcmc import sample, split_rhat_per_dim, ess_per_dim
    from .smc import smc_sample
    from .utils import MetricsLogger

    d = cfg.sampler.num_chains
    dim = cfg.flow.dim
    log = MetricsLogger(cfg.metrics_path) if cfg.metrics_path else None

    if cfg.target:
        from .utils.config import resolve_target
        logp = resolve_target(cfg.target)     # user target: --target mod:fn
    else:
        def logp(q):       # demo target: standard normal
            return -0.5 * jnp.sum(q * q)

    key = jax.random.PRNGKey(cfg.sampler.seed)
    if cfg.sampler.algorithm == "smc":
        parts, lw, logz, infos = smc_sample(
            logp, key, dim=dim, num_particles=cfg.sampler.num_particles,
            mutation_steps=cfg.sampler.mutation_steps,
            ess_target=cfg.sampler.ess_target, metrics=log)
        print(f"SMC: {len(infos)} temperatures, logZ={float(logz):.4f}")
    else:
        samples, _, stats = sample(
            logp, key, dim=dim, num_chains=cfg.sampler.num_chains,
            num_warmup=cfg.sampler.num_warmup,
            num_samples=cfg.sampler.num_samples,
            algorithm=cfg.sampler.algorithm,
            max_depth=cfg.sampler.max_depth,
            num_steps=cfg.sampler.num_steps,
            target_accept=cfg.sampler.target_accept,
            metrics=log if cfg.sampler.algorithm != "chees" else None)
        print(f"{cfg.sampler.algorithm}: rhat="
              f"{split_rhat_per_dim(samples).max():.4f} "
              f"ess_min={ess_per_dim(samples).min():.0f} "
              f"accept={float(np.mean(np.asarray(stats.accept_prob))):.3f}")
    if log is not None:
        jax.effects_barrier()
        log.close()
    return 0


def cmd_infer(cfg):
    """One-call pipeline (ef.infer): auto-fit a transport, sample the
    preconditioned target, print the rank-normalized diagnostics summary.

    The target is the user's own log density when ``--target mod:logp``
    (or ``file.py:logp``) is given; otherwise a built-in demo warped
    target — so ``enflows_tpu infer --target mymod:logp --flow.dim=8``
    runs end-to-end inference on a density defined outside the repo."""
    import numpy as np
    from . import infer

    dim = cfg.flow.dim
    dt = jnp.dtype(cfg.flow.dtype)
    if cfg.target:
        from .utils.config import resolve_target
        logp = resolve_target(cfg.target)
    else:
        from . import (compose, ScaleShift, Householder, JohnsonInv,
                       FlowDistribution)
        vec = lambda v: jnp.full((dim,), v, dt)
        stages = [ScaleShift(a=vec(1.3), b=vec(2.5))]
        if dim > 1:
            stages.append(Householder(
                V=jax.random.normal(jax.random.PRNGKey(0), (dim,), dt)))
        stages.append(JohnsonInv(gamma=vec(0.5), delta=vec(2.0),
                                 xi=vec(0.0), lam=vec(1.0)))
        target = FlowDistribution(bijector=compose(*stages))
        logp = lambda q: target.logpdf(q)

    key = jax.random.PRNGKey(cfg.sampler.seed)
    if cfg.sampler.algorithm == "smc":
        res = infer(logp, dim=dim, key=key,
                    method="smc", precondition=None,
                    num_particles=cfg.sampler.num_particles, dtype=dt)
    else:
        res = infer(logp, dim=dim, key=key,
                    method=cfg.sampler.algorithm,
                    num_chains=cfg.sampler.num_chains,
                    num_warmup=cfg.sampler.num_warmup,
                    num_samples=cfg.sampler.num_samples,
                    precondition_kind=cfg.sampler.precondition_kind,
                    vi_steps=cfg.train.nsteps, dtype=dt)
    d = res.diagnostics
    if "precondition_family" in d:
        print(f"precondition: family={d['precondition_family']} "
              f"khat={d['precondition_khat']:.2f} "
              f"coverage_gap={d['precondition_coverage_gap']:.2f}")
    if "log_z" in d:
        print(f"smc: logZ={d['log_z']:.4f} "
              f"weight_ess={d['weight_ess']:.0f} "
              f"mean={np.round(d['mean'], 3)}")
    else:
        print(f"{cfg.sampler.algorithm}: rhat={d['rhat'].max():.4f} "
              f"min_bulk_ess={d['min_bulk_ess']:.0f} "
              f"tail_ess={d['tail_ess'].min():.0f} "
              f"divergences={d['divergences']} "
              f"mean={np.round(d['mean'], 3)}")
    return 0


def main(argv=None):
    from .utils import load_config
    from .utils.compilation_cache import enable_persistent_compilation_cache

    enable_persistent_compilation_cache()

    parser = argparse.ArgumentParser(prog="enflows_tpu")
    parser.add_argument("command", choices=["train", "sample", "infer"])
    parser.add_argument("--config", default=None)
    parser.add_argument("--target", default=None, metavar="MOD:ATTR",
                        help="user log-density spec: 'module:attr' or "
                             "'path/to/file.py:attr' ((dim,) -> scalar)")
    parser.add_argument("--data", default=None, metavar="PATH",
                        help="training data .npz/.npy of shape (n, dim) "
                             "for the whitening objective")
    args, overrides = parser.parse_known_args(argv)
    cfg = load_config(args.config, overrides)
    if args.target:
        cfg.target = args.target
    if args.data:
        cfg.data_path = args.data
    return {"train": cmd_train, "sample": cmd_sample,
            "infer": cmd_infer}[args.command](cfg)


if __name__ == "__main__":
    sys.exit(main())
