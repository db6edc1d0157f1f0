"""Bring-up check on NVIDIA GPUs: the training and sampling path end to end.

Run from the repository root:

    python chip_smoke.py            # one card, every phase
    python chip_smoke.py --multi    # four cards, the sharded path only

Each phase drives the public entry points (``forward_and_ladj``,
``optimize_whitening``, ``optimize_elbo``, ``mcmc.sample``,
``smc.smc_sample`` and their ``parallel`` counterparts) at the full width of
a configuration the repository supports, checks its result against a
float64 reference computed on the host CPU (or against the analytic
posterior), and prints compile time, steady time per step, peak device
memory, and the card's name and power limit. Any failed check raises, and
the script exits non-zero. The last line of standard output is one JSON
object naming the device. Without a GPU the script exits non-zero and
prints no result.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import optax

import enflows_tpu as ef
from __graft_entry__ import _flagship_flow
from benchmarks.harness import (build_coupling, card_info,
                                compile_and_time, device_summary,
                                peak_bytes_in_use)
from enflows_tpu.mcmc import ess_per_dim, sample
from enflows_tpu.smc import smc_sample
from enflows_tpu.train import (make_train_step, mvnormal_negll, neg_elbo,
                               optimize_elbo, optimize_whitening)
from enflows_tpu.utils.compilation_cache import \
    enable_persistent_compilation_cache

F32 = jnp.float32

# ---------------------------------------------------------------------
# Tolerances, each with its reason.
#
# Elementwise chain (flagship flow): every stage is float32 elementwise
# arithmetic (the Householder product pins HIGHEST precision), so values
# carry a few ulps of round-off per stage: 1e-5 relative to the output
# scale. Loss gradients sum 65,536 such terms: 1e-4 relative to the largest
# gradient component.
CHAIN_VALUE_RTOL = 1e-5
CHAIN_GRAD_RTOL = 1e-4
# Coupling stacks at the default matmul precision: the conditioner matmuls
# may run in TF32 (10-bit mantissa, unit round-off 2^-11 ~ 4.9e-4). Four
# coupling layers of three matmuls each compound that to ~1e-2 relative to
# the output scale; gradients, which difference such terms, to 3e-2.
TF32_VALUE_RTOL = 1e-2
TF32_GRAD_RTOL = 3e-2
# The same stacks under jax.default_matmul_precision("float32"): float32
# round-off (2^-24) through the same depth, with the 512-term dot products
# summed in a different order than on the CPU: 1e-4 / 1e-3. Passing these
# shows the default-precision gap is TF32 alone.
F32_VALUE_RTOL = 1e-4
F32_GRAD_RTOL = 1e-3
# Sampler moments: Monte-Carlo error, Z_MC standard errors (NUTS: from the
# spread across independent chains; SMC: from the weight ESS).
Z_MC = 5.0
# SMC log normalizer on the 100-D mixture: tests/test_smc.py holds the 8-D
# mixture to 0.8 nats; the 100-D run at 8,192 particles lands 0.17 nats off
# on the CPU, and more particles only narrow the estimator's spread. One
# nat leaves room for seed-to-seed variation.
SMC_LOGZ_ATOL = 1.0
# Sharded and one-device SMC ladders of the same key: the reductions run in
# another order, so a bisection can land a step apart; three steps, as in
# tests/test_parallel.py.
SMC_LADDER_GAP = 3
# Whitening drive recipe (.claude/skills/verify/SKILL.md): the fit lands
# within 0.05 nats of the truth's negll.
RECIPE_GAP = 0.05


class Report:
    """Prints one line per measurement, each with the card beside it."""

    def __init__(self, card: str):
        self.card = card

    def line(self, phase: str, what: str, compile_s=None, step_s=None,
             extra: str = ""):
        peak = peak_bytes_in_use()
        parts = [f"[{phase}] {what}:"]
        if compile_s is not None:
            parts.append(f"compile {compile_s:.3f} s,")
        if step_s is not None:
            parts.append(f"steady {step_s * 1e3:.3f} ms/step,")
        parts.append("peak " + ("n/a" if peak is None
                                else f"{peak / 2**30:.3f} GiB") + ",")
        if extra:
            parts.append(extra + ",")
        parts.append(f"card: {self.card}")
        print(" ".join(parts), flush=True)


def check(ok: bool, msg: str):
    if not ok:
        raise AssertionError(msg)


def on_cpu_f64(fn, *trees):
    """Evaluate ``fn(*trees)`` in float64 on the host CPU (the plain
    reference), returning NumPy leaves."""
    cpu = jax.devices("cpu")[0]

    def to64(a):
        a = np.asarray(a)
        return a.astype(np.float64) if np.issubdtype(a.dtype,
                                                     np.floating) else a

    with jax.enable_x64(True), jax.default_device(cpu):
        args = jax.tree.map(lambda a: jnp.asarray(to64(a)), trees)
        return jax.tree.map(np.asarray, fn(*args))


def max_rel_err(got, ref) -> float:
    """max |got - ref| over all leaves, relative to max |ref|."""
    got_l, ref_l = jax.tree.leaves(got), jax.tree.leaves(ref)
    scale = max(float(np.max(np.abs(r))) for r in ref_l)
    err = max(float(np.max(np.abs(np.asarray(g, np.float64) - r)))
              for g, r in zip(got_l, ref_l))
    return err / max(scale, 1e-30)


def timed_call(fn):
    """Wall time of a call whose result ends in block_until_ready."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn())
    return out, time.perf_counter() - t0


def _fwd_ladj(flow, x):
    return flow.forward_and_ladj(x)


def _negll_vg(flow, x):
    return jax.value_and_grad(mvnormal_negll)(flow, x)


# ---------------------------------------------------------------------
# Phase 1: whitening, the reference workload (flagship 5-stage flow, d=2).

def phase_whitening(report: Report, *, n_fwd=1 << 24, n_train=1 << 22,
                    nbatches=4, nepochs=2, n_cmp=1 << 16,
                    recipe_n=100_000, recipe_batches=100, recipe_epochs=40):
    flow = _flagship_flow(2)
    x = jax.random.normal(jax.random.PRNGKey(0), (n_fwd, 2), F32)

    (y, ladj), c, s = compile_and_time(_fwd_ladj, flow, x)
    check(y.shape == (n_fwd, 2) and ladj.shape == (n_fwd,),
          "forward_and_ladj shapes")
    check(bool(jnp.all(jnp.isfinite(y))) and bool(jnp.all(jnp.isfinite(ladj))),
          "forward_and_ladj produced non-finite values")
    report.line("whitening", f"forward_and_ladj {n_fwd}x2", c, s,
                f"{n_fwd / s / 1e6:.1f}M evals/s")

    ref = on_cpu_f64(_fwd_ladj, flow, x[:n_cmp])
    err = max_rel_err((y[:n_cmp], ladj[:n_cmp]), ref)
    check(err <= CHAIN_VALUE_RTOL,
          f"forward_and_ladj vs f64 reference: {err:.3e} > "
          f"{CHAIN_VALUE_RTOL:.0e}")
    report.line("whitening", f"forward_and_ladj vs f64 CPU on {n_cmp} rows",
                extra=f"max rel err {err:.3e} (tol {CHAIN_VALUE_RTOL:.0e})")

    (loss, grads) = jax.jit(_negll_vg)(flow, x[:n_cmp])
    ref_loss, ref_grads = on_cpu_f64(_negll_vg, flow, x[:n_cmp])
    err_l = abs(float(loss) - float(ref_loss)) / abs(float(ref_loss))
    err_g = max_rel_err(grads, ref_grads)
    check(err_l <= CHAIN_VALUE_RTOL and err_g <= CHAIN_GRAD_RTOL,
          f"whitening loss/grad vs f64: {err_l:.3e} / {err_g:.3e}")
    report.line("whitening", f"negll value+grad vs f64 CPU on {n_cmp} rows",
                extra=f"loss rel err {err_l:.3e} (tol "
                      f"{CHAIN_VALUE_RTOL:.0e}), grad max rel err "
                      f"{err_g:.3e} (tol {CHAIN_GRAD_RTOL:.0e})")

    xt = x[:n_train]
    opt = optax.adagrad(0.05)
    step = make_train_step(opt)
    carry = (flow, opt.init(flow))
    batch = xt[: n_train // nbatches]
    _, c, s = compile_and_time(step, carry, batch)
    report.line("whitening", f"train step {n_train // nbatches}x2", c, s,
                f"{n_train // nbatches / s / 1e6:.1f}M samples/s")
    res, wall = timed_call(lambda: optimize_whitening(
        xt, flow, opt, nbatches=nbatches, nepochs=nepochs))
    hist = np.asarray(res.negll_history)
    check(hist.shape == (nbatches * nepochs,) and np.all(np.isfinite(hist)),
          "optimize_whitening history")
    before = float(mvnormal_negll(flow, xt))
    after = float(mvnormal_negll(res.result, xt))
    check(after < before, f"optimize_whitening did not lower the loss: "
          f"{before:.4f} -> {after:.4f}")
    report.line("whitening", f"optimize_whitening {n_train}x2, "
                f"{nbatches} batches x {nepochs} epochs (wall incl. compile)",
                extra=f"wall {wall:.3f} s, negll {hist[0]:.4f} -> "
                      f"{hist[-1]:.4f}")

    # The drive recipe and its gate.
    v = lambda *a: jnp.asarray(a, F32)
    truth = ef.compose(ef.CenterStretch(a=v(4.), b=v(1.), c=v(0.)),
                       ef.Johnson(gamma=v(10.), delta=v(3.5), xi=v(10.),
                                  lam=v(1.)))
    X = truth.forward(jax.random.normal(jax.random.PRNGKey(0),
                                        (recipe_n, 1), F32))
    model = ef.compose(ef.Johnson(gamma=v(0.), delta=v(5.), xi=v(0.),
                                  lam=v(5.)),
                       ef.invert(ef.CenterStretch(a=v(0.), b=v(1.),
                                                  c=v(0.))))
    res, wall = timed_call(lambda: optimize_whitening(
        X, model, optax.adagrad(0.1), nbatches=recipe_batches,
        nepochs=recipe_epochs))
    gap = float(mvnormal_negll(res.result, X)
                - mvnormal_negll(ef.invert(truth), X))
    check(gap < RECIPE_GAP, f"drive recipe gap {gap:.4f} >= {RECIPE_GAP}")
    report.line("whitening", f"drive recipe {recipe_n}x1, {recipe_batches}"
                f" batches x {recipe_epochs} epochs",
                extra=f"wall {wall:.3f} s, negll gap to truth {gap:.4f} "
                      f"(gate < {RECIPE_GAP})")


# ---------------------------------------------------------------------
# Phase 2: coupling flows at the widest configuration the repository has
# (benchmarks/bench_coupling.py: d=64, 4 couplings, (512, 512)).

# Adagrad's and Adam's first steps move every weight by about the learning
# rate; over a 512-wide layer those moves add up. Adagrad at 1e-2 drove
# the log-scales into their clamp in three steps (negll 91 -> 607 nats);
# Adam at 1e-4 keeps the steps a descent.
COUPLING_OPT = optax.adam(1e-4)


def _gauss_logp(z):
    return -0.5 * jnp.sum(z * z, axis=-1)


def _elbo_vg(flow, xi):
    return jax.value_and_grad(neg_elbo)(flow, _gauss_logp, xi)


def _compare_coupling(report, kind, stack, x, precision, value_tol,
                      grad_tol):
    label = "default" if precision is None else precision
    with jax.default_matmul_precision(precision):
        y, ladj = jax.jit(_fwd_ladj)(stack, x)
        _, grads = jax.jit(_negll_vg)(stack, x)
    ref_y, ref_l = on_cpu_f64(_fwd_ladj, stack, x)
    _, ref_g = on_cpu_f64(_negll_vg, stack, x)
    err_y, err_l = max_rel_err(y, ref_y), max_rel_err(ladj, ref_l)
    err_g = max_rel_err(grads, ref_g)
    check(max(err_y, err_l) <= value_tol and err_g <= grad_tol,
          f"{kind} coupling at {label} precision vs f64: y {err_y:.3e}, "
          f"ladj {err_l:.3e}, grad {err_g:.3e}")
    report.line("coupling", f"{kind} vs f64 CPU on {x.shape[0]} rows, "
                f"{label} matmul precision",
                extra=f"y {err_y:.3e}, ladj {err_l:.3e} (tol "
                      f"{value_tol:.0e}); grad {err_g:.3e} (tol "
                      f"{grad_tol:.0e})")


def phase_coupling(report: Report, *, rows=1 << 17, dim=64, n_layers=4,
                   hidden=(512, 512), n_bins=8, train_steps=3,
                   n_cmp=4096):
    x = jax.random.normal(jax.random.PRNGKey(1), (rows, dim), F32)
    for kind in ("affine", "spline"):
        stack = build_coupling(kind, dim, n_layers, hidden, n_bins)
        cfg = f"{kind} d={dim} {n_layers}x{tuple(hidden)}"

        (y, ladj), c, s = compile_and_time(_fwd_ladj, stack, x)
        check(bool(jnp.all(jnp.isfinite(y)))
              and bool(jnp.all(jnp.isfinite(ladj))),
              f"{kind} forward_and_ladj non-finite")
        report.line("coupling", f"{cfg} forward_and_ladj {rows} rows", c, s,
                    f"{rows / s / 1e6:.2f}M evals/s")

        opt = COUPLING_OPT
        _, c, s = compile_and_time(make_train_step(opt),
                                   (stack, opt.init(stack)), x)
        report.line("coupling", f"{cfg} whitening train step {rows} rows",
                    c, s, f"{rows / s / 1e6:.2f}M samples/s")
        xt = jnp.tile(x, (train_steps, 1))
        res, wall = timed_call(lambda: optimize_whitening(
            xt, stack, opt, nbatches=train_steps, nepochs=1))
        hist = np.asarray(res.negll_history)
        # Every batch is the same rows, so small steps must lower it.
        check(np.all(np.isfinite(hist)) and hist[-1] < hist[0],
              f"{kind} whitening did not descend: {hist}")
        report.line("coupling", f"{cfg} optimize_whitening {train_steps} "
                    f"steps x {rows} rows (wall incl. compile)",
                    extra=f"wall {wall:.3f} s, negll {hist[0]:.4f} -> "
                          f"{hist[-1]:.4f}")

        xi = x[: rows]
        _, c, s = compile_and_time(_elbo_vg, stack, xi)
        report.line("coupling", f"{cfg} ELBO value+grad {rows} rows", c, s,
                    f"{rows / s / 1e6:.2f}M samples/s")
        res, wall = timed_call(lambda: optimize_elbo(
            _gauss_logp, stack, COUPLING_OPT, dim=dim,
            batch_size=rows // 2, nsteps=train_steps))
        hist = np.asarray(res.nelbo_history)
        check(np.all(np.isfinite(hist)), f"{kind} ELBO non-finite")
        report.line("coupling", f"{cfg} optimize_elbo {train_steps} steps x"
                    f" {rows} draws (wall incl. compile)",
                    extra=f"wall {wall:.3f} s, nelbo {hist[0]:.4f} -> "
                          f"{hist[-1]:.4f}")

        xc = x[:n_cmp]
        _compare_coupling(report, kind, stack, xc, None, TF32_VALUE_RTOL,
                          TF32_GRAD_RTOL)
        _compare_coupling(report, kind, stack, xc, "float32",
                          F32_VALUE_RTOL, F32_GRAD_RTOL)


# ---------------------------------------------------------------------
# Phase 3: samplers (BASELINE.json configs[3] and configs[4]).

def equicorr_logp(dim: int, rho: float = 0.9):
    """Equicorrelated Gaussian; the quadratic form pins HIGHEST precision so
    the target itself is not rounded to TF32 on the card."""
    cov = rho * np.ones((dim, dim)) + (1.0 - rho) * np.eye(dim)
    prec = jnp.asarray(np.linalg.inv(cov), F32)
    return lambda q: -0.5 * jnp.dot(
        q, jnp.dot(prec, q, precision=jax.lax.Precision.HIGHEST),
        precision=jax.lax.Precision.HIGHEST)


def mixture_logp(q):
    """Equal-weight two-component unit-Gaussian mixture at +-1.5 on every
    axis; normalizer (2 pi)^(d/2)."""
    a = -0.5 * jnp.sum((q - 1.5) ** 2) + jnp.log(0.5)
    b = -0.5 * jnp.sum((q + 1.5) ** 2) + jnp.log(0.5)
    return jnp.logaddexp(a, b)


def check_moments(name, draws, mean, var):
    """Per-dimension mean and variance of (chains, steps, dim) draws within
    Z_MC standard errors of a Gaussian's (mean, var). The chains are
    independent, so each estimator's standard error is the spread of its
    per-chain values over sqrt(chains): no autocorrelation estimate, which
    short chains on a slowly mixing target would overstate."""
    n = draws.shape[0]
    per_chain_m = draws.mean(axis=1)
    per_chain_v = ((draws - mean) ** 2).mean(axis=1)
    z_m = float(np.max(np.abs(per_chain_m.mean(0) - mean)
                       / (per_chain_m.std(0, ddof=1) / np.sqrt(n))))
    z_v = float(np.max(np.abs(per_chain_v.mean(0) - var)
                       / (per_chain_v.std(0, ddof=1) / np.sqrt(n))))
    check(z_m <= Z_MC and z_v <= Z_MC,
          f"{name} moments off: max |z| mean {z_m:.2f}, var {z_v:.2f}")
    return z_m, z_v, float(np.min(ess_per_dim(draws)))


def check_smc(name, parts, lw, log_z, infos, dim):
    """The tempered ladder reached beta = 1, log Z is within SMC_LOGZ_ATOL
    of (2 pi)^(d/2), both modes keep weight, and each mode's mean and
    variance are within Z_MC standard errors of (+-1.5, 1). A particle's
    mode is the sign of its coordinate sum (N(+-1.5 d, d): no overlap)."""
    check(abs(float(infos[-1].beta) - 1.0) < 1e-6,
          f"{name} stopped at beta {float(infos[-1].beta)} before 1 "
          f"({len(infos)} temperatures)")
    err_z = abs(float(log_z) - dim * 0.5 * np.log(2 * np.pi))
    check(err_z <= SMC_LOGZ_ATOL, f"{name} logZ error {err_z:.3f}")
    p = np.asarray(parts, np.float64)
    w = np.asarray(jax.nn.softmax(jnp.asarray(lw, F32)), np.float64)
    pos = p.sum(axis=1) > 0
    frac = float(w[pos].sum())
    check(0.25 < frac < 0.75, f"{name} lost a mode: weight fraction "
          f"{frac:.3f}")
    zs = []
    for sel, centre in ((pos, 1.5), (~pos, -1.5)):
        wm = w[sel] / w[sel].sum()
        ess_w = 1.0 / np.sum(wm * wm)
        m = (wm[:, None] * p[sel]).sum(0)
        v = (wm[:, None] * (p[sel] - m) ** 2).sum(0)
        zs.append(float(np.max(np.abs(m - centre) * np.sqrt(ess_w))))
        zs.append(float(np.max(np.abs(v - 1.0) / np.sqrt(2.0 / ess_w))))
    check(max(zs) <= Z_MC, f"{name} within-mode moments off: z {zs}")
    return err_z, frac, max(zs)


def phase_samplers(report: Report, *, nuts_chains=1024, nuts_dim=50,
                   num_warmup=300, num_samples=200, smc_particles=1 << 16,
                   smc_dim=100):
    logp = equicorr_logp(nuts_dim)

    def run_nuts(seed):
        return sample(logp, jax.random.PRNGKey(seed), dim=nuts_dim,
                              num_chains=nuts_chains, num_warmup=num_warmup,
                              num_samples=num_samples)[0]

    _, first = timed_call(lambda: run_nuts(0))
    draws, steady = timed_call(lambda: run_nuts(1))
    z_m, z_v, min_ess = check_moments(
        "NUTS", np.asarray(draws, np.float64), 0.0, 1.0)
    report.line("samplers", f"NUTS {nuts_chains} chains x {nuts_dim}D "
                f"equicorrelated rho=0.9, {num_warmup}+{num_samples} steps",
                step_s=steady / (num_warmup + num_samples),
                extra=f"first call {first:.3f} s (compile + run), steady "
                      f"call {steady:.3f} s, min ESS {min_ess:.0f}, "
                      f"max |z| mean {z_m:.2f} var {z_v:.2f} "
                      f"(tol {Z_MC})")

    def run_smc(seed):
        return smc_sample(mixture_logp, jax.random.PRNGKey(seed),
                          dim=smc_dim, num_particles=smc_particles)

    _, first = timed_call(lambda: run_smc(9))
    (parts, lw, log_z, infos), steady = timed_call(lambda: run_smc(0))
    err_z, frac, z_max = check_smc("SMC", parts, lw, log_z, infos, smc_dim)
    report.line("samplers", f"SMC {smc_particles} particles x {smc_dim}D "
                f"bimodal mixture, {len(infos)} temperatures",
                step_s=steady / len(infos),
                extra=f"first call {first:.3f} s (compile + run), steady "
                      f"call {steady:.3f} s, logZ err {err_z:.3f} (tol "
                      f"{SMC_LOGZ_ATOL}), mode weight {frac:.3f}, "
                      f"within-mode max |z| {z_max:.2f} (tol {Z_MC})")


# ---------------------------------------------------------------------
# --multi: the sharded path on four cards, each compared with a
# one-device run of the same key.

N_MULTI = 4


def phase_multi(report: Report, *, n_devices=N_MULTI, rows=1 << 17, dim=64,
                n_layers=4, hidden=(512, 512), train_steps=3,
                nuts_chains=4096, nuts_dim=50, num_warmup=200,
                num_samples=100, smc_particles=1 << 18, smc_dim=100):
    from enflows_tpu.parallel import (make_mesh, sample_sharded,
                                      smc_sample_sharded)

    devices = jax.devices()[:n_devices]
    check(len(devices) == n_devices,
          f"--multi needs {n_devices} devices, found {len(jax.devices())}")

    # Sharded whitening at the coupling configuration (float32 as users
    # run it): the batch psum changes only the gradient summation order.
    stack = build_coupling("affine", dim, n_layers, hidden)
    x = jax.random.normal(jax.random.PRNGKey(1), (rows * train_steps, dim),
                          F32)
    bmesh = make_mesh({"batch": n_devices}, devices=devices)
    kw = dict(nbatches=train_steps, nepochs=1)
    r1, t1 = timed_call(lambda: optimize_whitening(
        x, stack, COUPLING_OPT, **kw))
    rn, tn = timed_call(lambda: optimize_whitening(
        x, stack, COUPLING_OPT, mesh=bmesh, **kw))
    h1, hn = np.asarray(r1.negll_history), np.asarray(rn.negll_history)
    err_h = float(np.max(np.abs(hn - h1) / np.abs(h1)))
    err_p = max_rel_err(rn.result, jax.tree.map(np.asarray, r1.result))
    check(err_h <= 1e-5 and err_p <= 1e-4,
          f"sharded whitening vs one device: history {err_h:.3e}, "
          f"params {err_p:.3e}")
    report.line("multi", f"optimize_whitening affine d={dim} "
                f"{n_layers}x{tuple(hidden)}, {train_steps} steps x {rows} "
                f"rows on {n_devices} cards (wall incl. compile)",
                extra=f"wall {tn:.3f} s (one card {t1:.3f} s), history rel "
                      f"err {err_h:.3e} (tol 1e-5), params {err_p:.3e} "
                      f"(tol 1e-4)")

    # NUTS in float64: the same-key trajectory gate of tests/test_parallel.py
    # (test_sharded_mcmc_shard_map_vs_spmd_vs_unsharded), where only the
    # summation order of the consensus collectives differs.
    cmesh = make_mesh({"chains": n_devices}, devices=devices)
    with jax.enable_x64(True):
        logp = equicorr_logp(nuts_dim)
        key = jax.random.PRNGKey(7)
        kw = dict(dim=nuts_dim, num_chains=nuts_chains,
                  num_warmup=num_warmup, num_samples=num_samples,
                  dtype=jnp.float64)
        (dn, _, sn), tn = timed_call(lambda: sample_sharded(
            logp, key, cmesh, implementation="shard_map", **kw))
        k2, k0 = jax.random.split(key)
        init = 0.1 * jax.random.normal(k0, (nuts_chains, nuts_dim),
                                       jnp.float64)
        (d1, _, s1), t1 = timed_call(lambda: sample(
            logp, k2, initial_position=init, **kw))
        err_d = float(np.max(np.abs(np.asarray(dn) - np.asarray(d1))))
        err_s = abs(float(sn.step_size) / float(s1.step_size) - 1.0)
        check(err_d <= 1e-8 and err_s <= 1e-10,
              f"sharded NUTS vs one device: draws {err_d:.3e}, step size "
              f"{err_s:.3e}")
        report.line("multi", f"sample_sharded NUTS {nuts_chains} chains x "
                    f"{nuts_dim}D f64 on {n_devices} cards (wall incl. "
                    f"compile)",
                    extra=f"wall {tn:.3f} s (one card {t1:.3f} s), max "
                          f"|draw diff| {err_d:.3e} (tol 1e-8), step size "
                          f"rel diff {err_s:.3e} (tol 1e-10)")

    # SMC: the resampler's cumulative weight sums run in another order
    # across shards, so a particle near an ancestor boundary can take the
    # other ancestor and the runs part ways; the gate is therefore the
    # statistical one of tests/test_parallel.py
    # (test_sharded_smc_matches_single_device), in float32 as users run it.
    smc_kw = dict(dim=smc_dim, num_particles=smc_particles)
    key = jax.random.PRNGKey(4)
    (pn, lwn, lzn, infn), tn = timed_call(lambda: smc_sample_sharded(
        mixture_logp, key, cmesh, **smc_kw))
    (p1, lw1, lz1, inf1), t1 = timed_call(lambda: smc_sample(
        mixture_logp, key, **smc_kw))
    ez_n, _, _ = check_smc("sharded SMC", pn, lwn, lzn, infn, smc_dim)
    ez_1, _, _ = check_smc("one-device SMC", p1, lw1, lz1, inf1, smc_dim)
    # Both ladders set their temperatures from the same weights, so their
    # lengths agree to within the few steps that rounding can shift
    # (the gate of test_sharded_smc_matches_single_device).
    err_pair = abs(float(lzn) - float(lz1))
    check(err_pair <= SMC_LOGZ_ATOL,
          f"sharded and one-device logZ differ by {err_pair:.3f}")
    check(abs(len(infn) - len(inf1)) <= SMC_LADDER_GAP,
          f"sharded ladder {len(infn)} temperatures, one device "
          f"{len(inf1)}")
    report.line("multi", f"smc_sample_sharded {smc_particles} particles x "
                f"{smc_dim}D on {n_devices} cards, {len(infn)} temperatures"
                f" (one card {len(inf1)}; wall incl. compile)",
                extra=f"wall {tn:.3f} s (one card {t1:.3f} s), logZ err "
                      f"{ez_n:.3f} (one card {ez_1:.3f}), logZ difference "
                      f"{err_pair:.3f} (tol {SMC_LOGZ_ATOL} each), ladders "
                      f"{len(infn)} / {len(inf1)} (gap tol "
                      f"{SMC_LADDER_GAP})")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--multi", action="store_true",
                        help="run only the sharded path, on four cards")
    args = parser.parse_args(argv)

    summary = device_summary()
    if summary["platform"] != "gpu":
        print(f"chip_smoke: no GPU (jax.devices()[0].platform = "
              f"{summary['platform']!r}); nothing was run", file=sys.stderr)
        return 2
    cache = enable_persistent_compilation_cache()
    card = card_info()
    print(f"card: {card}")
    print(f"device_kind: {summary['kind']}, device count: "
          f"{summary['count']}, jax {jax.__version__}, compile cache: "
          f"{cache}")
    report = Report(card)
    t0 = time.perf_counter()
    if args.multi:
        phase_multi(report)
        summary["count"] = N_MULTI
    else:
        phase_whitening(report)
        phase_coupling(report)
        phase_samplers(report)
    print(f"all phases passed in {time.perf_counter() - t0:.1f} s; "
          f"card: {card}")
    print(json.dumps({"ok": True, "device": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
