"""MCMC benchmarks: ESS/s for NUTS on the 2D example target, and raw
leapfrog+log-prob throughput.

The "2D example target" is the pushforward density of the reference's 2D
example flow (nf_example_2d.jl ground truth) — i.e. NUTS samples the
correlated, warped 2D density whose whitening transform the reference
learns, both raw and flow-preconditioned.

Run: python benchmarks/bench_mcmc.py [--chains 128]
"""
import argparse
import json
import sys
import time

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), '..'))

import jax

from enflows_tpu.utils.compilation_cache import \
    enable_persistent_compilation_cache

enable_persistent_compilation_cache()
import jax.numpy as jnp
import numpy as np

import enflows_tpu as ef
from enflows_tpu.mcmc import sample, ess_per_dim, flow_preconditioned
from enflows_tpu.mcmc.hmc import leapfrog


def example_2d_target(dtype=jnp.float32):
    v = lambda *a: jnp.asarray(a, dtype)
    flow = ef.compose(
        ef.ScaleShift(a=v(1.3, 0.4), b=v(2.5, -1.2)),
        ef.Householder(V=v(1.0, 0.3)),
        ef.CenterStretch(a=v(4.0, 4.1), b=v(2.0, 2.1), c=v(3.0, 3.1)),
    )
    dist = ef.FlowDistribution(bijector=flow)
    return lambda q: dist.logpdf(q), flow


def run_stats(run, rounds=3):
    """min/median/spread of a metric over ``rounds`` re-seeded runs —
    the reconcilable-output discipline of VERDICT r3 next #5. ``run``
    maps a seed to a scalar (e.g. min-ESS/s); run(0) must already have
    paid the compile."""
    vals = sorted(run(seed) for seed in range(1, rounds + 1))
    spread = vals[-1] / vals[0] if vals[0] > 0 else float("inf")
    if spread > 2.0:
        print(f"[bench] WARNING: metric spread {spread:.2f}x over "
              f"{rounds} runs — box noise dominating", file=sys.stderr)
    return {"n_runs": rounds, "min": round(vals[0], 1),
            "median": round(vals[len(vals) // 2], 1),
            "max": round(vals[-1], 1), "spread": round(spread, 2)}


def bench_nuts(num_chains, num_warmup=500, num_samples=1000):
    logp, flow = example_2d_target()
    logp1 = lambda q: logp(q)

    last = {}

    def run(seed):
        t0 = time.time()
        samples, _, stats = sample(logp1, jax.random.PRNGKey(seed), dim=2,
                                   num_chains=num_chains,
                                   num_warmup=num_warmup,
                                   num_samples=num_samples)
        jax.block_until_ready(samples)
        t_steady = time.time() - t0
        last.update(samples=samples, stats=stats, t=t_steady)
        return ess_per_dim(samples).min() / t_steady

    t0 = time.time()
    run(0)                       # compile
    t_total = time.time() - t0
    st = run_stats(run)

    samples, stats = last["samples"], last["stats"]
    ess = ess_per_dim(samples)
    div = int(np.sum(np.asarray(stats.divergent)))
    print(f"[nuts-raw] chains={num_chains} warm+samp {last['t']:.2f}s "
          f"(first run incl. compile {t_total:.2f}s) min-ESS {ess.min():.0f}"
          f" div {div} | min-ESS/s median {st['median']} "
          f"(spread {st['spread']}x)", file=sys.stderr)
    return st, samples.shape


def bench_preconditioned(num_chains, num_warmup=300, num_samples=1000):
    logp, flow = example_2d_target()
    target = flow_preconditioned(lambda q: logp(q), flow)

    def run(seed):
        t0 = time.time()
        s, _, stats = sample(target.logdensity_fn,
                             jax.random.PRNGKey(seed),
                             dim=2, num_chains=num_chains,
                             num_warmup=num_warmup,
                             num_samples=num_samples)
        jax.block_until_ready(s)
        t_steady = time.time() - t0
        z = target.push_forward(s)
        return ess_per_dim(np.asarray(z)).min() / t_steady

    run(0)
    st = run_stats(run)
    print(f"[nuts-precond] chains={num_chains} min-ESS/s median "
          f"{st['median']} (spread {st['spread']}x)", file=sys.stderr)
    return st


def bench_chees(num_chains, num_warmup=500, num_samples=1000):
    """ChEES-HMC on the same 2D warped target: the accelerator-native
    sampler's min-ESS/s vs NUTS (mcmc/chees.py design notes)."""
    logp, _ = example_2d_target()
    logp1 = lambda q: logp(q)

    last = {}

    def run(seed):
        t0 = time.time()
        s, _, stats = sample(logp1, jax.random.PRNGKey(seed), dim=2,
                             algorithm="chees", num_chains=num_chains,
                             num_warmup=num_warmup,
                             num_samples=num_samples)
        jax.block_until_ready(s)
        t_steady = time.time() - t0
        last.update(samples=s, stats=stats, t=t_steady)
        return ess_per_dim(s).min() / t_steady

    t0 = time.time()
    run(0)
    t_total = time.time() - t0
    st = run_stats(run)

    samples, stats = last["samples"], last["stats"]
    ess = ess_per_dim(samples)
    div = int(np.sum(np.asarray(stats.divergent)))
    grads = int(np.sum(np.asarray(stats.num_steps))) * num_chains
    print(f"[chees-raw] chains={num_chains} warm+samp {last['t']:.2f}s "
          f"(first run incl. compile {t_total:.2f}s) min-ESS {ess.min():.0f}"
          f" div {div} sampling-grad-evals {grads/1e6:.1f}M "
          f"traj {float(stats.trajectory_length):.3f} "
          f"step {float(stats.step_size):.4f} | min-ESS/s median "
          f"{st['median']} (spread {st['spread']}x)", file=sys.stderr)
    # ESS per thousand gradient evals (sampling phase): ChEES pays its
    # trajectory length on every chain with zero lockstep waste.
    ess_per_kgrad = ess.min() / (grads / 1e3)
    return st, ess_per_kgrad


def bench_lockstep_tax(num_chains=128, num_warmup=400, num_samples=600):
    """VERDICT r3 next #4: measure the vmapped-NUTS lockstep tax. All
    chains in a vmapped batch execute until the LAST chain's tree
    finishes, so per-transition cost is chains x max(leaf count) while
    useful work is each chain's own leaf count. Reported per target:

      tax                = mean over transitions of max/mean leaf count
                           (1.0 = no waste; the wasted-gradient fraction
                           is 1 - 1/tax)
      ess_per_kgrad_used = min-ESS per 1000 ALGORITHMIC gradient evals
      ess_per_kgrad_paid = min-ESS per 1000 LOCKSTEP-PAID gradient evals
      grad_rate_frac     = NUTS's paid gradient evals/s over the raw
                           vmapped-leapfrog rate on the same target and
                           chain count (the NUTS roofline row: how much
                           of the leapfrog roof the tree machinery keeps)
    """
    results = {}

    def equicorr_logp(dim, rho=0.9):
        cov = rho * jnp.ones((dim, dim)) + (1.0 - rho) * jnp.eye(dim)
        prec = jnp.linalg.inv(cov).astype(jnp.float32)
        return lambda q: -0.5 * q @ prec @ q

    logp2d, _ = example_2d_target()
    targets = {"2d_warped": (lambda q: logp2d(q), 2),
               "50d_equicorr": (equicorr_logp(50), 50)}

    for name, (logp, dim) in targets.items():
        t0 = time.time()
        s, _, st = sample(logp, jax.random.PRNGKey(3), dim=dim,
                          num_chains=num_chains, num_warmup=num_warmup,
                          num_samples=num_samples)
        jax.block_until_ready(s)
        t0 = time.time()
        s, _, st = sample(logp, jax.random.PRNGKey(4), dim=dim,
                          num_chains=num_chains, num_warmup=num_warmup,
                          num_samples=num_samples)
        jax.block_until_ready(s)
        t_steady = time.time() - t0

        ns = np.asarray(st.num_steps, np.float64)      # (samples, chains)
        used = ns.mean()
        paid = ns.max(axis=1).mean()
        tax = paid / used
        ess = float(ess_per_dim(s).min())
        grads_used = ns.sum()
        grads_paid = ns.max(axis=1).sum() * num_chains

        # Leapfrog roof on the SAME target/chains: vmapped jnp leapfrog.
        vg = jax.value_and_grad(lambda q1: logp(q1))
        L = 64
        q = 0.3 * jax.random.normal(jax.random.PRNGKey(5),
                                    (num_chains, dim), jnp.float32)
        p = jax.random.normal(jax.random.PRNGKey(6),
                              (num_chains, dim), jnp.float32)
        g = jax.vmap(lambda qq: vg(qq)[1])(q)
        im = jnp.ones(dim, jnp.float32)

        @jax.jit
        def lf(q, p, g):
            return jax.vmap(lambda a, b, c: leapfrog(vg, a, b, c, 0.05,
                                                     im, L))(q, p, g)

        jax.block_until_ready(lf(q, p, g))
        t0 = time.perf_counter()
        for _ in range(10):
            out = lf(q, p, g)
        jax.block_until_ready(out)
        lf_rate = num_chains * L / ((time.perf_counter() - t0) / 10)

        # The sampling phase is num_samples transitions of the total
        # (warmup compiled into the same program); attribute wall time
        # proportionally to transition counts for the rate estimate.
        frac_sampling = num_samples / (num_samples + num_warmup)
        grad_rate = grads_paid / (t_steady * frac_sampling)
        results[name] = {
            "lockstep_tax": round(tax, 2),
            "wasted_grad_frac": round(1.0 - 1.0 / tax, 3),
            "ess_per_kgrad_used": round(ess / (grads_used / 1e3), 3),
            "ess_per_kgrad_paid": round(ess / (grads_paid / 1e3), 3),
            "grad_rate_frac_of_leapfrog": round(grad_rate / lf_rate, 3),
        }
        print(f"[nuts-lockstep] {name}: tax {tax:.2f}x (waste "
              f"{100*(1-1/tax):.0f}%), ESS/kgrad used "
              f"{results[name]['ess_per_kgrad_used']} / paid "
              f"{results[name]['ess_per_kgrad_paid']}, NUTS grad rate = "
              f"{100*grad_rate/lf_rate:.0f}% of the {lf_rate/1e6:.0f}M/s "
              f"leapfrog rate", file=sys.stderr)
    return results


def bench_leapfrog(num_chains=8192, dim=50, num_steps=64, iters=20):
    """Raw per-device leapfrog+log-prob throughput on a 50D Gaussian."""
    prec = jnp.eye(dim, dtype=jnp.float32)

    def logp(q):
        return -0.5 * q @ prec @ q

    vg = jax.value_and_grad(logp)
    q = jax.random.normal(jax.random.PRNGKey(0), (num_chains, dim))
    p = jax.random.normal(jax.random.PRNGKey(1), (num_chains, dim))
    g = jax.vmap(jax.grad(logp))(q)
    inv_mass = jnp.ones(dim)

    @jax.jit
    def run(q, p, g):
        return jax.vmap(
            lambda q, p, g: leapfrog(vg, q, p, g, 0.1, inv_mass,
                                     num_steps))(q, p, g)

    out = run(q, p, g)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(q, p, g)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    steps_per_s = num_chains * num_steps / dt
    print(f"[leapfrog] {num_chains} chains x {num_steps} steps x {dim}D: "
          f"{dt*1e3:.2f} ms -> {steps_per_s/1e6:.1f}M leapfrog-steps/s",
          file=sys.stderr)
    return steps_per_s


def bench_flow_leapfrog(num_chains=8192, dim=50, num_steps=64, iters=20):
    """Leapfrog+logprob throughput of the plain path on a flow-pushforward
    log density (Johnson, center-contract and a Householder rotation at
    d=50): the rate a fused trajectory kernel would have to beat."""
    v = lambda val: jnp.full((dim,), val, jnp.float32)
    chain = ef.compose(
        ef.Johnson(gamma=v(0.0), delta=v(5.0), xi=v(0.0), lam=v(5.0)),
        ef.invert(ef.CenterStretch(a=v(0.0), b=v(1.0), c=v(0.0))),
        ef.Householder(V=jax.random.normal(jax.random.PRNGKey(0),
                                           (4, dim))).canonicalize(),
    )
    _LOG_2PI = 1.8378770664093453

    def logp(q):
        y, ladj = chain.forward_and_ladj(q)
        return jnp.sum(-(y * y + _LOG_2PI) * 0.5, -1) + ladj

    vg = jax.value_and_grad(lambda q1: logp(q1[None, :])[0])
    q = 0.3 * jax.random.normal(jax.random.PRNGKey(1), (num_chains, dim))
    p = jax.random.normal(jax.random.PRNGKey(2), (num_chains, dim))
    g = jax.vmap(lambda qq: vg(qq)[1])(q)
    inv_mass = jnp.ones(dim)

    @jax.jit
    def run(q, p, g):
        return jax.vmap(
            lambda q, p, g: leapfrog(vg, q, p, g, 0.05, inv_mass,
                                     num_steps))(q, p, g)

    out = run(q, p, g)
    jax.block_until_ready(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = run(q, p, g)
    jax.block_until_ready(out)
    dt = (time.perf_counter() - t0) / iters
    sps = num_chains * num_steps / dt
    print(f"[flow-leapfrog] {num_chains} x {num_steps} x {dim}D flow "
          f"chain: {dt*1e3:.2f} ms ({sps/1e6:.1f}M steps/s)",
          file=sys.stderr)
    return sps


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--chains", type=int, default=128)
    args = ap.parse_args()

    st_raw, _ = bench_nuts(args.chains)
    st_chees, chees_epk = bench_chees(args.chains)
    st_pre = bench_preconditioned(args.chains)
    lockstep = bench_lockstep_tax(args.chains)
    lf = bench_leapfrog()
    lf_flow = bench_flow_leapfrog()
    # Decompose the ChEES-vs-NUTS ESS/s headline (VERDICT r3 weak #4):
    # algorithm (ESS per algorithmic gradient) x lockstep (NUTS's paid/
    # used gradient factor) x rate. chees has zero lockstep waste (every
    # chain integrates the same shared trajectory length).
    nuts_epk_used = lockstep["2d_warped"]["ess_per_kgrad_used"]
    nuts_epk_paid = lockstep["2d_warped"]["ess_per_kgrad_paid"]
    print(json.dumps({
        "nuts_raw_min_ess_per_s": st_raw,
        "chees_raw_min_ess_per_s": st_chees,
        "nuts_precond_min_ess_per_s": st_pre,
        "nuts_lockstep": lockstep,
        "chees_ess_per_kgrad": round(chees_epk, 3),
        "chees_vs_nuts_ess_per_s": round(
            st_chees["median"] / st_raw["median"], 1),
        "chees_vs_nuts_ess_per_grad_algorithmic": round(
            chees_epk / nuts_epk_used, 2) if nuts_epk_used else None,
        "chees_vs_nuts_ess_per_grad_paid": round(
            chees_epk / nuts_epk_paid, 2) if nuts_epk_paid else None,
        "leapfrog_steps_per_s": round(lf),
        "flow_leapfrog_steps_per_s": round(lf_flow),
    }))


if __name__ == "__main__":
    main()
