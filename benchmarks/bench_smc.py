"""SMC benchmark: particles/s and temperatures-to-convergence, with and
without learned annealing transports.

Target: 100D bimodal mixture (the BASELINE.json "100D multimodal mixture"
config) and a 2D anisotropic Gaussian with analytic log Z for a
correctness-gated timing.

Run: python benchmarks/bench_smc.py
"""
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

from enflows_tpu.smc import smc_sample, make_transport_fitter
from enflows_tpu.distributions import std_normal_logpdf_sum


def bench_2d(num_particles=65536):
    mu = jnp.asarray([3.0, -2.0], jnp.float32)

    def log_target(q):
        d = q - mu
        return -0.5 * jnp.sum(d * d) / 0.25

    true_logz = np.log(2 * np.pi * 0.25)
    # warm compile (identical shapes/max_temps: the in-graph ladder jit is
    # keyed on max_temps, so the warm call must match the timed one)
    smc_sample(log_target, jax.random.PRNGKey(9), dim=2,
               num_particles=num_particles)

    def run(seed):
        # Best-of-2 per seed: the 2D run is short, so a single wall
        # sample folds in host dispatch stalls.
        best_dt, ln, err = float("inf"), 0, 0.0
        for _ in range(2):
            t0 = time.time()
            parts, lw, logz, infos = smc_sample(
                log_target, jax.random.PRNGKey(seed), dim=2,
                num_particles=num_particles)
            jax.block_until_ready(parts)
            dt = time.time() - t0
            e = abs(float(logz) - true_logz)
            assert e < 0.2, "correctness gate failed"
            if dt < best_dt:
                best_dt, ln, err = dt, len(infos), e
        return num_particles * ln / best_dt, ln, err

    vals = sorted(run(seed) for seed in range(9))
    med = vals[len(vals) // 2]
    spread = vals[-1][0] / vals[0][0] if vals[0][0] > 0 else float("inf")
    print(f"[smc-2d] {num_particles} particles, {med[1]} temps, "
          f"median {med[0]/1e6:.2f}M particle-temps/s "
          f"(spread {spread:.2f}x over 9 seeds), logZ err {med[2]:.3f}",
          file=sys.stderr)
    return {"n_runs": len(vals), "min": round(vals[0][0]),
            "median": round(med[0]), "max": round(vals[-1][0]),
            "spread": round(spread, 2)}


def bench_ladder_modes(num_particles=65536):
    """In-graph `lax.while_loop` ladder vs per-temperature Python loop on
    the 2D config: the Python ladder pays a dispatch per jitted call (2
    calls + 6 float() syncs per temperature); the one-jit ladder pays one
    dispatch for the whole run."""
    mu = jnp.asarray([3.0, -2.0], jnp.float32)

    def log_target(q):
        d = q - mu
        return -0.5 * jnp.sum(d * d) / 0.25

    times = {}
    for mode in (True, False):
        smc_sample(log_target, jax.random.PRNGKey(9), dim=2,
                   num_particles=num_particles, max_temps=3,
                   in_graph=mode)   # warm compile
        best = float("inf")
        for _ in range(3):
            t0 = time.time()
            parts, _, _, infos = smc_sample(
                log_target, jax.random.PRNGKey(0), dim=2,
                num_particles=num_particles, in_graph=mode)
            jax.block_until_ready(parts)
            best = min(best, time.time() - t0)
        times[mode] = (best, len(infos))
    (t_in, n_t), (t_host, _) = times[True], times[False]
    print(f"[smc-ladder] {n_t} temps: in-graph {t_in*1e3:.1f} ms | "
          f"host-loop {t_host*1e3:.1f} ms | saving "
          f"{(t_host-t_in)*1e3:.1f} ms/ladder "
          f"({(t_host-t_in)/max(n_t,1)*1e3:.2f} ms/temperature)",
          file=sys.stderr)
    return t_host - t_in


def bench_100d(num_particles=32768):
    dim = 100

    def log_target(q):
        a = -0.5 * jnp.sum((q - 1.5) ** 2) + jnp.log(0.5)
        b = -0.5 * jnp.sum((q + 1.5) ** 2) + jnp.log(0.5)
        return jnp.logaddexp(a, b)

    true_logz = dim * 0.5 * np.log(2 * np.pi)
    smc_sample(log_target, jax.random.PRNGKey(9), dim=dim,
               num_particles=num_particles, mutation_steps=8)  # warm

    def run(seed):
        # Best-of-2 wall per seed (same rationale as bench_2d).
        best = None
        for _ in range(2):
            t0 = time.time()
            parts, lw, logz, infos = smc_sample(
                log_target, jax.random.PRNGKey(seed), dim=dim,
                num_particles=num_particles, mutation_steps=8)
            jax.block_until_ready(parts)
            dt = time.time() - t0
            w = np.asarray(jax.nn.softmax(lw))
            frac = float((w * (np.asarray(parts)[:, 0] > 0)).sum())
            err = abs(float(logz) - true_logz)
            rate = num_particles * len(infos) / dt
            if best is None or rate > best[0]:
                best = (rate, frac, err)
        return best

    vals = sorted(run(seed) for seed in range(5))
    med = vals[len(vals) // 2]
    spread = vals[-1][0] / vals[0][0] if vals[0][0] > 0 else float("inf")
    print(f"[smc-100d] {num_particles} particles: median "
          f"{med[0]/1e6:.2f}M particle-temps/s (spread {spread:.2f}x "
          f"over 5 seeds), mode frac {med[1]:.3f}, logZ err {med[2]:.2f}",
          file=sys.stderr)
    return {"n_runs": len(vals), "min": round(vals[0][0]),
            "median": round(med[0]), "max": round(vals[-1][0]),
            "spread": round(spread, 2)}


def bench_transport(num_particles=65536):
    mu = jnp.asarray([3.0, -2.0], jnp.float32)

    def log_target(q):
        d = q - mu
        return -0.5 * jnp.sum(d * d) / 0.25

    fit = make_transport_fitter(lambda q: std_normal_logpdf_sum(q),
                                log_target, nsteps=60)
    smc_sample(log_target, jax.random.PRNGKey(9), dim=2,
               num_particles=num_particles, fit_transport=fit)  # warm
    t0 = time.time()
    parts, lw, logz, infos = smc_sample(
        log_target, jax.random.PRNGKey(0), dim=2,
        num_particles=num_particles, fit_transport=fit)
    jax.block_until_ready(parts)
    dt = time.time() - t0
    print(f"[smc-transport] {len(infos)} temps in {dt:.2f}s, "
          f"logZ {float(logz):.3f}", file=sys.stderr)
    return len(infos)


def main():
    pps_2d = bench_2d()
    ladder_saving = bench_ladder_modes()
    pps_100d = bench_100d()
    temps_t = bench_transport()
    print(json.dumps({
        "smc_2d_particle_temps_per_s": pps_2d,
        "smc_100d_particle_temps_per_s": pps_100d,
        "smc_transport_temps": temps_t,
        "smc_ladder_in_graph_saving_ms": round(ladder_saving * 1e3, 1),
    }))


if __name__ == "__main__":
    main()
