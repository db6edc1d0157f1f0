"""SMC tests: tempering, resampling, normalizing constants, transports.

Validates the M3 milestone (SURVEY.md §7): adaptive temperature schedule,
systematic resampler statistics, log-Z estimates against analytic values,
multimodal mass balance (BASELINE.json 100D-mixture config at reduced CI
scale), and that learned flow transports keep the weights even.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from enflows_tpu.smc import (
    smc_sample, systematic_resample, log_ess, make_transport_fitter,
)
from enflows_tpu.distributions import std_normal_logpdf_sum

DT = jnp.float64


def test_systematic_resample_statistics():
    key = jax.random.PRNGKey(0)
    n = 10000
    particles = jnp.arange(n, dtype=DT)[:, None]
    logw = jnp.log(jnp.asarray(
        np.concatenate([np.full(n // 2, 3.0), np.full(n // 2, 1.0)])))
    out = systematic_resample(key, logw, particles)
    # 3:1 weights -> 75% of offspring from the first half.
    frac = float(jnp.mean(out[:, 0] < n // 2))
    assert abs(frac - 0.75) < 0.01
    # Systematic resampling: offspring counts within +-1 of expectation.
    idx, counts = np.unique(np.asarray(out[:, 0]), return_counts=True)
    assert counts.max() <= 3  # E[count] = 1.5 for heavy half


def test_log_ess():
    lw = jnp.zeros(100, DT)
    np.testing.assert_allclose(float(jnp.exp(log_ess(lw))), 100.0,
                               rtol=1e-10)
    lw2 = jnp.asarray([0.0] + [-jnp.inf] * 99, DT)
    np.testing.assert_allclose(float(jnp.exp(log_ess(lw2))), 1.0,
                               rtol=1e-10)


def test_smc_gaussian_logz_and_moments():
    mu = jnp.asarray([3.0, -2.0], DT)
    s = 0.5

    def log_target(q):
        d = q - mu
        return -0.5 * jnp.sum(d * d) / s**2

    true_logz = 2 * 0.5 * np.log(2 * np.pi * s**2)
    parts, lw, logz, infos = smc_sample(
        log_target, jax.random.PRNGKey(0), dim=2, num_particles=4096,
        dtype=DT)
    assert float(infos[-1].beta) == 1.0
    assert len(infos) < 30
    w = np.asarray(jax.nn.softmax(lw))
    p = np.asarray(parts)
    m = (w[:, None] * p).sum(0)
    np.testing.assert_allclose(m, np.asarray(mu), atol=0.08)
    var = (w[:, None] * (p - m) ** 2).sum(0)
    np.testing.assert_allclose(var, s**2, rtol=0.2)
    assert abs(float(logz) - true_logz) < 0.15


def test_smc_multimodal_mass_balance():
    # Two well-separated modes with 70/30 mass: tempering + resampling must
    # preserve the balance (a plain MCMC chain cannot cross).
    def log_target(q):
        a = -0.5 * jnp.sum((q - 4.0) ** 2) / 0.25 + jnp.log(0.7)
        b = -0.5 * jnp.sum((q + 4.0) ** 2) / 0.25 + jnp.log(0.3)
        return jnp.logaddexp(a, b)

    parts, lw, logz, infos = smc_sample(
        log_target, jax.random.PRNGKey(1), dim=2, num_particles=8192,
        dtype=DT)
    w = np.asarray(jax.nn.softmax(lw))
    frac = float((w * (np.asarray(parts)[:, 0] > 0)).sum())
    assert abs(frac - 0.7) < 0.06, frac
    assert abs(float(logz) - np.log(2 * np.pi * 0.25)) < 0.2


def test_learned_transport_reduces_temperatures():
    """The tempering bisection reads the untransported weights, so the
    transport takes no more temperatures than the plain ladder; what it
    buys is even weights (no resampling) and a sharper log Z."""
    mu = jnp.asarray([3.0, -2.0], DT)
    s = 0.5

    def log_target(q):
        d = q - mu
        return -0.5 * jnp.sum(d * d) / s**2

    base = lambda q: std_normal_logpdf_sum(q)
    fit = make_transport_fitter(base, log_target, nsteps=80)
    p1, lw1, lz1, inf1 = smc_sample(log_target, jax.random.PRNGKey(0),
                                    dim=2, num_particles=4096, dtype=DT)
    p2, lw2, lz2, inf2 = smc_sample(log_target, jax.random.PRNGKey(0),
                                    dim=2, num_particles=4096,
                                    fit_transport=fit, dtype=DT)
    assert len(inf2) <= len(inf1)
    n = 4096
    assert min(float(i.ess) for i in inf1[:-1]) < 0.51 * n
    assert min(float(i.ess) for i in inf2) > 0.9 * n
    assert not any(bool(i.resampled) for i in inf2)
    true_logz = np.log(2 * np.pi * s**2)
    # Transport-corrected logZ is the sharper estimate.
    assert abs(float(lz2) - true_logz) < 0.1
    w2 = np.asarray(jax.nn.softmax(lw2))
    m2 = (w2[:, None] * np.asarray(p2)).sum(0)
    np.testing.assert_allclose(m2, np.asarray(mu), atol=0.05)


def test_smc_higher_dim_mixture():
    # Reduced-scale version of the BASELINE.json 100D multimodal config:
    # 16D, two modes.
    dim = 16

    def log_target(q):
        a = -0.5 * jnp.sum((q - 2.0) ** 2) + jnp.log(0.5)
        b = -0.5 * jnp.sum((q + 2.0) ** 2) + jnp.log(0.5)
        return jnp.logaddexp(a, b)

    parts, lw, logz, infos = smc_sample(
        log_target, jax.random.PRNGKey(2), dim=dim, num_particles=8192,
        mutation_steps=8, dtype=DT)
    w = np.asarray(jax.nn.softmax(lw))
    frac = float((w * (np.asarray(parts)[:, 0] > 0)).sum())
    assert 0.25 < frac < 0.75, frac  # both modes retain mass
    true_logz = dim * 0.5 * np.log(2 * np.pi)
    assert abs(float(logz) - true_logz) < 0.8


def test_smc_anisotropic_mass_adaptation():
    # 400:1 scale ratios: ensemble mass matrix must keep mutations mixing
    # (marginal stds within a few % and acceptance near target).
    scales = jnp.asarray([0.05, 0.1, 1.0, 5.0, 20.0], DT)

    def log_target(q):
        return -0.5 * jnp.sum((q / scales) ** 2)

    parts, lw, logz, infos = smc_sample(
        log_target, jax.random.PRNGKey(5), dim=5, num_particles=8192,
        mutation_steps=6, dtype=DT)
    w = np.asarray(jax.nn.softmax(lw))
    p = np.asarray(parts)
    m = (w[:, None] * p).sum(0)
    v = (w[:, None] * (p - m) ** 2).sum(0)
    np.testing.assert_allclose(np.sqrt(v), np.asarray(scales), rtol=0.1)
    true_logz = float(jnp.sum(jnp.log(scales)) + 5 * 0.5 * np.log(2 * np.pi))
    assert abs(float(logz) - true_logz) < 0.2
    # Acceptance settled near the 0.65 target after the first few temps.
    accs = [float(i.accept_prob) for i in infos[3:]]
    assert all(0.5 < a < 0.85 for a in accs), accs


def test_build_smc_kernels_explicit_reuse():
    """Explicit kernel builder: fresh-closure targets reuse ONE compiled
    kernel set across smc_sample calls (VERDICT r1 weak #6)."""
    from enflows_tpu.smc import build_smc_kernels

    def fresh_target():           # new closure identity each call
        return lambda q: -0.5 * jnp.sum((q - 1.0) ** 2)

    kern = build_smc_kernels(std_normal_logpdf_sum, fresh_target())
    results = []
    for seed in range(2):
        # log_base/log_target args are still passed for the base sampler /
        # transport paths but the jitted kernels come from `kern`.
        parts, lw, logz, infos = smc_sample(
            fresh_target(), jax.random.PRNGKey(seed), dim=2,
            num_particles=2048, kernels=kern, dtype=DT)
        results.append(float(logz))
    # Correct evidence: target is an unnormalized N(1, I) in 2D.
    true_logz = 2 * 0.5 * np.log(2 * np.pi)
    for lz in results:
        assert abs(lz - true_logz) < 0.1


def test_in_graph_ladder_matches_host_loop():
    """VERDICT r2 #5: the one-jit `lax.while_loop` ladder must follow the
    Python ladder's exact same-key trajectory (identical key stream and
    math; f64 keeps fusion-order noise below tolerance)."""

    def log_target(q):
        d = q - jnp.asarray([1.0, -2.0], DT)
        return -0.5 * jnp.sum(d * d) / 0.25

    outs = {}
    for mode in (True, False):
        parts, lw, logz, infos = smc_sample(
            log_target, jax.random.PRNGKey(7), dim=2,
            num_particles=2048, in_graph=mode, dtype=DT)
        outs[mode] = (parts, lw, logz, infos)
    p1, lw1, lz1, inf1 = outs[True]
    p2, lw2, lz2, inf2 = outs[False]
    assert len(inf1) == len(inf2)
    np.testing.assert_allclose([float(i.beta) for i in inf1],
                               [float(i.beta) for i in inf2], rtol=1e-12)
    np.testing.assert_allclose(float(lz1), float(lz2), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-9)
    np.testing.assert_allclose(np.asarray(lw1), np.asarray(lw2),
                               atol=1e-9)


def test_in_graph_ladder_with_transport_matches_host_loop():
    from enflows_tpu.smc import make_transport_fitter

    def log_target(q):
        d = q - jnp.asarray([2.0, -1.0], DT)
        return -0.5 * jnp.sum(d * d) / 0.5

    fit = make_transport_fitter(std_normal_logpdf_sum, log_target,
                                nsteps=40)
    outs = {}
    for mode in (True, False):
        parts, lw, logz, infos = smc_sample(
            log_target, jax.random.PRNGKey(9), dim=2,
            num_particles=2048, fit_transport=fit, in_graph=mode,
            dtype=DT)
        outs[mode] = (parts, lw, logz, infos)
    p1, _, lz1, inf1 = outs[True]
    p2, _, lz2, inf2 = outs[False]
    assert len(inf1) == len(inf2)
    np.testing.assert_allclose(float(lz1), float(lz2), rtol=1e-10)
    np.testing.assert_allclose(np.asarray(p1), np.asarray(p2), atol=1e-9)


def _mixture_100d(q):
    a = -0.5 * jnp.sum((q - 1.5) ** 2) + jnp.log(0.5)
    b = -0.5 * jnp.sum((q + 1.5) ** 2) + jnp.log(0.5)
    return jnp.logaddexp(a, b)


@pytest.mark.parametrize("path,in_graph", [("one_device", True),
                                           ("one_device", False),
                                           ("sharded", True)])
def test_ladder_advances_and_resamples_every_step(path, in_graph):
    """float32, 8,192 particles, the 100-D two-mode mixture: every
    temperature moves beta forward and every intermediate one resamples.
    A resample trigger with less slack than float32 rounding skips the
    resample, and the next bisection cannot move beta (repeated betas, a
    ladder that grows with the particle count)."""
    kw = dict(dim=100, num_particles=8192, in_graph=in_graph,
              dtype=jnp.float32)
    if path == "sharded":
        from enflows_tpu.parallel import make_mesh, smc_sample_sharded
        mesh = make_mesh({"chains": 4}, devices=jax.devices()[:4])
        _, _, logz, infos = smc_sample_sharded(
            _mixture_100d, jax.random.PRNGKey(0), mesh, **kw)
    else:
        _, _, logz, infos = smc_sample(_mixture_100d, jax.random.PRNGKey(0),
                                       **kw)
    betas = np.asarray([float(i.beta) for i in infos])
    assert betas[-1] == 1.0
    assert np.all(np.diff(betas) > 0), betas
    assert all(bool(i.resampled) for i in infos[:-1])
    assert len(infos) < 30
    assert abs(float(logz) - 50 * np.log(2 * np.pi)) < 1.0


def test_ladder_cut_by_max_temps_warns():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        smc_sample(_mixture_100d, jax.random.PRNGKey(0), dim=100,
                   num_particles=256, max_temps=2, dtype=jnp.float32)
    assert any("not posterior draws" in str(w.message) for w in caught)
