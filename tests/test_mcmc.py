"""MCMC subsystem tests: HMC/NUTS correctness, adaptation, diagnostics.

Validates the M2 milestone (SURVEY.md §7): posterior moments on Gaussian
targets, flow-preconditioned sampling of Neal's funnel and of the 2D example
target (BASELINE.json configs), warmup schedule vs Stan's shape, Welford
vs numpy moments, ESS calibration on AR(1) chains with known autocorrelation.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from enflows_tpu import CenterStretch, Johnson, ScaleShift, compose, invert
from enflows_tpu.mcmc import (
    sample, hmc_kernel, nuts_kernel, init_state, flow_preconditioned,
    ess, split_rhat, ess_per_dim, split_rhat_per_dim,
    welford_init, welford_update, welford_update_batch, welford_variance,
    build_schedule, da_init, da_update,
)

DT = jnp.float64


def _gauss_logp(mu, cov):
    prec = jnp.linalg.inv(cov)

    def logp(q):
        d = q - mu
        return -0.5 * d @ prec @ d

    return logp


def test_nuts_gaussian_moments():
    mu = jnp.asarray([1.0, -2.0], DT)
    cov = jnp.asarray([[2.0, 1.2], [1.2, 1.0]], DT)
    samples, _, stats = sample(_gauss_logp(mu, cov), jax.random.PRNGKey(0),
                               dim=2, num_chains=8, num_warmup=500,
                               num_samples=1000, dtype=DT)
    s = np.asarray(samples).reshape(-1, 2)
    np.testing.assert_allclose(s.mean(0), np.asarray(mu), atol=0.12)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(cov), atol=0.2)
    assert np.sum(np.asarray(stats.divergent)) == 0
    acc = float(np.mean(np.asarray(stats.accept_prob)))
    assert 0.6 < acc <= 1.0
    assert np.all(split_rhat_per_dim(samples) < 1.02)
    assert np.all(ess_per_dim(samples) > 500)


def test_hmc_gaussian_moments():
    mu = jnp.asarray([0.5, 0.0, -0.5], DT)
    cov = jnp.diag(jnp.asarray([0.5, 1.0, 2.0], DT))
    samples, _, stats = sample(_gauss_logp(mu, cov), jax.random.PRNGKey(1),
                               dim=3, num_chains=8, num_warmup=400,
                               num_samples=800, algorithm="hmc",
                               num_steps=16, dtype=DT)
    s = np.asarray(samples).reshape(-1, 3)
    np.testing.assert_allclose(s.mean(0), np.asarray(mu), atol=0.12)
    np.testing.assert_allclose(s.var(0), np.diag(cov), rtol=0.25)


def test_nuts_50d_correlated_gaussian():
    # BASELINE.json config: 50D correlated Gaussian.
    dim = 50
    rho = 0.7
    idx = np.arange(dim)
    cov_np = rho ** np.abs(idx[:, None] - idx[None, :])
    cov = jnp.asarray(cov_np, DT)
    samples, _, stats = sample(_gauss_logp(jnp.zeros(dim, DT), cov),
                               jax.random.PRNGKey(2), dim=dim,
                               num_chains=8, num_warmup=600,
                               num_samples=600, dtype=DT)
    s = np.asarray(samples).reshape(-1, dim)
    assert np.abs(s.mean(0)).max() < 0.25
    np.testing.assert_allclose(s.var(0), np.ones(dim), rtol=0.35)
    # off-diagonal structure captured
    emp = np.corrcoef(s.T)
    assert abs(emp[0, 1] - rho) < 0.15
    assert np.all(split_rhat_per_dim(samples) < 1.05)


def test_funnel_flow_preconditioned():
    """Neal's funnel (BASELINE.json config): raw NUTS struggles; an exact
    reparameterizing flow makes it iid-normal. Checks the preconditioning
    plumbing: logp_white == standard normal up to a constant, and posterior
    moments of the pushed-forward samples match the funnel."""
    dim = 5

    def funnel_logp(q):
        # q[0] = v ~ N(0,9); q[1:] | v ~ N(0, exp(v))
        v = q[0]
        lp_v = -0.5 * (v * v / 9.0)
        lp_x = -0.5 * (jnp.sum(q[1:] ** 2) * jnp.exp(-v)
                       + (dim - 1) * v)
        return lp_v + lp_x

    # Exact whitening-inverse flow: v = 3*xi0; x_i = exp(v/2) * xi_i.
    # Built from library bijectors: per-dim affine then v-dependent scaling
    # is not elementwise, so use a custom bijector-free preconditioner here
    # via the functional API.
    def flow_fwd_and_ladj(xi):
        v = 3.0 * xi[..., :1]
        x = jnp.exp(v / 2.0) * xi[..., 1:]
        y = jnp.concatenate([v, x], axis=-1)
        ladj = (jnp.log(3.0)
                + (dim - 1) * v[..., 0] / 2.0)
        return y, ladj

    class ExactFunnelFlow:
        def forward_and_ladj(self, xi):
            return flow_fwd_and_ladj(xi)

        def forward(self, xi):
            return flow_fwd_and_ladj(xi)[0]

    target = flow_preconditioned(funnel_logp, ExactFunnelFlow())
    # Whitened target should be exactly N(0, I) + const.
    xi = jax.random.normal(jax.random.PRNGKey(3), (100, dim), DT)
    lps = jax.vmap(target.logdensity_fn)(xi)
    ref = -0.5 * jnp.sum(xi * xi, axis=-1)
    np.testing.assert_allclose(np.asarray(lps - ref),
                               np.full(100, float(lps[0] - ref[0])),
                               atol=1e-8)

    samples, _, stats = sample(target.logdensity_fn, jax.random.PRNGKey(4),
                               dim=dim, num_chains=8, num_warmup=400,
                               num_samples=800, dtype=DT)
    z = np.asarray(target.push_forward(samples)).reshape(-1, dim)
    # Funnel moments: v ~ N(0,9); E[x]=0, Var[x_i] = E[exp(v)] = e^{4.5}.
    assert abs(z[:, 0].mean()) < 0.3
    np.testing.assert_allclose(z[:, 0].var(), 9.0, rtol=0.2)
    assert np.sum(np.asarray(stats.divergent)) == 0


def test_nuts_kernel_invariance():
    """The sharpest correctness check: chains started at *exact* target
    draws must keep the target distribution under repeated fixed-parameter
    NUTS transitions (stationarity <=> unbiased kernel)."""
    cov = jnp.asarray([[2.0, 1.2], [1.2, 1.0]], DT)
    prec = jnp.linalg.inv(cov)

    def logp(q):
        return -0.5 * q @ prec @ q

    kern = nuts_kernel(logp, max_depth=8)
    N = 8192
    L = np.linalg.cholesky(np.asarray(cov))
    q0 = jax.random.normal(jax.random.PRNGKey(0), (N, 2), DT) \
        @ jnp.asarray(L.T)
    states = jax.vmap(lambda q: init_state(logp, q))(q0)
    vk = jax.jit(jax.vmap(kern, in_axes=(0, 0, None, None)))
    key = jax.random.PRNGKey(42)
    for step_size in [0.3, 0.9]:
        st = states
        for t in range(5):
            keys = jax.random.split(jax.random.fold_in(key, t), N)
            st, _ = vk(keys, st, jnp.asarray(step_size, DT),
                       jnp.ones(2, DT))
        s = np.asarray(st.q)
        # sd of cov entries ~ 2*sqrt(2/N) ≈ 0.03; allow 4 sigma.
        np.testing.assert_allclose(s.mean(0), np.zeros(2), atol=0.08)
        np.testing.assert_allclose(np.cov(s.T), np.asarray(cov), atol=0.13)


def test_nuts_energy_is_total_hamiltonian():
    """NUTSInfo.energy must be -logp + kinetic at the accepted leaf:
    strictly above the potential alone (kinetic > 0 a.s.) and, for a
    well-tuned kernel on a Gaussian, BFMI near 1."""
    from enflows_tpu.mcmc import bfmi

    def logp(q):
        return -0.5 * jnp.sum(q * q)

    kern = nuts_kernel(logp, max_depth=6)
    N, T = 256, 40
    q0 = jax.random.normal(jax.random.PRNGKey(1), (N, 2), DT)
    st = jax.vmap(lambda q: init_state(logp, q))(q0)
    vk = jax.jit(jax.vmap(kern, in_axes=(0, 0, None, None)))
    energies = []
    for t in range(T):
        keys = jax.random.split(jax.random.fold_in(jax.random.PRNGKey(2), t),
                                N)
        st, info = vk(keys, st, jnp.asarray(0.5, DT), jnp.ones(2, DT))
        assert np.all(np.asarray(info.energy) > -np.asarray(st.logp))
        energies.append(np.asarray(info.energy))
    e = np.stack(energies, axis=1)               # (chains, steps)
    b = bfmi(e)
    assert 0.7 < b < 1.4, b


def test_welford_matches_numpy():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(64, 3)) * np.array([1.0, 2.0, 0.5]) + 1.0
    st = welford_init(3, jnp.float64)
    for x in X[:10]:
        st = welford_update(st, jnp.asarray(x))
    st = welford_update_batch(st, jnp.asarray(X[10:]))
    np.testing.assert_allclose(np.asarray(st.mean), X.mean(0), rtol=1e-10)
    var = welford_variance(st, regularize=False)
    np.testing.assert_allclose(np.asarray(var), X.var(0, ddof=1),
                               rtol=1e-10)


def test_schedule_stan_shape():
    in_slow, wend = build_schedule(1000)
    # Stan: 75 init fast, slow windows 25/50/100/..., 50 terminal fast.
    assert not in_slow[:75].any()
    assert in_slow[75:950].all()
    assert not in_slow[950:].any()
    ends = np.nonzero(wend)[0]
    np.testing.assert_array_equal(ends, [99, 149, 249, 449, 949])
    # short warmup still well-formed
    in_slow2, wend2 = build_schedule(120)
    assert in_slow2.sum() > 0 and wend2.sum() >= 1


def test_dual_averaging_targets_accept_rate():
    # Feeding accept = sigmoid(log_step diff) drives step toward target.
    da = da_init(1.0, jnp.float64)
    opt_log_step = np.log(0.3)
    for _ in range(200):
        # toy response: acceptance falls as step exceeds optimum
        acc = 1.0 / (1.0 + np.exp(2.0 * (float(da.log_step)
                                         - opt_log_step)))
        da = da_update(da, jnp.asarray(acc))
    final_acc = 1.0 / (1.0 + np.exp(2.0 * (float(da.log_step_avg)
                                           - opt_log_step)))
    assert abs(final_acc - 0.8) < 0.05


def test_ess_calibration_ar1():
    # AR(1) with coefficient phi has tau = (1+phi)/(1-phi).
    rng = np.random.default_rng(1)
    phi = 0.7
    n, chains = 20000, 4
    x = np.zeros((chains, n))
    innov = rng.normal(size=(chains, n)) * np.sqrt(1 - phi**2)
    for t in range(1, n):
        x[:, t] = phi * x[:, t - 1] + innov[:, t]
    tau_true = (1 + phi) / (1 - phi)
    e = ess(x)
    np.testing.assert_allclose(e, chains * n / tau_true, rtol=0.15)
    # iid chains: ESS ≈ total draws
    y = rng.normal(size=(chains, 5000))
    np.testing.assert_allclose(ess(y), chains * 5000, rtol=0.15)
    assert split_rhat(y) < 1.01
    # diverged chains flagged
    z = rng.normal(size=(4, 1000)) + np.array([[0.], [0.], [0.], [5.]])
    assert split_rhat(z) > 1.5


def test_rank_normalized_diagnostics():
    from enflows_tpu.mcmc import rank_normalized_rhat, bulk_ess, tail_ess

    rng = np.random.default_rng(3)
    # Well-mixed iid chains: rhat ~ 1, bulk/tail ESS ~ total draws.
    y = rng.normal(size=(4, 4000))
    assert rank_normalized_rhat(y) < 1.01
    np.testing.assert_allclose(bulk_ess(y), 16000, rtol=0.15)
    np.testing.assert_allclose(tail_ess(y), 16000, rtol=0.25)
    # Location mismatch: flagged (bulk term).
    z = y + np.array([[0.], [0.], [0.], [5.]])
    assert rank_normalized_rhat(z) > 1.5
    # Scale mismatch with identical means: classic split-rhat barely
    # reacts, the FOLDED rank-normalized term catches it (Vehtari 2021
    # fig. 2 failure mode).
    w = y * np.array([[1.], [1.], [1.], [6.]])
    assert split_rhat(w) < 1.12
    assert rank_normalized_rhat(w) > 1.2
    # Heavy-tailed draws (Cauchy): rank normalization keeps diagnostics
    # finite and calibrated where moment-based ESS is undefined.
    c = rng.standard_cauchy(size=(4, 4000))
    assert rank_normalized_rhat(c) < 1.01
    np.testing.assert_allclose(bulk_ess(c), 16000, rtol=0.15)
    # Constant indicator guard: all-equal draws give ESS = total.
    const = np.zeros((4, 100))
    assert tail_ess(const) == 400.0


def test_nuts_deterministic_given_key():
    logp = _gauss_logp(jnp.zeros(2, DT), jnp.eye(2, dtype=DT))
    s1, _, _ = sample(logp, jax.random.PRNGKey(7), dim=2, num_chains=2,
                      num_warmup=100, num_samples=50, dtype=DT)
    s2, _, _ = sample(logp, jax.random.PRNGKey(7), dim=2, num_chains=2,
                      num_warmup=100, num_samples=50, dtype=DT)
    np.testing.assert_array_equal(np.asarray(s1), np.asarray(s2))
