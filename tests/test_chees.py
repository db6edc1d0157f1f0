"""ChEES-HMC tests: adaptation sanity, posterior moments, determinism.

ChEES (mcmc/chees.py) is a beyond-reference component (SURVEY.md §2b adds
NUTS/HMC; ChEES is the accelerator-native adaptive variant). Validation
follows the same patterns as test_mcmc.py: Gaussian-moment recovery,
acceptance near the adaptation target, deterministic reruns, plus the
Halton-jitter unit properties.
"""
import jax
import jax.numpy as jnp
import numpy as np

from enflows_tpu.mcmc import chees_sample, sample, ess_per_dim
from enflows_tpu.mcmc.chees import halton_base2


def _gauss_logp(mu, cov):
    prec = jnp.linalg.inv(cov)

    def logp(q):
        d = q - mu
        return -0.5 * d @ prec @ d

    return logp


def test_halton_base2_properties():
    u = halton_base2(256)
    assert u.shape == (256,)
    assert np.all((u > 0) & (u < 1))
    # van der Corput: first points are 1/2, 1/4, 3/4, 1/8, ...
    np.testing.assert_allclose(u[:4], [0.5, 0.25, 0.75, 0.125])
    # low discrepancy: mean close to 1/2, much closer than iid would be
    assert abs(u.mean() - 0.5) < 0.01
    # offset continues the sequence without repeating the start
    u2 = halton_base2(4, offset=4)
    np.testing.assert_allclose(u2, [0.625, 0.375, 0.875, 0.0625])


def test_chees_gaussian_moments_2d():
    mu = jnp.asarray([1.0, -2.0], jnp.float64)
    cov = jnp.asarray([[2.0, 1.2], [1.2, 1.0]], jnp.float64)
    samples, _, stats = chees_sample(
        _gauss_logp(mu, cov), jax.random.PRNGKey(0), dim=2,
        num_chains=64, num_warmup=400, num_samples=500, dtype=jnp.float64)
    s = np.asarray(samples).reshape(-1, 2)
    np.testing.assert_allclose(s.mean(axis=0), np.asarray(mu), atol=0.1)
    np.testing.assert_allclose(np.cov(s.T), np.asarray(cov), atol=0.2)
    # acceptance should sit near the 0.651 ChEES target
    acc = float(np.mean(np.asarray(stats.accept_prob)))
    assert 0.45 < acc < 0.95, acc
    assert int(np.sum(np.asarray(stats.divergent))) == 0


def test_chees_anisotropic_gaussian_trajectory_adapts():
    """On a 100:1 anisotropic Gaussian the adapted trajectory must grow to
    O(longest scale) — the whole point of the ChEES criterion."""
    var = jnp.asarray([100.0, 1.0, 1.0, 1.0], jnp.float64)

    def logp(q):
        return -0.5 * jnp.sum(q * q / var)

    samples, _, stats = chees_sample(
        logp, jax.random.PRNGKey(1), dim=4, num_chains=128,
        num_warmup=600, num_samples=500, dtype=jnp.float64)
    # mass matrix handles the scales; trajectory should still exceed step
    traj = float(stats.trajectory_length)
    step = float(stats.step_size)
    assert traj > step, (traj, step)
    s = np.asarray(samples).reshape(-1, 4)
    np.testing.assert_allclose(s.var(axis=0), np.asarray(var), rtol=0.25)
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.35)


def test_chees_via_sample_dispatch():
    mu = jnp.zeros(2, jnp.float32)
    cov = jnp.eye(2, dtype=jnp.float32)
    samples, _, stats = sample(
        _gauss_logp(mu, cov), jax.random.PRNGKey(2), dim=2,
        algorithm="chees", num_chains=32, num_warmup=200, num_samples=200)
    assert samples.shape == (32, 200, 2)
    s = np.asarray(samples).reshape(-1, 2)
    np.testing.assert_allclose(s.mean(axis=0), 0.0, atol=0.15)


def test_chees_deterministic():
    logp = _gauss_logp(jnp.zeros(2, jnp.float32), jnp.eye(2, dtype=jnp.float32))
    out1 = chees_sample(logp, jax.random.PRNGKey(3), dim=2, num_chains=8,
                        num_warmup=50, num_samples=50)
    out2 = chees_sample(logp, jax.random.PRNGKey(3), dim=2, num_chains=8,
                        num_warmup=50, num_samples=50)
    np.testing.assert_array_equal(np.asarray(out1[0]), np.asarray(out2[0]))


def test_chees_ess_competitive_on_correlated_gaussian():
    """ChEES should achieve healthy per-sample ESS (its value prop is
    wall-clock on an accelerator; here we gate statistical efficiency per
    draw)."""
    rho = 0.9
    cov = jnp.asarray([[1.0, rho], [rho, 1.0]], jnp.float64)
    samples, _, _ = chees_sample(
        _gauss_logp(jnp.zeros(2, jnp.float64), cov), jax.random.PRNGKey(4),
        dim=2, num_chains=64, num_warmup=400, num_samples=400,
        dtype=jnp.float64)
    e = ess_per_dim(samples)
    total = samples.shape[0] * samples.shape[1]
    assert e.min() > 0.1 * total, (e, total)
