"""End-to-end training tests: whitening MLE and flow-VI.

The M1 judged checkpoint (SURVEY.md §7): reproduce the reference's example
workloads — /root/reference/examples/nf_example_1d.jl (4-stage flow fit by
ADAGrad whitening), nf_example_2d.jl (3-stage flow incl. Householder, with
cov(f(X)) ≈ I check, :38), and nf_variational_1d.jl (ELBO fit to a 1D
3-component Gaussian mixture) — at reduced step counts suitable for CI, with
statistical correctness gates instead of plots.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest

from enflows_tpu import (
    CenterStretch, Johnson, Householder, ScaleShift, compose, invert,
    std_normal_logpdf,
)
from enflows_tpu.train import (
    mvnormal_negll, optimize_whitening, optimize_elbo, neg_elbo,
)

DT = jnp.float64


def _vec(*vals):
    return jnp.asarray(vals, DT)


def test_whitening_1d_example():
    # Ground truth: CenterStretch ∘ Johnson warping N(0,1) into a heavy-
    # tailed target (nf_example_1d.jl:8-15).
    f_true = compose(
        CenterStretch(a=_vec(4.0), b=_vec(1.0), c=_vec(0.0)),
        Johnson(gamma=_vec(10.0), delta=_vec(3.5), xi=_vec(10.0),
                lam=_vec(1.0)),
    )
    key = jax.random.PRNGKey(0)
    XW = jax.random.normal(key, (20000, 1), dtype=DT)
    X = f_true.forward(XW)

    # 4-stage model from identity-ish init (nf_example_1d.jl:19-23).
    model = compose(
        Johnson(gamma=_vec(0.0), delta=_vec(5.0), xi=_vec(0.0),
                lam=_vec(5.0)),
        invert(CenterStretch(a=_vec(0.0), b=_vec(1.0), c=_vec(0.0))),
        Johnson(gamma=_vec(0.0), delta=_vec(5.0), xi=_vec(0.0),
                lam=_vec(5.0)),
        invert(CenterStretch(a=_vec(0.0), b=_vec(1.0), c=_vec(0.0))),
    )

    res = optimize_whitening(X, model, optax.adagrad(0.1),
                             nbatches=50, nepochs=20)
    # Gates: final negll near the analytic optimum = negll of the true
    # inverse transform (the reference's hline reference, :40-44).
    target = float(mvnormal_negll(invert(f_true), X))
    final = float(np.mean(np.asarray(res.negll_history[-50:])))
    initial = float(mvnormal_negll(model, X))
    assert final < initial - 0.5 * (initial - target), \
        f"no convergence: init {initial:.3f} final {final:.3f} target {target:.3f}"
    assert final < target + 0.15, (final, target)
    # Whitened pushforward has roughly standard moments.
    Y = res.result.forward(X)
    assert abs(float(jnp.mean(Y))) < 0.1
    assert abs(float(jnp.std(Y)) - 1.0) < 0.1


def test_whitening_2d_example_cov_identity():
    # nf_example_2d.jl:12-15 ground truth; :36-38 validates cov ≈ I.
    f_true = compose(
        ScaleShift(a=_vec(1.3, 0.4), b=_vec(2.5, -1.2)),
        Householder(V=_vec(1.0, 0.3)),
        CenterStretch(a=_vec(4.0, 4.1), b=_vec(2.0, 2.1),
                      c=_vec(3.0, 3.1)),
    )
    key = jax.random.PRNGKey(1)
    XW = jax.random.normal(key, (20000, 2), dtype=DT)
    X = f_true.forward(XW)

    model = compose(
        invert(CenterStretch(a=_vec(0.0, 0.0), b=_vec(1.0, 1.0),
                             c=_vec(0.0, 0.0))),
        invert(Householder(V=jax.random.normal(jax.random.PRNGKey(2), (2,),
                                               dtype=DT))),
        ScaleShift(a=_vec(1.0, 1.0), b=_vec(0.0, 0.0)),
    )
    res = optimize_whitening(X, model, optax.adagrad(0.1),
                             nbatches=100, nepochs=30)
    Y = np.asarray(res.result.forward(X))
    cov = np.cov(Y.T)
    np.testing.assert_allclose(cov, np.eye(2), atol=0.15)
    assert np.all(np.abs(Y.mean(axis=0)) < 0.15)


def test_whitening_resumable():
    key = jax.random.PRNGKey(3)
    X = 2.0 * jax.random.normal(key, (4000, 2), dtype=DT) + 1.0
    model = ScaleShift(a=_vec(1.0, 1.0), b=_vec(0.0, 0.0))
    opt = optax.adagrad(0.1)
    r1 = optimize_whitening(X, model, opt, nbatches=10, nepochs=5)
    r2 = optimize_whitening(X, r1.result, opt, nbatches=10, nepochs=5,
                            opt_state=r1.optimizer_state,
                            negll_history=r1.negll_history)
    assert r2.negll_history.shape[0] == 100
    # Resumed loss continues to decrease (no reset spike).
    assert float(r2.negll_history[-1]) <= float(r1.negll_history[-1]) + 1e-3


def test_vi_1d_mixture():
    # nf_variational_1d.jl: 3-component Gaussian mixture target (:21-23).
    def my_ll(z):
        z = z[..., 0]
        comps = jnp.stack([
            jnp.log(0.3) + std_normal_logpdf(z - 2.0),
            jnp.log(0.5) + std_normal_logpdf(z - 5.0),
            jnp.log(0.2) + std_normal_logpdf(z + 1.0),
        ], axis=-1)
        return jax.scipy.special.logsumexp(comps, axis=-1)

    fwd = compose(
        Johnson(gamma=_vec(0.0), delta=_vec(5.0), xi=_vec(0.0),
                lam=_vec(5.0)),
        invert(CenterStretch(a=_vec(0.0), b=_vec(1.0), c=_vec(0.0))),
        Johnson(gamma=_vec(0.0), delta=_vec(5.0), xi=_vec(0.0),
                lam=_vec(5.0)),
        invert(CenterStretch(a=_vec(0.0), b=_vec(1.0), c=_vec(0.0))),
    )
    model = invert(fwd)   # reference :73: VI trains the inverse direction

    res = optimize_elbo(my_ll, model, optax.adagrad(0.2), dim=1,
                        batch_size=100, nsteps=800, dtype=DT,
                        key=jax.random.PRNGKey(4))
    # Push base samples through the learned transport (reference :81-86).
    xi = jax.random.normal(jax.random.PRNGKey(5), (50000, 1), dtype=DT)
    z = np.asarray(res.result.forward(xi))[:, 0]
    # Mixture mean = 0.3*2 + 0.5*5 + 0.2*(-1) = 2.9; var = E[x^2]-mu^2
    mean_true = 2.9
    var_true = 0.3 * (1 + 4) + 0.5 * (1 + 25) + 0.2 * (1 + 1) - mean_true**2
    assert abs(z.mean() - mean_true) < 0.3, z.mean()
    assert abs(z.var() - var_true) < 1.2, (z.var(), var_true)
    # nELBO decreased substantially and ends near -log Z = 0 (normalized
    # mixture): final ELBO within 0.5 nat.
    hist = np.asarray(res.nelbo_history)
    assert hist[-1] < hist[0] - 1.0
    assert hist[-50:].mean() < 0.5


def test_negll_batch_size_independent():
    f = ScaleShift(a=_vec(2.0, 0.5), b=_vec(0.0, 0.0))
    X = jax.random.normal(jax.random.PRNGKey(6), (64, 2), dtype=DT)
    a = mvnormal_negll(f, X)
    b = (mvnormal_negll(f, X[:32]) + mvnormal_negll(f, X[32:])) / 2
    np.testing.assert_allclose(a, b, rtol=1e-12)


def test_whitening_mid_dim_converges():
    """d=16 with 1000-row batches: the trainer converges to the analytic
    optimum on a linearly-warped Gaussian."""
    import enflows_tpu as ef

    dim = 16
    key = jax.random.PRNGKey(0)
    scale = jnp.linspace(0.5, 2.0, dim).astype(jnp.float32)
    shift = jnp.linspace(-1.0, 1.0, dim).astype(jnp.float32)
    X = scale * jax.random.normal(key, (20_000, dim), jnp.float32) + shift

    model = ef.ScaleShift(a=jnp.ones(dim, jnp.float32),
                          b=jnp.zeros(dim, jnp.float32))
    res = optimize_whitening(X, model, optax.adam(0.05),
                             nbatches=20, nepochs=80)
    Y = res.result.forward(X)
    m = np.asarray(Y).mean(0)
    sd = np.asarray(Y).std(0)
    np.testing.assert_allclose(m, np.zeros(dim), atol=0.08)
    np.testing.assert_allclose(sd, np.ones(dim), atol=0.08)
