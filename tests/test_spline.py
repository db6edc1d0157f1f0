"""Rational-quadratic spline bijectors: the five reference test patterns
(SURVEY §4) applied to the neural-spline-flow family — AD-Jacobian oracle
for the analytic ladj, exact-inverse round trips, ladj antisymmetry
(convention #6), identity initialization, monotonicity/tail properties,
dtype checks, finite-difference gradient validation, and a whitening
convergence gate on a bimodal target that no *linear* map can whiten."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import enflows_tpu as ef
from enflows_tpu.bijectors import (
    init_rq_spline_coupling, init_elementwise_rq_spline,
    spline_coupling_stack,
)
from enflows_tpu.bijectors.spline import rq_spline
from _gradcheck import check_grads


def _layer(dim=4, key=0, n_bins=6, **kw):
    c = init_rq_spline_coupling(jax.random.PRNGKey(key), dim,
                                hidden=(16, 16), n_bins=n_bins,
                                dtype=jnp.float64, **kw)
    # Perturb the zero-initialized final layer so the map is non-trivial.
    W, b = c.conditioner.layers[-1]
    kW, kb = jax.random.split(jax.random.PRNGKey(key + 100))
    layers = c.conditioner.layers[:-1] + (
        (0.4 * jax.random.normal(kW, W.shape, W.dtype),
         0.3 * jax.random.normal(kb, b.shape, b.dtype)),)
    return c.replace(conditioner=c.conditioner.replace(layers=layers))


def _elem(dim=4, key=10, n_bins=8):
    es = init_elementwise_rq_spline(dim, n_bins=n_bins, dtype=jnp.float64)
    ks = jax.random.split(jax.random.PRNGKey(key), 3)
    return es.replace(
        w_raw=0.6 * jax.random.normal(ks[0], es.w_raw.shape, jnp.float64),
        h_raw=0.6 * jax.random.normal(ks[1], es.h_raw.shape, jnp.float64),
        d_raw=0.6 * jax.random.normal(ks[2], es.d_raw.shape, jnp.float64))


def test_identity_initialization():
    st = spline_coupling_stack(jax.random.PRNGKey(0), 6, n_layers=3,
                               dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 6), jnp.float64) * 2
    y, ladj = st.forward_and_ladj(x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-13)
    np.testing.assert_allclose(np.asarray(ladj), 0.0, atol=1e-13)
    es = init_elementwise_rq_spline(6, dtype=jnp.float64)
    y, ladj = es.forward_and_ladj(x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x), atol=1e-13)
    np.testing.assert_allclose(np.asarray(ladj), 0.0, atol=1e-13)


def test_round_trip_and_ladj_antisymmetry():
    c = _layer()
    x = jax.random.normal(jax.random.PRNGKey(2), (64, 4), jnp.float64)
    y, ladj = c.forward_and_ladj(x)
    x_back, ladj_inv = c.inverse().forward_and_ladj(y)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x), atol=1e-9)
    np.testing.assert_allclose(np.asarray(ladj_inv), -np.asarray(ladj),
                               atol=1e-9)
    assert c.inverse().inverse() == c


def test_elementwise_round_trip_and_antisymmetry():
    es = _elem()
    x = jax.random.normal(jax.random.PRNGKey(3), (64, 4), jnp.float64) * 3
    y, ladj = es.forward_and_ladj(x)
    x_back, ladj_inv = es.inverse().forward_and_ladj(y)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x), atol=1e-9)
    np.testing.assert_allclose(np.asarray(ladj_inv), -np.asarray(ladj),
                               atol=1e-9)


def test_ladj_matches_ad_jacobian():
    c = _layer()
    xs = jax.random.normal(jax.random.PRNGKey(4), (6, 4), jnp.float64)
    _, ladj = c.forward_and_ladj(xs)
    for i in range(6):
        J = jax.jacfwd(lambda v: c.forward_and_ladj(v)[0])(xs[i])
        sign, logdet = np.linalg.slogdet(np.asarray(J))
        assert sign == 1.0
        np.testing.assert_allclose(float(ladj[i]), logdet, rtol=1e-8)


def test_elementwise_ladj_matches_ad_derivative():
    es = _elem(dim=1)
    xs = jnp.linspace(-4.5, 4.5, 23, dtype=jnp.float64)[:, None]
    _, ladj = es.forward_and_ladj(xs)
    for i in range(xs.shape[0]):
        d = jax.jacfwd(lambda v: es.forward_and_ladj(v)[0])(xs[i])[0, 0]
        np.testing.assert_allclose(float(ladj[i]), np.log(abs(float(d))),
                                   rtol=1e-8)


def test_monotone_and_identity_tails():
    g = jnp.linspace(-6.0, 6.0, 2001, dtype=jnp.float64)
    ks = jax.random.split(jax.random.PRNGKey(5), 3)
    w = 1.5 * jax.random.normal(ks[0], (8,), jnp.float64)
    h = 1.5 * jax.random.normal(ks[1], (8,), jnp.float64)
    d = 1.5 * jax.random.normal(ks[2], (7,), jnp.float64)
    y, ladj = rq_spline(g, w, h, d, bound=4.0)
    assert bool(jnp.all(jnp.diff(y) > 0))
    out = jnp.abs(g) >= 4.0
    np.testing.assert_allclose(np.asarray(y[out]), np.asarray(g[out]))
    np.testing.assert_allclose(np.asarray(ladj[out]), 0.0)
    # C^1 continuity at the boundary: the boundary knot derivative is
    # pinned to 1, so infinitesimally inside +-bound the map is the
    # identity and the ladj vanishes.
    edge = jnp.asarray([-4.0 + 1e-9, 4.0 - 1e-9], jnp.float64)
    ye, le = rq_spline(edge, w, h, d, bound=4.0)
    np.testing.assert_allclose(np.asarray(ye), np.asarray(edge), atol=1e-7)
    np.testing.assert_allclose(np.asarray(le), 0.0, atol=1e-6)


def test_gradients_vs_finite_differences():
    c = _layer(dim=3, n_bins=4)
    x = jax.random.normal(jax.random.PRNGKey(6), (12, 3), jnp.float64)

    def loss(c, x):
        y, ladj = c.forward_and_ladj(x)
        return jnp.sum(y ** 2) - 2.0 * jnp.sum(ladj)

    check_grads(loss, (c, x), atol=3e-4, rtol=3e-4, eps=1e-5)


def test_float32_dtype_and_round_trip():
    c = init_rq_spline_coupling(jax.random.PRNGKey(7), 4, hidden=(16,),
                                dtype=jnp.float32)
    W, b = c.conditioner.layers[-1]
    kW = jax.random.PRNGKey(8)
    layers = c.conditioner.layers[:-1] + (
        (0.4 * jax.random.normal(kW, W.shape, jnp.float32), b),)
    c = c.replace(conditioner=c.conditioner.replace(layers=layers))
    x = jax.random.normal(jax.random.PRNGKey(9), (256, 4), jnp.float32)
    y, ladj = c.forward_and_ladj(x)
    assert y.dtype == jnp.float32 and ladj.dtype == jnp.float32
    x_back = c.inverse().forward(y)
    # The inverse direction amplifies an f32 ulp of y by the local inverse
    # slope wherever the forward map compresses (steep splines near the
    # bound), so the x-space error bound must carry that condition number;
    # re-applying the forward contracts it back to f32 exactness.
    y_rt = c.forward(x_back)
    np.testing.assert_allclose(np.asarray(y_rt), np.asarray(y), atol=1e-5)
    slope = jax.jacfwd(lambda v: c.inverse().forward(v))
    err = np.abs(np.asarray(x_back - x))
    bad = np.argwhere(err > 1e-4)
    for i, j in bad[:8]:
        amp = float(np.abs(np.asarray(slope(y[i]))).max())
        assert err[i, j] < 64 * amp * np.finfo(np.float32).eps * 5.0, \
            (i, j, err[i, j], amp)
    assert np.quantile(err, 0.9) < 2e-5


def test_conditioner_width_validation():
    c = _layer(dim=4)
    bad = c.replace(n_bins=5)  # wrong K for the emitted param width
    x = jax.random.normal(jax.random.PRNGKey(10), (4, 4), jnp.float64)
    with pytest.raises(ValueError, match="needs"):
        bad.forward_and_ladj(x)


def _perturbed_stack(dim=8, n_layers=3, n_bins=6, scale=0.05, key=0):
    st = spline_coupling_stack(jax.random.PRNGKey(key), dim,
                               n_layers=n_layers, hidden=(32,),
                               n_bins=n_bins)
    return jax.tree.map(
        lambda p: p + scale * jax.random.normal(
            jax.random.PRNGKey(p.size % 97), p.shape, p.dtype), st)


def _spline_or_mixed(kind):
    if kind == "spline":
        return _perturbed_stack()
    from enflows_tpu.bijectors import coupling_stack
    from enflows_tpu.bijectors.base import Chain
    aff = coupling_stack(jax.random.PRNGKey(5), 8, n_layers=2, hidden=(16,))
    mix = Chain.of(*(aff.stages + _perturbed_stack().stages))
    return jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(
            jax.random.PRNGKey(p.size % 89), p.shape, p.dtype), mix)


@pytest.mark.parametrize("kind", ["spline", "mixed"])
def test_spline_stack_roundtrip_and_ladj_f32(kind):
    """f32 spline (and affine+spline) stacks at d=8: forward then exact
    inverse returns the input, the inverse ladj is the negated forward
    ladj, and the f32 values match the same stack evaluated in f64."""
    st = _spline_or_mixed(kind)
    # Unit-scale inputs: points squashed against the spline bound are
    # f32-ill-conditioned for the inverse (the self-consistency test below
    # covers them).
    x = jax.random.normal(jax.random.PRNGKey(1), (64, 8), jnp.float32)
    y, ladj = st.forward_and_ladj(x)
    xb, ladj_b = st.inverse().forward_and_ladj(y)
    # The round trip compounds the inverse's conditioning through up to
    # five f32 layers: the same 1e-3 as the self-consistency gate below.
    np.testing.assert_allclose(np.asarray(xb), np.asarray(x), atol=1e-3)
    np.testing.assert_allclose(np.asarray(ladj_b), -np.asarray(ladj),
                               atol=1e-3)
    st64 = jax.tree.map(lambda p: p.astype(jnp.float64), st)
    y64, l64 = st64.forward_and_ladj(x.astype(jnp.float64))
    np.testing.assert_allclose(np.asarray(y), np.asarray(y64), atol=2e-4)
    np.testing.assert_allclose(np.asarray(ladj), np.asarray(l64), atol=2e-4)


@pytest.mark.parametrize("kind", ["spline", "mixed"])
def test_spline_stack_gradients_f32_match_f64(kind):
    """Parameter gradients of a tanh/ladj loss: f32 matches f64."""
    st = _spline_or_mixed(kind)
    x = jax.random.normal(jax.random.PRNGKey(7), (32, 8), jnp.float32)

    def loss(c, u):
        y, l = c.forward_and_ladj(u)
        return jnp.sum(jnp.tanh(y)) - 0.1 * jnp.sum(l)

    g32 = jax.grad(loss)(st, x)
    st64 = jax.tree.map(lambda p: p.astype(jnp.float64), st)
    g64 = jax.grad(loss)(st64, x.astype(jnp.float64))
    for a, b in zip(jax.tree.leaves(g32), jax.tree.leaves(g64)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=5e-4)


def test_spline_stack_right_inverse_self_consistency():
    st = _perturbed_stack(scale=0.1)
    x = jax.random.normal(jax.random.PRNGKey(3), (64, 8), jnp.float32) * 2
    y = st.forward(x)
    x_back = st.inverse().forward(y)
    y_rt = st.forward(x_back)
    np.testing.assert_allclose(np.asarray(y_rt), np.asarray(y), atol=1e-3)


def test_whitening_convergence_beats_linear_bound():
    """A bimodal marginal no linear (or orthogonal) whitening map can fix:
    the spline stack's trained negll must beat the best *Gaussian* fit —
    the analytic optimum of every linear-map flow — by a clear margin."""
    import optax
    from enflows_tpu.train import optimize_whitening

    rng = np.random.default_rng(0)
    n = 4096
    comp = rng.integers(0, 2, n)
    x0 = rng.normal(0, 0.5, n) + np.where(comp, 2.0, -2.0)
    x1 = 0.5 * x0 + rng.normal(0, 0.8, n)
    X = jnp.asarray(np.stack([x0, x1], 1), jnp.float32)

    st = spline_coupling_stack(jax.random.PRNGKey(11), 2, n_layers=2,
                               hidden=(32,), n_bins=8, bound=6.0)
    res = optimize_whitening(X, st, optax.adam(5e-3), nbatches=8,
                             nepochs=40)
    negll = float(res.negll_history[-1])

    # Gaussian MLE negll (nats/sample) = d/2 (1 + log 2pi) + 1/2 log|cov|:
    # the optimum of any affine map pushed to N(0, I).
    cov = np.cov(np.asarray(X).T)
    gauss = 0.5 * 2 * (1 + np.log(2 * np.pi)) \
        + 0.5 * np.linalg.slogdet(cov)[1]
    assert negll < gauss - 0.25, (negll, gauss)
    # And the map actually whitens: unit covariance within tolerance.
    Y = np.asarray(res.result.forward(X))
    c = np.cov(Y.T)
    np.testing.assert_allclose(c, np.eye(2), atol=0.25)
