"""Affine coupling + Permute: the five reference test patterns (SURVEY §4)
applied to the coupling family — AD-Jacobian oracle for the analytic ladj,
round-trip/antisymmetry/involution properties, dtype checks, and a trainer
convergence test on a correlated target the elementwise+rotation families
cannot whiten from this initialization alone."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

import enflows_tpu as ef
from enflows_tpu.bijectors import init_affine_coupling, coupling_stack
from _gradcheck import check_grads


def _layer(dim=4, key=0, **kw):
    c = init_affine_coupling(jax.random.PRNGKey(key), dim, hidden=(16, 16),
                             dtype=jnp.float64, **kw)
    # Perturb the zero-initialized final layer so the map is non-trivial.
    W, b = c.conditioner.layers[-1]
    kW, kb = jax.random.split(jax.random.PRNGKey(key + 100))
    layers = c.conditioner.layers[:-1] + (
        (0.3 * jax.random.normal(kW, W.shape, W.dtype),
         0.2 * jax.random.normal(kb, b.shape, b.dtype)),)
    return c.replace(conditioner=c.conditioner.replace(layers=layers))


def test_identity_initialization():
    c = init_affine_coupling(jax.random.PRNGKey(0), 6, dtype=jnp.float64)
    x = jax.random.normal(jax.random.PRNGKey(1), (32, 6), jnp.float64)
    y, ladj = c.forward_and_ladj(x)
    np.testing.assert_allclose(np.asarray(y), np.asarray(x))
    np.testing.assert_allclose(np.asarray(ladj), 0.0)


def test_round_trip_and_ladj_antisymmetry():
    c = _layer()
    x = jax.random.normal(jax.random.PRNGKey(2), (64, 4), jnp.float64)
    y, ladj = c.forward_and_ladj(x)
    x_back, ladj_inv = c.inverse().forward_and_ladj(y)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x),
                               atol=1e-12)
    # Convention #6: inverse ladj at the output = negated forward ladj.
    np.testing.assert_allclose(np.asarray(ladj_inv), -np.asarray(ladj),
                               atol=1e-12)
    assert c.inverse().inverse() == c


def test_ladj_matches_ad_jacobian():
    c = _layer()
    xs = jax.random.normal(jax.random.PRNGKey(3), (8, 4), jnp.float64)
    _, ladj = c.forward_and_ladj(xs)
    for i in range(8):
        J = jax.jacfwd(lambda v: c.forward_and_ladj(v)[0])(xs[i])
        sign, logdet = np.linalg.slogdet(np.asarray(J))
        assert sign == 1.0
        np.testing.assert_allclose(float(ladj[i]), logdet, rtol=1e-9)


def test_gradients_vs_finite_differences():
    c = _layer(dim=3)
    x = jax.random.normal(jax.random.PRNGKey(4), (16, 3), jnp.float64)

    def loss(c, x):
        y, ladj = c.forward_and_ladj(x)
        return jnp.sum(y ** 2) - 2.0 * jnp.sum(ladj)

    check_grads(loss, (c, x), atol=2e-4, rtol=2e-4, eps=1e-5)


def test_permute_round_trip_and_zero_ladj():
    p = ef.Permute(perm=(2, 0, 3, 1))
    x = jax.random.normal(jax.random.PRNGKey(5), (10, 4), jnp.float64)
    y, ladj = p.forward_and_ladj(x)
    np.testing.assert_allclose(np.asarray(ladj), 0.0)
    np.testing.assert_allclose(np.asarray(p.inverse().forward(y)),
                               np.asarray(x))
    assert p.inverse().inverse() == p


def test_coupling_stack_round_trip_f32():
    stack = coupling_stack(jax.random.PRNGKey(6), 4, n_layers=3,
                           hidden=(32,))
    # Perturb every coupling's final layer (stack is identity-initialized).
    def bump(s, i):
        if not isinstance(s, ef.AffineCoupling):
            return s
        W, b = s.conditioner.layers[-1]
        layers = s.conditioner.layers[:-1] + (
            (0.1 * jax.random.normal(jax.random.PRNGKey(i), W.shape,
                                     W.dtype), b),)
        return s.replace(conditioner=s.conditioner.replace(layers=layers))

    stack = ef.Chain(stages=tuple(bump(s, i)
                                  for i, s in enumerate(stack.stages)))
    x = jax.random.normal(jax.random.PRNGKey(7), (128, 4), jnp.float32)
    y, ladj = jax.jit(stack.forward_and_ladj)(x)
    assert y.dtype == jnp.float32 and ladj.shape == (128,)
    x_back = jax.jit(stack.inverse().forward)(y)
    np.testing.assert_allclose(np.asarray(x_back), np.asarray(x),
                               atol=2e-5)


def test_whitening_trains_coupling_on_correlated_gaussian():
    # A correlated, nonlinearly warped 2D target: optimize_whitening over a
    # coupling stack must drive cov(f(X)) toward identity.
    import optax
    from enflows_tpu.train import optimize_whitening, mvnormal_negll

    key = jax.random.PRNGKey(8)
    z = jax.random.normal(key, (20_000, 2), jnp.float32)
    X = jnp.stack([z[:, 0], 0.5 * z[:, 1] + 0.8 * z[:, 0] ** 2], axis=-1)

    model = coupling_stack(jax.random.PRNGKey(9), 2, n_layers=4,
                           hidden=(32, 32))
    res = optimize_whitening(X, model, optax.adam(1e-2), nbatches=20,
                             nepochs=30)
    Y = res.result.forward(X)
    C = np.cov(np.asarray(Y), rowvar=False)
    np.testing.assert_allclose(C, np.eye(2), atol=0.12)
    hist = np.asarray(res.negll_history)
    assert hist[-1] < hist[0] - 0.3


def _perturbed_stack(key, dim, n_layers=3, hidden=(32, 32), **kw):
    stack = coupling_stack(jax.random.PRNGKey(key), dim,
                           n_layers=n_layers, hidden=hidden,
                           dtype=jnp.float32, **kw)
    return jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(
            jax.random.PRNGKey(p.size % 97), p.shape, p.dtype), stack)


def _f64_tree(tree):
    return jax.tree.map(lambda p: p.astype(jnp.float64), tree)


@pytest.mark.parametrize("dim", [4, 8, 64])
def test_coupling_stack_roundtrip_and_ladj(dim):
    """Perturbed 3-layer stack: the exact inverse undoes the forward, its
    ladj is the negated forward ladj, and the ladj equals log|det J| of
    the AD Jacobian (f64)."""
    stack = _perturbed_stack(dim, dim)
    x = jax.random.normal(jax.random.PRNGKey(1), (200, dim), jnp.float32)
    y, ladj = stack.forward_and_ladj(x)
    xb, ladj_b = stack.inverse().forward_and_ladj(y)
    np.testing.assert_allclose(np.asarray(xb), np.asarray(x),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(np.asarray(ladj_b), -np.asarray(ladj),
                               rtol=1e-4, atol=1e-4)

    s64 = _f64_tree(stack)
    x64 = x[:8].astype(jnp.float64)
    jac = jax.vmap(jax.jacfwd(s64.forward))(x64)
    _, logdet = np.linalg.slogdet(np.asarray(jac))
    _, l64 = s64.forward_and_ladj(x64)
    np.testing.assert_allclose(np.asarray(l64), logdet, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(ladj[:8]), logdet, rtol=1e-4,
                               atol=1e-4)


@pytest.mark.parametrize("dim", [4, 8, 64])
def test_coupling_stack_gradients_f32_match_f64(dim):
    """Parameter and input gradients of a loss through the f32 stack match
    the same loss evaluated in f64, and the f64 gradient matches a central
    finite difference along a random parameter direction."""
    stack = _perturbed_stack(dim, dim)
    x = jax.random.normal(jax.random.PRNGKey(2), (64, dim), jnp.float32)

    def loss(c, u):
        y, l = c.forward_and_ladj(u)
        return jnp.sum(jnp.sin(y)) + jnp.sum(l)

    g32 = jax.grad(loss, argnums=(0, 1))(stack, x)
    s64, x64 = _f64_tree(stack), x.astype(jnp.float64)
    g64 = jax.grad(loss, argnums=(0, 1))(s64, x64)
    for a, b in zip(jax.tree.leaves(g32), jax.tree.leaves(g64)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-3, atol=2e-3)

    leaves, treedef = jax.tree.flatten(s64)
    keys = jax.random.split(jax.random.PRNGKey(3), len(leaves))
    dirs = [jax.random.normal(k, p.shape, p.dtype)
            for k, p in zip(keys, leaves)]
    h = 1e-6
    shifted = lambda sgn: jax.tree.unflatten(
        treedef, [p + sgn * h * d for p, d in zip(leaves, dirs)])
    fd = (loss(shifted(1.0), x64) - loss(shifted(-1.0), x64)) / (2 * h)
    ad = sum(jnp.vdot(g, d) for g, d in zip(jax.tree.leaves(g64[0]), dirs))
    np.testing.assert_allclose(float(ad), float(fd), rtol=1e-6)


def test_coupling_bf16_conditioner_invertibility():
    """compute_dtype='bfloat16' conditioner: forward/inverse round trip is
    EXACT up to f32 io rounding (the inverse recomputes the identical
    conditioner), and the ladj is consistent with the realized map."""
    key = jax.random.PRNGKey(11)
    dim = 8
    stack16 = coupling_stack(key, dim, n_layers=2, hidden=(32, 32),
                             compute_dtype="bfloat16")
    # Perturb weights so the map is non-trivial (identity init otherwise).
    stack16 = jax.tree.map(
        lambda p: p + 0.05 * jax.random.normal(
            jax.random.PRNGKey(p.shape[0] if p.ndim else 0), p.shape,
            p.dtype), stack16)
    x = jax.random.normal(jax.random.fold_in(key, 2), (64, dim),
                          jnp.float32)
    y, ladj = stack16.forward_and_ladj(x)
    x_rt = stack16.inverse().forward(y)
    np.testing.assert_allclose(np.asarray(x_rt), np.asarray(x),
                               rtol=1e-5, atol=1e-5)
    # ladj consistency: AD jacobian of the realized bf16-conditioned map
    # (AD tangents through bf16 matmuls carry ~0.4% noise themselves).
    jac = jax.vmap(jax.jacfwd(lambda v: stack16.forward(v)))(x[:8])
    sign, logdet = np.linalg.slogdet(np.asarray(jac, np.float64))
    np.testing.assert_allclose(np.asarray(ladj[:8]), logdet,
                               rtol=2e-2, atol=2e-2)


def test_vi_trainer_coupling_stack_fits_target():
    """optimize_elbo on a coupling-stack transport fits a shifted
    Gaussian target."""
    import optax
    from enflows_tpu.train import optimize_elbo

    dim = 4
    mean = jnp.asarray([1.0, -1.0, 0.5, 0.0], jnp.float32)

    def logp(z):
        return -0.5 * jnp.sum((z - mean) ** 2, axis=-1)

    stack = coupling_stack(jax.random.PRNGKey(9), dim, n_layers=2,
                           hidden=(16, 16))
    # A shift is outside the pure coupling family at identity init unless
    # the stack trains; couple with a ScaleShift head like the template.
    flow = ef.Chain.of(ef.ScaleShift(a=jnp.ones(dim, jnp.float32),
                                     b=jnp.zeros(dim, jnp.float32)),
                       *stack.stages)
    res = optimize_elbo(logp, flow, optax.adam(1e-2), dim=dim,
                        batch_size=256, nsteps=300,
                        key=jax.random.PRNGKey(10))
    z = res.result.forward(
        jax.random.normal(jax.random.PRNGKey(11), (20000, dim),
                          jnp.float32))
    np.testing.assert_allclose(np.asarray(z).mean(0), np.asarray(mean),
                               atol=0.15)
