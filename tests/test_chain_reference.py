"""The plain elementwise + Householder chain against a float64 NumPy
reference (tests/_chain_reference.py).

For every event dimension the flagship-style chain serves (d = 1 .. 2048)
and for randomized fusible compositions: the float32 forward and
per-sample ladj match the float64 reference, the float64 JAX path matches
it to round-off, float32 gradients match float64 gradients, and the
float64 gradient matches a central finite difference of the NumPy
reference along a random parameter-and-input direction.
"""
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import enflows_tpu as ef
from _chain_reference import reference_forward_and_ladj

F = jnp.float32
DIMS = [1, 2, 3, 5, 8, 16, 50, 64, 100, 128, 1024, 2048]


def full_chain(d):
    return ef.compose(
        ef.Johnson(gamma=jnp.full(d, 0.3, F), delta=jnp.full(d, 5.0, F),
                   xi=jnp.zeros(d, F), lam=jnp.full(d, 5.0, F)),
        ef.Householder(
            V=jax.random.normal(jax.random.PRNGKey(0), (3, d), F)
        ).canonicalize(),
        ef.invert(ef.CenterStretch(a=jnp.full(d, 1.0, F),
                                   b=jnp.full(d, 1.5, F),
                                   c=jnp.full(d, 0.1, F))),
        ef.ScaleShift(a=jnp.full(d, 1.3, F), b=jnp.full(d, -0.4, F)),
        ef.JohnsonInv(gamma=jnp.zeros(d, F), delta=jnp.full(d, 5.0, F),
                      xi=jnp.zeros(d, F), lam=jnp.full(d, 5.0, F)),
        ef.CenterStretch(a=jnp.full(d, 0.4, F), b=jnp.full(d, 2.0, F),
                         c=jnp.zeros(d, F)),
    )


def _random_stage(key, d, kind):
    ks = jax.random.split(key, 4)

    def par(k, lo, hi):
        val = jax.random.uniform(k, (d,), F, lo, hi)
        if bool(jax.random.bernoulli(jax.random.fold_in(k, 1))):
            return val[0]          # scalar param exercises the broadcast path
        return val

    if kind == 0:
        return ef.ScaleShift(a=par(ks[0], 0.5, 2.0), b=par(ks[1], -1.0, 1.0))
    if kind == 1:
        return ef.CenterStretch(a=par(ks[0], 0.1, 1.0),
                                b=par(ks[1], 0.5, 2.5),
                                c=par(ks[2], -0.5, 0.5))
    if kind == 2:
        return ef.CenterContract(a=par(ks[0], 0.1, 1.0),
                                 b=par(ks[1], 0.5, 2.5),
                                 c=par(ks[2], -0.5, 0.5))
    if kind == 3:
        return ef.Johnson(gamma=par(ks[0], -0.5, 0.5),
                          delta=par(ks[1], 2.0, 6.0),
                          xi=par(ks[2], -0.5, 0.5), lam=par(ks[3], 2.0, 6.0))
    if kind == 4:
        return ef.JohnsonInv(gamma=par(ks[0], -0.5, 0.5),
                             delta=par(ks[1], 2.0, 6.0),
                             xi=par(ks[2], -0.5, 0.5),
                             lam=par(ks[3], 2.0, 6.0))
    k = int(jax.random.randint(ks[0], (), 1, 4))
    return ef.Householder(
        V=jax.random.normal(ks[1], (k, d), F)).canonicalize()


def _f64(tree):
    return jax.tree.map(lambda p: jnp.asarray(p, jnp.float64), tree)


def _loss(chain, x):
    y, ladj = chain.forward_and_ladj(x)
    return jnp.sum(jnp.cos(y)) + jnp.sum(ladj)


def _check_against_reference(chain, x):
    d = x.shape[-1]
    y_ref, l_ref = reference_forward_and_ladj(chain, x)

    # float32 path: per-element round-off of a six-stage transcendental
    # chain (~1e-6 relative on O(1) values); the ladj sums d such elements.
    y, ladj = chain.forward_and_ladj(x)
    np.testing.assert_allclose(np.asarray(y), y_ref, rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(ladj), l_ref, rtol=2e-5,
                               atol=2e-5 * d)

    # float64 path: the same formulas to round-off.
    c64, x64 = _f64(chain), jnp.asarray(x, jnp.float64)
    y64, l64 = c64.forward_and_ladj(x64)
    np.testing.assert_allclose(np.asarray(y64), y_ref, rtol=1e-10,
                               atol=1e-10)
    np.testing.assert_allclose(np.asarray(l64), l_ref, rtol=1e-10,
                               atol=1e-10 * d)

    # Gradients w.r.t. parameters and input: float32 against float64.
    g32 = jax.grad(_loss, argnums=(0, 1))(chain, x)
    g64 = jax.grad(_loss, argnums=(0, 1))(c64, x64)
    scale = max(float(jnp.max(jnp.abs(b))) for b in jax.tree.leaves(g64))
    for a, b in zip(jax.tree.leaves(g32), jax.tree.leaves(g64)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=2e-4, atol=2e-5 * (scale + 1.0))

    # float64 AD against a central difference of the NumPy reference
    # along one random direction in (parameters, input) space.
    leaves, treedef = jax.tree.flatten((c64, x64))
    keys = jax.random.split(jax.random.PRNGKey(d), len(leaves))
    dirs = [np.asarray(jax.random.normal(k, p.shape, jnp.float64))
            for k, p in zip(keys, leaves)]

    def ref_loss(t):
        c, u = jax.tree.unflatten(
            treedef, [np.asarray(p) + t * v for p, v in zip(leaves, dirs)])
        yr, lr = reference_forward_and_ladj(c, u)
        return np.sum(np.cos(yr)) + np.sum(lr)

    h = 1e-6
    fd = (ref_loss(h) - ref_loss(-h)) / (2 * h)
    ad = sum(float(np.vdot(np.asarray(g), v))
             for g, v in zip(jax.tree.leaves(g64), dirs))
    np.testing.assert_allclose(ad, fd, rtol=1e-6, atol=1e-6 * x.size)


@pytest.mark.parametrize("d", DIMS)
def test_chain_matches_f64_reference(d):
    x = jax.random.normal(jax.random.PRNGKey(1), (137, d), F)
    _check_against_reference(full_chain(d), x)


@pytest.mark.parametrize("seed", range(8))
def test_random_chain_matches_f64_reference(seed):
    """Randomized compositions: random stage kinds and order, scalar and
    vector parameters, random dims and batch sizes."""
    key = jax.random.PRNGKey(100 + seed)
    k_dim, k_len, k_kinds, k_x, k_stage = jax.random.split(key, 5)
    d = [1, 2, 4, 8, 16, 32, 64, 128][int(jax.random.randint(k_dim, (), 0, 8))]
    n_stages = int(jax.random.randint(k_len, (), 1, 6))
    kinds = jax.random.randint(k_kinds, (n_stages,), 0, 6)
    stages = [_random_stage(jax.random.fold_in(k_stage, i), d, int(kinds[i]))
              for i in range(n_stages)]
    chain = ef.compose(*stages) if n_stages > 1 else ef.Chain.of(stages[0])
    n = int(jax.random.randint(k_x, (), 1, 700))
    x = jax.random.normal(jax.random.fold_in(k_x, 1), (n, d), F)
    _check_against_reference(chain, x)


@pytest.mark.parametrize("d", [2, 50])
def test_flagship_flow_matches_f64_reference(d):
    """The flagship flow chip_smoke.py and bench.py time, at both widths."""
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    from __graft_entry__ import _flagship_flow

    x = jax.random.normal(jax.random.PRNGKey(2), (256, d), F)
    _check_against_reference(_flagship_flow(d), x)
