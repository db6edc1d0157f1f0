"""Householder chain tests: oracle matrices, custom-VJP vs AD, involutions.

Ports /root/reference/test/test_householder_trafo.jl: explicit
``I - 2vv^T/(v^Tv)`` oracle (reference :18-25,38-43), custom-pullback
cross-check against forward-mode AD of the *primal kernel* (reference
:28-33,49-55 — the naive chained-matrix construction is a known-wrong AD
oracle there too), batched-vs-single consistency, involution, zero ladj.
Adds scan-vs-dense path equivalence (the dense path has no reference
counterpart).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from _gradcheck import check_grads

from enflows_tpu import Householder
from enflows_tpu.bijectors.householder import (
    householder_chain, householder_chain_dense, householder_matrix,
    _reflect,
)


def _oracle_matrix(V):
    """Dense oracle: product of I - 2 v v^T / (v^T v), applied in row order."""
    d = V.shape[1]
    Q = np.eye(d)
    for v in np.asarray(V):
        H = np.eye(d) - 2.0 * np.outer(v, v) / (v @ v)
        Q = H @ Q
    return Q


@pytest.fixture
def V():
    return jax.random.normal(jax.random.PRNGKey(0), (4, 6),
                             dtype=jnp.float64)


@pytest.fixture
def x(V):
    return jax.random.normal(jax.random.PRNGKey(1), (32, 6),
                             dtype=jnp.float64)


def test_single_reflection_vs_oracle(V, x):
    v = V[0]
    H = np.eye(6) - 2.0 * np.outer(v, v) / (v @ v)
    np.testing.assert_allclose(_reflect(v, x), x @ H.T, rtol=1e-12)


def test_chain_vs_oracle(V, x):
    Q = _oracle_matrix(V)
    np.testing.assert_allclose(householder_chain(V, x), x @ Q.T, rtol=1e-11)


def test_dense_path_vs_scan(V, x):
    np.testing.assert_allclose(householder_chain_dense(V, x),
                               householder_chain(V, x), rtol=1e-11)
    np.testing.assert_allclose(householder_matrix(V), _oracle_matrix(V),
                               rtol=1e-11)


def test_batched_vs_single(V, x):
    y = householder_chain(V, x)
    for i in range(x.shape[0]):
        np.testing.assert_allclose(householder_chain(V, x[i]), y[i],
                                   rtol=1e-11)


def test_involution_and_inverse(V, x):
    f = Householder(V=V[0], mode="scan")
    np.testing.assert_allclose(f.forward(f.forward(x)), x, rtol=1e-11)
    assert f.inverse() is f  # single reflection is its own inverse

    g = Householder(V=V, mode="scan")
    np.testing.assert_allclose(g.inverse().forward(g.forward(x)), x,
                               rtol=1e-10)


def test_zero_ladj_and_orthogonality(V, x):
    g = Householder(V=V, mode="auto")
    y, ladj = g.forward_and_ladj(x)
    np.testing.assert_array_equal(ladj, np.zeros(x.shape[0]))
    # Norm preservation == exact orthogonality.
    np.testing.assert_allclose(jnp.sum(y * y, axis=-1),
                               jnp.sum(x * x, axis=-1), rtol=1e-11)


def test_custom_vjp_vs_ad(V, x):
    """The memory-free backward pass must match AD of the primal kernel."""
    def loss(V, x):
        y = householder_chain(V, x)
        return jnp.sum(jnp.sin(y) * y)

    def loss_dense(V, x):
        y = householder_chain_dense(V, x)
        return jnp.sum(jnp.sin(y) * y)

    gV, gx = jax.grad(loss, argnums=(0, 1))(V, x)
    gV_d, gx_d = jax.grad(loss_dense, argnums=(0, 1))(V, x)
    np.testing.assert_allclose(gV, gV_d, rtol=1e-9, atol=1e-10)
    np.testing.assert_allclose(gx, gx_d, rtol=1e-9, atol=1e-10)

    check_grads(loss, (V, x), order=1, modes=["rev"],
                              atol=1e-6, rtol=1e-6)


def test_custom_vjp_vs_jacfwd_single(V):
    """Reflection pullback vs ForwardDiff-style Jacobian (reference :28-33)."""
    v = V[0]
    x1 = jax.random.normal(jax.random.PRNGKey(7), (6,), dtype=jnp.float64)

    f_v = lambda v: householder_chain(v[None, :], x1)
    # Pure-AD oracle Jacobian via the dense path (no custom_vjp on it).
    J_v = jax.jacfwd(lambda v: householder_chain_dense(v[None, :], x1))(v)
    g = jax.random.normal(jax.random.PRNGKey(8), (6,), dtype=jnp.float64)
    vjp_expected = g @ J_v
    _, vjp_fn = jax.vjp(f_v, v)
    np.testing.assert_allclose(vjp_fn(g)[0], vjp_expected, rtol=1e-9)


def test_canonicalize_normalizes_rows(V):
    f = Householder(V=3.0 * V)
    g = f.canonicalize()
    norms = jnp.linalg.norm(g.V, axis=-1)
    np.testing.assert_allclose(norms, np.ones(V.shape[0]), rtol=1e-12)
    # Same transform (direction-only dependence).
    x = jax.random.normal(jax.random.PRNGKey(2), (5, 6), dtype=jnp.float64)
    np.testing.assert_allclose(g.forward(x), f.forward(x), rtol=1e-11)


def test_grad_through_normalization_is_tangent(V):
    """∂v must be orthogonal to v (direction-only dependence)."""
    x = jax.random.normal(jax.random.PRNGKey(3), (16, 6), dtype=jnp.float64)

    def loss(V):
        return jnp.sum(householder_chain(V, x) ** 3)

    gV = jax.grad(loss)(V)
    dots = jnp.sum(gV * V, axis=-1) / jnp.linalg.norm(V, axis=-1)
    np.testing.assert_allclose(dots, np.zeros(V.shape[0]), atol=1e-9)


@pytest.mark.parametrize("d", [2, 4, 8, 16, 50, 128])
def test_auto_mode_rule_and_paths_agree(d):
    """mode='auto' takes the scan below d=8 and the dense matmul from
    d=8 on (vectors always scan); both paths give the same rotation and
    the same parameter and input gradients in float32."""
    V = jax.random.normal(jax.random.PRNGKey(d), (4, d), jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(d + 1), (64, d), jnp.float32)
    h = Householder(V=V)
    assert h._use_dense(x) == (d >= 8)
    assert not h._use_dense(x[0])
    np.testing.assert_allclose(np.asarray(h.forward(x)),
                               np.asarray(x) @ _oracle_matrix(V).T,
                               rtol=1e-5, atol=1e-5)

    def loss(hh, xx):
        return jnp.sum(jnp.sin(hh.forward(xx)))

    g = {m: jax.grad(loss, argnums=(0, 1))(
        Householder(V=V, mode=m), x) for m in ("dense", "scan")}
    for a, b in zip(jax.tree.leaves(g["dense"]), jax.tree.leaves(g["scan"])):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   rtol=1e-4, atol=1e-5)
