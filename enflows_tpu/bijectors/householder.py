"""Householder reflection chains: exact orthogonal (rotation) bijectors.

Redesign of /root/reference/src/householder_trafo.jl. A single
reflection is ``y = x - 2 v (v.x)/(v.v)`` (reference :8-11); a chain applies
``k`` reflections in sequence. The log-abs-det-Jacobian is identically zero
(orthogonal map, reference :159-160).

Layout change vs the reference: ``V`` has shape ``(k, d)`` — reflections are
**rows** (event dim last, matching the library-wide ``(..., d)`` convention
and XLA's lane-major tiling), where the reference stores them as columns of a
``(d, k)`` matrix (reference :127-129).

Two execution paths, selected statically per shape:

* ``scan``: `lax.scan` over reflections with a **memory-free custom VJP** —
  the backward pass re-applies reflections in reverse to reconstruct each
  stage's input instead of storing k intermediates, exploiting
  H_i = H_i^-1 = H_i^T (port of the reference's O(1)-memory pullback,
  chained_householder_trafo_pullback_V, reference :88-114; SURVEY.md §3.3).
  O(k·batch·d) elementwise work, O(batch·d) memory. Right for small d;
  each sweep is its own pass over the batch (a row reduction, then the
  update).

* ``dense``: materialize the orthogonal product Q = H_{k-1}···H_0 once per
  evaluation (O(k·d²), batch-independent) and apply it as a single batched
  matmul ``x @ Q^T`` — no reference counterpart. AD flows through the Q
  construction natively (cost again batch-independent).

``mode='auto'`` picks dense from d = 8 on (see ``Householder._use_dense``).

Normalization: the forward map depends only on the *direction* of each row,
so rows need not be unit norm; after an optimizer step, ``canonicalize()``
re-normalizes rows onto the unit sphere — the explicit-JAX replacement for
the reference's renormalize-inside-Functors trick (reference :134-146).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from ..utils.pytree import pytree_dataclass
from .base import Bijector

Array = jax.Array


def _dot(a: Array, b: Array) -> Array:
    """Contract the trailing axis elementwise: exact float32 arithmetic,
    where a matmul at the default precision may round to TF32 on a GPU."""
    return jnp.sum(a * b, axis=-1)


def _reflect(v: Array, x: Array) -> Array:
    """Apply one reflection; v (d,), x (..., d). Self-inverse, self-adjoint."""
    coef = 2.0 * _dot(x, v) / _dot(v, v)
    return x - coef[..., None] * v


def _reflect_pullback_v(v: Array, x: Array, g: Array) -> Array:
    """Cotangent w.r.t. ``v`` of ``_reflect(v, x)`` against upstream ``g``.

    Includes the pullback of the implicit normalization v -> v/|v| (the map
    depends on direction only, so the gradient is tangent to the sphere).
    Batched port of householder_trafo_pullback_v (reference :22-40).
    """
    inrm = lax.rsqrt(_dot(v, v))
    w = inrm * v
    w_x = _dot(x, w)                              # (...,)
    w_g = _dot(g, w)                              # (...,)
    # Sum over all batch axes: dw has shape (d,).
    bshape = tuple(range(x.ndim - 1))
    dw = -2.0 * (
        jnp.sum(g * w_x[..., None], axis=bshape)
        + jnp.sum(x * w_g[..., None], axis=bshape)
    )
    return inrm * (dw - w * _dot(dw, w))


@jax.custom_vjp
def householder_chain(V: Array, x: Array) -> Array:
    """Apply reflections V[0], V[1], ... in order to x (..., d)."""
    def step(y, v):
        return _reflect(v, y), None

    y, _ = lax.scan(step, x, V)
    return y


def _hh_fwd(V, x):
    y = householder_chain(V, x)
    return y, (V, y)        # memory-free: only (V, output) saved


def _hh_bwd(res, g):
    V, y = res

    def step(carry, v):
        z, delta = carry
        # Unwind: H_i is an involution, so H_i z recovers stage i's input
        # (reference :94-100, incl. the z ≈ x invariant asserted at :101).
        z = _reflect(v, z)
        dv = _reflect_pullback_v(v, z, delta)
        delta = _reflect(v, delta)              # self-adjoint cotangent hop
        return (z, delta), dv

    (_, dx), dV = lax.scan(step, (y, g), V, reverse=True)
    return dV, dx


householder_chain.defvjp(_hh_fwd, _hh_bwd)


def householder_matrix(V: Array, dtype=None) -> Array:
    """Materialize Q = H_{k-1}···H_0 as a (d, d) orthogonal matrix.

    The dense-path analogue of the tests' oracle construction
    (/root/reference/test/test_householder_trafo.jl:18-25), used here as a
    *production* path: Q is batch-independent, so for batch >> d it is
    computed once and applied as one matmul ``x @ Q^T``.
    """
    k, d = V.shape
    if dtype is None:
        dtype = V.dtype
    eye = jnp.eye(d, dtype=dtype)

    def step(Q, v):
        w = v * lax.rsqrt(_dot(v, v))
        # H Q = Q - 2 w (w^T Q)
        wQ = jnp.matmul(w, Q, precision=jax.lax.Precision.HIGHEST)
        return Q - 2.0 * jnp.outer(w, wQ), None

    Q, _ = lax.scan(step, eye, V.astype(dtype))
    return Q


def householder_chain_dense(V: Array, x: Array) -> Array:
    Q = householder_matrix(V)
    # HIGHEST precision: at the default precision an f32 matmul may run in
    # TF32 (or bf16 passes), ~1e-3 relative error on the rotation
    # (orthogonality is a tested invariant).
    return jnp.matmul(x, Q.T, precision=jax.lax.Precision.HIGHEST,
                      preferred_element_type=x.dtype)


@pytree_dataclass(static=("mode",))
class Householder(Bijector):
    """Orthogonal bijector from a chain of Householder reflections.

    ``V``: (k, d) rows = reflection directions, or (d,) for one reflection.
    ``mode``: 'auto' | 'scan' | 'dense' (see module docstring).
    """

    V: jnp.ndarray
    mode: str = "auto"

    @classmethod
    def init(cls, V, mode="auto"):
        return cls(V=jnp.asarray(V), mode=mode)

    def _vmat(self):
        V = self.V
        return V[None, :] if V.ndim == 1 else V

    def _use_dense(self, x) -> bool:
        if self.mode != "auto":
            return self.mode == "dense"
        if x.ndim < 2:
            return False
        # Measured on the H100 (PERF.md, Householder; k = 4, d from 2 to
        # 128): at 1M rows the scan's value+grad wins at d <= 4 and the
        # dense matmul from d = 8 on. At 16K rows and below both paths sit
        # at the same per-call dispatch floor, so the rule ignores the
        # batch size.
        return self._vmat().shape[1] >= 8

    def forward(self, x):
        V = self._vmat()
        if self._use_dense(x):
            return householder_chain_dense(V, x)
        return householder_chain(V, x)

    def forward_and_ladj(self, x):
        y = self.forward(x)
        ladj = jnp.zeros(jnp.shape(x)[:-1] if jnp.ndim(x) > 0 else (),
                         dtype=jnp.result_type(x, jnp.float32))
        return y, ladj

    def inverse(self):
        if self.V.ndim == 1:
            return self          # single reflection is an involution
        return Householder(V=self.V[::-1], mode=self.mode)

    def canonicalize(self):
        V = self.V
        if V.ndim == 1:
            return Householder(V=V * lax.rsqrt(_dot(V, V)), mode=self.mode)
        nrm = lax.rsqrt(jnp.sum(V * V, axis=-1, keepdims=True))
        return Householder(V=V * nrm, mode=self.mode)
