"""Affine coupling bijector (RealNVP-style) + static Permute.

No reference counterpart: bat/EuclidianNormalizingFlows.jl's bijector
library (/root/reference/src/) is elementwise transforms plus Householder
rotations, which caps the dependence structure its flows can express at
"orthogonal rotation of independently warped marginals". Coupling layers
are the canonical way normalizing-flow frameworks express learnable
*conditional* structure while keeping the reference's core contracts
(SURVEY.md §1): analytic AD-free ladj (convention #4), an exact
parameter-sharing inverse (convention #5), and per-sample ladj vectors.

Design notes:

* The conditioner is a dense MLP — all FLOPs are ``(batch, d_a) @ (d_a, h)``
  matmuls that XLA hands to the GPU's GEMM library; no gathers, no masks in
  the hot path. The event split is a static *contiguous* slice (``x[..., :d_a]`` /
  ``x[..., d_a:]``), so XLA sees fixed shapes and zero relayout; alternation
  between layers is done by composing with :class:`Permute` (a static
  permutation, free at trace time for small event dims).
* The log-scale is soft-clamped, ``s = max_log_scale * tanh(s_raw /
  max_log_scale)`` — smooth, exactly invertible, and keeps ``exp(s)``
  bounded in bf16/f32 so deep stacks cannot overflow during early training.
* ``init_affine_coupling`` zero-initializes the final conditioner layer, so
  a fresh stack is exactly the identity map — the standard stable
  initialization, and the analogue of the reference examples' identity-ish
  starting flows (/root/reference/examples/nf_example_1d.jl:19-23).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..utils.pytree import pytree_dataclass
from .base import Bijector

Array = jax.Array

_ACTIVATIONS = {
    "tanh": jnp.tanh,
    "gelu": jax.nn.gelu,
    "relu": jax.nn.relu,
    "silu": jax.nn.silu,
}


@pytree_dataclass(static=("activation", "compute_dtype"))
class MLPConditioner:  # plain callable pytree, not a Bijector
    """Dense MLP ``(..., d_in) -> (..., d_out)``; weights are pytree leaves.

    ``layers`` is a tuple of ``(W, b)`` pairs with ``W: (fan_in, fan_out)``
    — batch-major matmuls, no transposes.

    Precision: float32 matmuls run at JAX's default matmul precision,
    which on an NVIDIA GPU lets the tensor cores compute them in TF32;
    wrap a call in ``jax.default_matmul_precision("float32")`` for full
    float32 products. ``compute_dtype='bfloat16'`` runs the matmuls in bf16
    while parameters and the output stay in the parameter dtype. This is SAFE for invertibility: the coupling inverse
    recomputes the *same* conditioner on the untouched half, so forward and
    inverse see bit-identical (s, t) and the round trip stays exact — lower
    precision only perturbs *which* bijection is represented, never breaks
    it. The ladj (sum of s) is likewise consistent by construction.
    """

    layers: tuple
    activation: str = "gelu"
    compute_dtype: str | None = None

    def __call__(self, x: Array) -> Array:
        act = _ACTIVATIONS[self.activation]
        out_dtype = self.layers[-1][0].dtype
        cd = jnp.dtype(self.compute_dtype) if self.compute_dtype else None
        h = x.astype(cd) if cd else x
        for i, (W, b) in enumerate(self.layers):
            if cd:
                W, b = W.astype(cd), b.astype(cd)
            h = h @ W + b
            if i + 1 < len(self.layers):
                h = act(h)
        return h.astype(out_dtype)


@pytree_dataclass(static=("split", "inverted", "max_log_scale"))
class AffineCoupling(Bijector):
    """``y = [x_a, x_b * exp(s) + t]`` with ``(s, t) = conditioner(x_a)``.

    ``split`` = ``d_a``, the (static) number of untouched leading dims;
    the conditioner must map ``(..., d_a) -> (..., 2 * d_b)`` where
    ``d_b = dim - d_a`` (first half ``s_raw``, second half ``t``).
    ladj = ``sum(s)`` over the transformed dims — analytic, AD-free.

    ``inverse()`` returns a parameter-sharing sibling (``inverted`` flag
    flipped): since ``y_a == x_a``, the inverse re-runs the *same*
    conditioner on ``y_a`` and solves ``x_b = (y_b - t) * exp(-s)`` exactly
    (reference convention #5, and the #6 negated-ladj-at-output identity
    holds by construction because ``s`` depends only on the untouched part).
    """

    conditioner: MLPConditioner
    split: int
    inverted: bool = False
    max_log_scale: float = 3.0

    def _s_t(self, x_a: Array) -> tuple[Array, Array]:
        h = self.conditioner(x_a)
        if h.shape[-1] % 2:
            raise ValueError(
                f"conditioner output width {h.shape[-1]} must be even "
                "(first half log-scale, second half shift)")
        d_b = h.shape[-1] // 2
        s_raw, t = h[..., :d_b], h[..., d_b:]
        m = self.max_log_scale
        return m * jnp.tanh(s_raw / m), t

    def forward_and_ladj(self, x: Array) -> tuple[Array, Array]:
        x_a, x_b = x[..., : self.split], x[..., self.split:]
        s, t = self._s_t(x_a)
        if s.shape[-1] != x_b.shape[-1]:
            raise ValueError(
                f"conditioner emits {s.shape[-1]} (s, t) pairs but the "
                f"transformed half has {x_b.shape[-1]} dims "
                f"(event dim {x.shape[-1]}, split {self.split})")
        if self.inverted:
            y_b = (x_b - t) * jnp.exp(-s)
            ladj = -jnp.sum(s, axis=-1)
        else:
            y_b = x_b * jnp.exp(s) + t
            ladj = jnp.sum(s, axis=-1)
        return jnp.concatenate([x_a, y_b], axis=-1), ladj

    def inverse(self) -> "AffineCoupling":
        return self.replace(inverted=not self.inverted)


@pytree_dataclass(static=("perm",))
class Permute(Bijector):
    """Static event-dim permutation ``y[..., i] = x[..., perm[i]]``.

    Volume-preserving (ladj = 0); ``inverse()`` holds the argsorted
    permutation. Used between coupling layers so every dimension gets
    transformed (the classic RealNVP alternation).
    """

    perm: tuple

    def forward(self, x: Array) -> Array:
        return x[..., np.asarray(self.perm)]

    def forward_and_ladj(self, x: Array) -> tuple[Array, Array]:
        y = self.forward(x)
        return y, jnp.zeros(jnp.shape(x)[:-1],
                            dtype=jnp.result_type(x, jnp.float32))

    def inverse(self) -> "Permute":
        return Permute(perm=tuple(int(i) for i in np.argsort(self.perm)))


def init_affine_coupling(key: Array, dim: int, hidden=(64, 64), *,
                         split: int | None = None, activation: str = "gelu",
                         max_log_scale: float = 3.0, dtype=jnp.float32,
                         compute_dtype: str | None = None) -> AffineCoupling:
    """Identity-initialized coupling layer (zeroed final layer)."""
    if dim < 2:
        raise ValueError("coupling needs event dim >= 2")
    d_a = dim // 2 if split is None else split
    if not 0 < d_a < dim:
        raise ValueError(
            f"split must satisfy 0 < split < dim (got split={d_a}, "
            f"dim={dim}); split=0 would be a constant shift and "
            f"split>=dim an identity layer")
    d_b = dim - d_a
    sizes = (d_a,) + tuple(hidden) + (2 * d_b,)
    layers = []
    keys = jax.random.split(key, len(sizes) - 1)
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        last = i == len(sizes) - 2
        if last:
            W = jnp.zeros((fan_in, fan_out), dtype)
        else:
            W = jax.random.normal(keys[i], (fan_in, fan_out), dtype) \
                * jnp.asarray(np.sqrt(2.0 / fan_in), dtype)
        layers.append((W, jnp.zeros((fan_out,), dtype)))
    cond = MLPConditioner(layers=tuple(layers), activation=activation,
                          compute_dtype=compute_dtype)
    return AffineCoupling(conditioner=cond, split=d_a,
                          max_log_scale=max_log_scale)


def coupling_stack(key: Array, dim: int, n_layers: int = 4, hidden=(64, 64),
                   *, activation: str = "gelu", max_log_scale: float = 3.0,
                   dtype=jnp.float32,
                   compute_dtype: str | None = None) -> "Bijector":
    """``n_layers`` identity-initialized couplings with reversal permutes
    in between, as a :class:`Chain` (applied first-to-last)."""
    from .base import Chain

    rev = Permute(perm=tuple(range(dim - 1, -1, -1)))
    stages: list[Bijector] = []
    for i, k in enumerate(jax.random.split(key, n_layers)):
        if i:
            stages.append(rev)
        stages.append(init_affine_coupling(
            k, dim, hidden, activation=activation,
            max_log_scale=max_log_scale, dtype=dtype,
            compute_dtype=compute_dtype))
    return Chain.of(*stages)
