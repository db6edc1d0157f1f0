"""Monotone rational-quadratic spline bijectors (neural-spline-flow family).

No reference counterpart: bat/EuclidianNormalizingFlows.jl's expressivity
tops out at "orthogonal rotation of independently warped marginals"
(/root/reference/src/ — elementwise warps + Householder) plus this repo's
affine couplings. Rational-quadratic splines (Durkan et al. 2019,
"Neural Spline Flows") are the standard step up: a piecewise monotone
map with K bins whose knot positions and derivatives are free parameters,
giving per-dimension multimodal warps while keeping every reference
contract from SURVEY.md §1 — analytic AD-free ladj (convention #4),
an exact parameter-sharing ``inverse()`` sibling (convention #5), and the
negated-ladj-at-output identity (convention #6, exact here because the
derivative of the inverse at y is 1/derivative of the forward at x).

Design notes:

* **Static shapes, no gathers in the hot math.** The bin locate step is
  ``sum(x >= interior_knots)`` over the K-1 interior knots — K is small
  (default 8), so this is a handful of fused compares, not a
  ``searchsorted`` with data-dependent layout. Per-element bin parameters
  are then picked with ``take_along_axis`` on a length-K trailing axis
  (a lane-local select at these sizes).
* **All elements evaluate all branches.** In-range and identity-tail
  results are combined with ``jnp.where`` — branchless, so XLA vectorizes
  the whole batch regardless of how many elements fall outside ``[-B, B]``.
* **Numerics.** Bin widths/heights go through a floored softmax
  (``min_bin`` floor) and knot derivatives through a floored softplus, so
  no bin can collapse and every slope stays positive in f32/bf16. The
  inverse solves the bin-local quadratic with the citardauq form
  ``2c / (-b - sqrt(b^2 - 4ac))`` which is stable when ``a -> 0`` (the
  affine-bin limit). Zero raw parameters give uniform bins with unit
  derivatives — the exact identity — so zero-initialized conditioners
  start coupling stacks at the identity map, like ``init_affine_coupling``.
"""
from __future__ import annotations

import math

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass
from .base import Bijector
from .coupling import MLPConditioner, Permute

Array = jax.Array

_MIN_BIN = 1e-3
_MIN_DERIV = 1e-3
# softplus(raw + _DERIV_SHIFT) == 1 - _MIN_DERIV at raw == 0, so zero raw
# parameters give exactly unit knot derivatives (identity spline).
_DERIV_SHIFT = math.log(math.expm1(1.0 - _MIN_DERIV))


def _knots(raw: Array, bound: float, min_bin: float) -> tuple[Array, Array]:
    """Floored softmax over the trailing axis -> (bin sizes, knot positions).

    ``raw: (..., K)`` -> sizes ``(..., K)`` summing to ``2 * bound`` with
    every bin at least ``2 * bound * min_bin``, and knots ``(..., K+1)``
    running exactly from ``-bound`` to ``+bound`` (endpoints pinned, not
    accumulated, so the tails join the identity region bit-exactly).
    """
    K = raw.shape[-1]
    probs = jax.nn.softmax(raw, axis=-1)
    probs = min_bin + (1.0 - min_bin * K) * probs
    sizes = 2.0 * bound * probs
    knots = -bound + jnp.cumsum(sizes, axis=-1)
    knots = jnp.concatenate(
        [jnp.full_like(knots[..., :1], -bound), knots[..., :-1],
         jnp.full_like(knots[..., :1], bound)], axis=-1)
    return sizes, knots


def _derivs(raw: Array, min_deriv: float) -> Array:
    """``raw: (..., K-1)`` interior knot slopes -> ``(..., K+1)`` with the
    boundary slopes pinned to 1 so the spline is C^1 with identity tails."""
    d_in = min_deriv + jax.nn.softplus(raw + _DERIV_SHIFT)
    one = jnp.ones_like(d_in[..., :1])
    return jnp.concatenate([one, d_in, one], axis=-1)


def rq_spline(x: Array, w_raw: Array, h_raw: Array, d_raw: Array, *,
              bound: float, inverse: bool = False,
              min_bin: float = _MIN_BIN,
              min_deriv: float = _MIN_DERIV) -> tuple[Array, Array]:
    """Elementwise monotone rational-quadratic spline on ``[-bound, bound]``.

    ``x: (...,)`` with parameter arrays broadcasting against it on the
    leading axes: ``w_raw, h_raw: (..., K)`` (unnormalized bin widths /
    heights), ``d_raw: (..., K-1)`` (unconstrained interior knot slopes).
    Identity with zero ladj outside the bound. Returns ``(y, elementwise
    ladj)``; with ``inverse=True`` evaluates the exact inverse map (closed
    form — the bin-local map is a degree-(2,2) rational whose inverse is a
    quadratic root) and its own ladj (= negated forward ladj at the
    pre-image, convention #6).
    """
    if d_raw.shape[-1] != w_raw.shape[-1] - 1:
        raise ValueError(
            f"expected K-1={w_raw.shape[-1] - 1} interior derivatives, got "
            f"{d_raw.shape[-1]}")
    widths, xk = _knots(w_raw, bound, min_bin)
    heights, yk = _knots(h_raw, bound, min_bin)
    d = _derivs(d_raw, min_deriv)
    K = w_raw.shape[-1]

    in_range = (x > -bound) & (x < bound)
    # Locate the bin against the *input-side* knots; clamp the out-of-range
    # lanes so every branch evaluates on valid (if meaningless) parameters.
    ref_knots = yk if inverse else xk
    idx = jnp.sum((x[..., None] >= ref_knots[..., 1:-1]).astype(jnp.int32),
                  axis=-1)
    idx = jnp.clip(idx, 0, K - 1)

    # Branchless per-element bin select via a one-hot contraction over the
    # (small) K axis instead of take_along_axis: the contraction fuses into
    # a fan of elementwise multiply-adds and never materializes broadcast
    # operands or a gather.
    onehot = (idx[..., None] ==
              jax.lax.broadcasted_iota(jnp.int32, idx.shape + (K,),
                                       idx.ndim)).astype(x.dtype)

    def pick(a: Array, shift: int = 0) -> Array:
        # a broadcasts against x.shape + (K or K+1,); shift selects a[k+1].
        sl = a[..., shift:shift + K] if a.shape[-1] != K else a
        return jnp.sum(sl * onehot, axis=-1)

    wk, hk = pick(widths), pick(heights)
    x0, y0 = pick(xk), pick(yk)
    d0, d1 = pick(d), pick(d, shift=1)
    s = hk / wk  # bin slope

    if inverse:
        dy = jnp.where(in_range, x - y0, 0.5 * hk)  # safe dummy off-range
        t = d1 + d0 - 2.0 * s
        a = hk * (s - d0) + dy * t
        b = hk * d0 - dy * t
        c = -s * dy
        disc = b * b - 4.0 * a * c
        # Monotonicity guarantees disc >= 0; clamp for f32 cancellation.
        root = jnp.sqrt(jnp.maximum(disc, 0.0))
        # Stable two-root form: q = -(b + sign(b) * sqrt(disc)) / 2 gives
        # roots c/q and q/a with no catastrophic cancellation in either
        # (the naive 2c / (-b - sqrt) loses all precision when b < 0 and
        # |4ac| << b^2 — observed as O(1) f32 round-trip errors). The
        # bin-local quadratic has f(0) = c <= 0 <= f(1), so exactly one
        # root lies in [0, 1]; pick it.
        q = -0.5 * (b + jnp.where(b >= 0.0, 1.0, -1.0) * root)
        r1 = jnp.where(q != 0.0, c / jnp.where(q != 0.0, q, 1.0), 0.0)
        r2 = jnp.where(a != 0.0, q / jnp.where(a != 0.0, a, 1.0), r1)
        eps = 1e-6
        use_r1 = (r1 >= -eps) & (r1 <= 1.0 + eps)
        xi = jnp.where(use_r1, r1, r2)
        xi = jnp.clip(xi, 0.0, 1.0)
        y = x0 + xi * wk
    else:
        xi = jnp.where(in_range, (x - x0) / wk, 0.5)
        xi = jnp.clip(xi, 0.0, 1.0)
        t = d1 + d0 - 2.0 * s
        y = y0 + hk * (s * xi * xi + d0 * xi * (1.0 - xi)) \
            / (s + t * xi * (1.0 - xi))

    omxi = 1.0 - xi
    t = d1 + d0 - 2.0 * s
    denom = s + t * xi * omxi
    num = s * s * (d1 * xi * xi + 2.0 * s * xi * omxi + d0 * omxi * omxi)
    ladj_fwd = jnp.log(num) - 2.0 * jnp.log(denom)

    y = jnp.where(in_range, y, x)
    ladj = jnp.where(in_range, -ladj_fwd if inverse else ladj_fwd, 0.0)
    return y, ladj


@pytree_dataclass(static=("inverted", "bound"))
class ElementwiseRQSpline(Bijector):
    """Unconditional per-dimension spline warp — a trainable generalization
    of the reference's fixed-form marginal warps (CenterStretch / Johnson,
    /root/reference/src/center_stretch.jl, johnson_trafo.jl): K bins buy a
    free-form monotone marginal instead of a 3-4 parameter family.

    ``w_raw, h_raw: (dim, K)`` and ``d_raw: (dim, K-1)`` (or leading-axis
    broadcastable shapes). ``inverse()`` shares parameters and flips a
    static flag (convention #5).
    """

    w_raw: Array
    h_raw: Array
    d_raw: Array
    inverted: bool = False
    bound: float = 5.0

    def forward_and_ladj(self, x: Array) -> tuple[Array, Array]:
        y, ladj = rq_spline(x, self.w_raw, self.h_raw, self.d_raw,
                            bound=self.bound, inverse=self.inverted)
        return y, jnp.sum(ladj, axis=-1)

    def inverse(self) -> "ElementwiseRQSpline":
        return self.replace(inverted=not self.inverted)


def init_elementwise_rq_spline(dim: int, n_bins: int = 8, *,
                               bound: float = 5.0,
                               dtype=jnp.float32) -> ElementwiseRQSpline:
    """Identity-initialized (uniform bins, unit derivatives)."""
    return ElementwiseRQSpline(
        w_raw=jnp.zeros((dim, n_bins), dtype),
        h_raw=jnp.zeros((dim, n_bins), dtype),
        d_raw=jnp.zeros((dim, n_bins - 1), dtype),
        bound=bound)


@pytree_dataclass(static=("split", "n_bins", "inverted", "bound"))
class RQSplineCoupling(Bijector):
    """Coupling layer whose transformed half goes through per-dimension
    rational-quadratic splines conditioned on the untouched half.

    The conditioner maps ``(..., split) -> (..., d_b * (3 * n_bins - 1))``
    (per transformed dim: K widths, K heights, K-1 interior derivatives) —
    one matmul stack, exactly like :class:`AffineCoupling`, with the
    spline evaluation a fixed fan of elementwise ops after it. ``inverse()`` flips
    a static flag: ``y_a == x_a`` so the inverse re-runs the *same*
    conditioner and applies the closed-form spline inverse (convention #5).
    """

    conditioner: MLPConditioner
    split: int
    n_bins: int = 8
    inverted: bool = False
    bound: float = 5.0

    def forward_and_ladj(self, x: Array) -> tuple[Array, Array]:
        x_a, x_b = x[..., : self.split], x[..., self.split:]
        K = self.n_bins
        h = self.conditioner(x_a)
        d_b = x_b.shape[-1]
        if h.shape[-1] != d_b * (3 * K - 1):
            raise ValueError(
                f"conditioner emits {h.shape[-1]} params but the spline "
                f"needs {d_b} * (3*{K}-1) = {d_b * (3 * K - 1)} "
                f"(event dim {x.shape[-1]}, split {self.split})")
        p = h.reshape(*h.shape[:-1], d_b, 3 * K - 1)
        y_b, ladj = rq_spline(
            x_b, p[..., :K], p[..., K:2 * K], p[..., 2 * K:],
            bound=self.bound, inverse=self.inverted)
        return (jnp.concatenate([x_a, y_b], axis=-1),
                jnp.sum(ladj, axis=-1))

    def inverse(self) -> "RQSplineCoupling":
        return self.replace(inverted=not self.inverted)


def init_rq_spline_coupling(key: Array, dim: int, hidden=(64, 64), *,
                            n_bins: int = 8, split: int | None = None,
                            bound: float = 5.0, activation: str = "gelu",
                            dtype=jnp.float32,
                            compute_dtype: str | None = None
                            ) -> RQSplineCoupling:
    """Identity-initialized spline coupling (zeroed final conditioner
    layer -> uniform bins + unit derivatives -> exact identity)."""
    import numpy as np

    if dim < 2:
        raise ValueError("coupling needs event dim >= 2")
    d_a = dim // 2 if split is None else split
    if not 0 < d_a < dim:
        raise ValueError(
            f"split must satisfy 0 < split < dim (got split={d_a}, "
            f"dim={dim})")
    d_b = dim - d_a
    sizes = (d_a,) + tuple(hidden) + (d_b * (3 * n_bins - 1),)
    layers = []
    keys = jax.random.split(key, len(sizes) - 1)
    for i, (fan_in, fan_out) in enumerate(zip(sizes[:-1], sizes[1:])):
        if i == len(sizes) - 2:
            W = jnp.zeros((fan_in, fan_out), dtype)
        else:
            W = jax.random.normal(keys[i], (fan_in, fan_out), dtype) \
                * jnp.asarray(np.sqrt(2.0 / fan_in), dtype)
        layers.append((W, jnp.zeros((fan_out,), dtype)))
    cond = MLPConditioner(layers=tuple(layers), activation=activation,
                          compute_dtype=compute_dtype)
    return RQSplineCoupling(conditioner=cond, split=d_a, n_bins=n_bins,
                            bound=bound)


def spline_coupling_stack(key: Array, dim: int, n_layers: int = 4,
                          hidden=(64, 64), *, n_bins: int = 8,
                          bound: float = 5.0, activation: str = "gelu",
                          dtype=jnp.float32,
                          compute_dtype: str | None = None) -> Bijector:
    """``n_layers`` identity-initialized spline couplings with reversal
    permutes in between (mirrors :func:`coupling_stack`)."""
    from .base import Chain

    rev = Permute(perm=tuple(range(dim - 1, -1, -1)))
    stages: list[Bijector] = []
    for i, k in enumerate(jax.random.split(key, n_layers)):
        if i:
            stages.append(rev)
        stages.append(init_rq_spline_coupling(
            k, dim, hidden, n_bins=n_bins, bound=bound,
            activation=activation, dtype=dtype,
            compute_dtype=compute_dtype))
    return Chain.of(*stages)
