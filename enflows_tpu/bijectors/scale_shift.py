"""Elementwise affine bijector ``y = a * x + b``.

Counterpart of ``ScaleShiftTrafo``
(/root/reference/src/scale_shift_trafo.jl:4-30). Params may be scalars or
per-dimension vectors (broadcast against the trailing event axis). Unlike the
reference (which only defines ladj for vector-params × matrix-x,
scale_shift_trafo.jl:18-24), ladj works for every input rank here.

``inverse`` numerically inverts the parameters — the one reference bijector
that does (convention #5 exception, /root/reference/src/scale_shift_trafo.jl:26-30).
"""
from __future__ import annotations

import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass
from .base import Bijector, sum_ladjs


@pytree_dataclass
class ScaleShift(Bijector):
    a: jnp.ndarray
    b: jnp.ndarray

    def forward(self, x):
        return x * self.a + self.b

    def forward_and_ladj(self, x):
        y = x * self.a + self.b
        # Constant per-sample ladj: sum(log|a|) broadcast over the event axis
        # (the reference materializes it as a full 1×batch row via
        # similar_fill, scale_shift_trafo.jl:22-23; XLA folds this for free).
        elem = jnp.broadcast_to(jnp.log(jnp.abs(self.a)), jnp.shape(y))
        return y, sum_ladjs(elem)

    def inverse(self):
        a_inv = 1.0 / self.a
        return ScaleShift(a=a_inv, b=-a_inv * self.b)
