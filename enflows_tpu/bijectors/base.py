"""Bijector protocol: composable trainable transforms with analytic ladjs.

Redesign of the reference's bijector algebra
(/root/reference/src/abstract_trafo.jl, and the InverseFunctions /
ChangesOfVariables protocols it extends — see SURVEY.md §1). Key contracts
preserved from the reference:

* ``forward_and_ladj`` returns the transformed batch together with the
  per-sample log-abs-det-Jacobian, computed **analytically** (AD-free) —
  reference convention #4 (SURVEY.md §1).
* ``inverse()`` returns a parameter-*sharing* sibling bijector, not a
  numerically-inverted one — reference convention #5
  (/root/reference/src/center_stretch.jl:45, johnson_trafo.jl:82).
* The inverse-direction ladj is the negated forward ladj evaluated at the
  output — reference convention #6 (/root/reference/src/center_stretch.jl:39-43).

Array convention (deliberately changed from the reference's ``(dim, batch)``
column-major layout, /root/reference/src/optimize_whitening.jl:8): arrays are
``(..., dim)`` with the **event dimension last** — idiomatic for JAX `vmap`,
`NamedSharding` batch axes, and XLA's lane-major tiling. Per-sample ladjs have
shape ``x.shape[:-1]`` (the reference's ``1×batch`` adjoint row,
/root/reference/src/abstract_trafo.jl:9, becomes a plain ``(batch,)`` vector).
"""
from __future__ import annotations

from typing import Any, Sequence

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass

Array = jax.Array


def sum_ladjs(elementwise_ladjs: Array) -> Array:
    """Collapse per-element ladjs to per-sample ladjs.

    Mirrors ``sum_ladjs`` (/root/reference/src/abstract_trafo.jl:7-9): scalar
    input stays scalar; otherwise sum over the trailing event axis, leaving
    the batch shape.
    """
    if jnp.ndim(elementwise_ladjs) == 0:
        return elementwise_ladjs
    return jnp.sum(elementwise_ladjs, axis=-1)


class Bijector:
    """Base class. Subclasses are pytree dataclasses (see utils.pytree).

    Subclasses implement ``forward``, ``forward_and_ladj`` and ``inverse``;
    everything else (``__call__``, composition via ``>>``, canonicalization)
    is shared. Bijectors are immutable pytrees: jit/grad/optax traverse
    their parameter leaves directly.
    """

    def forward(self, x: Array) -> Array:
        y, _ = self.forward_and_ladj(x)
        return y

    def forward_and_ladj(self, x: Array) -> tuple[Array, Array]:
        raise NotImplementedError

    def inverse(self) -> "Bijector":
        raise NotImplementedError

    def inverse_and_ladj(self, y: Array) -> tuple[Array, Array]:
        return self.inverse().forward_and_ladj(y)

    def canonicalize(self) -> "Bijector":
        """Return a normalized copy after an optimizer step.

        Replaces the reference's re-normalization inside Functors
        reconstruction (/root/reference/src/householder_trafo.jl:141-146):
        JAX optimizer updates are explicit, so normalization is too.
        Default: identity. Containers recurse.
        """
        return self

    def __call__(self, x: Array) -> Array:
        return self.forward(x)

    def __rshift__(self, other: "Bijector") -> "Chain":
        """``f >> g`` applies f first, then g (data-flow order)."""
        return Chain.of(self, other)


@pytree_dataclass
class Identity(Bijector):
    def forward(self, x):
        return x

    def forward_and_ladj(self, x):
        return x, jnp.zeros(jnp.shape(x)[:-1] if jnp.ndim(x) else (),
                            dtype=jnp.result_type(x, jnp.float32))

    def inverse(self):
        return self


@pytree_dataclass
class Chain(Bijector):
    """Composition of bijectors, applied ``stages[0]`` first.

    The replacement for Julia ``Base.∘`` over ``Function``
    subtypes (reference convention #3, SURVEY.md §1): ladjs accumulate
    per-sample across stages (/root/reference call stack §3.2), and
    ``inverse`` reverses stage order with each stage inverted
    (InverseFunctions' ComposedFunction rule, call stack §3.4).
    """

    stages: tuple[Bijector, ...]

    @classmethod
    def of(cls, *stages: Bijector) -> "Chain":
        flat: list[Bijector] = []
        for s in stages:
            if isinstance(s, Chain):
                flat.extend(s.stages)
            elif isinstance(s, Identity):
                continue
            else:
                flat.append(s)
        return cls(stages=tuple(flat))

    def forward(self, x):
        for s in self.stages:
            x = s.forward(x)
        return x

    def forward_and_ladj(self, x):
        y, ladj = x, None
        for s in self.stages:
            y, l = s.forward_and_ladj(y)
            ladj = l if ladj is None else ladj + l
        if ladj is None:
            return Identity().forward_and_ladj(x)
        return y, ladj

    def inverse(self):
        return Chain(stages=tuple(s.inverse() for s in reversed(self.stages)))

    def canonicalize(self):
        return Chain(stages=tuple(s.canonicalize() for s in self.stages))

    def __len__(self):
        return len(self.stages)

    def __getitem__(self, i):
        return self.stages[i]


def compose(*fs: Bijector) -> Chain:
    """Mathematical composition ``compose(f, g)(x) == f(g(x))``.

    Matches the reference examples' ``f3 ∘ f2 ∘ f1`` reading order
    (/root/reference/examples/nf_example_2d.jl:12-15): the *last* argument
    is applied first.
    """
    return Chain.of(*reversed(fs))


def invert(f: Bijector) -> Bijector:
    """Functional spelling of ``f.inverse()`` (InverseFunctions.inverse)."""
    return f.inverse()


def forward_and_ladj(f: Bijector, x: Array) -> tuple[Array, Array]:
    """ChangesOfVariables.with_logabsdet_jacobian equivalent."""
    return f.forward_and_ladj(x)
