"""Pytree-registered dataclasses for bijectors and inference state.

Replacement for the reference's Functors.jl `@functor` mechanism
(see /root/reference/src/EuclidianNormalizingFlows.jl:38-40): every bijector
and state object is a frozen dataclass registered as a JAX pytree so that
`jax.jit` / `jax.grad` / optax / shardings traverse its parameters natively.

Unlike Functors.jl, reconstruction does NOT mutate leaves (the reference
re-normalizes Householder vectors inside `Functors.functor`,
/root/reference/src/householder_trafo.jl:141-146 — in JAX that would corrupt
tangent semantics). Canonicalization after an optimizer step is explicit via
`Bijector.canonicalize()` instead.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, TypeVar

import jax

T = TypeVar("T")


def pytree_dataclass(cls: type[T] | None = None, *, static: tuple[str, ...] = ()):
    """Decorate a class as a frozen dataclass registered as a JAX pytree.

    Fields named in ``static`` become auxiliary (hashable, compile-time)
    data; all other fields are child pytrees (trainable leaves).
    """

    def wrap(c: type[T]) -> type[T]:
        c = dataclasses.dataclass(frozen=True, eq=False)(c)
        data_fields = tuple(
            f.name for f in dataclasses.fields(c) if f.name not in static
        )
        meta_fields = tuple(
            f.name for f in dataclasses.fields(c) if f.name in static
        )

        def flatten(obj):
            children = tuple(getattr(obj, name) for name in data_fields)
            aux = tuple(getattr(obj, name) for name in meta_fields)
            return children, aux

        def flatten_with_keys(obj):
            children = tuple(
                (jax.tree_util.GetAttrKey(name), getattr(obj, name))
                for name in data_fields
            )
            aux = tuple(getattr(obj, name) for name in meta_fields)
            return children, aux

        def unflatten(aux, children):
            kwargs = dict(zip(data_fields, children))
            kwargs.update(zip(meta_fields, aux))
            return object.__new__(c).__init_shim__(**kwargs)

        # Bypass __init__ (which may run __post_init__ checks on tracers).
        def __init_shim__(self, **kwargs):
            for k, v in kwargs.items():
                object.__setattr__(self, k, v)
            return self

        c.__init_shim__ = __init_shim__

        def _eq(a, b):
            if type(a) is not type(b):
                return NotImplemented
            la, ta = jax.tree_util.tree_flatten(a)
            lb, tb = jax.tree_util.tree_flatten(b)
            if ta != tb:
                return False
            import numpy as np

            return all(np.array_equal(x, y) for x, y in zip(la, lb))

        c.__eq__ = _eq
        # Hash covers only static (aux) fields: array leaves are unhashable
        # and pytree equality is value-based, so two bijectors differing
        # only in parameters hash EQUAL (consistent — eq implies same hash —
        # but coarse). This intentionally diverges from the reference, which
        # hashes parameter values (/root/reference/src/center_stretch.jl:35):
        # do not use these objects as dict keys expecting parameter-level
        # discrimination.
        c.__hash__ = lambda self: hash(
            (type(self).__name__,) + tuple(
                getattr(self, name) for name in meta_fields
            )
        )

        def _replace(self, **changes):
            return dataclasses.replace(self, **changes)

        c.replace = _replace

        jax.tree_util.register_pytree_with_keys(
            c, flatten_with_keys, unflatten, flatten
        )
        return c

    if cls is None:
        return wrap
    return wrap(cls)


def field(**kwargs) -> Any:
    return dataclasses.field(**kwargs)


def param_dtype(tree):
    """Common (promoted) dtype of a pytree's array leaves — the JAX
    equivalent of the reference's ``Distributions.partype`` param-dtype
    introspection (/root/reference/src/johnson_trafo.jl:19). Works on any
    bijector/distribution/state pytree; returns float32 for a leafless
    tree (the library default dtype)."""
    import jax.numpy as jnp

    leaves = [l for l in jax.tree_util.tree_leaves(tree)
              if hasattr(l, "dtype") or isinstance(l, (int, float, complex))]
    if not leaves:
        return jnp.dtype(jnp.float32)
    return jnp.result_type(*leaves)
