"""Johnson SU distribution: a standard normal pushed through JohnsonInv.

Counterpart of the reference's ``JohnsonSU <: Distribution``
(/root/reference/src/johnson_trafo.jl:1-26,120-129): pdf/cdf/logpdf/quantile
are defined by mapping through the Johnson transform and its derivative;
sampling pushes standard-normal draws through the inverse transform (the
reference gets ``rand`` for free from ``quantile`` via a Distributions.jl
fallback — here sampling is the direct, vectorizable path).

Parameter defaults match the reference (gamma=10, delta=3.5, xi=10, lambda=1,
johnson_trafo.jl:9-13).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax.scipy.stats import norm as _norm
from jax.scipy.special import ndtri

from ..utils.pytree import pytree_dataclass
from ..bijectors.johnson import (
    johnson_forward, johnson_inverse, johnson_ladj,
)


@pytree_dataclass
class JohnsonSU:
    gamma: jnp.ndarray
    delta: jnp.ndarray
    xi: jnp.ndarray
    lam: jnp.ndarray

    @classmethod
    def init(cls, gamma=10.0, delta=3.5, xi=10.0, lam=1.0,
             dtype=jnp.float32):
        return cls(gamma=jnp.asarray(gamma, dtype),
                   delta=jnp.asarray(delta, dtype),
                   xi=jnp.asarray(xi, dtype),
                   lam=jnp.asarray(lam, dtype))

    def _z(self, x):
        return johnson_forward(x, self.gamma, self.delta, self.xi, self.lam)

    def logpdf(self, x):
        # log pdf = ladj(x) + logN(z(x)) — the log of reference pdf :120.
        return (johnson_ladj(x, self.gamma, self.delta, self.xi, self.lam)
                + _norm.logpdf(self._z(x)))

    def pdf(self, x):
        return jnp.exp(self.logpdf(x))

    def cdf(self, x):
        return _norm.cdf(self._z(x))

    def logcdf(self, x):
        return _norm.logcdf(self._z(x))

    def ccdf(self, x):
        return _norm.sf(self._z(x))

    def logccdf(self, x):
        return _norm.logsf(self._z(x))

    def quantile(self, p):
        return johnson_inverse(ndtri(p), self.gamma, self.delta,
                               self.xi, self.lam)

    def sample(self, key, shape=()):
        z = jax.random.normal(key, shape, dtype=jnp.result_type(self.gamma))
        return johnson_inverse(z, self.gamma, self.delta, self.xi, self.lam)

    # Distributions-API surface (reference johnson_trafo.jl:15-22).
    def minimum(self):
        return -jnp.inf

    def maximum(self):
        return jnp.inf

    def params(self):
        """(gamma, delta, xi, lambda) — StatsBase.params equivalent."""
        return (self.gamma, self.delta, self.xi, self.lam)

    def location(self):
        return self.mean()

    def scale(self):
        return self.var()

    # Analytic moments (reference johnson_trafo.jl:24-26).
    def mean(self):
        d2 = 1.0 / (self.delta * self.delta)
        return (self.xi - self.lam * jnp.exp(d2 / 2.0)
                * jnp.sinh(self.gamma / self.delta))

    def median(self):
        return self.xi + self.lam * jnp.sinh(-self.gamma / self.delta)

    def var(self):
        d2 = 1.0 / (self.delta * self.delta)
        return (self.lam ** 2 / 2.0 * (jnp.exp(d2) - 1.0)
                * (jnp.exp(d2) * jnp.cosh(2.0 * self.gamma / self.delta)
                   + 1.0))
