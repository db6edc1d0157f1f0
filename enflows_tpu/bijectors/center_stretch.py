"""CenterStretch / CenterContract: smooth move-mass-from/toward-center pair.

Counterpart of /root/reference/src/center_stretch.jl. The
*contract* direction is a double-softplus

    y = (softplus(b*(x - c - a)) - softplus(-b*(x - c + a))) / b

(center_contract, reference :11-15), with analytic elementwise ladj

    log| sigmoid(b*(x-c-a)) + sigmoid(-b*(x-c+a)) |

(center_contract_ladj, reference :17-22). The *stretch* direction is its
closed-form inverse; the reference's expression (center_stretch, :4-8)
overflows at |b*x| ≳ 88 in float32 (it materializes exp(|b x|)), so here it
is re-derived fully in the log domain (SURVEY.md §7 hard part (d)):

with m = |b x|, q = exp(-a b), solving the contract equation for s = e^{b t}
gives the quadratic  q s^2 + (1 - e^m) s - e^m q = 0, whose positive root in
log form is

    log s = m + a b - log 2 + logaddexp(log A, 0.5 * logaddexp(2 log A, log B))
    log A = log1p(-e^{-m}),   log B = log 4 - 2 a b - m

and y = c + sign(x) * log(s)/b  (odd symmetry of the map around x = 0, the
same sign trick as the reference).

Overflow domain (ADVICE r3): the f32 path uses a round-3 single-exp form
that materializes exp(±2ab), which assumes ``a*b >= 0`` — the natural
parameter domain (a = half-width >= 0, b = sharpness > 0); for a*b < -44
it would overflow f32. Within that domain no term overflows for finite
b*x (exp(2ab) -> inf for a*b > 44 only drives one sigmoid term to its
correct limit of 0). f64 inputs dispatch to the fully log-domain
logaddexp form (``_center_stretch_logdomain``), which is the
high-precision oracle: measured f64 roundtrip error 5.7e-13 vs 1.7e-7
for the single-exp form in small-b regimes (a=2, b=0.05).

Forward (stretch) ladj uses the reference's inverse-ladj-at-output trick:
``-contract_ladj(y)`` (convention #6, reference :39-43).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp

from ..utils.pytree import pytree_dataclass
from .base import Bijector, sum_ladjs

_LOG2 = 0.6931471805599453
_LOG4 = 1.3862943611198906


def center_contract(x, a, b, c):
    xu = x - c
    sp = jax.nn.softplus
    return (sp(b * (xu - a)) - sp(-b * (xu + a))) / b


def center_contract_ladj(x, a, b, c):
    """Elementwise log|dy/dx| of center_contract (reference :17-22)."""
    xu = x - c
    dy_dx = jax.nn.sigmoid(b * (xu - a)) + jax.nn.sigmoid(-b * (xu + a))
    return jnp.log(jnp.abs(dy_dx))


def _center_stretch_logdomain(x, a, b, c):
    """Fully log-domain quadratic-root form (the module doc's logaddexp
    chain). 5 exp/log per element but no exp(±2ab) materialization and
    the best measured f64 roundtrip precision (5.7e-13 small-b) — the
    high-precision oracle and the f64 dispatch target (ADVICE r3)."""
    m = jnp.maximum(jnp.abs(b * x), 1e-6)
    ab = a * b
    log_a_ = jnp.log1p(-jnp.exp(-m))
    log_b_ = _LOG4 - 2.0 * ab - m
    log_s = m + ab - _LOG2 + jnp.logaddexp(
        log_a_, 0.5 * jnp.logaddexp(2.0 * log_a_, log_b_))
    return c + jnp.sign(x) * log_s / b


def center_stretch(x, a, b, c):
    """Closed-form inverse of center_contract (see module doc).

    f32/bf16: round-3 single-exp form — with em = e^{-m}, the quadratic
    root's logaddexp chain collapses algebraically (e^{log1p(-em)} =
    1 - em and e^{logaddexp(...)/2} is a sqrt), leaving ONE exp and ONE
    log per element instead of five of each. Assumes a*b >= 0 (the
    natural parameter domain; exp(-2ab) overflows f32 below ab ~ -44 —
    module doc). f64: dispatches to the log-domain form, whose roundtrip
    precision is ~6 decimal digits better in small-b regimes."""
    if jnp.result_type(x, a, b, c) == jnp.float64:
        return _center_stretch_logdomain(x, a, b, c)
    m = jnp.abs(b * x)
    m = jnp.maximum(m, 1e-6)
    ab = a * b
    em = jnp.exp(-m)
    one_m = 1.0 - em
    c1 = 4.0 * jnp.exp(-2.0 * ab)
    r = jnp.sqrt(one_m * one_m + c1 * em)
    log_s = m + ab - _LOG2 + jnp.log(one_m + r)
    return c + jnp.sign(x) * log_s / b


@pytree_dataclass
class CenterStretch(Bijector):
    """Stretch mass away from the center (reference :25-45).

    Params ``a`` (half-width), ``b`` (sharpness, > 0), ``c`` (center);
    scalars or per-dim vectors. Defaults a=0, b=1, c=0 give the identity.
    """

    a: jnp.ndarray
    b: jnp.ndarray
    c: jnp.ndarray

    @classmethod
    def init(cls, a=0.0, b=1.0, c=0.0, dtype=jnp.float32):
        return cls(a=jnp.asarray(a, dtype), b=jnp.asarray(b, dtype),
                   c=jnp.asarray(c, dtype))

    def forward(self, x):
        return center_stretch(x, self.a, self.b, self.c)

    def forward_and_ladj(self, x):
        # Same convention-#6 value as -contract_ladj(y) but computed by
        # sharing the forward's em/denom intermediates (the e^{ab}
        # factors cancel into ae = 2 em/denom), so the whole fwd+ladj is
        # 1 exp + 2 log + 1 sqrt per element (the round-3 single-exp
        # derivation). Assumes a*b >= 0 (module doc); f64 takes the high-precision
        # log-domain path.
        if jnp.result_type(x, self.a, self.b, self.c) == jnp.float64:
            y = _center_stretch_logdomain(x, self.a, self.b, self.c)
            elem = -center_contract_ladj(y, self.a, self.b, self.c)
            return y, sum_ladjs(jnp.broadcast_to(elem, jnp.shape(y)))
        m = jnp.maximum(jnp.abs(self.b * x), 1e-6)
        ab = self.a * self.b
        em = jnp.exp(-m)
        one_m = 1.0 - em
        c1 = 4.0 * jnp.exp(-2.0 * ab)
        r = jnp.sqrt(one_m * one_m + c1 * em)
        denom = one_m + r
        log_s = m + ab - _LOG2 + jnp.log(denom)
        y = self.c + jnp.sign(x) * log_s / self.b
        ae = 2.0 * em / denom
        a2 = jnp.exp(2.0 * ab)
        s_sum = 1.0 / (1.0 + ae) + ae / (ae + a2)
        elem = -jnp.log(s_sum)
        return y, sum_ladjs(jnp.broadcast_to(elem, jnp.shape(y)))

    def inverse(self):
        return CenterContract(a=self.a, b=self.b, c=self.c)


@pytree_dataclass
class CenterContract(Bijector):
    """Contract mass toward the center (reference :49-69)."""

    a: jnp.ndarray
    b: jnp.ndarray
    c: jnp.ndarray

    @classmethod
    def init(cls, a=0.0, b=1.0, c=0.0, dtype=jnp.float32):
        return cls(a=jnp.asarray(a, dtype), b=jnp.asarray(b, dtype),
                   c=jnp.asarray(c, dtype))

    def forward(self, x):
        return center_contract(x, self.a, self.b, self.c)

    def forward_and_ladj(self, x):
        y = self.forward(x)
        elem = center_contract_ladj(x, self.a, self.b, self.c)
        return y, sum_ladjs(jnp.broadcast_to(elem, jnp.shape(y)))

    def inverse(self):
        return CenterStretch(a=self.a, b=self.b, c=self.c)
