"""Float64 NumPy reference for the elementwise + Householder bijector chain.

An implementation of the stage formulas independent of the JAX code under
test (SURVEY.md §1 formulas; center-stretch through its log-domain
quadratic root). ``reference_forward_and_ladj(chain, x)`` reads the stage
parameters from a JAX chain and evaluates it in float64 NumPy.
"""
from __future__ import annotations

import numpy as np

import enflows_tpu as ef

_LOG2 = np.log(2.0)


def _softplus(u):
    return np.maximum(u, 0.0) + np.log1p(np.exp(-np.abs(u)))


def _sigmoid(u):
    return 0.5 * (1.0 + np.tanh(0.5 * u))


def _contract(x, a, b, c):
    xu = x - c
    y = (_softplus(b * (xu - a)) - _softplus(-b * (xu + a))) / b
    elem = np.log(_sigmoid(b * (xu - a)) + _sigmoid(-b * (xu + a)))
    return y, elem


def _stretch(x, a, b, c):
    m = np.maximum(np.abs(b * x), 1e-12)
    ab = a * b
    log_a = np.log1p(-np.exp(-m))
    log_b = np.log(4.0) - 2.0 * ab - m
    log_s = m + ab - _LOG2 + np.logaddexp(
        log_a, 0.5 * np.logaddexp(2.0 * log_a, log_b))
    y = c + np.sign(x) * log_s / b
    _, elem_c = _contract(y, a, b, c)
    return y, -elem_c


def _johnson(x, g, d, xi, lam):
    u = (x - xi) / lam
    return g + d * np.arcsinh(u), np.log(np.abs(d / lam)) - 0.5 * np.log1p(u * u)


def _johnson_inv(y, g, d, xi, lam):
    v = (y - g) / d
    logcosh = np.abs(v) + np.log1p(np.exp(-2.0 * np.abs(v))) - _LOG2
    return lam * np.sinh(v) + xi, np.log(np.abs(lam / d)) + logcosh


def _householder(x, V):
    V = V[None, :] if V.ndim == 1 else V
    for v in V:
        x = x - 2.0 * np.outer(x @ v, v) / (v @ v)
    return x


def _f64(*ps):
    return [np.asarray(p, np.float64) for p in ps]


def stage_forward_and_ladj(stage, x):
    """(y, per-element ladj) of one stage in float64."""
    if isinstance(stage, ef.ScaleShift):
        a, b = _f64(stage.a, stage.b)
        return x * a + b, np.broadcast_to(np.log(np.abs(a)), x.shape)
    if isinstance(stage, ef.CenterContract):
        return _contract(x, *_f64(stage.a, stage.b, stage.c))
    if isinstance(stage, ef.CenterStretch):
        return _stretch(x, *_f64(stage.a, stage.b, stage.c))
    if isinstance(stage, ef.Johnson):
        return _johnson(x, *_f64(stage.gamma, stage.delta, stage.xi,
                                 stage.lam))
    if isinstance(stage, ef.JohnsonInv):
        return _johnson_inv(x, *_f64(stage.gamma, stage.delta, stage.xi,
                                     stage.lam))
    if isinstance(stage, ef.Householder):
        return _householder(x, *_f64(stage.V)), np.zeros_like(x)
    raise TypeError(f"no reference for {type(stage).__name__}")


def reference_forward_and_ladj(chain, x):
    """Float64 (y, per-sample ladj) of ``chain`` at ``x``."""
    y = np.asarray(x, np.float64)
    ladj = np.zeros(y.shape[:-1])
    stages = chain.stages if isinstance(chain, ef.Chain) else (chain,)
    for s in stages:
        y, elem = stage_forward_and_ladj(s, y)
        ladj = ladj + np.broadcast_to(elem, y.shape).sum(-1)
    return y, ladj
