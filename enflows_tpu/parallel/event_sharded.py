"""Event-dimension sharding for very large event dims.

SURVEY.md §5 (long-context row): the reference has no sequence axis — the
scaling analogue is the event dimension. Elementwise bijectors act
independently per dimension and the per-sample ladj is a SUM over
dimensions (reference sum_ladjs, /root/reference/src/abstract_trafo.jl:9),
so the event axis shards trivially: each device transforms its dim-slice
with its param-slice and contributes a partial ladj that one `psum`
combines. Ring/Ulysses-style sequence tricks are deliberately NOT
cargo-culted in (SURVEY.md §5).

Works for any chain of elementwise bijectors (per-dim params). Householder
mixes dimensions and is excluded — for large-d rotations use the dense
matmul path with the batch axis sharded instead.
"""
from __future__ import annotations

from typing import Callable

import jax
import jax.numpy as jnp
from jax import lax, shard_map
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..bijectors.base import Bijector, Chain
from ..bijectors.householder import Householder


def _check_elementwise(chain: Bijector):
    stages = chain.stages if isinstance(chain, Chain) else (chain,)
    for s in stages:
        if isinstance(s, Householder):
            raise ValueError(
                "Householder mixes event dims; event-sharding only "
                "supports elementwise chains (shard the batch instead)")


def event_sharded_forward_and_ladj(chain: Bijector, mesh: Mesh,
                                   axis_name: str = "dim") -> Callable:
    """Build ``f(x) -> (y, ladj)`` with the trailing event axis of ``x``
    (and every per-dim param leaf of ``chain``) sharded over ``axis_name``.

    Per-device work is the local dim-slice; the single collective is the
    psum of partial ladjs.
    """
    _check_elementwise(chain)

    def local(chain_local, x_local):
        y, ladj_partial = chain_local.forward_and_ladj(x_local)
        return y, lax.psum(ladj_partial, axis_name)

    sharded = P(None, axis_name)     # (batch, dim-shard)
    param = P(axis_name)
    chain_specs = jax.tree.map(lambda _: param, chain)

    fn = shard_map(local, mesh=mesh,
                   in_specs=(chain_specs, sharded),
                   out_specs=(sharded, P()),
                   check_vma=False)

    @jax.jit
    def run(x):
        c = jax.device_put(chain, NamedSharding(mesh, param))
        return fn(c, x)

    return run


def shard_event_batch(x, mesh: Mesh, axis_name: str = "dim"):
    """Place a (batch, dim) array with the event axis sharded."""
    return jax.device_put(x, NamedSharding(mesh, P(None, axis_name)))


def event_sharded_negll_fn(mesh: Mesh, batch_axis: str = "batch",
                           dim_axis: str = "dim") -> Callable:
    """Whitening negll over a 2D (batch x event) mesh — dp x "tp" composed.

    Returns ``fn(chain, x) -> negll`` where ``x`` is (n, d) with the batch
    axis sharded over ``batch_axis`` and the event axis (plus every per-dim
    param leaf of ``chain``) sharded over ``dim_axis``. The negll
    (reference mvnormal_negll_trafo, src/optimize_whitening.jl:7-15) is a
    full sum of per-element terms (logpdf + elem-ladj) over (n, d), so it
    distributes over both axes with ONE scalar psum; `jax.grad` through the
    shard_map yields dim-sharded parameter gradients with the data-parallel
    psum inserted by the transpose rule — a full 2D-sharded train step.
    """
    from ..distributions.base import std_normal_logpdf

    def local(chain_local, x_local):
        y, ladj_partial = chain_local.forward_and_ladj(x_local)
        tot = jnp.sum(std_normal_logpdf(y)) + jnp.sum(ladj_partial)
        tot = lax.psum(tot, (batch_axis, dim_axis))
        n = x_local.shape[0] * lax.psum(1, batch_axis)
        return -tot / n

    x_spec = P(batch_axis, dim_axis)
    param = P(dim_axis)

    def fn(chain, x):
        _check_elementwise(chain)
        chain_specs = jax.tree.map(lambda _: param, chain)
        return shard_map(local, mesh=mesh,
                         in_specs=(chain_specs, x_spec),
                         out_specs=P(),
                         check_vma=False)(chain, x)

    return fn
