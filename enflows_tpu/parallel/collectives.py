"""Collective helpers for shard_map'ped sampling kernels.

No reference counterpart (SURVEY.md §5 "Distributed communication backend:
ABSENT"). Thin, named wrappers over XLA collectives so inference code reads
at the domain level (consensus, gather-diagnostics) rather than the
primitive level. XLA lowers them to the backend's collectives (NCCL
across the cards of a GPU host).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax


def pmean(x, axis_name: str = "chains"):
    """Cross-shard mean — the step-size/acceptance consensus primitive
    (SURVEY.md §5: 'cross-chip step-size consensus via psum mean')."""
    return lax.pmean(x, axis_name)


def psum(x, axis_name: str = "chains"):
    return lax.psum(x, axis_name)


def all_gather(x, axis_name: str = "chains", axis: int = 0,
               tiled: bool = True):
    """Gather shard-local arrays along ``axis`` (resampling ancestry,
    diagnostics)."""
    return lax.all_gather(x, axis_name, axis=axis, tiled=tiled)


def psum_scatter(x, axis_name: str = "chains", tiled: bool = True):
    """Reduce-scatter: sharded moment accumulation (SURVEY.md §5)."""
    return lax.psum_scatter(x, axis_name, tiled=tiled)


def axis_index(axis_name: str = "chains"):
    return lax.axis_index(axis_name)


def broadcast_from_zero(x, axis_name: str = "chains"):
    """Make shard 0's value the collective value everywhere (e.g. one
    shared RNG draw). Implemented as a masked psum so it stays a single
    collective."""
    idx = lax.axis_index(axis_name)
    return lax.psum(jnp.where(idx == 0, x, jnp.zeros_like(x)), axis_name)
