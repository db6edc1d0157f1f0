"""Distributed systematic resampling over a sharded particles axis.

No reference counterpart (SURVEY.md §2b "Collectives layer" row / §7 hard
part (c)). Particles live sharded as (n_local, dim) per device on a
``chains`` mesh axis; the resampler must produce a globally-correct
systematic sample without funneling all particles through one host.

Design (inside `shard_map`):

1. Global weight normalization: `pmax` shift + `psum` of local exp-sums —
   no gather of the weight vector itself.
2. One shared uniform u0 (broadcast from shard 0) defines the global
   systematic grid pts_t = (u0 + t)/N, identical on every shard.
3. Each shard computes the *global* ancestry indices for its own contiguous
   slot range [d*n_local, (d+1)*n_local) against the global weight CDF.
4. Particle exchange. Two strategies sharing the same ancestry semantics:

   * ``gather`` — assemble the global CDF with one (n_global,) `all_gather`
     + searchsorted, then one tiled `all_gather` of particles plus a local
     row gather. Minimum latency, but every device materializes the
     full (n_global, dim) array. Right below ~10^6 x 100-dim f32 particles
     (≤ ~0.4 GB of device memory), which covers every BASELINE.json
     config.
   * ``ring`` — O(n_local) peak memory end to end. Ancestry: each shard's
     slice of the global CDF (local cumulative weights + its device prefix,
     a K-scalar all_gather) rotates around the mesh via `ppermute`; at each
     hop every shard searchsorts its grid points against the visiting block
     and keeps the *minimum* candidate global index — exactly the
     first-hit semantics of a searchsorted over the concatenated CDF, so
     ancestry is bit-identical to the gather path. Exchange: a second
     k-step `ppermute` ring rotates the (n_local, dim) particle blocks,
     each shard copying the rows it needs out of the visiting block with a
     masked gather. Same total interconnect bytes as the all_gather (each
     block traverses the whole ring) but nothing O(n_global) is ever
     materialized, so particle counts scale with the number of devices
     rather than with one device's memory.

   ``sharded_systematic_resample`` auto-selects: ``ring`` once the
   gathered array would exceed ``_GATHER_BYTES_LIMIT`` (256 MB), ``gather``
   otherwise; pass ``method=`` to force one. Outputs are bit-identical
   between the two (tested: tests/test_parallel.py ring-vs-gather), and
   the ring path's compiled HLO contains no O(n_global) collective
   (tested: test_ring_path_memory_is_local).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
from jax import lax

from .collectives import broadcast_from_zero

_GATHER_BYTES_LIMIT = 256 * 1024 * 1024


def _ring_ancestry(shifted_cdf, pts, my_dev, n_local, k, axis_name):
    """Global ancestry via a k-step ppermute sweep of CDF blocks.

    ``shifted_cdf`` is this shard's slice of the global CDF (local cumsum +
    device prefix). Global searchsorted-left over the concatenated CDF ==
    min over blocks of (block offset + in-block searchsorted-left), because
    the concatenation is exactly these blocks in order — so taking the
    running min over visiting blocks reproduces the gather path's ancestry
    bit for bit while holding only one block at a time.
    """
    n_global = n_local * k
    perm = [(i, (i - 1) % k) for i in range(k)]

    def body(s, carry):
        anc, block = carry
        owner = (my_dev + s) % k
        idx = jnp.searchsorted(block, pts, side="left")      # in [0, n_local]
        hit = idx < n_local
        cand = owner * n_local + jnp.minimum(idx, n_local - 1)
        anc = jnp.where(hit & (cand < anc), cand, anc)
        # Rotate unconditionally (collective under dynamic cond can
        # deadlock if XLA can't prove the predicate uniform); one wasted
        # final hop out of k is noise.
        block = lax.ppermute(block, axis_name, perm)
        return anc, block

    anc0 = jnp.full(pts.shape, n_global, jnp.int32)
    if k == 1:
        anc, _ = body(0, (anc0, shifted_cdf))
    else:
        anc, _ = lax.fori_loop(0, k, body, (anc0, shifted_cdf))
    return jnp.clip(anc, 0, n_global - 1)


def _ring_fetch(particles, anc, n_local, k, axis_name):
    """Fetch global rows ``anc`` via a k-step ppermute ring.

    Rotates each shard's block one hop per step (device i sends to i-1, so
    after s steps shard d holds the block that originated on (d+s) % k) and
    copies matching rows out with a masked gather. Peak memory: two blocks.
    """
    my_dev = lax.axis_index(axis_name)
    perm = [(i, (i - 1) % k) for i in range(k)]

    def body(s, carry):
        out, block = carry
        owner = (my_dev + s) % k
        rel = anc - owner * n_local
        hit = (rel >= 0) & (rel < n_local)
        rows = jnp.take(block, jnp.clip(rel, 0, n_local - 1), axis=0)
        out = jnp.where(hit[:, None], rows, out)
        block = lax.ppermute(block, axis_name, perm)
        return out, block

    out = jnp.zeros_like(particles)
    if k == 1:
        rel = jnp.clip(anc, 0, n_local - 1)
        return jnp.take(particles, rel, axis=0)
    out, _ = lax.fori_loop(0, k, body, (out, particles))
    return out


def sharded_systematic_resample(key, log_weights, particles,
                                axis_name: str = "chains",
                                method: str | None = None):
    """Systematic resampling of sharded particles; call inside shard_map.

    key: identical PRNG key on every shard (fold the step index, not the
    shard index). log_weights (n_local,), particles (n_local, dim).
    method: None (auto), "gather", or "ring" — see module docstring.
    Returns resampled (n_local, dim) for this shard's slot range.
    """
    n_local = log_weights.shape[0]
    k = lax.psum(1, axis_name)               # number of shards
    n_global = n_local * k
    dtype = particles.dtype

    # 1. Stable global normalization.
    m = lax.pmax(jnp.max(log_weights), axis_name)
    w_local = jnp.exp(log_weights - m)            # (n_local,)
    local_sum = jnp.sum(w_local)
    total = lax.psum(local_sum, axis_name)
    w_local = w_local / total                     # globally normalized

    # 2. Shared uniform -> global systematic grid for my slots.
    u0 = broadcast_from_zero(jax.random.uniform(key, (), dtype), axis_name)
    my_dev = lax.axis_index(axis_name)
    slot0 = my_dev * n_local
    pts = (u0 + slot0 + jnp.arange(n_local, dtype=dtype)) / n_global

    # 3. My slice of the global CDF: device-prefix (K scalars gathered) +
    # local cumulative weights. Nothing O(n_global) so far.
    sums = lax.all_gather(local_sum / total, axis_name)        # (k,)
    device_prefix = jnp.concatenate(
        [jnp.zeros(1, dtype), jnp.cumsum(sums)])               # (k+1,)
    shifted_cdf = jnp.cumsum(w_local) + device_prefix[my_dev]  # (n_local,)

    if method is None:
        gathered_bytes = (n_global * particles.shape[-1]
                          * particles.dtype.itemsize)
        method = "ring" if gathered_bytes > _GATHER_BYTES_LIMIT else "gather"

    if method == "ring":
        # 4a. O(n_local) memory throughout: ancestry by CDF-block ring
        # sweep, rows by particle-block ring sweep.
        anc = _ring_ancestry(shifted_cdf, pts, my_dev, n_local, k, axis_name)
        return _ring_fetch(particles, anc, n_local, k, axis_name)
    if method != "gather":
        raise ValueError(f"unknown resample exchange method: {method!r}")

    # 4b. Latency-optimal: materialize the global CDF and particle array.
    global_cdf = lax.all_gather(shifted_cdf, axis_name, axis=0,
                                tiled=True)                    # (n_global,)
    anc = jnp.searchsorted(global_cdf, pts, side="left")
    anc = jnp.clip(anc, 0, n_global - 1)
    all_particles = lax.all_gather(particles, axis_name, axis=0,
                                   tiled=True)                 # (n_global, d)
    return jnp.take(all_particles, anc, axis=0)
