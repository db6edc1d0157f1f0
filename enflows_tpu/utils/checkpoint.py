"""Checkpoint / resume for training and sampling state.

The reference's only resume seed is the (trafo, optimizer-state) kwarg pair
(/root/reference/src/optimize_whitening.jl:28-29,44 — SURVEY.md §5). Here
checkpointing is a first-class subsystem: whole pytrees (params, opt_state,
rng key, step, chain states, adaptation state) serialize via Orbax when
available, with a dependency-free .npz fallback.

Multi-host / sharded state (SURVEY.md §5 "async multi-host save" row):
``save_checkpoint`` detects leaves that are sharded across devices and
writes each process's **addressable shards** to a per-process file keyed by
the shard's global slice coordinates — no process ever materializes a
non-addressable shard (``np.asarray`` on such an array would raise; funneling
through host 0 would cap state size at one host's RAM). Replicated leaves
are written once by process 0. ``restore_checkpoint`` reassembles each
sharded leaf with ``jax.make_array_from_single_device_arrays`` against the
sharding carried by the ``like`` pytree, so restored state lands exactly on
the original ``NamedSharding`` (bit-equivalence is tested on the 8-device
mesh in tests/test_utils.py).
"""
from __future__ import annotations

import glob
import json
import os
from typing import Any

import jax
import jax.numpy as jnp
import numpy as np


def _orbax():
    """orbax.checkpoint if installed, else None. Imported on first use, so
    the package never needs it."""
    try:
        import orbax.checkpoint as ocp
    except Exception:        # pragma: no cover
        return None
    return ocp


def _is_cross_device_sharded(leaf: Any) -> bool:
    """True for jax.Arrays laid out across >1 device and not replicated."""
    return (isinstance(leaf, jax.Array)
            and len(leaf.sharding.device_set) > 1
            and not leaf.is_fully_replicated)


def _index_key(index: tuple) -> str:
    """Stable string key for a global shard index (tuple of slices)."""
    return json.dumps([[s.start, s.stop] for s in index])


def save_checkpoint(path: str, pytree: Any, step: int = 0,
                    use_orbax: bool = False) -> str:
    """Save ``pytree`` under ``path`` (directory). Returns the final path.

    Default is the npz format (fast, dependency-free, plenty for flow/chain
    state sizes); pass use_orbax=True for async multi-host Orbax layout.
    Sharded leaves are written as per-process shard files (see module
    docstring); replicated/host leaves by process 0 only. Every process
    must call this (it is a collective on sharded state).
    """
    proc = jax.process_index()
    if proc == 0:
        os.makedirs(path, exist_ok=True)
    ocp = _orbax() if use_orbax else None
    if ocp is not None:
        if proc != 0 and jax.process_count() > 1:  # pragma: no cover
            pass  # orbax coordinates all processes internally
        ckpt = ocp.StandardCheckpointer()
        target = os.path.join(os.path.abspath(path), f"step_{step}")
        ckpt.save(target, pytree, force=True)
        ckpt.wait_until_finished()
        return target

    leaves, treedef = jax.tree.flatten(pytree)
    sharded_ids = [i for i, l in enumerate(leaves)
                   if _is_cross_device_sharded(l)]

    # Per-process shard file: addressable shards of every sharded leaf.
    if sharded_ids:
        os.makedirs(path, exist_ok=True)
        shard_data: dict[str, np.ndarray] = {}
        shard_meta: dict[str, Any] = {}
        for i in sharded_ids:
            seen = set()
            for j, sh in enumerate(leaves[i].addressable_shards):
                k = _index_key(sh.index)
                if k in seen:       # replicated-within-shard duplicates
                    continue
                seen.add(k)
                name = f"l{i}s{len(shard_meta)}"
                shard_data[name] = np.asarray(sh.data)
                shard_meta[name] = {"leaf": i, "index": k}
        np.savez(os.path.join(path, f"step_{step}.shards.p{proc}.npz"),
                 **shard_data)
        with open(os.path.join(path,
                               f"step_{step}.shards.p{proc}.json"),
                  "w") as f:
            json.dump(shard_meta, f)

    target = os.path.join(path, f"step_{step}.npz")
    if proc == 0:
        host_arrays = {f"arr_{i}": np.asarray(l)
                       for i, l in enumerate(leaves)
                       if i not in sharded_ids}
        np.savez(target, **host_arrays)
        with open(os.path.join(path, f"step_{step}.tree.json"), "w") as f:
            json.dump({"treedef": str(treedef), "step": step,
                       "num_leaves": len(leaves),
                       "sharded_leaves": sharded_ids}, f)
    return target


def restore_checkpoint(path: str, like: Any, step: int = 0,
                       use_orbax: bool = False) -> Any:
    """Restore a pytree saved by save_checkpoint; ``like`` supplies the
    structure and, for sharded leaves, the target sharding (its leaves must
    carry the original ``NamedSharding``, e.g. the freshly-initialized
    state of a resuming run)."""
    ocp = _orbax() if use_orbax else None
    if ocp is not None:
        ckpt = ocp.StandardCheckpointer()
        target = os.path.join(os.path.abspath(path), f"step_{step}")
        return ckpt.restore(target, like)

    leaves, treedef = jax.tree.flatten(like)
    meta_path = os.path.join(path, f"step_{step}.tree.json")
    sharded_ids: set[int] = set()
    if os.path.exists(meta_path):
        with open(meta_path) as f:
            sharded_ids = set(json.load(f).get("sharded_leaves", []))

    data = np.load(os.path.join(path, f"step_{step}.npz"))

    # index-key -> np.ndarray, per sharded leaf, from every process's file
    # reachable on this filesystem (shared-FS layout; each process only
    # *needs* the slices of its own addressable devices).
    shard_maps: dict[int, dict[str, np.ndarray]] = {i: {}
                                                    for i in sharded_ids}
    if sharded_ids:
        for jpath in sorted(glob.glob(
                os.path.join(path, f"step_{step}.shards.p*.json"))):
            with open(jpath) as f:
                meta = json.load(f)
            npz = np.load(jpath[:-len(".json")] + ".npz")
            for name, rec in meta.items():
                shard_maps[rec["leaf"]][rec["index"]] = npz[name]

    new_leaves = []
    for i, ref in enumerate(leaves):
        if i in sharded_ids:
            if not isinstance(ref, jax.Array):
                raise ValueError(
                    f"leaf {i} was saved sharded; `like` must carry a "
                    f"jax.Array with the target sharding at that position")
            sharding = ref.sharding
            shape = ref.shape
            idx_map = sharding.addressable_devices_indices_map(shape)
            per_device = []
            for dev, index in idx_map.items():
                k = _index_key(index)
                if k not in shard_maps[i]:
                    raise FileNotFoundError(
                        f"no saved shard covers slice {k} of leaf {i} "
                        f"(device {dev}); was the mesh layout changed "
                        f"between save and restore?")
                per_device.append(jax.device_put(shard_maps[i][k], dev))
            new_leaves.append(jax.make_array_from_single_device_arrays(
                shape, sharding, per_device))
        else:
            new_leaves.append(jnp.asarray(data[f"arr_{i}"]))
    return treedef.unflatten(new_leaves)


def latest_step(path: str) -> int | None:
    """Largest step with a saved checkpoint under ``path``, else None."""
    if not os.path.isdir(path):
        return None
    steps = []
    for name in os.listdir(path):
        if name.startswith("step_"):
            stem = name[5:].split(".")[0]
            if stem.isdigit():
                steps.append(int(stem))
    return max(steps) if steps else None
