"""Persistent XLA compilation cache for the program's entry points.

Entry points (``chip_smoke.py``, ``bench.py``, ``enflows_tpu.cli`` and the
scripts in ``benchmarks/``) call :func:`enable_persistent_compilation_cache`
once, before their first compilation. Importing the package sets nothing.
"""
from __future__ import annotations

import os

import jax

# A fixed path inside the checkout: the cache key includes the path, so a
# directory that moved between runs would never hit.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_persistent_compilation_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
    function sets nothing. Otherwise the cache goes to ``<repo>/.jax_cache``.
    """
    env_dir = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env_dir:
        return env_dir
    jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    return REPO_CACHE_DIR
