"""Test config: run on CPU with 8 simulated devices.

Multi-device sharding paths are exercised per SURVEY.md §4:
`--xla_force_host_platform_device_count=8` gives an 8-device CPU mesh so
collectives and NamedShardings compile and run without accelerators. Must
run before the first `import jax` anywhere in the test process.
"""
import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)  # high-precision oracles in tests
# No persistent-cache AOT hits: a cached executable compiled with different
# machine features perturbs f64 results by ~1 ULP, breaking the bit-for-bit
# multi-process/single-process equivalence gates (test_multiprocess.py).
jax.config.update("jax_enable_compilation_cache", False)

import pytest  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _clear_jax_caches_between_modules():
    """Reset JAX's in-process caches after each test module.

    Measured round 4: with hundreds of accumulated compiled programs,
    XLA-CPU compilation degrades ~25x deep into a single-process run of
    the whole suite (a grad compile that takes 18 s in a fresh process
    took 8+ min mid-suite), blowing the suite from ~20 to ~60+ minutes.
    Clearing per module keeps every module's compile times at their
    fresh-process cost; cross-module compile reuse was negligible by
    comparison.
    """
    yield
    jax.clear_caches()
