"""The compile-cache rule: JAX_COMPILATION_CACHE_DIR wins and nothing is
set; otherwise the cache is <repo>/.jax_cache, and importing the package
sets nothing."""
import os
import subprocess
import sys

import jax
import pytest

from enflows_tpu.utils import compilation_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    old = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", old)


def test_env_var_is_honoured(monkeypatch, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/some/where")
    assert cc.enable_persistent_compilation_cache() == "/some/where"
    assert jax.config.jax_compilation_cache_dir == before


def test_default_is_fixed_path_in_checkout(monkeypatch, restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = cc.enable_persistent_compilation_cache()
    assert path == os.path.join(REPO, ".jax_cache") == cc.REPO_CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == path
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_import_sets_no_cache():
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    code = ("import jax, enflows_tpu; "
            "print(repr(jax.config.jax_compilation_cache_dir))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() in ("None", "''")
