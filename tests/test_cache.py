"""The compile-cache rule: JAX_COMPILATION_CACHE_DIR when set, else the
checkout's .jax_cache, and nothing else."""

import os
import subprocess
import sys

import sparse_matrix_mult_tpu as smm

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import jax, jax.numpy as jnp
import sparse_matrix_mult_tpu
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
jax.jit(lambda x: x * 3 + 1)(jnp.arange(7.0)).block_until_ready()
print(jax.config.jax_compilation_cache_dir)
"""


def _probe(env):
    env = dict(env, JAX_PLATFORMS="cpu")
    r = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_checkout_cache_dir():
    assert smm._checkout_cache_dir() == os.path.join(ROOT, ".jax_cache")


def test_cache_dir_defaults_to_checkout():
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    assert _probe(env) == os.path.join(ROOT, ".jax_cache")


def test_cache_dir_from_environment(tmp_path):
    cache = tmp_path / "cache"
    assert _probe(dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache))) == str(cache)
    assert any(cache.iterdir()), "the compiled program was not cached there"
