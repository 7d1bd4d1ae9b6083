"""Persistent XLA compilation cache.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, the cache lives there and
nowhere else. Where it is not set, the cache lives at the fixed path
``<checkout>/.jax_cache`` (listed in .gitignore): the path is part of the
cache key, so a directory that moved would never hit.

Call from entry points that compile large programs (bench.py,
chip_smoke.py, benchmarks/*, the CLI). Deliberately NOT called on library
import: a library must not silently set global jax config for its host
process.
"""

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_persistent_cache() -> str:
    """Turn the persistent compilation cache on. Returns its directory:
    $JAX_COMPILATION_CACHE_DIR when set, else DEFAULT_DIR. (The variable
    is applied here too, so it also takes effect when it was set after
    jax was imported.)"""
    import jax
    path = os.environ.get(ENV_VAR) or DEFAULT_DIR
    jax.config.update("jax_compilation_cache_dir", path)
    return path
