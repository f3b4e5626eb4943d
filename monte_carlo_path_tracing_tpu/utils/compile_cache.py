"""Persistent XLA compilation cache, enabled first by every entry point
(cli.main, bench.py, chip_smoke.py)."""

from __future__ import annotations

import os

import jax

#: <repo>/.jax_cache — a fixed path (gitignored), because the cache key
#: includes the directory: a cache that moves never hits.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Returns the cache directory in use.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is set here; otherwise the cache goes to :data:`DEFAULT_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
