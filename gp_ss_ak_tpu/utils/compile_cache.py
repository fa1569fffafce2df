"""JAX's persistent compilation cache at a fixed place.

The cache key includes the directory, so the directory must not move
between runs: `$JAX_COMPILATION_CACHE_DIR` when it is set (JAX reads
it itself, and nothing else is set), otherwise `.jax_cache/` at the
checkout root (git-ignored).
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its fixed directory; returns it."""
    path = os.environ.get(ENV_VAR)
    if path:
        return path
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
