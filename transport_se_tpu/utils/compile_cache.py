"""Persistent XLA compilation cache location.

`JAX_COMPILATION_CACHE_DIR`, when set, is honoured as JAX reads it and no
other cache is configured.  Otherwise the cache lives at a fixed path in
the checkout (`.jax_cache/`, ignored by git): the cache key includes the
path, so a directory named per run or per process would never hit.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get(ENV) or DEFAULT_DIR


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at cache_dir(); returns
    it.  Call before the first compilation."""
    import jax
    path = cache_dir()
    if not os.environ.get(ENV):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
