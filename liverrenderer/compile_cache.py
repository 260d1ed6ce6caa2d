"""Where entry points keep JAX's persistent compilation cache.

`JAX_COMPILATION_CACHE_DIR`, when set, names the directory and nothing else
is set in code.  Otherwise the cache lives in `.jax_cache` at the root of the
checkout: a fixed path, because the path is part of every entry's key.
"""
from __future__ import annotations

import os

import jax

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at its directory; returns the path."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") \
        or os.path.join(_CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
