"""JAX's persistent compilation cache, in one place for every entry point.

Full-scene frame programs take seconds to minutes to compile at a fresh
shape; the cache makes the second process that needs one start at once.
The cache directory is part of each entry's key, so it must not move
between runs: it is `JAX_COMPILATION_CACHE_DIR` where that is set (JAX
reads the variable itself, and nothing here overrides it), and otherwise
the fixed `.jax_cache` directory at the root of the checkout.
"""

from __future__ import annotations

import os

import jax

CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(CHECKOUT, ".jax_cache")


def setup_compile_cache() -> str:
    """Turn the persistent cache on; returns its directory."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
