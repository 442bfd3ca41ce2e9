"""Persistent XLA compilation cache.

Compiling the sampler's scan is the slow part of every cold start, so every
process of this repo (CLI, bench, tools, tests) shares one on-disk cache.
JAX itself reads `JAX_COMPILATION_CACHE_DIR`; this helper follows the same
variable when it is set and sets no other path.  When it is unset, the cache
goes to one fixed directory inside the checkout (`<repo>/.jax_cache`, listed
in .gitignore), so that a later process finds what an earlier one compiled.
"""

import os
import pathlib

import jax

DEFAULT_CACHE_DIR = pathlib.Path(__file__).resolve().parents[2] / ".jax_cache"


def cache_dir() -> str:
    """The compile-cache directory: `JAX_COMPILATION_CACHE_DIR` if set,
    else the fixed in-checkout default."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_CACHE_DIR)


def enable_compile_cache() -> str:
    """Point JAX's persistent cache at `cache_dir()` and cache every
    compiled program, however small or quick to compile."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", -1)
    return path
