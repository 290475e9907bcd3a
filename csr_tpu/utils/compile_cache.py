"""
Where JAX keeps compiled programs between processes.

Every script of this repository and the test suite call
:func:`enable_compile_cache` before their first compile, so that they
share one cache.
"""

from __future__ import annotations

import os

import jax

#: the default cache directory: ``.jax_cache`` at the root of the checkout
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and no
    other directory is set here; otherwise the cache sits at
    :data:`DEFAULT_DIR`."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
