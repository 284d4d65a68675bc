"""Where JAX keeps its persistent compilation cache.

Entry points (the CLIs, ``bench.py``, ``bench_scaling.py``,
``chip_smoke.py``) call :func:`enable_compile_cache` once at start-up, so
a second run on the same checkout reuses the first run's compiled
programs.  Importing this module changes nothing.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"

# <checkout>/.jax_cache: fixed, because the directory is part of the
# cache's key — a path built from a temp name, pid or time never hits.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compilation cache and return its directory.

    When ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
    nothing is changed here; otherwise the cache goes to
    :data:`DEFAULT_DIR`.
    """
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
