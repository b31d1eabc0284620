"""Persistent XLA compile cache for the user-facing drivers.

Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and this
module sets no directory.  Otherwise the cache lives in one fixed directory
inside the checkout, ``<repo>/.jax_cache`` (listed in .gitignore), so a
fresh process of an unchanged program replays its compiles from disk.
Library import does not enable it: only the drivers (CLI, ``Endpoint``,
``bench.py``, ``chip_smoke.py``, the benchmark scripts) call this.
"""
from __future__ import annotations

import os

__all__ = ["DEFAULT_CACHE_DIR", "enable_compile_cache"]

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Turn the persistent compile cache on (idempotent); returns its
    directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    if jax.config.jax_compilation_cache_dir != DEFAULT_CACHE_DIR:
        os.makedirs(DEFAULT_CACHE_DIR, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    return DEFAULT_CACHE_DIR
