"""Persistent XLA compile cache for the entry points.

Kernel compiles are set-up time that every run of the same shapes would
pay again.  Where JAX_COMPILATION_CACHE_DIR is set, JAX reads it itself
and nothing is set here; otherwise the cache lives at one fixed path
inside the checkout (``.jax_cache/``, git-ignored), so a later run of the
same checkout finds it.
"""

from __future__ import annotations

import os

CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))), ".jax_cache")


def enable_compile_cache() -> None:
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", CACHE_DIR)
