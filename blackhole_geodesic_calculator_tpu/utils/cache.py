"""The persistent XLA compilation cache, at one fixed place."""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
# Inside the checkout (listed in .gitignore): a fixed path, because the
# cache key includes it -- a directory that moves never hits.
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compilation cache and return its directory.

    Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX already reads it and
    nothing is set here; otherwise the cache goes to ``DEFAULT_DIR``."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
