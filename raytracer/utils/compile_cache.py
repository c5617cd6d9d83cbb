"""Persistent XLA compilation cache: one place decides where it lives.

With ``JAX_COMPILATION_CACHE_DIR`` set, JAX reads that directory itself and
nothing here sets another. Without it, the cache goes to a fixed absolute
path inside the checkout, ``<repo>/output/.jax_cache``, derived from this
package's location, so that runs started from any working directory share
one cache.
"""

from __future__ import annotations

import os

ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), "output", ".jax_cache")


def cache_dir(environ=None) -> str:
    """The directory the cache uses: the variable's value, else the
    checkout's default."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV) or DEFAULT_DIR


def enable(path: str = None) -> str:
    """Turn the persistent cache on and return its directory. ``path``
    overrides the default only when the variable is unset."""
    import jax
    if os.environ.get(ENV):
        return os.environ[ENV]
    path = os.path.abspath(path or DEFAULT_DIR)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)
    return path
