"""
Persistent XLA compilation cache.

JAX's persistent compilation cache keys compiled executables on the
HLO, the compile options and the backend, so a second process reuses
the binaries from disk instead of compiling the fused analysis
programs again. Enabled at ``import amof_tpu``.

The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set, and
otherwise one fixed directory inside the checkout (``.jax_cache/``,
listed in ``.gitignore``). The path is part of nothing but the cache's
location: it does not depend on the host, the platform or the time.
"""

from __future__ import annotations

import os

import jax

_DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def cache_dir() -> str:
    """The directory the compile cache uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or _DEFAULT_DIR


def enable_persistent_cache() -> str:
    """Point jax at the persistent compilation cache; returns its
    directory. Safe to call repeatedly, before or after backend
    initialization (the settings apply to later compilations)."""
    path = cache_dir()
    jax.config.update("jax_compilation_cache_dir", path)
    # the default minimum compile time is 1 s; cache the small
    # sub-programs too, so a warm start replays the whole program set
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.2)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
