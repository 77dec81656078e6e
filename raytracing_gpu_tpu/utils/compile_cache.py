"""Persistent compilation cache.

A compiled render program is keyed by its shapes and static config, and the
first compile of each costs seconds to minutes. JAX's persistent cache keeps
the compiled programs across processes. Its directory is part of what finds
them again, so it is a fixed path: `JAX_COMPILATION_CACHE_DIR` when that is
set (JAX reads it itself, and nothing here overrides it), otherwise
`.jax_cache/` at the root of the checkout (listed in .gitignore).
"""

from __future__ import annotations

import os

import jax

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_CACHE_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_persistent_cache() -> str:
    """Turn on JAX's persistent compilation cache; returns the directory in
    use. Safe to call repeatedly."""
    path = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if not path:
        path = DEFAULT_CACHE_DIR
        jax.config.update("jax_compilation_cache_dir", path)
    os.makedirs(path, exist_ok=True)
    return path
