"""Persistent XLA compilation cache.

PLS fits are small programs but the CV stack compiles several
vmapped/scanned variants; on modest hosts the compile dominates wall time.
The cache makes every repeat invocation (tests, CLI, benchmarks) start
warm.  Its directory is `JAX_COMPILATION_CACHE_DIR` when that is set;
otherwise a fixed `.jax_cache` in the checkout (the path is part of the
cache key, so it must not move between runs).
"""

from __future__ import annotations

import os
from pathlib import Path

DEFAULT_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(DEFAULT_DIR)
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path
