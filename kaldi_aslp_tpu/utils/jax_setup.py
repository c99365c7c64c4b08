"""Process set-up shared by the programs that drive the card.

- ``configure_compile_cache``: JAX's persistent compilation cache.  Where
  ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
  here overrides it; otherwise the cache goes to one fixed directory in
  the checkout (``.jax_cache``, listed in .gitignore).  The path is part
  of the cache key, so it never depends on a temporary name, a PID or
  the time.
- ``cpu_only_env``: the environment for a child process of this package
  that must stay off the card.  A JAX process reserves most of the
  card's memory when it first uses it, so at most one process of a run
  may open the card; every other one is pinned to the CPU before it
  imports JAX.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import Dict, Mapping, Optional

CACHE_ENV = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def configure_compile_cache() -> str:
    """Point JAX's compilation cache at its directory; returns it."""
    if os.environ.get(CACHE_ENV):
        return os.environ[CACHE_ENV]
    import jax

    path = str(DEFAULT_CACHE_DIR)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def cpu_only_env(base: Optional[Mapping[str, str]] = None
                 ) -> Dict[str, str]:
    """A copy of ``base`` (default: this process's environment) that
    pins a child's JAX to the CPU."""
    env = dict(os.environ if base is None else base)
    env["JAX_PLATFORMS"] = "cpu"
    return env
