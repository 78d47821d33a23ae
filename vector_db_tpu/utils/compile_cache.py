"""Where JAX keeps its persistent compilation cache.

If ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and nothing
here sets another directory.  Otherwise the cache goes to one fixed
directory inside the checkout, ``.jax_cache/`` (listed in .gitignore): the
path is part of the cache key, so a directory that moved would never hit.
"""

from __future__ import annotations

import os
from pathlib import Path

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE = Path(__file__).resolve().parents[2] / ".jax_cache"


def compile_cache_dir(environ=None) -> str:
    """The cache directory under the rule above."""
    environ = os.environ if environ is None else environ
    return environ.get(ENV_VAR) or str(CHECKOUT_CACHE)


def enable_compile_cache(min_compile_secs: float | None = None,
                         environ=None) -> str:
    """Point JAX's persistent cache at `compile_cache_dir` and return it.
    ``min_compile_secs`` lowers JAX's one-second threshold for what is
    cached (the tests cache everything)."""
    import jax

    path = compile_cache_dir(environ)
    jax.config.update("jax_compilation_cache_dir", path)
    if min_compile_secs is not None:
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_compile_secs)
        jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
