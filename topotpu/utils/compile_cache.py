"""Where JAX keeps its persistent compilation cache.

``JAX_COMPILATION_CACHE_DIR``, when set, wins: JAX reads it itself and no
other path is set in code. Otherwise the cache lives in ``.jax_cache`` at
the root of the checkout (listed in ``.gitignore``), a fixed path, so a
later process on the same checkout finds what an earlier one compiled.
"""

from __future__ import annotations

import os
import pathlib

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]


def compile_cache_dir() -> str:
    """The directory the persistent cache uses under the rule above."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or str(
        CHECKOUT / ".jax_cache"
    )


def enable_compile_cache() -> str:
    """Point JAX at ``compile_cache_dir()``; returns the directory."""
    import jax

    path = compile_cache_dir()
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", path)
    return path
