"""Where compiled programs persist between processes."""

from __future__ import annotations

import os
from pathlib import Path

# Inside the checkout, listed in .gitignore.  A fixed path: it is part of
# each cache entry's key, so a moving directory would never hit.
CACHE_DIR = Path(__file__).absolute().parents[2] / ".jax_cache"


def enable_compile_cache():
    """Turn on JAX's persistent compilation cache.

    JAX reads ``JAX_COMPILATION_CACHE_DIR`` itself; when that is set it
    is used and no other directory is.  Otherwise the cache goes to
    :data:`CACHE_DIR`.
    """
    import jax

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(CACHE_DIR))
