"""Where JAX keeps its persistent compile cache.

Kernel shapes are bucketed so that they recur (engine._bucket_rows), and a
persistent cache lets a later run skip their compilation. The rule:

  * JAX_COMPILATION_CACHE_DIR set: JAX reads it itself and this module
    sets no other directory;
  * otherwise a fixed directory inside the checkout (bench_data/ is
    git-ignored). The path is part of the cache's key, so it never
    depends on a temporary name, a pid or the time.
"""

from __future__ import annotations

import os

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, "bench_data", "jax_cache")


def setup_compile_cache(default_dir: str = DEFAULT_DIR) -> str:
    """Apply the rule above before the first compilation; returns the
    directory in use."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    import jax
    os.makedirs(default_dir, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", default_dir)
    return default_dir
