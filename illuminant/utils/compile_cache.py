"""Where the persistent XLA compile cache lives.

One rule for every entry point (bench.py, demo.py, chip_smoke.py,
tools/): when `JAX_COMPILATION_CACHE_DIR` is set, JAX reads it itself and
nothing here touches the configuration; otherwise the cache goes to
`<checkout>/.jax_cache` (listed in .gitignore). The default is a fixed
path because the cache directory is part of what makes a later process
find an entry again.
"""

from __future__ import annotations

import os

import jax

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
DEFAULT_DIR = os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Point JAX's persistent compile cache at `$JAX_COMPILATION_CACHE_DIR`
    or `DEFAULT_DIR`; returns the directory."""
    if os.environ.get(ENV_VAR):
        return os.environ[ENV_VAR]
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
