"""Where JAX keeps its persistent compilation cache.

Every entry point (the CLI, ``bench.py``, ``chip_smoke.py``) calls
:func:`enable_compile_cache` before it compiles anything, so repeated runs
from one checkout reuse compiled programs.

* ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself; nothing is set here.
* Otherwise: ``<checkout>/.jax_cache`` (listed in ``.gitignore``).  The path is
  fixed — never derived from a temporary name, a process id or the time — so
  later runs find what earlier ones stored.
"""

from __future__ import annotations

import os

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache",
)


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and return
    that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    return DEFAULT_DIR
