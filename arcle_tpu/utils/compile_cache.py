"""Where compiled XLA programs are cached across processes.

JAX keys its persistent cache on the program and the directory, so the
directory must not move between runs: one that holds a process id, a user
id or a temp-dir name never hits.  ``JAX_COMPILATION_CACHE_DIR``, when set,
is read by JAX itself and wins; otherwise the cache lives in ``.jax_cache``
at the root of the checkout.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
ENV_VAR = "JAX_COMPILATION_CACHE_DIR"


def default_cache_dir(environ: Mapping[str, str]) -> Optional[str]:
    """The directory this program sets, or None when ``environ`` already
    names one for JAX."""
    if environ.get(ENV_VAR):
        return None
    return os.path.join(REPO_ROOT, ".jax_cache")


def enable_compile_cache() -> str:
    """Turn on the persistent compile cache; returns the directory in use.
    Call before the first compilation."""
    path = default_cache_dir(os.environ)
    if path is None:
        return os.environ[ENV_VAR]
    import jax
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    return path
