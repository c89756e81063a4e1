"""Persistent XLA compilation cache.

The reference pays its compile cost once, at build time (nvcc AOT,
``TestProject.vcxproj``); XLA compiles at runtime.  JAX's persistent
compilation cache is the runtime equivalent of the reference's build
artifacts: compiled executables are keyed by (program, compiler flags,
device kind) and reloaded on the next process start.

Where the cache lives:

- ``JAX_COMPILATION_CACHE_DIR`` set: JAX reads it itself, and this module
  sets no other directory;
- otherwise one fixed path inside the checkout, ``<repo>/.jax_cache``
  (listed in ``.gitignore``).  A fixed path matters: a directory that
  moves between runs never hits.

Enabled from the CLI and bench entry points.
"""

from __future__ import annotations

import os
from pathlib import Path

REPO_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compilation_cache() -> str:
    """Turn on JAX's persistent compilation cache (idempotent) and return
    its directory."""
    import jax
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        REPO_CACHE_DIR.mkdir(exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(REPO_CACHE_DIR))
    return jax.config.jax_compilation_cache_dir
