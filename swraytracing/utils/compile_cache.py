"""Persistent XLA compilation cache placement.

Compiling the headline configuration takes tens of seconds; the cache
keeps compiled programs across processes. One rule for every entry
point (bench.py, chip_smoke.py, `python -m swraytracing`): when
JAX_COMPILATION_CACHE_DIR is set, JAX reads it and nothing is set here;
otherwise the cache lives at <checkout>/.jax_cache, a fixed path (the
path is part of the cache key, so a moving directory never hits).
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["CHECKOUT_CACHE_DIR", "enable_compile_cache"]

ENV_VAR = "JAX_COMPILATION_CACHE_DIR"
CHECKOUT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def enable_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory and
    return that directory."""
    env = os.environ.get(ENV_VAR)
    if env:
        return env
    import jax

    jax.config.update("jax_compilation_cache_dir", str(CHECKOUT_CACHE_DIR))
    return str(CHECKOUT_CACHE_DIR)
