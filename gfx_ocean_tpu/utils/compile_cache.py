"""Persistent XLA compilation cache — the precompiled-SPIR-V analog.

The reference never compiles shaders at runtime: GLSL is compiled offline
and the SPIR-V blobs are embedded in the binary (``shader/shader_gen.sh``,
``src/render.rs:212-220``). The XLA analog is JAX's persistent compilation
cache: the first run pays the compile, every later process deserializes
the executable.

``enable_default_cache()`` is called by every product entry point (CLI,
serve, bench, graft entry, ``chip_smoke.py``). Where the
``JAX_COMPILATION_CACHE_DIR`` environment variable is set, JAX reads it
itself and this module sets no other directory. Otherwise the cache lives
at the fixed ``.jax_cache/`` at the root of the checkout: the directory
is part of what a later process must find again, so it never moves.
"""

from __future__ import annotations

import os

DEFAULT_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


def enable_default_cache() -> str | None:
    """Turn on JAX's persistent compilation cache.

    Returns the active cache dir, or None if caching stayed disabled.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    current = jax.config.jax_compilation_cache_dir
    if current:
        return current
    try:
        os.makedirs(DEFAULT_DIR, exist_ok=True)
    except OSError:  # read-only checkout: run uncached
        return None
    jax.config.update("jax_compilation_cache_dir", DEFAULT_DIR)
    # Cache every program that took a second or more to compile.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    return DEFAULT_DIR
