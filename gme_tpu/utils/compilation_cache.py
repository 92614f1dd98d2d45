"""Persistent XLA compilation cache.

The pipeline's jitted programs (hierarchical GME with lockstep searches)
take a while to compile cold; caching compiled executables on disk lets
every later process with the same programs start in seconds.

The cache lives where `JAX_COMPILATION_CACHE_DIR` says when it is set, and
otherwise at the fixed `<checkout>/.jax_cache`: the path is part of what a
later process must find again, so it never depends on the process, the time
or a temporary directory.  Safe to call always — errors (read-only FS,
unsupported backend) degrade to cold compiles.
"""

from __future__ import annotations

import os

_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)

_DONE = False


def cache_dir() -> str:
    """The persistent-cache directory this process uses."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache"
    )


def enable() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    try:
        import jax

        path = cache_dir()
        os.makedirs(path, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", path)
        jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    except Exception:
        pass
