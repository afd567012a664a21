"""JAX runtime setup: persistent compilation cache.

Every engine shape compiles once per cache directory instead of once per
process. Where ``JAX_COMPILATION_CACHE_DIR`` is set, JAX reads it itself and
this module sets no other directory; otherwise the cache lives at a fixed,
gitignored path inside the checkout (`default_cache_dir`). Called by the
engine, bench, CLIs and ``chip_smoke.py``; a no-op after the first call.
"""
from __future__ import annotations

import logging
import os
from pathlib import Path

logger = logging.getLogger(__name__)

_DONE = False

REPO_ROOT = Path(__file__).resolve().parents[2]


def _host_fingerprint() -> str:
    """Short stable id for the HOST CPU's feature set.

    JAX's persistent-cache key does not include host machine features, so
    XLA:CPU executables compiled on one machine could load on another and
    SIGILL ('Target machine feature ... is not supported on the host
    machine'). Namespacing the cache dir by the cpuinfo flags line keeps
    entries from a different host physically separate. GPU executables are
    compiled for the device, not the host, and are unaffected either way."""
    import zlib

    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return f"{zlib.crc32(line.encode()) & 0xffffffff:08x}"
    except OSError:
        pass
    import platform

    return platform.machine() or "unknown"


def default_cache_dir() -> Path:
    """The cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset:
    ``<checkout>/.jax_cache/<host-cpu-id>`` — fixed, so a later process on
    the same machine finds what an earlier one compiled."""
    return REPO_ROOT / ".jax_cache" / _host_fingerprint()


def enable_compilation_cache() -> None:
    global _DONE
    if _DONE:
        return
    _DONE = True
    import jax

    # numeric sanitizer: fail fast on NaN/Inf escaping any jitted program
    if os.environ.get("AMRF_DEBUG_NANS") == "1":
        jax.config.update("jax_debug_nans", True)

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        path = default_cache_dir()
        path.mkdir(parents=True, exist_ok=True)
        jax.config.update("jax_compilation_cache_dir", str(path))
    # cache every program, even fast-compiling ones
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
