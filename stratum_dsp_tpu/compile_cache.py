"""Persistent XLA compile cache for benches, CLIs, and perf scripts.

Every entry point calls :func:`enable` before its first compilation, so the
full-pipeline compile is paid once per cache directory, not once per
process. The directory is ``$JAX_COMPILATION_CACHE_DIR`` when that is set,
and otherwise ``.jax_cache/`` in the checkout (listed in ``.gitignore``).
"""

from __future__ import annotations

import hashlib
import os

REPO_CACHE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache"
)


def host_fingerprint() -> str:
    """Short hash of the host CPU's feature flags.

    XLA:CPU persists AOT executables compiled for the *build* machine's CPU
    features; loading them on a host with different features warns
    ("cpu_aot_loader ... could lead to execution errors such as SIGILL") and
    then segfaults on execute, so CPU entries live in a per-CPU-signature
    subdirectory.
    """
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith("flags"):
                    return hashlib.sha1(line.encode()).hexdigest()[:10]
    except OSError:
        pass
    import platform

    return hashlib.sha1(platform.processor().encode()).hexdigest()[:10]


def cache_dir(platform: str) -> str:
    """Cache directory for ``platform`` (``jax.default_backend()``)."""
    base = os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE
    if platform == "cpu":
        return os.path.join(base, f"cpu-{host_fingerprint()}")
    return base


def enable() -> str:
    """Turn on the persistent compile cache (idempotent); returns its path.

    Starts the JAX backend to learn the platform, so a caller that sets
    ``XLA_FLAGS`` sets them before this call."""
    import jax

    path = cache_dir(jax.default_backend())
    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
