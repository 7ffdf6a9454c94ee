"""Persistent XLA compilation cache wiring.

Compiling the timestep scan is the largest part of a run's init phase.
JAX's persistent compilation cache stores each compiled executable on disk
keyed by its HLO hash, so a later process that builds the same program
loads it instead of compiling it again.

Combined with the driver's fixed-length segmented execution
(models/driver.py:_SEGMENT_STEPS) the cache key does not depend on the step
count, so any run of a given (grid, variant, backend) after the first skips
compilation regardless of --steps.

The directory: ``$JAX_COMPILATION_CACHE_DIR`` when set (JAX reads it itself
and nothing here overrides it), else ``<checkout>/.jax_cache`` — a fixed
path, because the cache's entries are only found again at the same place.

The reference has no analog — its compile cost is `make` (SerialCode/
Makefile:7-8), paid once per build rather than per run; this brings the
JAX workflow to the same amortization.
"""

from __future__ import annotations

import os

CHECKOUT_DIR = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)
DEFAULT_DIR = os.path.join(CHECKOUT_DIR, ".jax_cache")


def cache_dir() -> str | None:
    """The directory the compilation cache uses, or None when disabled
    (``LBM_NO_COMPILE_CACHE=1``)."""
    if os.environ.get("LBM_NO_COMPILE_CACHE"):
        return None
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or DEFAULT_DIR


def enable_persistent_cache() -> str | None:
    """Point JAX's compilation cache at :func:`cache_dir`.

    Must run before the first compilation.  Returns the directory in use,
    or None when disabled.
    """
    path = cache_dir()
    if path is None or os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return path
    import jax

    os.makedirs(path, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    # Cache every entry: a compile that is cheap here still costs a
    # process start-up its share when many short runs follow each other.
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.1)
    jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)
    return path
