"""Runtime setup shared by CLIs and benchmarks.

``setup`` enables JAX's persistent compilation cache, so repeated
command-line invocations skip the compile latency of the device programs;
``device_budget`` sizes device-memory budgets from what the device reports;
``cpu_only_children`` keeps spawned worker processes off the accelerator.
"""

from __future__ import annotations

import contextlib
import os
from pathlib import Path

#: the checkout root (the directory holding the ``krisp_tpu`` package)
REPO_ROOT = Path(__file__).resolve().parent.parent


def cache_dir() -> str:
    """Where compiled programs persist: ``JAX_COMPILATION_CACHE_DIR`` when
    set, else a fixed directory inside the checkout.  The path is part of
    each cache entry's key, so it must not move between runs."""
    return (os.environ.get("JAX_COMPILATION_CACHE_DIR")
            or str(REPO_ROOT / ".jax_cache"))


def setup() -> str:
    """Point JAX's persistent compilation cache at ``cache_dir()``;
    returns the directory."""
    import jax

    path = cache_dir()
    Path(path).mkdir(parents=True, exist_ok=True)
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)
    return path


def device_budget(env_var: str, fraction: float, fallback: int) -> int:
    """A device-memory budget in bytes.

    ``env_var`` pins it when set.  Otherwise it is ``fraction`` of the
    first device's ``bytes_limit`` (the memory the allocator may hand
    out).  ``fallback`` applies where the backend reports no memory
    statistics, as the CPU backend does."""
    pinned = os.environ.get(env_var)
    if pinned:
        return int(pinned)
    import jax

    stats = jax.devices()[0].memory_stats()
    if stats and stats.get("bytes_limit"):
        return int(stats["bytes_limit"] * fraction)
    return fallback


@contextlib.contextmanager
def cpu_only_children():
    """Process pools created inside this block start with
    ``JAX_PLATFORMS=cpu``: spawned workers inherit the environment, so none
    of them initialises the accelerator backend (a JAX process reserves
    most of a card's memory when it first uses it)."""
    old = os.environ.get("JAX_PLATFORMS")
    os.environ["JAX_PLATFORMS"] = "cpu"
    try:
        yield
    finally:
        if old is None:
            os.environ.pop("JAX_PLATFORMS", None)
        else:
            os.environ["JAX_PLATFORMS"] = old
