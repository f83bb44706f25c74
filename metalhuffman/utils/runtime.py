"""Process-level runtime rules shared by the CLI, the bench and the smoke run.

- Build outputs and caches live under ``.cache/`` in the checkout (listed in
  ``.gitignore``), never in the user's home directory.
- JAX's persistent compilation cache honours ``JAX_COMPILATION_CACHE_DIR``
  when it is set and otherwise uses ``.cache/jax`` in the checkout: a fixed
  path, because the path is part of the cache key.
- Measurement entry points run only on a GPU (:func:`require_gpu`); a CPU
  fallback would time the Pallas interpreter.
"""

from __future__ import annotations

import os
from pathlib import Path

#: the checkout root (the directory holding the ``metalhuffman`` package)
ROOT = Path(__file__).resolve().parents[2]


def cache_dir(*parts: str) -> Path:
    """``<checkout>/.cache/<parts>``, created on demand."""
    p = ROOT.joinpath(".cache", *parts)
    p.mkdir(parents=True, exist_ok=True)
    return p


def configure_compile_cache() -> str:
    """Point JAX's persistent compilation cache at its directory; returns it.

    ``JAX_COMPILATION_CACHE_DIR``, when set, is JAX's own setting and is
    left alone; otherwise the cache goes to ``<checkout>/.cache/jax``.
    """
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = str(cache_dir("jax"))
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def force_cpu_platform() -> None:
    """Run JAX on the CPU (the kernel then runs in the Pallas interpreter).

    Must happen before JAX initializes a backend: afterwards the platform
    is fixed, so a process already on another platform is refused.
    """
    import jax
    from jax._src import xla_bridge

    started = xla_bridge.backends_are_initialized()
    if started and jax.default_backend() != "cpu":
        raise RuntimeError(
            "JAX already runs on " + jax.default_backend()
            + "; the CPU platform must be chosen before JAX starts")
    jax.config.update("jax_platforms", "cpu")


def require_gpu():
    """The first JAX device, which must be a GPU; raises SystemExit if not."""
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(
            f"needs a GPU: JAX found {dev.platform!r} ({dev.device_kind}); "
            "a CPU run would time the Pallas interpreter")
    return dev
