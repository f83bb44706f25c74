"""Process-level rules: compile-cache location, platform choice, refusal."""

import subprocess
import sys

import jax
import pytest

from metalhuffman.utils import runtime


def test_compile_cache_honours_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    assert runtime.configure_compile_cache() == str(tmp_path)
    assert jax.config.jax_compilation_cache_dir == before  # left to JAX


def test_compile_cache_defaults_into_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        path = runtime.configure_compile_cache()
        assert path == str(runtime.ROOT / ".cache" / "jax")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_native_library_builds_into_checkout(monkeypatch):
    from metalhuffman import native

    monkeypatch.delenv("MHT_CACHE_DIR", raising=False)
    assert native._cache_dir() == runtime.ROOT / ".cache" / "native"


def test_force_cpu_refused_after_another_backend_started(monkeypatch):
    from jax._src import xla_bridge

    monkeypatch.setattr(xla_bridge, "backends_are_initialized", lambda: True)
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    with pytest.raises(RuntimeError, match="before JAX starts"):
        runtime.force_cpu_platform()


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="needs a GPU"):
        runtime.require_gpu()


def test_cli_interpret_runs_on_cpu():
    """``--interpret`` picks the CPU platform before JAX starts (the child
    has no JAX_PLATFORMS pin), and the kernel is then interpreted."""
    env = {k: v for k, v in __import__("os").environ.items()
           if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    out = subprocess.run(
        [sys.executable, "-m", "metalhuffman", "platform", "--interpret"],
        capture_output=True, text=True, cwd=str(runtime.ROOT), env=env,
        timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("cpu ") and "interpreted" in out.stdout
