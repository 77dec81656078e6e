"""Platform plumbing: backend choice, compile-cache location, chip_smoke.py
refusing to run without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from raytracing_gpu_tpu import RenderConfig
from raytracing_gpu_tpu.render import resolve_backend
from raytracing_gpu_tpu.utils import compile_cache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,expect", [("gpu", "pallas"),
                                             ("cpu", "jnp")])
def test_auto_backend_follows_platform(monkeypatch, platform, expect):
    """backend="auto" is the sweep kernel on the GPU and plain XLA
    elsewhere; an explicit backend is left alone."""
    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    assert RenderConfig().backend == "auto"
    assert resolve_backend(RenderConfig()).backend == expect
    for explicit in ("jnp", "pallas"):
        cfg = RenderConfig(backend=explicit)
        assert resolve_backend(cfg) is cfg


@pytest.fixture
def restore_cache_dir():
    saved = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", saved)


def test_compile_cache_honours_env(monkeypatch, tmp_path, restore_cache_dir):
    """With JAX_COMPILATION_CACHE_DIR set, that directory is used and the
    code sets no other."""
    want = str(tmp_path / "cache")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", want)
    jax.config.update("jax_compilation_cache_dir", None)
    assert compile_cache.enable_persistent_cache() == want
    assert os.path.isdir(want)
    assert jax.config.jax_compilation_cache_dir is None  # not overridden


def test_compile_cache_default_is_fixed_in_checkout(monkeypatch,
                                                    restore_cache_dir):
    """Without the variable the cache is `.jax_cache` at the checkout's
    root: a fixed path (no home, temp name, pid or time), so a later process
    finds it again; .gitignore lists it."""
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = compile_cache.enable_persistent_cache()
    assert path == os.path.join(ROOT, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert compile_cache.enable_persistent_cache() == path  # stable
    with open(os.path.join(ROOT, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    """No GPU: chip_smoke.py exits non-zero and prints no result line."""
    p = _run_smoke(ROOT)
    assert p.returncode != 0
    assert "found no GPU" in p.stderr
    assert '"ok"' not in p.stdout


def test_chip_smoke_fails_without_the_repo(tmp_path):
    """chip_smoke.py alone in a directory, without the program: non-zero
    exit, no result line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run_smoke(tmp_path)
    assert p.returncode != 0
    assert "ModuleNotFoundError" in p.stderr
    assert '"ok"' not in p.stdout
