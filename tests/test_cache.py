"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR, and
otherwise one fixed directory inside the checkout."""
import pathlib

import jax

from tamcmc_tpu.utils import cache

ROOT = pathlib.Path(__file__).resolve().parents[1]


def test_env_variable_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cache.cache_dir() == str(tmp_path)


def test_default_is_fixed_inside_the_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first, second = cache.cache_dir(), cache.cache_dir()
    assert first == second == str(ROOT / ".jax_cache")
    assert pathlib.Path(first).resolve().is_relative_to(ROOT)
    assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()


def test_enable_points_jax_at_cache_dir():
    path = cache.enable_compile_cache()
    assert path == cache.cache_dir()
    assert jax.config.jax_compilation_cache_dir == path
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0
