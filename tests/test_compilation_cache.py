"""The persistent compile cache lives where JAX_COMPILATION_CACHE_DIR says,
and otherwise at one fixed directory of the checkout."""

import os

import jax

from gme_tpu.utils import compilation_cache

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cache_dir_follows_environment(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "x"))
    assert compilation_cache.cache_dir() == str(tmp_path / "x")


def test_cache_dir_fixed_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compilation_cache.cache_dir()
    assert first == os.path.join(_CHECKOUT, ".jax_cache")
    assert compilation_cache.cache_dir() == first  # same on every call


def test_enable_sets_jax_cache_dir(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "x"))
    monkeypatch.setattr(compilation_cache, "_DONE", False)
    old = jax.config.jax_compilation_cache_dir
    try:
        compilation_cache.enable()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "x")
        assert os.path.isdir(tmp_path / "x")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
