"""The persistent compile cache follows JAX_COMPILATION_CACHE_DIR when it
is set and sits at <checkout>/.jax_cache otherwise."""

import pathlib

from topotpu.utils.compile_cache import compile_cache_dir

REPO = pathlib.Path(__file__).resolve().parent.parent


def test_cache_dir_follows_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache_dir() == str(tmp_path)


def test_cache_dir_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    assert compile_cache_dir() == str(REPO / ".jax_cache")
