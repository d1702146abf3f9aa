"""Compile-cache placement: the directory JAX_COMPILATION_CACHE_DIR names,
else one fixed directory inside the checkout."""

import os

import jax

import mamri_tpu


def test_cache_dir_from_environment():
    assert mamri_tpu.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": "/x/cache"}) == "/x/cache"


def test_cache_dir_defaults_to_checkout():
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert mamri_tpu.compile_cache_dir({}) == os.path.join(repo, ".jax_cache")
    # an empty variable counts as unset
    assert mamri_tpu.compile_cache_dir({"JAX_COMPILATION_CACHE_DIR": ""}) == os.path.join(
        repo, ".jax_cache"
    )


def test_configure_sets_nothing_when_environment_names_a_cache(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    mamri_tpu._configure_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_configure_points_loaded_jax_at_checkout(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        mamri_tpu._configure_compile_cache()
        assert jax.config.jax_compilation_cache_dir == mamri_tpu.compile_cache_dir({})
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
