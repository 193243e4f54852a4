"""utils/compile_cache.py: where the persistent compilation cache goes."""

import jax

from swraytracing.utils import compile_cache as cc


def test_cache_at_checkout_without_env(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    before = jax.config.jax_compilation_cache_dir
    try:
        got = cc.enable_compile_cache()
        assert got == str(cc.CHECKOUT_CACHE_DIR)
        assert cc.CHECKOUT_CACHE_DIR.name == ".jax_cache"
        assert (cc.CHECKOUT_CACHE_DIR.parent / "swraytracing").is_dir()
        assert jax.config.jax_compilation_cache_dir == got
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_env_var_is_honoured(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    before = jax.config.jax_compilation_cache_dir
    got = cc.enable_compile_cache()
    assert got == str(tmp_path)
    # nothing set in code: JAX reads the variable itself
    assert jax.config.jax_compilation_cache_dir == before
