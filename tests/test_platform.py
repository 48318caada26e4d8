"""The platform policy (utils/platform.policy) and the compile-cache
location."""

import os

import jax
import pytest

from hiprfish_tpu.utils import platform as plat


def test_policy_cpu():
    p = plat.policy()
    assert jax.default_backend() == "cpu"
    assert p == plat.policy("cpu")
    assert (p.bf16_dots, p.lp3d_bf16, p.cli_engine, p.nlm_kernel) == \
        (False, False, "host", "xla")


def test_policy_gpu_via_default_backend(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    p = plat.policy()
    assert (p.bf16_dots, p.lp3d_bf16, p.cli_engine, p.nlm_kernel) == \
        (True, True, "fused", "triton")


def test_policy_unknown_backend_is_an_error():
    with pytest.raises(ValueError, match="no platform policy"):
        plat.policy("tpu")


def test_call_sites_ask_the_policy(monkeypatch):
    from hiprfish_tpu.ops import segstats

    assert segstats._use_bf16_dots() is False
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert segstats._use_bf16_dots() is True


def test_compile_cache_env_wins(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    assert plat.compile_cache_dir() == str(tmp_path / "c")


def test_compile_cache_default_is_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert plat.compile_cache_dir() == os.path.join(root, ".jax_cache")


def test_apply_compile_cache_env_sets_jax_config(monkeypatch, tmp_path):
    old = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "cc"))
    try:
        plat.apply_compile_cache_env()
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "cc")
        assert os.path.isdir(tmp_path / "cc")
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
