"""The compile-cache rule (utils/compile_cache.py): JAX_COMPILATION_CACHE_DIR
wins and no other directory is set; otherwise one fixed directory inside
the checkout."""

import os

import jax
import pytest

from gencore_tpu.utils import compile_cache


@pytest.fixture
def config_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update",
                        lambda name, value: calls.append((name, value)))
    return calls


def test_env_dir_is_honoured(monkeypatch, config_updates, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert compile_cache.setup_compile_cache() == str(tmp_path)
    assert compile_cache.setup_compile_cache("/elsewhere") == str(tmp_path)
    assert config_updates == []


def test_default_is_fixed_inside_checkout(monkeypatch, config_updates):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = compile_cache.setup_compile_cache()
    second = compile_cache.setup_compile_cache()
    assert first == second == os.path.join(compile_cache.REPO_ROOT,
                                           "bench_data", "jax_cache")
    assert os.path.isdir(first)
    assert config_updates == [("jax_compilation_cache_dir", first)] * 2


def test_cli_follows_the_rule(monkeypatch, config_updates, tmp_path):
    """The CLI sets no cache directory of its own when the env names one."""
    from gencore_tpu import cli
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert cli.main(["-v"]) == 0
    bam = tmp_path / "missing.bam"
    with pytest.raises(FileNotFoundError):
        cli.main(["-i", str(bam), "-o", str(tmp_path / "o.bam"),
                  "-j", str(tmp_path / "o.json"),
                  "-h", str(tmp_path / "o.html")])
    assert [c for c in config_updates
            if c[0] == "jax_compilation_cache_dir"] == []
