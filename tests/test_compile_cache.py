"""Compile-cache location (transport_se_tpu/utils/compile_cache.py)."""

import os
import subprocess
import sys

import pytest

from transport_se_tpu.utils import compile_cache as cc

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _in_child(env_dir):
    """cache_dir() and JAX's configured directory after
    enable_compile_cache(), in a fresh process (the setting is global)."""
    env = {k: v for k, v in os.environ.items() if k != cc.ENV}
    if env_dir is not None:
        env[cc.ENV] = env_dir
    code = ("import jax; from transport_se_tpu.utils.compile_cache import "
            "enable_compile_cache as e; p = e(); "
            "print(p); print(jax.config.jax_compilation_cache_dir)")
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         check=True).stdout.split("\n")
    return out[0], out[1]


def test_env_variable_wins(tmp_path):
    """JAX_COMPILATION_CACHE_DIR is used as set; no other cache is set."""
    got, jax_dir = _in_child(str(tmp_path))
    assert got == str(tmp_path) and jax_dir == str(tmp_path)


def test_default_is_fixed_in_checkout():
    """Without the variable: .jax_cache/ at the checkout root, the same
    path in every process (no temporary name, pid or time in it)."""
    a, jax_dir = _in_child(None)
    b, _ = _in_child(None)
    assert a == b == jax_dir == os.path.join(REPO, ".jax_cache")


def test_default_dir_is_gitignored():
    ignored = open(os.path.join(REPO, ".gitignore")).read().split()
    assert ".jax_cache/" in ignored


@pytest.mark.parametrize("value,want", [("", cc.DEFAULT_DIR),
                                        ("/some/dir", "/some/dir")])
def test_cache_dir_reads_environment(monkeypatch, value, want):
    monkeypatch.setenv(cc.ENV, value)
    assert cc.cache_dir() == want
