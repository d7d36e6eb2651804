"""Where the persistent compilation cache lives."""

import os

import pytest

import nnet_asr_tpu
from nnet_asr_tpu import compilation_cache_dir


@pytest.mark.parametrize("env", [None, "/some/cache"])
def test_compilation_cache_dir(env, monkeypatch):
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        root = os.path.dirname(os.path.dirname(
            os.path.abspath(nnet_asr_tpu.__file__)))
        got = compilation_cache_dir()
        # fixed, inside the checkout, no per-process or temporary part
        assert got == os.path.join(root, ".jax_cache")
        assert str(os.getpid()) not in got and "tmp" not in got.lower()
        assert got == compilation_cache_dir()
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert compilation_cache_dir() == env
