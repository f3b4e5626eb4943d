"""The measurement entry points refuse to run without a GPU, and the
compile-cache helper honours JAX_COMPILATION_CACHE_DIR.

bench.py and chip_smoke.py time and check the card; on any other platform
they must exit non-zero and print no result (no CPU fallback that would
hide the device). chip_smoke.py must also fail when it stands alone, away
from the package."""

import json
import os
import shutil
import subprocess
import sys

import pytest

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _run(script, cwd):
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.run(
        [sys.executable, script], cwd=cwd, env=env,
        capture_output=True, text=True, timeout=300,
    )


def _printed_result(stdout: str) -> bool:
    for line in stdout.splitlines():
        try:
            if isinstance(json.loads(line), dict):
                return True
        except ValueError:
            pass
    return False


@pytest.mark.parametrize("script", ["bench.py", "chip_smoke.py"])
def test_script_fails_without_gpu(script):
    out = _run(os.path.join(_REPO, script), _REPO)
    assert out.returncode != 0, out.stdout[-2000:]
    assert "needs a GPU" in out.stderr, out.stderr[-2000:]
    assert not _printed_result(out.stdout), out.stdout[-2000:]


def test_chip_smoke_alone_fails(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    out = _run("chip_smoke.py", str(tmp_path))
    assert out.returncode != 0
    assert not _printed_result(out.stdout), out.stdout[-2000:]


@pytest.mark.parametrize("env_dir", [None, "custom"])
def test_compile_cache_dir(monkeypatch, tmp_path, env_dir):
    import jax

    from monte_carlo_path_tracing_tpu.utils import compile_cache

    before = jax.config.jax_compilation_cache_dir
    try:
        if env_dir is None:
            monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
            got = compile_cache.enable_compile_cache()
            assert got == os.path.join(_REPO, ".jax_cache")
            assert jax.config.jax_compilation_cache_dir == got
        else:
            path = str(tmp_path / env_dir)
            monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", path)
            jax.config.update("jax_compilation_cache_dir", before)
            assert compile_cache.enable_compile_cache() == path
            # the variable is JAX's own: nothing else is set
            assert jax.config.jax_compilation_cache_dir == before
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
