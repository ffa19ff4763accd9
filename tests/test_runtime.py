"""Process-level runtime choices: the platform predicate, the compile-cache
directory, --platform validation, and chip_smoke.py refusing to run
without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

from dvs_mcemvs_tpu.config import parse_args
from dvs_mcemvs_tpu.utils import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("platform,want", [
    ("cpu", False), ("gpu", True), ("cuda", True), ("CUDA", True)])
def test_on_accelerator_known_platforms(platform, want):
    assert runtime.on_accelerator(platform) is want


@pytest.mark.parametrize("platform", ["rocm", "metal", "neuron", ""])
def test_on_accelerator_rejects_unknown_platform(platform):
    with pytest.raises(ValueError, match="unsupported JAX platform"):
        runtime.on_accelerator(platform)


def test_on_accelerator_defaults_to_jax_backend():
    assert runtime.on_accelerator() is False   # the test session runs on CPU


def test_compile_cache_dir_from_env(monkeypatch, tmp_path):
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    assert runtime.compile_cache_dir() == str(tmp_path)


def test_compile_cache_dir_default_in_checkout(monkeypatch):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    d = runtime.compile_cache_dir()
    assert d == os.path.join(REPO, ".jax_cache")
    assert runtime.compile_cache_dir() == d   # fixed, not per call


@pytest.mark.parametrize("value", ["", "cpu", "gpu", "cuda"])
def test_platform_flag_accepts(value):
    assert parse_args([f"--platform={value}"]).platform == value


@pytest.mark.parametrize("value", ["rocm", "gpu0", "CPU"])
def test_platform_flag_rejects(value):
    with pytest.raises(ValueError, match="--platform"):
        parse_args([f"--platform={value}"])


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("XLA_FLAGS", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(REPO, os.path.join(REPO, "chip_smoke.py"))
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_outside_checkout(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(str(tmp_path), str(tmp_path / "chip_smoke.py"))
    assert r.returncode != 0
    assert r.stdout.strip() == ""
