"""utils/device.py: one platform decision, no silent CPU fallback, the
compile-cache location; utils/timing.py: the block_until_ready idiom."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import pytest

from arcanefem_tpu.utils import device
from arcanefem_tpu.utils.timing import time_call, timed

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def cache_env(monkeypatch, tmp_path):
    """Point the compile cache at a scratch dir and restore JAX's config."""
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path))
    yield tmp_path
    jax.config.update("jax_compilation_cache_dir", before)


def test_setup_cpu_when_asked(cache_env):
    dev = device.setup(cpu=True)
    assert dev.platform == "cpu"
    assert device.describe() == {"platform": "cpu", "device_kind": "cpu",
                                 "device_count": jax.device_count()}


def test_setup_pins_highest_matmul_precision(cache_env):
    jax.config.update("jax_default_matmul_precision", None)
    try:
        device.setup(cpu=True)
        assert jax.config.jax_default_matmul_precision == "highest"
    finally:
        jax.config.update("jax_default_matmul_precision", "highest")


def test_setup_refuses_cpu_when_gpu_required(cache_env):
    with pytest.raises(device.NoGpuError):
        device.setup(cpu=False)


def test_compile_cache_follows_env(cache_env):
    before = jax.config.jax_compilation_cache_dir
    assert device.compile_cache_dir() == str(cache_env)
    # JAX reads the variable itself; the helper sets nothing
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo(monkeypatch):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    try:
        path = device.compile_cache_dir()
        assert path == os.path.join(REPO, ".jax_cache")
        assert jax.config.jax_compilation_cache_dir == path
    finally:
        jax.config.update("jax_compilation_cache_dir", before)


def test_cpu_pinned_in_tests():
    assert device.cpu_pinned()


@pytest.mark.parametrize("argv", [
    ["bench.py"],
    ["-m", "arcanefem_tpu", "testlab", "--rect", "4", "--cross-validate"],
])
def test_entry_points_fail_without_gpu(argv, tmp_path):
    """No CPU fallback: with only the CPU visible and no explicit request,
    the run fails and prints no result."""
    env = dict(os.environ, JAX_PLATFORMS="", BENCH_CPU="0",
               JAX_COMPILATION_CACHE_DIR=str(tmp_path))
    env.pop("XLA_FLAGS", None)
    proc = subprocess.run([sys.executable, *argv], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode != 0
    assert "NoGpuError" in proc.stderr
    assert "{" not in proc.stdout


def test_time_call_blocks_and_reports():
    f = jax.jit(lambda x: jnp.sum(x * x))
    x = jnp.arange(1000.0)
    out, first, best = time_call(f, x, reps=2)
    assert float(out) == float(jnp.sum(x * x))
    assert first > 0 and 0 < best < float("inf")
    y, t = timed(f, x)
    assert t > 0 and float(y) == float(out)
