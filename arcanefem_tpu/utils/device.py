"""Where the program runs: platform, compile cache and matmul precision.

The accelerator is an NVIDIA GPU.  Every entry point (``bench.py``,
``chip_smoke.py``, the CLI and the assembly lab) calls :func:`setup` once,
before its first JAX computation.  It never falls back: a run that needs a
GPU and finds none raises :class:`NoGpuError`.  The CPU is used only when
the caller asks for it (``cpu=True``: ``JAX_PLATFORMS=cpu`` for the CLI and
the assembly lab, the test suite, ``BENCH_CPU=1``, the virtual-device
children of the sweeps and the multi-device dry run).

Precision policy: on Hopper an f32 ``dot_general`` at default precision may
run in TF32, which keeps about three decimal digits.  :func:`setup` sets
JAX's default matmul precision to ``highest`` for the whole process, so
every f32 contraction (BELL SpMV, block-Jacobi, AMG transfers and coarse
solve, GMRES projections, Krylov dots) keeps full f32 products; f64
contractions are unaffected by the setting.
"""

from __future__ import annotations

import os

import jax

_REPO_ROOT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


class NoGpuError(RuntimeError):
    """A GPU run was requested and JAX found no GPU."""


def compile_cache_dir() -> str:
    """Persistent compile cache: ``JAX_COMPILATION_CACHE_DIR`` when set (JAX
    reads the variable itself), else ``<repo>/.jax_cache``."""
    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(_REPO_ROOT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def setup(cpu: bool = False, x64: bool = False) -> jax.Device:
    """Configure this process and return the device it computes on.

    cpu=True pins the CPU platform; otherwise the first device must be a
    GPU.  x64 enables float64 arrays (the H100 runs fp64 natively).
    """
    if cpu:
        jax.config.update("jax_platforms", "cpu")
    if x64:
        jax.config.update("jax_enable_x64", True)
    jax.config.update("jax_default_matmul_precision", "highest")
    compile_cache_dir()
    dev = jax.devices()[0]
    if not cpu and dev.platform != "gpu":
        raise NoGpuError(
            f"no GPU found (JAX reports {dev.platform!r} devices); "
            "ask for the CPU explicitly to run there")
    return dev


def cpu_pinned() -> bool:
    """True when the process was already pinned to the CPU before setup:
    ``JAX_PLATFORMS=cpu`` in the environment or the test suite's
    ``jax.config.update("jax_platforms", "cpu")``."""
    return (jax.config.jax_platforms or "") == "cpu"


def describe() -> dict:
    """The device fields every benchmark result carries."""
    dev = jax.devices()[0]
    return {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": jax.device_count(),
    }


def peak_bytes() -> int | None:
    """Peak device memory of this process so far (None where the backend
    does not report it, e.g. the CPU)."""
    stats = jax.devices()[0].memory_stats()
    return None if not stats else int(stats["peak_bytes_in_use"])
