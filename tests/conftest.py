"""Test configuration: run JAX on a virtual 8-device CPU mesh in float64.

The parity suite compares against the reference implementation (read-only
mount at /root/reference) in double precision; device speed is measured
by bench.py and chip_smoke.py on the GPU instead. Tests marked ``gpu``
need the card and skip elsewhere; run them there with
``GETDIST_TPU_TEST_PLATFORM=cuda python -m pytest -m gpu tests``.
"""

import os
import sys

# XLA:CPU's multi-threaded FFT is not run-to-run deterministic (a batched
# rfftn differs in the last bit between two calls of one executable), and
# the parity tests compare two runs of the f64 pipeline bit for bit; the
# suite gets its parallelism from test workers instead.
os.environ["XLA_FLAGS"] = (
    os.environ.get("XLA_FLAGS", "")
    + " --xla_force_host_platform_device_count=8 --xla_cpu_multi_thread_eigen=false"
)
# Force (not setdefault): the suite is a CPU suite even on a machine with a
# card, and tests that exec emitted plot scripts / app bundles in
# subprocesses inherit the setting. GETDIST_TPU_TEST_PLATFORM overrides it
# for the card-only tests.
os.environ["JAX_PLATFORMS"] = os.environ.get("GETDIST_TPU_TEST_PLATFORM", "cpu")

import jax

jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])
jax.config.update("jax_enable_x64", True)
# sanitizer mode (the role ruff/pre-commit + single-threading play in the
# reference, SURVEY.md section 5): trap NaNs inside jitted kernels
if os.environ.get("GETDIST_TPU_DEBUG_NANS"):
    jax.config.update("jax_debug_nans", True)

REFERENCE_PATH = "/root/reference"


def has_reference():
    return os.path.isdir(os.path.join(REFERENCE_PATH, "getdist"))


if has_reference() and REFERENCE_PATH not in sys.path:
    # Reference getdist, used purely as a numerical oracle in parity tests.
    sys.path.append(REFERENCE_PATH)

import pytest  # noqa: E402


@pytest.fixture(scope="session")
def reference_getdist():
    if not has_reference():
        pytest.skip("reference getdist not available")
    import getdist as reference

    return reference


@pytest.fixture
def gpu():
    """Skip unless JAX's default device is a GPU (decided at run time, never
    at import, so every test worker collects the same tests)."""
    from getdist_tpu import backend

    if backend.platform() != "gpu":
        pytest.skip("needs an NVIDIA GPU (run with GETDIST_TPU_TEST_PLATFORM=cuda -m gpu)")


@pytest.fixture(scope="module", autouse=True)
def _bounded_jit_cache():
    """Clear JAX's in-process jit/executable caches after every test module.

    XLA:CPU becomes unstable in a single process that has accumulated many
    hundreds of compiled executables on this host: the full suite crashed
    reproducibly (SIGSEGV inside backend_compile_and_load, or SIGABRT
    deserializing a cache entry) at the ~310th test, while the same test
    passes in isolation. Bounding live executables per module avoids the
    failure mode; the persistent disk cache keeps cross-module recompiles
    cheap."""
    yield
    import jax as _jax

    _jax.clear_caches()
