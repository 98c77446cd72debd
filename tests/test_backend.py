"""The backend module's answers, the compile-cache placement, and the chip
smoke script's refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

import jax

from getdist_tpu import backend

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_cpu_answers():
    assert backend.platform() == "cpu"
    assert backend.fused_route_default() is False
    assert backend.pair_hist_route() == "scatter"
    assert backend.native_f64_fft() is True


def test_gpu_answers(monkeypatch):
    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert backend.platform() == "gpu"
    assert backend.fused_route_default() is True
    assert backend.pair_hist_route() == "cuda"
    assert backend.native_f64_fft() is True


@pytest.mark.parametrize("query", ["platform", "fused_route_default", "pair_hist_route", "native_f64_fft"])
@pytest.mark.parametrize("name", ["rocm", "METAL", "iree"])
def test_unknown_platform_raises(monkeypatch, query, name):
    monkeypatch.setattr(jax, "default_backend", lambda: name)
    with pytest.raises(RuntimeError, match="unsupported JAX platform"):
        getattr(backend, query)()


def _cache_dir_in_subprocess(env_value):
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    env["JAX_PLATFORMS"] = "cpu"
    if env_value is not None:
        env["JAX_COMPILATION_CACHE_DIR"] = env_value
    code = "import getdist_tpu, jax; print(jax.config.jax_compilation_cache_dir)"
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    return proc.stdout.strip().splitlines()[-1]


def test_compile_cache_defaults_inside_checkout():
    assert _cache_dir_in_subprocess(None) == os.path.join(ROOT, ".jax_cache")


def test_compile_cache_follows_environment(tmp_path):
    assert _cache_dir_in_subprocess(str(tmp_path / "xla")) == str(tmp_path / "xla")


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, script], cwd=cwd, env=env, capture_output=True, text=True, timeout=300)


def test_chip_smoke_refuses_cpu():
    proc = _run_smoke(ROOT, os.path.join(ROOT, "chip_smoke.py"))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
    assert "needs an NVIDIA GPU" in proc.stderr


def test_chip_smoke_refuses_outside_checkout(tmp_path):
    script = tmp_path / "chip_smoke.py"
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), script)
    proc = _run_smoke(tmp_path, str(script))
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout
