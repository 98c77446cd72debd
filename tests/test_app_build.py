"""End-to-end app packaging: the portable zipapp artifact builds and runs.

Counterpart of the reference's GUI app-build scripts
(``/root/reference/scripts/build_mac_app.py:1-407``,
``build_windows_app.py``): this environment has no PyInstaller or signing
toolchain, so the cross-platform builder is exercised through its
dependency-free zipapp mode, which produces a genuinely runnable artifact,
plus the PyInstaller spec-generation dry run.
"""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILDER = os.path.join(REPO, "scripts", "build_gui_app.py")


def test_zipapp_builds_and_runs(tmp_path):
    build = subprocess.run(
        [sys.executable, BUILDER, "--zipapp", str(tmp_path)], capture_output=True, text=True
    )
    assert build.returncode == 0, build.stderr
    artifact = tmp_path / "GetDistTPU-GUI.pyz"
    assert artifact.is_file() and artifact.stat().st_size > 100_000

    # the artifact must run standalone (no repo on sys.path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(JAX_PLATFORMS="cpu", MPLBACKEND="Agg")
    smoke = subprocess.run(
        [sys.executable, str(artifact), "--smoke"],
        capture_output=True,
        text=True,
        env=env,
        cwd=str(tmp_path),
    )
    assert smoke.returncode == 0, smoke.stderr
    assert "smoke ok" in smoke.stdout


def test_pyinstaller_dry_run(tmp_path):
    run = subprocess.run(
        [sys.executable, BUILDER, "--dry-run", str(tmp_path)], capture_output=True, text=True
    )
    assert run.returncode == 0, run.stderr
    assert "PyInstaller" in run.stdout
    assert (tmp_path / "_gui_launcher.py").is_file()
