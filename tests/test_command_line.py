"""End-to-end CLI test (reference GetDistFileTest model,
getdist_test.py:59-100): run the batch script on simulated chains, check
outputs and the "-Ln(mean like)" statistic, then execute an emitted plot
script and check the figure file exists."""

import os
import subprocess
import sys
import types

import numpy as np
import pytest

from getdist_tpu import chains as tchains
from getdist_tpu.command_line import getdist_command, getdist_script, make_param_file
from getdist_tpu.gaussian_mixtures import Mixture2D

tchains.print_load_details = False


@pytest.fixture(scope="module")
def chain_dir(tmp_path_factory):
    tempdir = tmp_path_factory.mktemp("cli_chains")
    random_state = np.random.default_rng(10)
    prob = Mixture2D([[-1, 0], [1, 0]], [(2 / 3, 2 / 3, 0), (2 / 3, 2 / 3, 0)], label="bimodal")
    root = os.path.join(str(tempdir), "testchain")
    for n in range(3):
        mcsamples = prob.MCSamples(4000, logLikes=True, random_state=random_state)
        mcsamples.saveAsText(root, chain_index=n)
    return str(tempdir), root


def test_cli_default_settings(chain_dir, tmp_path, monkeypatch):
    tempdir, root = chain_dir
    monkeypatch.chdir(tmp_path)
    args = types.SimpleNamespace(ini_file=root, chain_root=None, ignore_rows=None, make_plots=False)
    output = getdist_script(args, exit_on_error=False)
    # reference anchor: "-Ln(mean like) = 2.31" (getdist_test.py:75)
    assert "-Ln(mean like)  = 2.31" in output
    assert os.path.exists(tmp_path / "testchain.margestats")
    assert os.path.exists(tmp_path / "testchain.likestats")
    assert os.path.exists(tmp_path / "testchain.covmat")
    assert os.path.exists(tmp_path / "testchain.corr")
    assert os.path.exists(tmp_path / "testchain.converge")


def test_cli_param_file_and_plots(chain_dir, tmp_path, monkeypatch):
    tempdir, root = chain_dir
    monkeypatch.chdir(tmp_path)
    make_param_file("testpars.ini", feedback=False)
    from getdist_tpu.inifile import IniFile

    ini = IniFile("testpars.ini")
    ini.params.update(
        {
            "triangle_plot": "T",
            "no_plots": "F",
            "plot_2D_num": "1",
            "plot1": "x y",
            "num_3D_plots": "1",
            "3D_plot1": "x y x",
            "plot_ext": "py",
            "out_dir": str(tmp_path),
            "file_root": root,
        }
    )
    ini.saveFile("testpars.ini")
    args = types.SimpleNamespace(ini_file="testpars.ini", chain_root=root, ignore_rows=0.1, make_plots=False)
    getdist_script(args, exit_on_error=False)
    # plot scripts written
    for tag in ["", "_2D", "_tri", "_3D"]:
        assert os.path.exists(tmp_path / f"testchain{tag}.py"), tag
    # executing the emitted triangle script produces the figure file
    env = dict(os.environ)
    env["PYTHONPATH"] = "/root/repo" + os.pathsep + env.get("PYTHONPATH", "")
    env.setdefault("MPLBACKEND", "Agg")
    result = subprocess.run(
        [sys.executable, str(tmp_path / "testchain_tri.py")], capture_output=True, text=True, env=env, cwd=tmp_path
    )
    assert result.returncode == 0, result.stderr[-2000:]
    assert os.path.exists(tmp_path / "testchain_tri.pdf")


def test_cli_version_flag(capsys):
    with pytest.raises(SystemExit):
        getdist_command(["--version"])


def test_cli_end_to_end_byte_parity(tmp_path, reference_getdist, capsys, monkeypatch):
    """Full getdist-tpu CLI run on chain files: stdout and every output file
    (.margestats, .likestats, .converge) byte-identical to the reference CLI."""
    import numpy as np

    from getdist_tpu.mcsamples import MCSamples

    rng = np.random.RandomState(0)
    n = 20000
    cov = np.array([[1, 0.5, 0.2], [0.5, 1, 0.3], [0.2, 0.3, 1.0]])
    x = rng.standard_normal((n, 3)) @ np.linalg.cholesky(cov).T
    mc = MCSamples(
        samples=[x[:10000], x[10000:]],
        weights=[np.ones(10000)] * 2,
        loglikes=[0.5 * np.sum(x[:10000] ** 2, 1), 0.5 * np.sum(x[10000:] ** 2, 1)],
        names=["omegam", "sigma8", "H0"],
        labels=["\\Omega_m", "\\sigma_8", "H_0"],
    )
    root = str(tmp_path / "chains" / "run")
    mc.saveChainsAsText(root, make_dirs=True)
    monkeypatch.chdir(tmp_path)  # stats files are written to the cwd
    # align load-details chatter on both sides (the module header silences ours)
    import getdist.chains as ref_chains

    from getdist_tpu import chains as gd_chains

    monkeypatch.setattr(gd_chains, "print_load_details", False)
    monkeypatch.setattr(ref_chains, "print_load_details", False)

    from getdist_tpu.command_line import getdist_command

    getdist_command([root])
    out_mine = capsys.readouterr().out
    mine_files = {}
    for ext in (".margestats", ".likestats", ".converge"):
        p = tmp_path / ("run" + ext)
        mine_files[ext] = p.read_bytes()
        p.unlink()

    from getdist.command_line import getdist_command as ref_command

    ref_command([root])
    out_ref = capsys.readouterr().out
    assert out_mine == out_ref
    for ext, data in mine_files.items():
        assert (tmp_path / ("run" + ext)).read_bytes() == data, ext


def test_emitted_plot_scripts_execute(tmp_path, monkeypatch):
    """Plot scripts written by the CLI run end-to-end from a relative
    chain_dir and produce figures (regression: get_chain_root_files
    double-joined relative rootdirs -> FileNotFoundError 'chains/chains')."""
    import subprocess
    import types as _types

    import numpy as np

    from getdist_tpu.command_line import getdist_script
    from getdist_tpu.mcsamples import MCSamples

    rng = np.random.RandomState(0)
    x = rng.standard_normal((8000, 3))
    mc = MCSamples(samples=x, names=["a", "b", "c"])
    monkeypatch.chdir(tmp_path)
    mc.saveChainsAsText("chains/run", make_dirs=True)
    (tmp_path / "opts.ini").write_text("file_root = chains/run\ntriangle_plot = T\n")
    args = _types.SimpleNamespace(ini_file="opts.ini", chain_root=None, ignore_rows=None, make_plots=False)
    getdist_script(args, exit_on_error=False)
    script = tmp_path / "run_tri.py"
    assert script.exists()
    env = dict(
        os.environ,
        MPLBACKEND="Agg",
        PYTHONPATH=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="",
    )
    proc = subprocess.run(
        [sys.executable, str(script)], cwd=tmp_path, env=env, capture_output=True, text=True, timeout=600
    )
    assert proc.returncode == 0, proc.stderr[-800:]
    assert (tmp_path / "run_tri.pdf").exists()


def test_streamlit_launcher_arg_routing(monkeypatch):
    """--port / --server.* flags route to the streamlit server side of the
    command line; the chain directory passes through to the app."""
    import subprocess as sp

    import getdist_tpu.command_line as cl

    captured = {}
    monkeypatch.setattr(sp, "Popen", lambda cmd, env=None: captured.setdefault("cmd", cmd))
    monkeypatch.setattr(cl, "subprocess", sp)
    import importlib.util as ilu

    real_find = ilu.find_spec
    monkeypatch.setattr(ilu, "find_spec", lambda name: object() if name == "streamlit" else real_find(name))

    cl.getdist_streamlit(["--port", "8502", "/tmp/chains", "--server.headless=true"])
    cmd = captured["cmd"]
    sep = cmd.index("--")
    assert "--server.port" in cmd[:sep] and "8502" in cmd[:sep]
    assert "--server.headless=true" in cmd[:sep]
    assert cmd[sep + 1 :] == ["/tmp/chains"]
