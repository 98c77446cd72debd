"""getdist_tpu — accelerator-native MCMC sample analysis in JAX.

A ground-up JAX/XLA re-design of the capabilities of GetDist
(reference: cmbant/getdist v1.7.7): weighted chain statistics, FFT-convolved
kernel density estimation with automatic Botev Improved-Sheather-Jones
bandwidths, boundary/multiplicative-bias corrections, convergence
diagnostics, LaTeX result tables, and publication plotting.

Device-side core: ``getdist_tpu.ops`` (jit/vmap kernels) and
``getdist_tpu.parallel`` (mesh sharding / collectives). Host-side layers
(file formats, settings, tables, plots, CLI, GUI) are getdist-compatible.

Reference layer map: see SURVEY.md at the repo root; package config mirrors
the reference's ``getdist/__init__.py:26-67``.
"""

import logging
import os

__version__ = "0.5.0"
__author__ = "getdist_tpu developers"

# ---------------------------------------------------------------------------
# Package configuration (mirrors reference getdist/__init__.py:26-67:
# config.ini / env-var driven cache dir, default grid root, output dirs).
# ---------------------------------------------------------------------------


def _get_cache_dir():
    if os.name == "nt":
        base = os.environ.get("LOCALAPPDATA") or os.path.join(os.path.expanduser("~"), "AppData", "Local")
    else:
        base = os.environ.get("XDG_CACHE_HOME") or os.path.join(os.path.expanduser("~"), ".cache")
    return os.path.join(base, "getdist_tpu_cache")


def make_cache_dir():
    """Create (if needed) and return the analysis cache directory, or None on failure."""
    if not cache_dir:
        return None
    try:
        os.makedirs(cache_dir, exist_ok=True)
        return cache_dir
    except OSError:
        return None


_config_file = os.environ.get("GETDIST_TPU_CONFIG") or os.path.join(os.path.dirname(__file__), "config.ini")

default_grid_root = None
output_base_dir = None
cache_dir = _get_cache_dir()
default_plot_output = "pdf"
loglevel = None

if os.path.exists(_config_file):
    from getdist_tpu.inifile import IniFile

    _ini = IniFile(_config_file)
    default_grid_root = _ini.string("default_grid_root", "") or None
    output_base_dir = _ini.string("output_base_dir", "") or None
    cache_dir = _ini.string("cache_dir", "") or cache_dir
    default_plot_output = _ini.string("default_plot_output", default_plot_output)
    loglevel = _ini.string("logging", "") or None


# Persistent XLA compilation cache: the fused pipelines take tens of
# seconds to compile, so every process after the first starts warm. Where
# JAX_COMPILATION_CACHE_DIR is set JAX reads it itself and nothing is set
# here; otherwise the cache lives at a fixed path next to the package
# (``<checkout>/.jax_cache``), since the path is part of the cache key.
compile_cache_dir = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), ".jax_cache")
if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
    import jax as _jax

    _jax.config.update("jax_compilation_cache_dir", compile_cache_dir)
    _jax.config.update("jax_persistent_cache_min_compile_time_secs", 2.0)


def set_logging(log_level):
    """Configure package logging (mirrors reference getdist/__init__.py:20-23)."""
    logging.basicConfig(level=log_level)


def get_defaults_file(name="analysis_defaults.ini"):
    """Path of a packaged defaults ini (reference getdist/__init__.py:16-17)."""
    return os.path.join(os.path.dirname(os.path.abspath(__file__)), name)


def get_config():
    """The package config as an IniFile: $GETDIST_TPU_CONFIG or the packaged
    config.ini, empty if neither exists (reference getdist/__init__.py:26-33)."""
    from getdist_tpu.inifile import IniFile

    return IniFile(_config_file) if os.path.exists(_config_file) else IniFile()


# legacy-compatibility flag carried by the reference (getdist/__init__.py:63)
use_plot_data = False


if loglevel:
    set_logging(loglevel)

distparam_template = os.path.join(os.path.dirname(__file__), "distparam_template.ini")
default_getdist_settings = os.path.join(os.path.dirname(__file__), "analysis_defaults.ini")

# Convenience API re-exports (lazy to keep bare import cheap and to avoid
# importing jax before the caller has a chance to configure platforms/x64).
_LAZY_EXPORTS = {
    "WeightedSamples": "getdist_tpu.chains",
    "MCSamples": "getdist_tpu.mcsamples",
    "loadMCSamples": "getdist_tpu.mcsamples",
    "loadCobayaSamples": "getdist_tpu.cobaya_interface",
    "MCSamplesFromCobaya": "getdist_tpu.cobaya_interface",
    "chains": "getdist_tpu.chains",
    "IniFile": "getdist_tpu.inifile",
    "ParamInfo": "getdist_tpu.paramnames",
    "ParamNames": "getdist_tpu.paramnames",
    "get_single_plotter": "getdist_tpu.plots",
    "get_subplot_plotter": "getdist_tpu.plots",
    "ParamBounds": "getdist_tpu.parampriors",
    "CovMat": "getdist_tpu.covmat",
    "plots": "getdist_tpu.plots",
    "types": "getdist_tpu.types",
    "densities": "getdist_tpu.densities",
    "gaussian_mixtures": "getdist_tpu.gaussian_mixtures",
}
_MODULE_EXPORTS = {"chains", "plots", "types", "densities", "gaussian_mixtures"}


def __getattr__(name):
    mod = _LAZY_EXPORTS.get(name)
    if mod is None:
        raise AttributeError(f"module 'getdist_tpu' has no attribute {name!r}")
    import importlib

    module = importlib.import_module(mod)
    if name in _MODULE_EXPORTS:
        return module
    return getattr(module, name)
