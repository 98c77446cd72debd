"""MCSamples: the high-level sample-analysis engine.

Getdist-compatible API (reference ``getdist/mcsamples.py``) over the
device-side numerical core: fine binning is an XLA scatter-add
(``ops.binning``), all KDE smoothing/boundary/bias convolutions are device
FFT kernels (``ops.convolve``), and weighted statistics come from
``ops.stats`` via the Chains layer. Bandwidth optimization runs on the
parity-exact host path (``kde_bandwidth``). The fully-fused, vmapped
all-pairs pipeline used for benchmarks lives in ``ops.kde`` /
``ops.batched``; this module is the reference-parity orchestration with
identical settings, fallbacks and output formats.
"""

import copy
import glob
import logging
import math
import os
import pickle
import time
from collections.abc import Iterable, Mapping
from typing import Any

import numpy as np
from scipy.stats import norm

import jax.numpy as jnp

import getdist_tpu
from getdist_tpu import backend, chains, cobaya_interface, covmat
from getdist_tpu import kde_bandwidth as kde
from getdist_tpu import types
from getdist_tpu.chains import Chains, ParamError, WeightedSampleError, chainFiles, last_modified
from getdist_tpu.cobaya_interface import MCSamplesFromCobaya
from getdist_tpu.densities import Density1D, Density2D, DensityND
from getdist_tpu.densities import getContourLevels as getImportContourLevels
from getdist_tpu.inifile import IniFile
from getdist_tpu.ops.binning import weighted_bincount, weighted_bincount_2d
from getdist_tpu.ops.convolve import convolve1D as _dev_convolve1D
from getdist_tpu.ops.convolve import convolve1D_host as _host_convolve1D
from getdist_tpu.ops.convolve import convolve2D as _dev_convolve2D
from getdist_tpu.ops.convolve import convolve2D_host as _host_convolve2D
from getdist_tpu.paramnames import ParamInfo, ParamNames
from getdist_tpu.parampriors import ParamBounds

pickle_version = 22


class MCSamplesError(WeightedSampleError):
    """Error raised by MCSamples operations."""


class SettingError(MCSamplesError):
    """Bad analysis settings."""


class BandwidthError(MCSamplesError):
    """KDE bandwidth determination failure."""


# The parity path's per-call ops act on few-hundred-bin grids where one
# device dispatch (plus a per-shape jit compile) costs orders of magnitude
# more than the op itself, so they run on the host by default;
# GETDIST_TPU_DEVICE_OPS=1 forces the device versions.
# The fused bulk pipelines (ops.batched / fastTriangleDensities) are always
# device-resident.
_use_device_ops = bool(os.environ.get("GETDIST_TPU_DEVICE_OPS"))


def convolve1D(x, y, mode, cache=None, cache_args=None, largest_size=0):
    if _use_device_ops:
        return np.array(_dev_convolve1D(jnp.asarray(x), jnp.asarray(y), mode, largest_size=largest_size))
    return _host_convolve1D(x, y, mode, largest_size=largest_size)


def convolve2D(x, y, mode, largest_size=0, cache=None, cache_args=None):
    if _use_device_ops:
        return np.array(_dev_convolve2D(jnp.asarray(x), jnp.asarray(y), mode, largest_size=largest_size))
    return _host_convolve2D(x, y, mode, largest_size=largest_size)


def _bincount(ix, weights, nbins):
    """Weighted histogram for the parity path (host by default)."""
    if _use_device_ops:
        return np.array(weighted_bincount(jnp.asarray(ix), jnp.asarray(weights), nbins))
    return np.bincount(np.asarray(ix), weights=np.asarray(weights), minlength=nbins)


def _bincount2d(ixs, iys, weights, xsize, ysize):
    """Weighted 2D histogram (rows = y) for the parity path."""
    if _use_device_ops:
        return np.array(weighted_bincount_2d(jnp.asarray(ixs), jnp.asarray(iys), jnp.asarray(weights), xsize, ysize))
    flat = np.bincount(np.asarray(iys) * xsize + np.asarray(ixs), weights=np.asarray(weights), minlength=xsize * ysize)
    return flat.reshape((ysize, xsize))


def loadMCSamples(
    file_root: str, ini=None, jobItem=None, no_cache=False, settings: Mapping[str, Any] | None = None,
    chain_exclude=None
) -> "MCSamples":
    """Load samples from chain text files, with pickle caching.

    Chain files are ``file_root.txt`` or ``file_root_1.txt`` etc, with
    sidecar ``.paramnames`` / ``.ranges`` / ``.properties.ini`` files.
    The analyzed object is cached in the package cache dir, invalidated by
    source mtimes and analysis-relevant settings (reference
    ``mcsamples.py:47-126``).

    :param file_root: root name (no extension)
    :param ini: .ini filename or IniFile with analysis settings
    :param jobItem: optional grid jobItem
    :param no_cache: delete/ignore any pickle cache
    :param settings: dict of analysis setting overrides
    :param chain_exclude: chain indices to exclude
    """
    if chain_exclude:
        no_cache = True
    for separator in ("_", "."):
        files = chainFiles(file_root, separator=separator, chain_exclude=chain_exclude)
        if files:
            break
    cachefile = _cache_path(file_root)
    samples = MCSamples(file_root, jobItem=jobItem, ini=ini, settings=settings)
    if not no_cache:
        cached = _load_valid_cache(cachefile, _source_files(file_root, files), samples, ini, settings)
        if cached is not None:
            return cached
    if not files:
        raise OSError(f"no chain files found for root {file_root}")
    samples.readChains(files)
    if no_cache:
        if os.path.exists(cachefile):
            os.remove(cachefile)
    else:
        samples.savePickle(cachefile)
    return samples


def _cache_path(file_root):
    """Pickle-cache filename: in the package cache dir keyed by a path hash,
    or next to the chains when no cache dir is configured."""
    folder, name = os.path.split(file_root)
    cache_dir = getdist_tpu.make_cache_dir()
    if cache_dir:
        import hashlib

        name += "_" + hashlib.md5(os.path.abspath(folder).encode("utf-8")).hexdigest()[:10]
        folder = cache_dir
    if not os.path.exists(folder):
        os.mkdir(folder)
    return os.path.join(folder, name) + ".py_mcsamples"


def _source_files(file_root, files):
    """Chain files plus the metadata sidecars whose mtimes gate the cache."""
    if os.path.isfile(f"{file_root}.paramnames"):
        return files + [file_root + ext for ext in (".ranges", ".paramnames", ".properties.ini")]
    # Cobaya: any updated/full yaml next to the chains
    folder = os.path.dirname(file_root)
    prefix = os.path.basename(file_root)
    yamls = [
        os.path.join(folder, f)
        for f in os.listdir(folder)
        if f.startswith(prefix) and f.lower().endswith(("updated.yaml", "full.yaml"))
    ]
    return files + yamls


def _load_valid_cache(cachefile, source_files, samples, ini, settings):
    """The cached analyzed object, when newer than every source and built
    with the same version/burn/weight-filter settings; else None.  A
    contour-set change refreshes settings on the cached object in place."""
    if not os.path.exists(cachefile) or last_modified(source_files) >= os.path.getmtime(cachefile):
        return None
    try:
        with open(cachefile, "rb") as handle:
            cache = pickle.load(handle)
        same_build = (
            cache.version == pickle_version
            and cache.ignore_rows == samples.ignore_rows
            and cache.min_weight_ratio == samples.min_weight_ratio
        )
        if not same_build:
            return None
        contours_changed = list(np.ravel(samples.contours)) != list(np.ravel(cache.contours))
        cache.updateSettings(ini=ini, settings=settings, doUpdate=contours_changed)
        return cache
    except Exception:
        return None


# defaults applied as attributes of every MCSamples before settings merge;
# keys mirror analysis_defaults.ini (values here are the hard-coded floor)
_BASE_ANALYSIS_SETTINGS = dict(
    range_ND_contour=1,
    range_confidence=0.001,
    num_bins=128,
    fine_bins=1024,
    num_bins_2D=40,
    fine_bins_2D=256,
    smooth_scale_1D=-1.0,
    smooth_scale_2D=-1.0,
    num_bins_ND=12,
    boundary_correction_order=1,
    mult_bias_correction_order=1,
    max_corr_2D=0.95,
    use_effective_samples_2D=False,
    max_scatter_points=2000,
    credible_interval_threshold=0.05,
    shade_likes_is_mean_loglikes=False,
    max_mult=0.0,
    mean_mult=0.0,
    plot_data_dir="",
    rootdirname="",
    indep_thin=0,
    subplot_size_inch=4.0,
    subplot_size_inch3=6.0,
    out_dir="",
    no_warning_chi2_params=True,
    max_split_tests=4,
    force_twotail=False,
    corr_length_thin=0,
    corr_length_steps=15,
    converge_test_limit=0.95,
    done_1Dbins=False,
)


class Kernel1D:
    """Discrete normalized Gaussian window over [-winw, winw] bins."""

    def __init__(self, winw, h):
        self.winw = winw
        self.h = h
        self.x = np.arange(-winw, winw + 1)
        win = np.exp(-((self.x / h) ** 2) / 2.0)
        self.Win = win / np.sum(win)


class MCSamples(Chains):
    """High-level collection of parameter samples: KDE densities with
    automatic bandwidths and boundary/bias corrections, marginalized limits,
    convergence diagnostics, PCA, and LaTeX result tables."""

    def __init__(
        self, root: str | None = None, jobItem=None, ini=None, settings: Mapping[str, Any] | None = None, ranges=None,
        samples: np.ndarray | Iterable[np.ndarray] | None = None,
        weights: np.ndarray | Iterable[np.ndarray] | None = None,
        loglikes: np.ndarray | Iterable[np.ndarray] | None = None, temperature: float | None = None, **kwargs
    ):
        """
        See ``analysis_defaults.ini`` for analysis settings.

        :param root: file root to load from
        :param jobItem: grid jobItem (with chainRoot/batchPath)
        :param ini: .ini file (or IniFile) of analysis settings
        :param settings: dict of setting overrides
        :param ranges: dict/list of hard prior bounds per parameter; a
            triplet [min, max, True] marks a periodic parameter
        :param samples: array (or list of arrays) of sample values
        :param weights: weights array(s)
        :param loglikes: -log(posterior) array(s)
        :param temperature: sampling temperature (default from
            .properties.ini or 1)
        :param kwargs: paramNamesFile/names/labels/renames/ignore_rows/
            label/name_tag/sampler passed to inherited classes
        """
        super().__init__(root, jobItem=jobItem, **kwargs)

        self.version = pickle_version
        self.markers, self.ini = {}, ini
        self.batch_path = self.jobItem.batchPath if self.jobItem else ""

        self._readRanges()
        if ranges is not None:
            self.setRanges(ranges)

        # baseline analysis settings (overridden by analysis_defaults.ini /
        # user ini / settings dict in updateSettings below)
        for key, value in _BASE_ANALYSIS_SETTINGS.items():
            setattr(self, key, value)
        self.contours = np.array([0.68, 0.95])
        self.likeStats, self.no_warning_params, self.density1D = None, [], {}
        self.plot_output = getdist_tpu.default_plot_output
        self.subplot_size_inch2 = self.subplot_size_inch
        self.rootname = os.path.basename(root) if root else ""

        if "ignore_rows" in kwargs:
            settings = dict(settings or {})
            settings["ignore_rows"] = kwargs["ignore_rows"]
        self.ignore_rows = float(kwargs.get("ignore_rows") or 0)
        if not np.isclose(self.ignore_rows, 0) and self.sampler == "nested":
            raise ValueError("nested-sampler samples have no burn-in phase to remove")

        self.updateSettings(ini=ini, settings=settings)

        sidecar = root + ".properties.ini" if root else None
        if sidecar and os.path.exists(sidecar):
            self._adopt_properties_ini(root, kwargs)
        else:
            self._adopt_cobaya_properties(root, kwargs, temperature)
        if self.ignore_frac or self.ignore_rows:
            self.properties.params["burn_removed"] = True

        if samples is not None:
            self.readChains(samples, weights, loglikes)

    def _mark_burn_removed(self):
        self.ignore_frac = 0.0
        self.ignore_lines = 0

    def _adopt_properties_ini(self, root, kwargs):
        """Per-chain .properties.ini overrides the generic settings."""
        own_ini = root + ".properties.ini"
        self.properties = IniFile(own_ini)
        self._setBurnOptions(self.properties)
        if self.properties.bool("burn_removed", False):
            self._mark_burn_removed()
        if not self.label:
            self.label = self.properties.params.get("label")
        if "sampler" not in kwargs:
            self.setSampler(self.properties.string("sampler", self.sampler))

    def _adopt_cobaya_properties(self, root, kwargs, temperature):
        """Chain properties inferred from a Cobaya yaml info block, if any."""
        self.properties = IniFile()
        info = self.paramNames.info_dict if root and self.paramNames else None
        if info:
            if cobaya_interface.get_burn_removed(info):
                self.properties.params["burn_removed"] = True
                self._mark_burn_removed()
            if not self.label:
                self.label = cobaya_interface.get_sample_label(info)
                if self.label:
                    self.properties.params["label"] = self.label
            if "sampler" not in kwargs:
                self.setSampler(cobaya_interface.get_sampler_type(info))
            self.properties.params["sampler"] = self.sampler
            if temperature is None:
                temperature = cobaya_interface.get_sampler_temperature(info)
        if temperature not in (None, 1):
            self.properties.params["temperature"] = temperature

    def _WritePlotFile(self, filename, subplot_size, text, tag, ext=None):
        if not self.root:
            raise ValueError("plot scripts need file-rooted samples (no root set)")
        fname = self.rootname + tag + "." + (ext or self.plot_output)
        script = [
            "import getdist_tpu.plots as plots, os",
            "g=plots.GetDistPlotter(chain_dir=r'%s')" % (self.batch_path or os.path.dirname(self.root)),
            "g.settings.set_with_subplot_size(%s)" % subplot_size,
            "roots = ['%s']" % self.rootname,
            text,
            f"g.export(os.path.join(r'{self.out_dir}',r'{fname}'))",
        ]
        with open(filename, "w", encoding="utf-8") as handle:
            handle.write("\n".join(script) + "\n")

    def _writeScriptPlots3D(self, filename, plot_3D, ext=None):
        rows = ["sets=[]"]
        rows.extend("sets.append(['{}','{}','{}'])".format(*pars) for pars in plot_3D)
        rows.append("g.plots_3d(roots,sets)")
        self._WritePlotFile(filename, self.subplot_size_inch3, "\n".join(rows), "_3D", ext)

    def _writeScriptPlotsTri(self, filename, triangle_params, ext=None):
        self._WritePlotFile(filename, self.subplot_size_inch, "g.triangle_plot(roots, %s)" % triangle_params, "_tri", ext)

    def _writeScriptPlots2D(self, filename, plot_2D_param=None, cust2DPlots=(), ext=None):
        restricted = bool(plot_2D_param) or bool(len(cust2DPlots))
        wanted = {f"{a}__{b}" for a, b in cust2DPlots}
        done2D = {}
        lines = ["pairs=[]"]
        for j, name1 in enumerate(self.paramNames.list()):
            if restricted and name1 == plot_2D_param:
                continue
            start = 0 if restricted else j + 1
            for j2 in range(start, self.n):
                name2 = self.parName(j2)
                if plot_2D_param and name2 != plot_2D_param:
                    continue
                if wanted and f"{name1}__{name2}" not in wanted:
                    continue
                if (name1, name2) not in done2D:
                    done2D[(name1, name2)] = True
                    lines.append(f"pairs.append(['{name1}','{name2}'])")
        lines.append("g.plots_2d(roots,param_pairs=pairs,filled=True)")
        self._WritePlotFile(filename, self.subplot_size_inch2, "\n".join(lines), "_2D", ext)
        return done2D

    def _writeScriptPlots1D(self, filename, plotparams=None, ext=None):
        rows = ["markers = " + (str(self.markers) if self.markers else "None")]
        if plotparams:
            quoted = ",".join(f"'{name}'" for name in plotparams)
            rows.append(f"g.plots_1d(roots,[{quoted}], markers=markers)")
        else:
            rows.append("g.plots_1d(roots, markers=markers)")
        self._WritePlotFile(filename, self.subplot_size_inch, "\n".join(rows), "", ext)

    class _RLAbort(Exception):
        """Raftery-Lewis hit a degenerate fitted count; abort the battery."""

    class _RLChainFail(Exception):
        """This chain cannot be RL-analysed (zero transitions)."""

    @staticmethod
    def _rl_binary_transitions(values, threshold, order):
        """Transition-count tensor of the thresholded binary chain: shape
        (2,)*(order+1), counting order+1-grams."""
        bits = (values < threshold).astype(int)
        grams = 0
        for shift in range(order + 1):
            stop = bits.size - order + shift
            grams = grams * 2 + bits[shift:stop]
        return np.bincount(grams, minlength=2 ** (order + 1)).reshape((2,) * (order + 1))

    @staticmethod
    def _rl_g2_second_vs_markov(tran):
        """2 * G^2 likelihood-ratio of a 2nd-order binary process against
        1st-order, from the (2,2,2) trigram counts."""
        lead = tran.sum(axis=2, keepdims=True)
        trail = tran.sum(axis=0, keepdims=True)
        mid = tran.sum(axis=(0, 2), keepdims=True)
        with np.errstate(divide="ignore", invalid="ignore"):
            fitted = lead * trail / mid
            pieces = np.where(tran != 0, np.log(tran / fitted) * tran, 0.0)
        return 2 * pieces.sum()

    def _rl_g2_markov_vs_indep(self, tran2, thin_rows):
        """2 * G^2 of a Markov binary process against independence, from the
        (2,2) bigram counts; aborts the battery on degenerate fits."""
        expected = tran2.sum(axis=1, keepdims=True) * tran2.sum(axis=0, keepdims=True) / float(thin_rows - 1)
        live = tran2 != 0
        if np.any(live & ((expected <= 0) | (tran2 <= 0))):
            raise self._RLAbort()
        with np.errstate(divide="ignore", invalid="ignore"):
            pieces = np.where(live, np.log(tran2 / expected) * tran2, 0.0)
        return 2 * pieces.sum()

    def _rl_analyse_chain(self, chain, limits, nparamMC, test_confidence, shared):
        """Raftery-Lewis numbers for one chain: (markov_thin, indep_thin,
        nburn).  ``shared`` carries the hardest (param, end) across chains.
        Cf. reference ``mcsamples.py:1039-1181``.
        """
        epsilon = 0.001
        thin_fac = int(round(np.max(chain.weights)))
        nburn = 0
        for j in range(nparamMC):
            edges = self.confidence(chain.samples[:, j], limits, weights=chain.weights)
            for endb in (0, 1):
                # grow the thinning until 2nd-order structure is gone (BIC)
                tran = None
                while True:
                    thin_ix = self.thin_indices(thin_fac, chain.weights)
                    thin_rows = len(thin_ix)
                    if thin_rows < 2:
                        break
                    tran = self._rl_binary_transitions(chain.samples[thin_ix, j], edges[endb], order=2)
                    if self._rl_g2_second_vs_markov(tran) - math.log(float(thin_rows - 2)) * 2 < 0:
                        break
                    thin_fac += 1
                # burn-in from the thinned chain's Markov transition rates
                if tran is None or not (tran[:, 0, 1].sum() and tran[:, 1, 0].sum()):
                    raise self._RLChainFail()
                alpha = tran[:, 0, 1].sum() / float(tran[:, 0, 0].sum() + tran[:, 0, 1].sum())
                beta = tran[:, 1, 0].sum() / float(tran[:, 1, 0].sum() + tran[:, 1, 1].sum())
                switch_rate = alpha + beta
                decay = math.log(switch_rate * epsilon / max(alpha, beta)) / math.log(abs(1.0 - switch_rate))
                if int(decay + 1) * thin_fac > nburn:
                    nburn = int(decay + 1) * thin_fac
                    shared["hardest"] = j
                    shared["hardestend"] = endb

        markov_thin = thin_fac
        # continue growing until even Markov structure is gone -> independence
        hardest = max(shared["hardest"], 0)
        u = self.confidence(
            self.samples[:, hardest], (1 - test_confidence) / 2, shared["hardestend"] == 0
        )
        while True:
            thin_ix = self.thin_indices(thin_fac, chain.weights)
            thin_rows = len(thin_ix)
            if thin_rows < 2:
                break
            tran2 = self._rl_binary_transitions(chain.samples[thin_ix, hardest], u, order=1)
            if self._rl_g2_markov_vs_indep(tran2, thin_rows) - np.log(float(thin_rows - 1)) < 0:
                break
            thin_fac += 1
        if thin_rows < 2:
            thin_fac = 0
        return markov_thin, thin_fac, nburn

    def _report_corr_lengths(self, out, chainlist, parNames, parForm):
        out.append(
            "Parameter autocorrelation lengths (effective number of samples N_eff = tot weight/weight length)\n"
        )
        out.append("\n")
        out.append(parForm % "" + "%15s %15s %15s\n" % ("Weight Length", "Sample length", "N_eff"))
        maxoff = min(chain.weights.size // 10 for chain in chainlist)
        form = "%15.2f" if self.mean_mult > 1 else "%15.2E"
        longest = 0
        for j in range(self.n):
            curve = sum(chain.getAutocorrelation(j, maxoff, normalized=False) * chain.norm for chain in chainlist)
            curve /= self.norm * self.vars[j]
            cut = np.argmin(curve > 0.05 * curve[0])
            N = curve[0] + 2 * np.sum(curve[1:cut])
            longest = max(N, longest)
            out.append(parNames[j] + form % N + " %15.2f %15i\n" % (N / self.mean_mult, self.norm / N))
        self.indep_thin = longest
        out.append("\n")

    def _report_mean_var(self, out, chainlist, parNames):
        out.append("\n")
        out.append("mean convergence stats using remaining chains\n")
        out.append("param sqrt(var(chain mean)/mean(chain var))\n")
        out.append("\n")
        between = sum((chain.means - self.means) ** 2 for chain in chainlist) / (len(chainlist) - 1)
        within = (
            np.array([[np.dot(chain.weights, d * d) for d in chain.diffs] for chain in chainlist]).sum(axis=0)
            / self.norm
        )
        for j in range(self.n):
            out.append(parNames[j] + f"{math.sqrt(between[j] / within[j]):10.4f}  {self.parLabel(j)}\n")
        out.append("\n")

    def _report_gelman_rubin(self, out, chainlist, feedback):
        eigs = self.getGelmanRubinEigenvalues(chainlist=chainlist)
        if eigs is None:
            self.GelmanRubin = None
            summary = "Gelman-Rubin covariance not invertible (parameter not moved?)"
            logging.warning(summary)
        else:
            self.GelmanRubin = np.max(eigs)
            out.append("var(mean)/mean(var) for eigenvalues of covariance of y of orthonormalized parameters\n")
            out.extend("%3i%13.5f\n" % (k + 1, val) for k, val in enumerate(eigs))
            summary = " var(mean)/mean(var), remaining chains, worst e-value: R-1 = %13.5F" % self.GelmanRubin
        if feedback:
            print(summary)
        out.append("\n")

    def _report_split_test(self, out, parNames, limits):
        out.append(
            "Split tests: rms_n([delta(upper/lower quantile)]/sd) n={2,3,4}, limit=%.0f%%:\n"
            % (100 * self.converge_test_limit)
        )
        out.append("i.e. mean sample splitting change in the quantiles in units of the st. dev.\n")
        out.append("\n")
        n_splits = self.max_split_tests - 1
        partitions = [self.getFractionIndices(self.weights, k + 2) for k in range(n_splits)]
        for j in range(self.n):
            column = self.samples[:, j]
            whole = self.confidence(column, limits)
            rms = np.zeros((n_splits, 2))
            for ix, cuts in enumerate(partitions):
                for lo, hi in zip(cuts[:-1], cuts[1:]):
                    rms[ix] += (self.confidence(column, limits, start=lo, end=hi) - whole) ** 2
                rms[ix] = np.sqrt(rms[ix] / (ix + 2)) / self.sddev[j]
            for endb, tail_name in enumerate(("upper", "lower")):
                out.append(parNames[j] + "".join("%9.4f" % rms[ix, endb] for ix in range(n_splits)) + " %s\n" % tail_name)
        out.append("\n")

    def _report_raftery_lewis(self, out, chainlist, limits, nparamMC, test_confidence, feedback):
        num = len(chainlist)
        markov_thin = np.zeros(num, dtype=int)
        thin_fac = np.zeros(num, dtype=int)
        nburn = np.zeros(num, dtype=int)
        shared = {"hardest": -1, "hardestend": 0}
        for ix, chain in enumerate(chainlist):
            try:
                markov_thin[ix], thin_fac[ix], nburn[ix] = self._rl_analyse_chain(
                    chain, limits, nparamMC, test_confidence, shared
                )
            except self._RLAbort:
                raise
            except Exception:
                # numerical failure on this chain -> reported as Failed
                thin_fac[ix] = 0
        out.append("Raftery&Lewis statistics\n")
        out.append("\n")
        out.append("chain  markov_thin  indep_thin    nburn\n")
        for ix in range(num):
            if thin_fac[ix] == 0:
                out.append("%4i      Failed/not enough samples\n" % ix)
            else:
                out.append("%4i%12i%12i%12i\n" % (ix, markov_thin[ix], thin_fac[ix], nburn[ix]))
        self.RL_indep_thin = np.max(thin_fac)
        if feedback:
            if not np.all(thin_fac != 0):
                print("RL: Not enough samples to estimate convergence stats")
            else:
                print("RL: Thin for Markov: ", np.max(markov_thin))
                print("RL: Thin for indep samples:  ", str(self.RL_indep_thin))
                print(
                    "RL: Estimated burn in steps: ",
                    np.max(nburn),
                    " (",
                    int(round(np.max(nburn) / self.mean_mult)),
                    " rows)",
                )
        out.append("\n")

    def _report_corr_steps(self, out, chainlist, parNames, parForm):
        out.append("Parameter auto-correlations as function of step separation\n")
        out.append("\n")
        if self.corr_length_thin != 0:
            autocorr_thin = self.corr_length_thin
        elif self.indep_thin == 0:
            autocorr_thin = 20
        elif self.indep_thin <= 30:
            autocorr_thin = 5
        else:
            autocorr_thin = int(5 * (self.indep_thin / 30))

        thin_rows = len(self.thin_indices(autocorr_thin))
        maxoff = int(min(self.corr_length_steps, thin_rows // (2 * len(chainlist))))
        if maxoff <= 0:
            return
        corrs = np.zeros([maxoff, self.n])
        for chain in chainlist:
            thin_ix = chain.thin_indices(autocorr_thin)
            thin_rows = len(thin_ix)
            maxoff = min(maxoff, thin_rows // autocorr_thin)
            for j in range(self.n):
                thinned = chain.diffs[j][thin_ix]
                for off in range(1, maxoff + 1):
                    corrs[off - 1][j] += (
                        np.dot(thinned[off:], thinned[:-off]) / (thin_rows - off) / self.vars[j]
                    )
        corrs /= len(chainlist)
        out.append(parForm % "" + "".join("%8i" % ((i + 1) * autocorr_thin) for i in range(maxoff)) + "\n")
        for j in range(self.n):
            out.append(parNames[j] + "".join("%8.3f" % corrs[i][j] for i in range(maxoff)) + " %s\n" % self.parLabel(j))

    def getConvergeTests(
        self, test_confidence=0.95, writeDataToFile=False,
        what=("MeanVar", "GelmanRubin", "SplitTest", "RafteryLewis", "CorrLengths"), filename=None, feedback=False
    ):
        """Run the convergence-test battery and return the text report.

        Tests (reference ``mcsamples.py:904-1228``): CorrLengths (weighted
        autocorrelation lengths), MeanVar (per-parameter sqrt(var(chain
        mean)/mean(chain var))), GelmanRubin (worst orthogonalized
        eigenvalue R-1), SplitTest (quantile rms over 2..4 equal-weight
        splits), RafteryLewis (binary-chain BIC thinning/burn, integer
        weights only), CorrSteps table.  Each test is a ``_report_*``
        method appending to the shared line list; the report text is
        byte-compatible with the reference ``.converge`` format.
        """
        out = []
        chainlist = self.getSeparateChains()
        multi_chain = len(chainlist) > 1
        if multi_chain and feedback:
            print("Number of chains used = ", len(chainlist))
        for chain in chainlist:
            chain.setDiffs()
        parForm = self.paramNames.parFormat()
        parNames = [parForm % self.parName(j) for j in range(self.n)]
        tail = (1 - test_confidence) / 2
        limits = np.array([1 - tail, tail])
        nparamMC = self.paramNames.numNonDerived()
        integer_weights = np.all(np.abs(self.weights - self.weights.astype(int)) < 1e-4 / self.max_mult)

        battery = (
            ("CorrLengths", True, lambda: self._report_corr_lengths(out, chainlist, parNames, parForm)),
            ("MeanVar", multi_chain, lambda: self._report_mean_var(out, chainlist, parNames)),
            ("GelmanRubin", multi_chain and nparamMC > 0, lambda: self._report_gelman_rubin(out, chainlist, feedback)),
            ("SplitTest", True, lambda: self._report_split_test(out, parNames, limits)),
            (
                "RafteryLewis",
                integer_weights,
                lambda: self._report_raftery_lewis(out, chainlist, limits, nparamMC, test_confidence, feedback),
            ),
            ("CorrSteps", integer_weights, lambda: self._report_corr_steps(out, chainlist, parNames, parForm)),
        )
        for tag, applicable, run in battery:
            if tag in what and applicable:
                try:
                    run()
                except self._RLAbort:
                    print("Raftery and Lewis estimator had problems")
                    return

        report = "".join(out)
        if writeDataToFile:
            from pathlib import Path

            Path(filename or self.rootdirname + ".converge").write_text(report, encoding="utf-8")
        return report

    # -- plot-script writers (for the CLI) ---------------------------------------------

    def _pca_log_map(self, params, nparams):
        """Auto-select N (linear) / L (log) mapping per parameter: log when
        the samples sit well away from zero (reference ``mcsamples.py:
        706-713``)."""
        chosen = []
        for info in self.paramNames.parsWithNames(params):
            self._initParamRanges(info.name)
            span10 = (info.param_max - info.param_min) / 10
            chosen.append("N" if (info.param_max < 0 or info.param_min < span10) else "L")
        return "".join(chosen)

    def PCA(
        self, params, param_map=None, normparam=None, writeDataToFile=False, filename=None, conditional_params=(),
        n_best_only=None
    ):
        """Principal component analysis of normalized (optionally
        log-mapped) parameters; returns a text report with e-values,
        e-vectors, and power-law constraint forms (reference
        ``mcsamples.py:683-885``)."""
        logging.info("PCA over %s parameters", len(params))
        if conditional_params:
            logging.info("with %s parameters conditioned out", len(conditional_params))
        text = ["PCA for parameters:\n"]

        params = [name for name in params if self.paramNames.parWithName(name) is not None]
        nparams = len(params)
        indices = [self.index[param] for param in params] + [self.index[p] for p in conditional_params]
        normparam = params.index(normparam) if normparam and normparam in params else -1
        if param_map is None:
            param_map = self._pca_log_map(params, nparams)

        # map (ln / ln(-) / identity) and standardize each column
        n = len(indices)
        table = self.samples[:, indices].copy()
        doexp = False
        for i in range(nparams):
            label = self.parLabel(indices[i])
            mapped = label
            if param_map[i] == "L":
                doexp = True
                table[:, i] = np.log(table[:, i])
                mapped = "ln(" + label + ")"
            elif param_map[i] == "M":
                doexp = True
                table[:, i] = np.log(-1.0 * table[:, i])
                mapped = "ln(-" + label + ")"
            text.append("%10s :%s\n" % (str(indices[i] + 1), str(mapped)))
        center = np.empty(n)
        sd = np.empty(n)
        for i in range(n):
            center[i] = np.dot(self.weights, table[:, i]) / self.norm
            table[:, i] -= center[i]
            sd[i] = np.sqrt(np.dot(self.weights, table[:, i] ** 2) / self.norm)
            if sd[i] != 0:
                table[:, i] /= sd[i]

        text.append("\n")
        text.append("Correlation matrix for reduced parameters\n")
        correlation = np.ones((n, n))
        for i in range(n):
            for j in range(i):
                correlation[j][i] = np.dot(self.weights, table[:, i] * table[:, j]) / self.norm
                correlation[i][j] = correlation[j][i]
        for i in range(nparams):
            text.append("%12s :" % params[i] + "".join("%8.4f" % correlation[j][i] for j in range(n)) + "\n")

        if len(conditional_params):
            # marginalize out the conditional block via the precision matrix
            keep = list(range(nparams))
            reduced = np.linalg.inv(np.linalg.inv(correlation)[np.ix_(keep, keep)])
            n = nparams
            table = table[:, :nparams]
        else:
            reduced = correlation
        evals, evects = np.linalg.eig(reduced)
        by_size = evals.argsort()
        modes = np.transpose(evects[:, by_size])

        text.append("\n")
        text.append("e-values of correlation matrix\n")
        text.extend("PC%2i: %8.4f\n" % (i + 1, evals[by_size[i]]) for i in range(n))
        text.append("\n")
        text.append("e-vectors\n")
        for j in range(n):
            text.append("%3i:" % (indices[j] + 1) + "".join("%8.4f" % evects[j][by_size[i]] for i in range(n)) + "\n")

        # scale each mode so the pivot parameter enters with its own sd
        for i in range(n):
            pivot = normparam if normparam != -1 else np.abs(modes[i, :]).argmax()
            modes[i, :] = modes[i, :] / modes[i, pivot] * sd[pivot]

        for row in range(table.shape[0]):
            table[row, :] = np.dot(modes, table[row, :])
            if doexp:
                table[row, :] = np.exp(table[row, :])

        text.append("\n")
        text.append("Principal components\n")
        mode_texts = []
        pc_mean = np.empty(n)
        pc_sd = np.empty(n)
        for i in range(n):
            block = "PC%i (e-value: %f)\n" % (i + 1, evals[by_size[i]])
            for j in range(n):
                label = self.parLabel(indices[j])
                weight_tag = f"[{modes[i][j]:f}]"
                if param_map[j] in ("L", "M"):
                    expo = "%f" % (1.0 / sd[j] * modes[i][j])
                    sign = -1.0 if param_map[j] == "M" else 1.0
                    div = "%f" % (sign * np.exp(center[j]))
                    block += f"{weight_tag}  ({label}/{div})^{{{expo}}}\n"
                else:
                    expo = "%f" % (sd[j] / modes[i][j])
                    form = f"exp(({label}-{center[j]:f})/{expo})" if doexp else f"({label}-{center[j]:f})/{expo}"
                    block += f"{weight_tag}   {form}\n"
            pc_mean[i] = self.mean(table[:, i])
            pc_sd[i] = np.sqrt(self.mean((table[:, i] - pc_mean[i]) ** 2))
            block += f"          = {pc_mean[i]:f} +- {pc_sd[i]:f}\n"
            block += "\n"
            mode_texts.append(block)
        text.extend(mode_texts)

        text.append("Correlations of principal components\n")
        text.append("%s\n" % ("".join("%8i" % i for i in range(1, n + 1))))
        for i in range(n):
            table[:, i] = (table[:, i] - pc_mean[i]) / pc_sd[i]
        for j in range(n):
            text.append("PC%2i" % (j + 1) + "".join("%8.3f" % self.mean(table[:, i] * table[:, j]) for i in range(n)) + "\n")
        for j in range(self.n):
            row = "%4i" % (j + 1)
            scaled = (self.samples[:, j] - self.means[j]) / self.sddev[j]
            for i in range(n):
                row += "%8.3f" % (np.sum(self.weights * table[:, i] * scaled) / self.norm)
            text.append(row + "   (%s)\n" % self.parLabel(j))

        report = "".join(text)
        if writeDataToFile:
            from pathlib import Path

            Path(filename or self.rootdirname + ".PCA").write_text(report, encoding="utf-8")
        if n_best_only:
            return mode_texts[0] if n_best_only == 1 else mode_texts[:n_best_only]
        return report

    # -- convergence battery ---------------------------------------------------------

    def saveChainsAsText(self, root, make_dirs=False, properties=None):
        """Save each chain as text plus metadata sidecars (single-chain
        samples fall back to one unnumbered chain file)."""
        if self.chains is None and self.chain_offsets is None:
            super(Chains, self).saveAsText(root, None, make_dirs)
        else:
            chain_list = self.getSeparateChains() if self.chains is None else self.chains
            for i, chain in enumerate(chain_list):
                chain.saveAsText(root, i, make_dirs)
        self.saveTextMetadata(root, properties)

    # -- PCA ----------------------------------------------------------------------

    def saveTextMetadata(self, root, properties=None):
        """Save .paramnames, .ranges and .properties.ini sidecars."""
        super().saveTextMetadata(root)
        self.ranges.saveToFile(root + ".ranges")
        sidecar = root + ".properties.ini"
        stored = self.properties.params if self.properties else {}
        if not (properties or stored or self.label):
            if os.path.exists(sidecar):
                os.remove(sidecar)
            return
        ini = IniFile(sidecar) if os.path.exists(sidecar) else IniFile()
        ini.params.update(stored)
        if self.label:
            ini.params["label"] = self.label
        ini.params.update(properties or {})
        ini.saveFile(sidecar)

    def getCombinedSamplesWithSamples(self, samps2, sample_weights=(1, 1)):
        """New MCSamples appending samps2's samples for shared parameters,
        weighted so each set contributes equal mass by default."""
        mine = set(self.paramNames.list())
        shared = ParamNames()
        shared.names = [
            ParamInfo(name=q.name, label=q.label, derived=q.isDerived)
            for q in samps2.paramNames.names
            if q.name in mine
        ]
        both_have_likes = self.loglikes is not None and samps2.loglikes is not None
        loglikes = np.concatenate([self.loglikes, samps2.loglikes]) if both_have_likes else None
        if sample_weights is None:
            balance, sample_weights = 1, (1, 1)
        else:
            balance = np.sum(self.weights) / np.sum(samps2.weights)
        weights = np.concatenate([self.weights * sample_weights[0], samps2.weights * sample_weights[1] * balance])
        first, second = self.getParams(), samps2.getParams()
        columns = [np.concatenate([getattr(first, name), getattr(second, name)]) for name in shared.list()]
        return MCSamples(
            samples=np.array(columns).T,
            weights=weights,
            loglikes=loglikes,
            paramNamesFile=shared,
            ignore_rows=0,
            ranges=self.ranges,
            settings=copy.deepcopy(self.ini.params),
        )

    def getParamSampleDict(self, ix, want_derived=True, want_fixed=True):
        """Dict of parameter values for one sample row (incl. fixed)."""
        row = super().getParamSampleDict(ix, want_derived=want_derived)
        if want_fixed:
            row.update(self.ranges.fixedValueDict())
        return row

    def getParamBestFitDict(self, best_sample=False, want_derived=True, want_fixed=True, max_posterior=True):
        """Dict of parameter values at the best-fit point (from minimum
        files, or the best sample)."""
        if best_sample:
            if not max_posterior:
                raise ValueError("best_sample=True implies max_posterior=True")
            if self.loglikes is None:
                raise ValueError("samples carry no likelihood values")
            best_row = int(np.argmin(self.loglikes))
            return self.getParamSampleDict(best_row)
        best = self.getBestFit(max_posterior=max_posterior).getParamDict(include_derived=want_derived)
        if want_fixed:
            best.update(self.ranges.fixedValueDict())
        return best

    def addDerived(self, paramVec, name, label="", comment="", range=None):
        """Add a derived parameter column (optionally with hard bounds)."""
        if range is not None:
            self.ranges.setRange(name, range)
        return super().addDerived(paramVec, name, label=label, comment=comment)

    def getCorrelatedVariable2DPlots(self, num_plots=12, nparam=None):
        """Most-correlated parameter pair names, for quick-look plots."""
        if not nparam:
            nparam = self.paramNames.numNonDerived()
        ceiling = 1e5
        best_x = best_y = 0
        pairs = []
        for _ in range(num_plots):
            strongest = -1e5
            for ix1 in range(nparam):
                for ix2 in range(ix1 + 1, nparam):
                    strength = abs(self.correlationMatrix[ix1][ix2])
                    if strongest < strength < ceiling:
                        strongest = strength
                        best_x, best_y = ix1, ix2
            if strongest == -1e5:
                break
            ceiling = strongest
            pairs.append([self.parName(best_x), self.parName(best_y)])
        return pairs

    def getNumSampleSummaryText(self):
        """Text summary of sample counts and effective sample sizes."""
        out = [
            f"using {self.numrows} rows, {self.paramNames.numParams()} parameters; "
            f"mean weight {self.mean_mult}, tot weight {self.norm}\n"
        ]
        if self.indep_thin != 0:
            out.append("Approx indep samples (N/corr length): %s\n" % round(self.norm / self.indep_thin))
        out.append("Equiv number of single samples (sum w)/max(w): %s\n" % round(self.norm / self.max_mult))
        n_eff_w = int(self.norm**2 / np.dot(self.weights, self.weights))
        out.append("Effective number of weighted samples (sum w)^2/sum(w^2): %s\n" % n_eff_w)
        return "".join(out)

    def _setMargeLimits(self, par, paramConfid, max_frac_twotail=None, density1D=None):
        """Set par.limits: one- or two-tail depending on whether the
        density is cut off at the prior edges (reference
        ``mcsamples.py:2460-2531``)."""
        if max_frac_twotail is None:
            max_frac_twotail = self.max_frac_twotail
        par.limits = []
        if density1D is None:
            density1D = self.get1DDensity(par.name)
        interpGrid = None
        for level, contour in enumerate(self.contours):
            # a tail counts as prior-cut when the density at that edge is
            # still significant relative to the peak
            edge_frac = max_frac_twotail[level]
            force = self.force_twotail
            cut_bot = par.has_limits_bot and not force and density1D.P[0] > edge_frac
            cut_top = par.has_limits_top and not force and density1D.P[-1] > edge_frac

            if cut_bot and cut_top:
                window = [par.range_min, par.range_max]
            else:
                if not interpGrid:
                    interpGrid = density1D.initLimitGrids()
                lo, hi, cut_bot, cut_top = density1D.getLimits(contour, interpGrid)
                limfrac = 1 - contour
                eq_lo = eq_hi = None
                if cut_bot:
                    lo = par.range_min
                elif cut_top:
                    lo = self.confidence(paramConfid, limfrac, upper=False)
                else:
                    eq_lo = self.confidence(paramConfid, limfrac / 2, upper=False)
                if cut_top:
                    hi = par.range_max
                elif cut_bot:
                    hi = self.confidence(paramConfid, limfrac, upper=True)
                else:
                    eq_hi = self.confidence(paramConfid, limfrac / 2, upper=True)
                if not cut_bot and not cut_top:
                    # prefer equal-tail limits when the densities at the two
                    # tails are similar
                    if math.fabs(density1D.Prob(eq_hi) - density1D.Prob(eq_lo)) < self.credible_interval_threshold:
                        lo, hi = eq_lo, eq_hi
                window = [lo, hi]

            tag = {(True, True): "none", (True, False): ">", (False, True): "<"}.get((cut_bot, cut_top), "two")
            par.limits.append(types.ParamLimit(window, tag))

    # -- summaries / misc ------------------------------------------------------------

    def _setDensitiesandMarge1D(self, max_frac_twotail=None, meanlikes=False):
        """Compute (and cache) all 1D densities and marginalized limits."""
        if self.done_1Dbins:
            return
        for j, info in enumerate(self.paramNames.names):
            confid = self.initParamConfidenceData(self.samples[:, j])
            self.get1DDensityGridData(j, paramConfid=confid, meanlikes=meanlikes)
            self._setMargeLimits(info, confid, max_frac_twotail)
        self.done_1Dbins = True

    def getInlineLatex(self, param, limit=1, err_sig_figs=None):
        r"""Inline tex like ``A=x\pm y`` (adjusts for one/two-tail limits)."""
        names, snippets = self.getLatex([param], limit, err_sig_figs)
        if snippets[0] is None:
            raise ValueError(f"no parameter called {param}")
        joiner = " " if snippets[0][0] in ("<", ">") else " = "
        return names[0] + joiner + snippets[0]

    def getLatex(self, params=None, limit=1, err_sig_figs=None):
        """(labels, tex snippets) for constraints on a list of parameters."""
        if isinstance(params, str):
            return self.getInlineLatex(params, limit, err_sig_figs)
        marge = self.getMargeStats()
        formatter = types.NoLineTableFormatter()
        if err_sig_figs:
            formatter.numberFormatter.err_sf = err_sig_figs
        labels, texs = [], []
        for par in params if params is not None else marge.list():
            tex = marge.texValues(formatter, par, limit=limit)
            if tex is None:
                labels.append(None)
                texs.append(None)
                continue
            info = par if isinstance(par, ParamInfo) else marge.parWithName(par)
            labels.append(info.getLabel())
            texs.append(tex[0])
        return labels, texs

    def getTable(self, columns=1, include_bestfit=False, **kwargs):
        """ResultTable of the marginalized constraints."""
        return types.ResultTable(columns, [self.getMargeStats(include_bestfit)], **kwargs)

    def getLikeStats(self):
        """LikeStats with N-D limits and best-fit sample values."""
        if self.likeStats:
            return self.likeStats
        return self._setLikeStats()

    def getMargeStats(self, include_bestfit=False):
        """MargeStats with marginalized 1D constraints for all parameters."""
        self._setDensitiesandMarge1D()
        m = types.MargeStats()
        m.hasBestFit = False
        m.limits = self.contours
        m.names = self.paramNames.names
        if include_bestfit:
            m.addBestFit(self.getBestFit())
        return m

    def getBestFit(self, max_posterior=True):
        """BestFit from the .minimum (posterior) or .bestfit (likelihood)
        sidecar file."""
        ext = ".minimum" if max_posterior else ".bestfit"
        bf_file = self.root + ext
        if os.path.exists(bf_file):
            return types.BestFit(bf_file, max_posterior=max_posterior)
        raise MCSamplesError(
            f"a {ext} file next to the chains is required for best-fit values "
            "(they cannot be derived from the samples themselves)"
        )

    def _setLikeStats(self):
        """Compute and store the LikeStats summary: best-fit sample,
        likelihood moments, and per-parameter ND confidence region from
        sorting by -log(like) (reference ``mcsamples.py:2237-2278``)."""
        logl = self.loglikes
        if logl is None:
            self.likeStats = None
            return None
        stats = types.LikeStats()
        bestfit_ix = np.argmin(logl)
        maxlike = logl[bestfit_ix]
        stats.logLike_sample = maxlike
        spread_ok = np.max(logl) - maxlike < 30
        stats.logMeanInvLike = np.log(self.mean(np.exp(logl - maxlike))) + maxlike if spread_ok else None
        stats.meanLogLike = self.mean_loglike
        stats.logMeanLike = -np.log(self.mean(np.exp(-(logl - maxlike)))) + maxlike
        stats.complexity = 2 * (self.mean_loglike - maxlike)
        stats.varLogLike = self.mean(logl**2) - self.mean_loglike**2
        stats.names = self.paramNames.names

        # ND confidence regions: take the best-likelihood mass up to each contour
        by_like = logl.argsort()
        mass = np.cumsum(self.weights[by_like])
        ncontours = len(self.contours)
        cutoffs = np.searchsorted(mass, self.norm * self.contours[0:ncontours])
        for j, info in enumerate(self.paramNames.names):
            info.ND_limit_bot = np.empty(ncontours)
            info.ND_limit_top = np.empty(ncontours)
            for i, cut in enumerate(cutoffs):
                region = self.samples[by_like[:cut], j]
                info.ND_limit_bot[i] = np.min(region)
                info.ND_limit_top[i] = np.max(region)
            info.bestfit_sample = self.samples[bestfit_ix, j]
        self.likeStats = stats
        return stats

    def getRawNDDensityGridData(
        self, js, writeDataToFile=False, num_plot_contours=None, get_density=False, meanlikes=False, maxlikes=False,
        **kwargs
    ):
        """Unsmoothed ND histogram density with edge weighting and optional
        mean/profile likelihoods (reference ``mcsamples.py:2098-2235``)."""
        if self.needs_update:
            self.updateBaseStatistics()
        resolved = [self._parAndNumber(j) for j in js]
        if any(col is None for col, _ in resolved):
            return None
        columns = [col for col, _ in resolved]
        infos = [info for _, info in resolved]
        ndim = len(js)
        for col in columns:
            self._initParamRanges(col)

        boundary_order = kwargs.get("boundary_correction_order", self.boundary_correction_order)
        bounded = any(info.has_limits for info in infos)
        nbinsND = kwargs.get("num_bins_ND") or self.num_bins_ND

        binned = [self._binSamples(self.samples[:, col], info, nbinsND) for col, info in zip(columns, infos)]
        ixv = [b[0] for b in binned]
        axis_lo = [b[2] for b in binned]
        axis_hi = [b[3] for b in binned]
        shape = nbinsND * np.ones(ndim, dtype=int)
        binsND, flatixv = self._makeNDhist(ixv, shape)

        if bounded and boundary_order >= 0:
            edge_weight = np.ones(shape[::-1])
            self._setRawEdgeMaskND(infos, edge_weight)
            binsND /= edge_weight

        binNDlikes = None
        if meanlikes:
            # np.array: normalized in place below (device arrays view read-only)
            flat = np.array(_bincount(flatixv, self._likelihood_weights(), int(np.prod(shape))))
            binNDlikes = flat.reshape(shape[::-1], order="C")

        binNDmaxlikes = self._profile_likes_nd(binsND.shape, ixv, ndim) if maxlikes else None

        grids = [np.linspace(lo, hi, n) for lo, hi, n in zip(axis_lo, axis_hi, shape)]
        views = [(info.range_min, info.range_max) for info in infos]
        density = DensityND(grids, binsND, view_ranges=views)
        density.normalize("max", in_place=True)
        if get_density:
            return density

        ncontours = len(self.contours)
        if num_plot_contours:
            ncontours = min(int(num_plot_contours), ncontours)
        contours = self.contours[:ncontours]
        density.contours = density.getContourLevels(contours)

        if binNDlikes is not None:
            binNDlikes /= np.max(binNDlikes)
        density.likes = binNDlikes

        density.maxlikes = binNDmaxlikes
        if maxlikes:
            density.maxcontours = getImportContourLevels(binNDmaxlikes, contours, half_edge=False)

        if writeDataToFile:
            self._write_nd_density_files(density, binsND, binNDlikes, binNDmaxlikes, grids, ndim, meanlikes, maxlikes)
        return density

    def _profile_likes_nd(self, shape, ixv, ndim):
        """Per-cell profile (maximum) likelihood over the ND histogram."""
        out = np.zeros(shape)
        cells = list(zip(*[ixv[i] for i in range(ndim)[::-1]]))
        bestfit = np.max(-self.loglikes)
        for rec, cell in enumerate(cells):
            out[cell] = max(out[cell], np.exp(-bestfit - self.loglikes[rec]))
        return out

    def _write_nd_density_files(self, density, binsND, binNDlikes, binNDmaxlikes, grids, ndim, meanlikes, maxlikes):
        """Write the plot-data files for an ND histogram density."""
        stem = self.rootname + "_%s" + f"_{ndim}D.dat"
        table = [np.ravel(binsND, order="C")]
        for i in range(ndim):
            table.append([grids[i][cell[::-1][i]] for cell in np.ndindex(binsND.shape)])
        np.savetxt(os.path.join(self.plot_data_dir, stem % "posterior"), np.transpose(table), "%16.7E")
        contfile = f"{self.rootname}_posterior_{ndim}D_cont.dat"
        np.savetxt(os.path.join(self.plot_data_dir, contfile), np.atleast_2d(density.contours), "%16.7E")
        for wanted, values, tag in ((meanlikes, binNDlikes, "meanlike"), (maxlikes, binNDmaxlikes, "maxlike")):
            if wanted:
                table[0] = np.ravel(values, order="C")
                np.savetxt(os.path.join(self.plot_data_dir, stem % tag), np.transpose(table), "%16.7E")

    # -- likelihood-based statistics -----------------------------------------------

    def getRawNDDensity(self, xs, normalized=False, **kwargs):
        """DensityND (unsmoothed histogram) for a list of parameters."""
        if self.needs_update:
            self.updateBaseStatistics()
        density = self.getRawNDDensityGridData(xs, get_density=True, **kwargs)
        if normalized:
            density.normalize(in_place=True)
        return density

    def _fused_route_enabled(self):
        """Should default density queries route through the fused device
        pipeline? True on the GPU (or GETDIST_TPU_FUSED=1 /
        GETDIST_TPU_DEVICE_OPS=1) when the analysis settings match the
        fused path's reference-default conventions; False on plain CPU
        (the host path there is the byte-parity oracle) and when
        GETDIST_TPU_FUSED=0 (see :func:`getdist_tpu.backend.fused_route_default`)."""
        flag = os.environ.get("GETDIST_TPU_FUSED")
        if flag == "0":
            return False
        if getattr(self, "_force_host_densities", False):
            # parity device mode serves 1D through the byte-exact host path;
            # letting the f32-convention fused route answer would break parity
            return False
        if not (
            float(self.smooth_scale_1D) < 0
            and float(self.smooth_scale_2D) < 0
            and int(self.boundary_correction_order) == 1
            and int(self.mult_bias_correction_order) == 1
        ):
            return False
        if flag == "1" or _use_device_ops:
            return True
        return backend.fused_route_default()

    def _fused_densities_state(self, meanlikes=False):
        """(dens1, dens2) dicts from ONE fused pipeline run, cached until
        the samples change; the routed get*DensityGridData entry points
        serve individual queries from here so a 30-parameter triangle plot
        costs one device program, not 465. Mean-likelihood grids are a
        separately-cached variant (they double the binning work)."""
        cache = getattr(self, "_fused_cache", None)
        if cache is None:
            cache = self._fused_cache = {}
        if meanlikes not in cache:
            cache[meanlikes] = self.fastDensities(
                contours=tuple(np.asarray(self.contours, float)), meanlikes=meanlikes
            )
        return cache[meanlikes]

    def _fused_1d_lookup(self, j, paramConfid=None, meanlikes=False):
        """Density1D for one parameter via the fused pipeline (None if the
        parameter is unknown)."""
        jx, par = self._parAndNumber(j)
        if par is None:
            return None
        dens1, _ = self._fused_densities_state(meanlikes)
        density = dens1.get(par.name)
        if density is None:
            return None
        self._initParamRanges(jx, paramConfid)
        density.view_ranges = [par.range_min, par.range_max]
        self.density1D[par.name] = density
        return density

    def _fused_2d_lookup(self, j, j2, num_plot_contours=None, meanlikes=False):
        """Density2D for a pair via the fused pipeline, transposing when the
        query order is reversed relative to the stored (a < b) order."""
        jx, parx = self._parAndNumber(j)
        jy, pary = self._parAndNumber(j2)
        if parx is None or pary is None:
            return None
        _, dens2 = self._fused_densities_state(meanlikes)
        density = dens2.get((parx.name, pary.name))
        flipped = dens2.get((pary.name, parx.name))
        if density is None and flipped is not None:
            density = Density2D(flipped.y, flipped.x, flipped.P.T)
            density.contours = flipped.contours
            density.likes = None if getattr(flipped, "likes", None) is None else flipped.likes.T
        if density is None:
            return None
        if meanlikes and getattr(density, "likes", None) is None:
            # regrid/rescued pairs don't carry shading grids; host path serves
            return None
        self._initParamRanges(jx)
        self._initParamRanges(jy)
        out = Density2D(density.x, density.y, density.P,
                        view_ranges=[(parx.range_min, parx.range_max), (pary.range_min, pary.range_max)])
        levels = np.asarray(density.contours, float)
        if num_plot_contours:
            levels = levels[: min(int(num_plot_contours), len(levels))]
        out.contours = levels
        out.likes = getattr(density, "likes", None)
        return out

    def fastParityDensities(self, params=None, contours=None, device=False, materialize=True):
        """Reference-exact triangle densities at batched-device speed.

        The host parity pipeline with its per-pair python loop replaced by
        float64 fused device programs: exact host ranges, N_eff values and
        bandwidth matrices (the same code the parity path runs) feed
        :func:`~.ops.batched.all_2d_densities` per corr-adaptive fine-grid
        group through its override hooks. Measured max-grid delta vs
        ``get2DDensityGridData`` is ~1e-5 on the distribution zoo — the
        "fast AND faithful" mode (benchmarked by ``bench.py --parity``).

        1D densities run through the (cheap, byte-exact) host path.
        Requires float64 (``jax_enable_x64``); only the default
        auto-bandwidth smoothing settings are supported, and
        mean-likelihood shading is served by the host path.

        ``device=True`` selects the accelerator-resident variant
        (:meth:`_parity_densities_device`): every O(N) pass — binning,
        exact pair histograms, sheared residuals, N_eff lag sums — runs
        as f64 jitted programs on the default backend, only compact
        per-pair histograms return to the host-exact bandwidth
        optimizers, and the convolution programs run on device in f64. With
        ``materialize=False`` the 2D grids stay device-resident (the
        same convention as :meth:`fastTriangleDensities`) and the return
        is ``(dens1, group_list)``; see the method docstring.

        :return: ({name: Density1D}, {(name_a, name_b): Density2D})
        """
        import jax

        from getdist_tpu.ops.batched import all_2d_densities

        self._pin_host_stats()
        if device:
            return self._parity_densities_device(params, contours, materialize=materialize)
        if not jax.config.jax_enable_x64:
            raise MCSamplesError("parity mode needs float64: jax.config.update('jax_enable_x64', True) on CPU")
        if float(self.smooth_scale_2D) >= 0 or float(self.smooth_scale_1D) >= 0:
            raise SettingError("parity mode supports the auto-bandwidth smooth_scale settings only")
        if self.needs_update:
            self.updateBaseStatistics()
        idx = list(range(self.n)) if params is None else [self._parAndNumber(q)[0] for q in params]
        contours = np.asarray(self.contours if contours is None else contours, float)

        infos = [self._initParamRanges(j) for j in idx]
        names = [info.name for info in infos]
        # warm the per-param N_eff caches CONCURRENTLY: the adaptive-lag
        # estimator is ~0.5 s of numpy per param at 1M samples and numpy
        # ufuncs release the GIL, so a thread pool gets real parallelism;
        # each param's own evaluation order is unchanged (values identical
        # to the sequential path), and get1DDensityGridData below reuses
        # the cached values
        import os as _os
        from concurrent.futures import ThreadPoolExecutor

        self.get_norm()  # materialize the lazily-cached norm before forking
        workers = max(1, min(8, _os.cpu_count() or 1))
        if workers > 1 and len(idx) > 1:
            with ThreadPoolExecutor(max_workers=workers) as pool:
                list(pool.map(lambda ji: self._get1DNeff(ji[1], ji[0]), zip(idx, infos)))
        # 1D through the byte-exact host path even where density queries
        # route to the fused pipeline by default (the GPU)
        self._force_host_densities = True
        try:
            dens1 = {info.name: self.get1DDensityGridData(j) for j, info in zip(idx, infos)}
        finally:
            self._force_host_densities = False
        neff = np.array([self._get1DNeff(info, j) for j, info in zip(idx, infos)])

        # per-param fine ranges (the reference _binSamples convention)
        def grid_edge(par):
            pad = (par.range_max - par.range_min) * 0.1
            bmin = min(par.param_min, par.range_min) - (0 if par.has_limits_bot else pad)
            bmax = max(par.param_max, par.range_max) + (0 if par.has_limits_top else pad)
            return bmin, bmax
        edges = np.array([grid_edge(info) for info in infos])
        binmin, binmax = edges[:, 0], edges[:, 1]

        # per-pair: corr-adaptive fine size + the host path's exact bandwidth
        scale_2d = abs(float(self.smooth_scale_2D))
        corr_mat = np.asarray(self.getCorrelationMatrix())[np.ix_(idx, idx)]
        bin_cache = {}

        def binned(k, fine):
            # each param is re-binned ~n_params times per fine size without
            # memoization; ix is the raw reference _binSamples index
            if (k, fine) not in bin_cache:
                bin_cache[(k, fine)] = self._binSamples(self.samples[:, idx[k]], infos[k], fine)
            return bin_cache[(k, fine)]

        # decide each pair's corr-adaptive fine size first, then compute all
        # pair histograms per fine group in ONE multi-threaded native pass
        # (bit-identical to the per-pair np.bincount, getdist_tpu._native;
        # at 435 pairs x 1M samples the python loop was ~15% of the parity
        # wall-clock); bandwidth derivation stays the exact per-pair host
        # algorithm
        pair_fine = {}
        sheared_jobs = []
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                corr, actual_corr = self._pair_correlation(idx[a], idx[b], infos[a], infos[b])
                fine, _nbin2d = self._degeneracy_adapted_bins(corr, self.fine_bins_2D)
                pair_fine.setdefault(fine, []).append((a, b, actual_corr))
                # pairs that will take getAutoBandwidth2D's sheared branch:
                # batch their O(N) re-binning across pairs (identical values)
                both_limited = infos[a].has_limits and infos[b].has_limits
                if (
                    0.2 < abs(actual_corr) <= self.max_corr_2D
                    and not both_limited
                    and not (both_limited and actual_corr > 0.8)
                    and not self.use_effective_samples_2D
                ):
                    sheared_jobs.append(
                        (infos[a], infos[b], idx[a], idx[b], float(min(neff[a], neff[b])))
                    )
        sheared_results = (
            self._sheared_bandwidths_batch(sheared_jobs, self.fine_bins_2D) if sheared_jobs else {}
        )

        from getdist_tpu import _native

        groups = {}
        for fine, members in pair_fine.items():
            params_in = sorted({k for a, b, _ in members for k in (a, b)})
            for k in params_in:
                binned(k, fine)
            local = {k: i for i, k in enumerate(params_in)}
            ix_rows = np.ascontiguousarray(np.stack([bin_cache[(k, fine)][0] for k in params_in]))
            native_hists = _native.pair_histograms(
                ix_rows, self.weights, [(local[a], local[b]) for a, b, _ in members], fine
            )
            for i, (a, b, actual_corr) in enumerate(members):
                parx, pary = infos[a], infos[b]
                ix, step_x, x_lo, x_hi = binned(a, fine)
                iy, step_y, y_lo, y_hi = binned(b, fine)
                if native_hists is not None:
                    hist = native_hists[i]
                else:
                    hist, _ = self._make2Dhist(ix, iy, fine, fine)
                hx, hy, c = self.getAutoBandwidth2D(
                    hist, parx, pary, idx[a], idx[b], actual_corr, x_hi - x_lo, y_hi - y_lo,
                    self.fine_bins_2D, mult_bias_correction_order=self.mult_bias_correction_order,
                    sheared_result=sheared_results.get((idx[a], idx[b])),
                )
                rx = hx * scale_2d / step_x
                ry = hy * scale_2d / step_y
                winw = max(1, int(round(2.5 * max(rx, ry))))
                groups.setdefault(fine, []).append((a, b, hx, hy, c, winw, hist))

        active_lo = np.array([info.has_limits_bot for info in infos])
        active_hi = np.array([info.has_limits_top for info in infos])
        per = np.array([bool(getattr(info, "periodic", False)) for info in infos])
        bounded = active_lo.any() or active_hi.any()
        dens2 = {}

        def winw_level(w, fine):
            # pairs with small kernels shouldn't pay the widest pair's FFT
            # padding: bucket each fine-grid group by kernel window. Fixed
            # level steps keep the compiled program shapes cache-stable
            # across chains; +3 headroom because the program clips kernel
            # widths at winw/2.5 while the per-pair kernel_support is what
            # must match the reference truncation.
            cap = fine // 2 - 2
            for level in (18, 34, 66, 98):
                if w + 3 <= level <= cap:
                    return level
            return cap

        bucketed = []
        for fine, plist_all in groups.items():
            by_level = {}
            for entry in plist_all:
                by_level.setdefault(winw_level(entry[5], fine), []).append(entry)
            bucketed.extend((fine, winw, plist) for winw, plist in by_level.items())
        # loop-invariant device conversions, hoisted: the sample matrix alone
        # is ~240 MB f64 at bench scale and must not be re-copied per bucket
        dev_samples = jnp.asarray(self.samples[:, idx])
        dev_weights = jnp.asarray(self.weights)
        dev_neff = jnp.asarray(neff)
        dev_binmin, dev_binmax = jnp.asarray(binmin), jnp.asarray(binmax)
        dev_contours = jnp.asarray(contours)
        dev_lo = jnp.asarray(active_lo) if bounded else None
        dev_hi = jnp.asarray(active_hi) if bounded else None
        dev_per = jnp.asarray(per) if per.any() else None
        dev_sigma = jnp.asarray(np.array([info.sigma_range for info in infos]))
        for fine, winw, plist in bucketed:
            # reuse the host pair histograms computed for the bandwidth
            # derivation above: _make2Dhist (rows = b, cols = a) is exactly
            # the program's pair-histogram convention
            hists = np.stack([entry[6] for entry in plist])
            d2 = all_2d_densities(
                dev_samples,
                dev_weights,
                jnp.asarray(np.array([entry[0] for entry in plist], np.int32)),
                jnp.asarray(np.array([entry[1] for entry in plist], np.int32)),
                dev_neff,
                dev_binmin,
                dev_binmax,
                dev_contours,
                fine_bins=fine,
                winw=winw,
                bandwidth_scale=None if scale_2d == 1.0 else jnp.float64(scale_2d),
                bandwidth_override=(
                    jnp.asarray(np.array([entry[2] for entry in plist])),
                    jnp.asarray(np.array([entry[3] for entry in plist])),
                    jnp.asarray(np.array([entry[4] for entry in plist])),
                ),
                kernel_support=jnp.asarray(np.array([float(entry[5]) for entry in plist])),
                active_lo=dev_lo,
                active_hi=dev_hi,
                periodic=dev_per,
                sigma_range=dev_sigma,
                max_corr=float(self.max_corr_2D),
                enable_shear=False,  # bandwidths are host-exact overrides
                exact_mult_bias=True,
                hists_in=jnp.asarray(hists),
            )
            grids = np.asarray(d2["P"], float)
            for k, (a, b, *_rest) in enumerate(plist):
                density = Density2D(
                    np.linspace(binmin[a], binmax[a], fine),
                    np.linspace(binmin[b], binmax[b], fine),
                    grids[k],
                    view_ranges=[(infos[a].range_min, infos[a].range_max), (infos[b].range_min, infos[b].range_max)],
                )
                # host water levels on the final grid (byte-exact convention)
                density.contours = density.getContourLevels(contours)
                density.likes = None
                dens2[(names[a], names[b])] = density
        return dens1, dens2

    def _pin_host_stats(self):
        """Pin the basic statistics (means/vars/cov/corr) to numpy and drop
        any caches computed through another backend.

        The parity modes need the bandwidth optimizers' inputs
        BIT-IDENTICAL across backends and processes: scipy's fsolve/TNC
        stopping points move by their own ~1e-4 tolerance under 1-ulp
        input wobbles (measured round 4: an XLA-CPU-vs-numpy covariance
        differing by 1.8e-16 in one correlation entry moved a returned
        bandwidth by 1.5e-4 and a zoo grid by 1.2e-5). The caches may have
        been populated at construction time, before this call — recompute
        them on the host path."""
        if getattr(self, "_force_host_stats", False):
            return
        self._force_host_stats = True
        self.means = None
        self.vars = None
        self.fullcov = None
        self.correlationMatrix = None
        self._param_range_cache = {}
        if not self.needs_update:
            self.updateBaseStatistics()

    @staticmethod
    def _parity_winw_level(w, fine):
        # pairs with small kernels shouldn't pay the widest pair's FFT
        # padding: bucket each fine-grid group by kernel window. Fixed
        # level steps keep the compiled program shapes cache-stable
        # across chains; +3 headroom because the program clips kernel
        # widths at winw/2.5 while the per-pair kernel_support is what
        # must match the reference truncation.
        cap = fine // 2 - 2
        for level in (18, 34, 66, 98):
            if w + 3 <= level <= cap:
                return level
        return cap

    def _parity_densities_device(self, params=None, contours=None, materialize=True):
        """Accelerator-resident parity mode: the O(N) stages of
        :meth:`fastParityDensities` as f64 device programs.

        The split:

        - the f64 chain goes to the device once per chain
          (:meth:`_fast_chain_state`);
        - bin indices (``_binSamples`` / ``kde_bandwidth.bin_samples``
          conventions), exact scatter-add pair histograms, sheared
          Cholesky residuals and the adaptive-lag N_eff pair sums all run
          as jitted f64 programs (:mod:`~getdist_tpu.ops.parity_device`);
        - only compact per-pair histograms return (uint16 when every
          count fits), feeding the UNCHANGED host-exact bandwidth
          optimizers — a device f64 optimizer diverges on knife-edge
          shapes, so bandwidth semantics stay host;
        - the fused convolution programs run on device in native f64 with
          host-bandwidth overrides, reproducing :meth:`fastParityDensities`
          to reduction order.

        With ``materialize=False`` the 2D grids and their water levels
        stay device-resident and the return is ``(dens1, groups)`` where
        each group is a dict with keys ``pairs`` (list of name tuples),
        ``P`` ((K, fine, fine) device grids), ``contours`` ((K, C)
        device water levels), ``ranges`` (per-pair ((xmin, xmax),
        (ymin, ymax))), and ``fine``. Reference semantics:
        ``/root/reference/getdist/mcsamples.py:1517-2010``.
        """
        import jax

        from getdist_tpu.ops import parity_device as pdev
        from getdist_tpu.ops.batched import all_2d_densities

        if not jax.config.jax_enable_x64:
            raise MCSamplesError("parity device mode needs float64 enabled (jax_enable_x64)")
        if float(self.smooth_scale_2D) >= 0 or float(self.smooth_scale_1D) >= 0:
            raise SettingError("parity mode supports the auto-bandwidth smooth_scale settings only")
        # the device scatter-add histograms are exact only for integral,
        # f32-representable weights with bin sums below 2**24 (any summation
        # order is exact there, ops/parity_device.py); fractional or
        # f32-lossy weights would silently diverge from the host-exact
        # pipeline this mode promises, so route those chains to the host path
        w_all = np.asarray(self.weights)
        weights_device_exact = bool(
            w_all.size == 0
            or (
                np.all(np.float32(w_all) == w_all)
                and np.all(w_all == np.round(w_all))
                and w_all.min() >= 0
                and float(w_all.sum()) < 2**24
            )
        )
        if not weights_device_exact:
            if not materialize:
                raise MCSamplesError(
                    "parity device mode with materialize=False needs integral f32-representable "
                    "weights (sum < 2**24) for exact device histograms; this chain's weights are "
                    "fractional or f32-lossy — use materialize=True (host fallback) or the host "
                    "parity path"
                )
            logging.warning(
                "parity device mode: weights are fractional or not exactly f32-representable; "
                "device histograms would not be host-exact — falling back to the host "
                "parity pipeline"
            )
            return self.fastParityDensities(params, contours, device=False)
        self._pin_host_stats()
        if self.needs_update:
            self.updateBaseStatistics()
        idx = list(range(self.n)) if params is None else [self._parAndNumber(q)[0] for q in params]
        contours = np.asarray(self.contours if contours is None else contours, float)

        infos = [self._initParamRanges(j) for j in idx]
        names = [info.name for info in infos]

        import time as _time

        _prof_on = bool(os.environ.get("GETDIST_TPU_PARITY_PROFILE"))
        _marks = [("start", _time.perf_counter())]

        def _mark(label):
            if _prof_on:
                _marks.append((label, _time.perf_counter()))

        st = self._fast_chain_state()
        dev_s64, dev_w64 = st["native_samples"], st["native_weights"]
        _mark("chain_state")

        # per-param fine ranges (the reference _binSamples convention)
        def grid_edge(par):
            pad = (par.range_max - par.range_min) * 0.1
            bmin = min(par.param_min, par.range_min) - (0 if par.has_limits_bot else pad)
            bmax = max(par.param_max, par.range_max) + (0 if par.has_limits_top else pad)
            return bmin, bmax

        edges = np.array([grid_edge(info) for info in infos])
        binmin, binmax = edges[:, 0], edges[:, 1]

        scale_2d = abs(float(self.smooth_scale_2D))
        pair_fine = {}
        sheared_jobs = []
        for a in range(len(idx)):
            for b in range(a + 1, len(idx)):
                corr, actual_corr = self._pair_correlation(idx[a], idx[b], infos[a], infos[b])
                fine, _nbin2d = self._degeneracy_adapted_bins(corr, self.fine_bins_2D)
                pair_fine.setdefault(fine, []).append((a, b, actual_corr))
                both_limited = infos[a].has_limits and infos[b].has_limits
                if (
                    0.2 < abs(actual_corr) <= self.max_corr_2D
                    and not both_limited
                    and not (both_limited and actual_corr > 0.8)
                    and not self.use_effective_samples_2D
                ):
                    sheared_jobs.append((a, b))

        # -- device binning + exact pair histograms per fine group -----------
        col_arr = jnp.asarray(np.asarray(idx, np.int32))
        sub64 = dev_s64 if idx == list(range(self.n)) else jnp.take(dev_s64, col_arr, axis=1)
        group_hists = {}
        for fine, members in pair_fine.items():
            params_in = sorted({k for a, b, _ in members for k in (a, b)})
            local = {k: i for i, k in enumerate(params_in)}
            sel = jnp.take(sub64, jnp.asarray(np.asarray(params_in, np.int32)), axis=1)
            fw = (binmax[params_in] - binmin[params_in]) / (fine - 1)
            ix = pdev.bin_indices(sel, jnp.asarray(binmin[params_in]), jnp.asarray(fw))
            hists = pdev.group_pair_hists(
                ix,
                np.asarray([local[a] for a, b, _ in members], np.int32),
                np.asarray([local[b] for a, b, _ in members], np.int32),
                st["weights"],
                fine,
            )
            group_hists[fine] = hists
        _mark("device_hists")

        # -- plain-branch histogram readback, overlapped ----------------------
        # mirror getAutoBandwidth2D's branch selection on the corr value the
        # bandwidth loop below passes it (actual_corr): only the final
        # KernelOptimizer2D branch consumes the histogram. The readback runs
        # in a background thread WHILE the host runs the sheared-branch
        # optimizers below.
        def _takes_plain_branch(actual_corr, parx, pary):
            both_limited = parx.has_limits and pary.has_limits
            if abs(actual_corr) > self.max_corr_2D or (both_limited and actual_corr > 0.8):
                return False  # rule-of-thumb widths
            if abs(actual_corr) > 0.2 and not both_limited:
                return False  # sheared branch (device-assisted or host O(N) fallback)
            return True

        plain_sel = {}
        for fine, members in pair_fine.items():
            sel_rows = [
                k
                for k, (a, b, actual_corr) in enumerate(members)
                if _takes_plain_branch(actual_corr, infos[a], infos[b])
            ]
            if sel_rows:
                plain_sel[fine] = sel_rows

        plain_hists = {}
        plain_errs = []

        def _fetch_plain():
            try:
                for fine, sel_rows in plain_sel.items():
                    sel = jnp.take(
                        group_hists[fine], jnp.asarray(np.asarray(sel_rows, np.int32)), axis=0
                    )
                    host = self._compact_readback(sel)
                    for r, k in enumerate(sel_rows):
                        plain_hists[(fine, k)] = host[r]
            except BaseException as exc:  # re-raised on join
                plain_errs.append(exc)

        import threading

        plain_thread = threading.Thread(target=_fetch_plain, name="parity-plain-readback")
        plain_thread.start()

        # -- sheared bandwidths: device residual binning + host optimizer ----
        sheared_results = {}
        if sheared_jobs:
            metas = []
            r00 = np.empty(len(sheared_jobs))
            r10 = np.empty(len(sheared_jobs))
            r11 = np.empty(len(sheared_jobs))
            lead_pos_arr = np.empty(len(sheared_jobs), np.int32)
            other_pos_arr = np.empty(len(sheared_jobs), np.int32)
            for i, (a, b) in enumerate(sheared_jobs):
                parx, pary = infos[a], infos[b]
                lead_par, other_loc = (pary, a) if pary.has_limits else (parx, b)
                lead_loc = b if pary.has_limits else a
                pair_cov = self.getCov(pars=[idx[lead_loc], idx[other_loc]])
                root = np.linalg.cholesky(pair_cov)
                r00[i], r10[i], r11[i] = root[0, 0], root[1, 0], root[1, 1]
                lead_pos_arr[i] = lead_loc
                other_pos_arr[i] = other_loc
                metas.append((a, b, lead_par, lead_loc, root / root[0, 0]))
            nbins = self.fine_bins_2D
            rows, rlo, rhi = pdev.sheared_rows_minmax(
                sub64,
                jnp.asarray(other_pos_arr),
                jnp.asarray(lead_pos_arr),
                jnp.asarray(r00),
                jnp.asarray(r10),
                jnp.asarray(r11),
            )
        # host N_eff/ACL + 1D stage run here, OVERLAPPED with the device
        # histogram/sheared-row programs dispatched above (the device
        # queue drains while the host computes)
        # -- N_eff: batched adaptive-lag pair sums on device ------------------
        norm = self.get_norm()
        if self._independent_draws():
            neff = np.full(len(idx), self._weight_based_neff())
        else:
            kstds, maxoffs = [], []
            need_acl = [
                p
                for p, (j, info) in enumerate(zip(idx, infos))
                if getattr(info, "N_eff_kde", None) is None
            ]
            acl_by_pos = {}
            if need_acl:
                # batched device autocorrelation lengths (one f32 FFT pass)
                # replace the per-param host FFT loop (seconds of single-core
                # numpy at 30p x 1M). The acl only sets the integer lag horizon
                # min(4 + int(1.5*acl), n//10); params whose horizon could
                # flip under f32 rounding (knife-edge threshold comparisons
                # or 1.5*acl near an integer) are recomputed with the exact
                # host path, keeping results bit-identical to it.
                means = self.getMeans()
                variances = self.getVars()
                acls, acl_safe = pdev.acl_batch(
                    st["samples"],
                    st["weights"],
                    [means[idx[p]] for p in need_acl],
                    [variances[idx[p]] for p in need_acl],
                    [idx[p] for p in need_acl],
                    self.numrows // 10 + 1,
                )
                for p, acl, ok in zip(need_acl, acls, acl_safe):
                    acl_by_pos[p] = float(acl) if ok else self.getCorrelationLength(
                        idx[p], weight_units=False
                    )
            for p, (j, info) in enumerate(zip(idx, infos)):
                if getattr(info, "N_eff_kde", None) is not None:
                    kstds.append(None)  # cached; skip device work
                    maxoffs.append(0)
                    continue
                maxoffs.append(min(4 + int(1.5 * acl_by_pos[p]), self.numrows // 10))
                kstds.append(0.2 * info.sigma_range)
            todo = [p for p, k in enumerate(kstds) if k is not None]
            if todo:
                n_den = pdev.kde_neff_batch(
                    dev_s64,
                    dev_w64,
                    self.weights,
                    [kstds[p] for p in todo],
                    [maxoffs[p] for p in todo],
                    self.numrows,
                    col_ix=[idx[p] for p in todo],
                )
                for p, nd in zip(todo, n_den):
                    infos[p].N_eff_kde = norm * norm / nd
            neff = np.array([infos[p].N_eff_kde for p in range(len(idx))])
        _mark("neff")

        # 1D densities: the cheap byte-exact host path, reusing the primed
        # N_eff cache (the expensive lag sums above)
        self._force_host_densities = True
        try:
            dens1 = {info.name: self.get1DDensityGridData(j) for j, info in zip(idx, infos)}
        finally:
            self._force_host_densities = False
        _mark("1d_host")
        if sheared_jobs:
            rlo, rhi = np.asarray(rlo), np.asarray(rhi)
            pad = (rhi - rlo) * 0.1
            rmin = rlo - pad
            rwidth = (rhi + pad) - rmin
            rdx = rwidth / (nbins - 1)
            resid_ix = pdev.bin_rows(rows, jnp.asarray(rmin), jnp.asarray(rdx))
            # lead binning: kde_bandwidth.bin_samples semantics, host scalars
            leads = sorted({m[3] for m in metas})
            lead_rank = {k: i for i, k in enumerate(leads)}
            lead_lo = np.empty(len(leads))
            lead_dx = np.empty(len(leads))
            lead_width = np.empty(len(leads))
            for i, k in enumerate(leads):
                par = infos[k]
                col = self.samples[:, idx[k]]
                lo_d, hi_d = float(col.min()), float(col.max())
                pad_l = (hi_d - lo_d) * 0.1
                range_min = par.range_min if par.has_limits_bot else lo_d - pad_l
                range_max = par.range_max if par.has_limits_top else hi_d + pad_l
                lead_lo[i] = range_min
                lead_width[i] = range_max - range_min
                lead_dx[i] = lead_width[i] / (nbins - 1)
            lead_cols = jnp.take(sub64, jnp.asarray(np.asarray(leads, np.int32)), axis=1).T
            lead_ix = pdev.bin_rows(lead_cols, jnp.asarray(lead_lo), jnp.asarray(lead_dx))
            stacked = jnp.concatenate([lead_ix, resid_ix], axis=0)
            sh_hists_dev = pdev.group_pair_hists(
                stacked,
                np.asarray([lead_rank[m[3]] for m in metas], np.int32),
                np.arange(len(metas), dtype=np.int32) + len(leads),
                st["weights"],
                nbins,
            )
            # chunked readback in a producer thread: chunk k+1 is copied
            # while the host optimizes chunk k
            import queue as _queue

            _chunk = 32
            _q = _queue.Queue(maxsize=2)

            def _fetch_sheared():
                try:
                    for s in range(0, len(metas), _chunk):
                        _q.put((s, self._compact_readback(sh_hists_dev[s : s + _chunk])))
                    _q.put(None)
                except BaseException as exc:
                    _q.put(exc)

            sheared_thread = threading.Thread(
                target=_fetch_sheared, name="parity-sheared-readback", daemon=True
            )
            sheared_thread.start()

            def _sheared_optimize(i, hist_i):
                a, b, lead_par, lead_loc, unshear = metas[i]
                parx, pary = infos[a], infos[b]
                n_eff = min(neff[a], neff[b])
                try:
                    opt = kde.KernelOptimizer2D(
                        hist_i, n_eff, 0, do_correlation=not (parx.has_limits or pary.has_limits)
                    )
                    h1, h2, c12 = opt.get_h()
                except ValueError as e:
                    sheared_results[(idx[a], idx[b])] = e
                    return
                h1 *= lead_width[lead_rank[lead_loc]]
                h2 *= rwidth[i]
                kernel_cov = unshear @ np.array([[h1 * h1, h1 * h2 * c12], [h1 * h2 * c12, h2 * h2]]) @ unshear.T
                widths = np.sqrt(kernel_cov.diagonal())
                c = kernel_cov[0, 1] / (widths[0] * widths[1])
                if pary.has_limits:
                    sheared_results[(idx[a], idx[b])] = (widths[1], widths[0], c)
                else:
                    sheared_results[(idx[a], idx[b])] = (widths[0], widths[1], c)

            try:
                while True:
                    item = _q.get()
                    if item is None:
                        break
                    if isinstance(item, BaseException):
                        raise item
                    s, block = item
                    for r in range(block.shape[0]):
                        _sheared_optimize(s + r, block[r])
            finally:
                # if the consumer raised (re-raised readback error, or an
                # exception escaping _sheared_optimize), the producer may be
                # blocked on the bounded queue — drain it so the thread can
                # finish, then join (it is daemonized as a last resort)
                while True:
                    sheared_thread.join(timeout=0.05)
                    if not sheared_thread.is_alive():
                        break
                    try:
                        _q.get_nowait()
                    except _queue.Empty:
                        pass
        _mark("sheared")

        # join the plain-branch readback started before the sheared section
        plain_thread.join()
        if plain_errs:
            raise plain_errs[0]
        _mark("plain_readback")

        # -- host-exact bandwidths + conv grouping ----------------------------
        groups = {}
        for fine, members in pair_fine.items():
            fw = (binmax - binmin) / (fine - 1)
            for k, (a, b, actual_corr) in enumerate(members):
                parx, pary = infos[a], infos[b]
                hist = plain_hists.get((fine, k))
                hx, hy, c = self.getAutoBandwidth2D(
                    hist,
                    parx,
                    pary,
                    idx[a],
                    idx[b],
                    actual_corr,
                    binmax[a] - binmin[a],
                    binmax[b] - binmin[b],
                    self.fine_bins_2D,
                    mult_bias_correction_order=self.mult_bias_correction_order,
                    sheared_result=sheared_results.get((idx[a], idx[b])),
                )
                rx = hx * scale_2d / fw[a]
                ry = hy * scale_2d / fw[b]
                winw = max(1, int(round(2.5 * max(rx, ry))))
                groups.setdefault(fine, []).append((a, b, hx, hy, c, winw, k))
        _mark("bandwidths")

        # -- fused convolution programs with host-bandwidth overrides --------
        active_lo = np.array([info.has_limits_bot for info in infos])
        active_hi = np.array([info.has_limits_top for info in infos])
        per = np.array([bool(getattr(info, "periodic", False)) for info in infos])
        bounded = active_lo.any() or active_hi.any()

        if not backend.native_f64_fft():
            raise MCSamplesError("parity device mode needs native float64 FFTs")
        conv_dtype = jnp.float64
        conv_samples = dev_s64 if idx == list(range(self.n)) else jnp.take(dev_s64, col_arr, axis=1)
        conv_weights = dev_w64
        dev_neff = jnp.asarray(neff, conv_dtype)
        dev_binmin, dev_binmax = jnp.asarray(binmin, conv_dtype), jnp.asarray(binmax, conv_dtype)
        dev_contours = jnp.asarray(contours, conv_dtype)
        dev_lo = jnp.asarray(active_lo) if bounded else None
        dev_hi = jnp.asarray(active_hi) if bounded else None
        dev_per = jnp.asarray(per) if per.any() else None
        dev_sigma = jnp.asarray(np.array([info.sigma_range for info in infos]), conv_dtype)

        bucketed = []
        for fine, plist_all in groups.items():
            by_level = {}
            for entry in plist_all:
                by_level.setdefault(self._parity_winw_level(entry[5], fine), []).append(entry)
            bucketed.extend((fine, winw, plist) for winw, plist in by_level.items())

        dens2 = {}
        out_groups = []
        for fine, winw, plist in bucketed:
            hists_in = jnp.take(
                group_hists[fine], jnp.asarray(np.asarray([entry[6] for entry in plist], np.int32)), axis=0
            ).astype(conv_dtype)
            d2 = all_2d_densities(
                conv_samples,
                conv_weights,
                jnp.asarray(np.array([entry[0] for entry in plist], np.int32)),
                jnp.asarray(np.array([entry[1] for entry in plist], np.int32)),
                dev_neff,
                dev_binmin,
                dev_binmax,
                dev_contours,
                fine_bins=fine,
                winw=winw,
                bandwidth_scale=None if scale_2d == 1.0 else conv_dtype(scale_2d),
                bandwidth_override=(
                    jnp.asarray(np.array([entry[2] for entry in plist]), conv_dtype),
                    jnp.asarray(np.array([entry[3] for entry in plist]), conv_dtype),
                    jnp.asarray(np.array([entry[4] for entry in plist]), conv_dtype),
                ),
                kernel_support=jnp.asarray(np.array([float(entry[5]) for entry in plist]), conv_dtype),
                active_lo=dev_lo,
                active_hi=dev_hi,
                periodic=dev_per,
                sigma_range=dev_sigma,
                max_corr=float(self.max_corr_2D),
                enable_shear=False,  # bandwidths are host-exact overrides
                exact_mult_bias=True,
                hists_in=hists_in,
            )
            if not materialize:
                out_groups.append(
                    {
                        "pairs": [(names[entry[0]], names[entry[1]]) for entry in plist],
                        "P": d2["P"],
                        "contours": d2["contours"],
                        "ranges": [
                            ((binmin[entry[0]], binmax[entry[0]]), (binmin[entry[1]], binmax[entry[1]]))
                            for entry in plist
                        ],
                        "fine": fine,
                    }
                )
                continue
            grids = np.asarray(d2["P"], float)
            for k, (a, b, *_rest) in enumerate(plist):
                density = Density2D(
                    np.linspace(binmin[a], binmax[a], fine),
                    np.linspace(binmin[b], binmax[b], fine),
                    grids[k],
                    view_ranges=[
                        (infos[a].range_min, infos[a].range_max),
                        (infos[b].range_min, infos[b].range_max),
                    ],
                )
                density.contours = density.getContourLevels(contours)
                density.likes = None
                dens2[(names[a], names[b])] = density
        _mark("conv_dispatch" if not materialize else "conv_materialize")
        if _prof_on:
            import sys as _sys

            total = _marks[-1][1] - _marks[0][1]
            parts_s = " ".join(
                f"{lab}={t1 - t0:.2f}s" for (_, t0), (lab, t1) in zip(_marks, _marks[1:])
            )
            print(f"# parity-device profile: total={total:.2f}s {parts_s}", file=_sys.stderr)
        return (dens1, dens2) if materialize else (dens1, out_groups)

    @staticmethod
    def _compact_readback(dev_hists):
        """Read a (K, n, n) device histogram batch back as float64 via the
        narrowest exact dtype (uint16 when every count fits, a quarter of
        the f64 bytes).

        The uint16 path requires INTEGRAL cell values: fractional weighted
        counts (non-integer chain weights) would truncate toward zero, so
        the eligibility check includes integrality and falls back to the
        full-width readback otherwise (one fused scalar probe)."""
        import jax.numpy as jnp_

        if not dev_hists.shape[0]:
            return np.zeros(dev_hists.shape, np.float64)
        compact_ok = jnp_.logical_and(
            jnp_.logical_and(jnp_.max(dev_hists) < 65536, jnp_.min(dev_hists) >= 0),
            jnp_.all(dev_hists == jnp_.round(dev_hists)),
        )
        if bool(compact_ok):
            return np.asarray(dev_hists.astype(jnp_.uint16)).astype(np.float64)
        return np.asarray(dev_hists).astype(np.float64)

    def fastDensities(self, params=None, contours=(0.68, 0.95), cache_1d=True, meanlikes=False, parity=False):
        """Fused-pipeline densities as plot-ready objects: a dict of
        :class:`~.densities.Density1D` per parameter name and a dict of
        :class:`~.densities.Density2D` per name pair.

        With ``cache_1d`` the 1D results populate the ``density1D`` cache,
        so subsequent ``get1DDensity``/1D plotting reuses them; 2D objects
        plot via ``add_2d_contours(..., density=...)``. Fast-path KDE
        conventions (see :meth:`fastTriangleDensities`), or reference-exact
        ones with ``parity=True`` (see :meth:`fastParityDensities`).
        """
        if parity:
            dens1, dens2 = self.fastParityDensities(params=params, contours=contours)
            if cache_1d:
                self.density1D.update(dens1)
            return dens1, dens2
        d1, d2, pairs = self.fastTriangleDensities(params=params, contours=contours, meanlikes=meanlikes)
        if params is None:
            names = [p.name for p in self.paramNames.names]
        else:
            names = [self._parAndNumber(p)[1].name for p in params]
        import numpy as _np

        bmin = _np.asarray(d1["range"][0], float)
        bmax = _np.asarray(d1["range"][1], float)
        dens1 = {}
        for i, name in enumerate(names):
            par = self.paramNames.parWithName(name)
            view = [par.range_min, par.range_max] if hasattr(par, "range_min") else None
            dens1[name] = Density1D(_np.asarray(d1["x"][i], float), P=_np.array(d1["P"][i], float), view_ranges=view)
            dens1[name].likes = None if d1["likes"] is None else _np.asarray(d1["likes"][i], float)
        n2 = _np.asarray(d2["P"], float).shape[1]
        regrid = d2.get("regrid", {})
        dens2 = {}
        for k, (a, b) in enumerate(pairs):
            fine = regrid.get((a, b))
            grid_p = _np.array(fine["P"] if fine else d2["P"][k], float)
            npts = grid_p.shape[0]
            gx = _np.linspace(bmin[a], bmax[a], npts)
            gy = _np.linspace(bmin[b], bmax[b], npts)
            density = Density2D(gx, gy, grid_p)
            density.contours = _np.asarray(fine["contours"] if fine else d2["contours"][k], float)
            if fine is None and d2.get("likes") is not None:
                density.likes = _np.asarray(d2["likes"][k], float)
            else:
                density.likes = None
            dens2[(names[a], names[b])] = density
        if cache_1d:
            self.density1D.update(dens1)
        return dens1, dens2

    def _fast_chain_state(self):
        """Device-resident f32 chain for the fused pipeline, cached until
        the samples change (``chains._weightsChanged``), so repeated
        public-path calls pay device compute only, not the upload.
        ``native`` arrays keep the ambient jnp dtype (f64 under x64) for
        the regrid/rescue reruns and the parity device mode, aliasing the
        f32 arrays when x64 is off.
        """
        st = getattr(self, "_fast_chain_cache", None)
        if st is None:
            import jax

            from getdist_tpu.ops.batched import prepare_chain

            w = self.weights
            dev_s, dev_w = prepare_chain(self.samples, w)
            if jax.config.jax_enable_x64:
                nat_s, nat_w = jnp.asarray(self.samples), jnp.asarray(w)
            else:
                nat_s, nat_w = dev_s, dev_w
            st = {
                "samples": dev_s,
                "weights": dev_w,
                "native_samples": nat_s,
                "native_weights": nat_w,
                "cum_score": None,
                "like_weights": None,
            }
            self._fast_chain_cache = st
        return st

    def _fast_cum_score(self):
        """|k31| + |k13| + |k22| standardized joint cumulants per pair —
        the gate separating genuinely non-Gaussian pairs (hard zoo shapes
        measure 0.4-3.4) from Gaussian ones (<= 0.11) when the fused
        program flags a fragile bandwidth search. Computed on device from
        the cached chain (a host numpy pass cost ~2 s per call at 1M x 30)
        and cached with it."""
        st = self._fast_chain_state()
        if st["cum_score"] is None:
            from getdist_tpu.ops.batched import pair_cumulant_score

            st["cum_score"] = np.asarray(pair_cumulant_score(st["samples"], st["weights"]))
        return st["cum_score"]

    def _fast_device_view(self, idx, native=False):
        """Cached device chain restricted to the given parameter columns."""
        st = self._fast_chain_state()
        s = st["native_samples" if native else "samples"]
        w = st["native_weights" if native else "weights"]
        if list(idx) != list(range(self.n)):
            s = jnp.take(s, jnp.asarray(np.asarray(idx, np.int32)), axis=1)
        return s, w

    def fastTriangleDensities(self, params=None, contours=(0.68, 0.95), meanlikes=False, mesh=None):
        """All 1D and all-pairs 2D densities via the fused device pipeline
        (:mod:`getdist_tpu.ops.batched`), with this chain's hard prior
        bounds wired in automatically.

        Orders of magnitude faster than per-pair ``get2DDensityGridData``
        for many parameters (one jitted program per stage); results follow the fast path's own KDE conventions rather than
        exact reference parity. Returns the (d1, d2) dicts plus the pair
        index list.

        Pipelined for latency: the 1D program is dispatched and synced
        first (it is small), the all-pairs 2D program is dispatched
        asynchronously, and the host-side rescue preparation (sheared f64
        bandwidths for |corr| >= 0.5 pairs, corr-adaptive fine regrid
        groups — see :meth:`_fast_regrid_plan`) runs on the host WHILE the
        device executes the 2D program. Only the fragile-pair rescue has to
        wait for the 2D program's own diagnostics.

        ``mesh``: a :class:`jax.sharding.Mesh` (see
        :func:`getdist_tpu.parallel.make_mesh`) routes every device program
        — including the regrid/rescue reruns — through ``shard_map`` with
        the sample axis sharded across the mesh and bin/moment reductions
        psum'd over the mesh, so the multi-device path serves the SAME feature set
        (limits, periodic axes, shearing, meanlikes, host-assisted
        bandwidths) as the single-device one. The sample count is trimmed
        to a mesh multiple.
        """
        import jax

        from getdist_tpu.ops.batched import all_1d_densities, all_2d_densities

        if self.needs_update:
            self.updateBaseStatistics()
        if params is None:
            idx = list(range(self.n))
        else:
            idx = [self._parAndNumber(p)[0] for p in params]
            if None in idx:
                raise ParamError("Unknown parameter %s" % [p for p, j in zip(params, idx) if j is None])
        pars = [self.paramNames.names[j] for j in idx]
        lo = np.array([p.limmin if p.has_limits_bot else np.nan for p in pars], np.float32)
        hi = np.array([p.limmax if p.has_limits_top else np.nan for p in pars], np.float32)
        per = np.array([bool(getattr(p, "periodic", False)) for p in pars])
        has = bool(np.isfinite(lo).any() or np.isfinite(hi).any() or per.any())
        st = self._fast_chain_state()
        like_w = None
        if meanlikes and self.loglikes is not None:
            if st["like_weights"] is None:
                st["like_weights"] = jnp.asarray(self._likelihood_weights(), jnp.float32)
            like_w = st["like_weights"]
        # reference smooth_scale = -scale convention: auto bandwidth x scale
        scale_1d = -float(self.smooth_scale_1D) if float(self.smooth_scale_1D) < 0 else 1.0
        scale_2d = -float(self.smooth_scale_2D) if float(self.smooth_scale_2D) < 0 else 1.0
        bs1 = None if scale_1d == 1.0 else jnp.float32(scale_1d)
        bs2 = None if scale_2d == 1.0 else jnp.float32(scale_2d)

        dev_s, dev_w = self._fast_device_view(idx)
        if mesh is not None:
            from getdist_tpu.parallel import reductions as _reductions
            from getdist_tpu.parallel.mesh import SAMPLE_AXIS, shard_samples

            dev_s, dev_w = shard_samples(mesh, dev_s, dev_w)
            if like_w is not None:
                from jax.sharding import NamedSharding, PartitionSpec

                like_w = jax.device_put(
                    like_w[: dev_w.shape[0]], NamedSharding(mesh, PartitionSpec(SAMPLE_AXIS))
                )

            def all_1d_densities(*a, **k):  # noqa: F811 - mesh-routed twins
                return _reductions.sharded_all_1d_densities(mesh, *a, **k)

            def all_2d_densities(*a, **k):  # noqa: F811
                return _reductions.sharded_all_2d_densities(mesh, *a, **k)

        p = len(idx)
        pairs = [(a, b) for a in range(p) for b in range(a + 1, p)]
        pairs_arr = np.array(pairs, np.int32).reshape(-1, 2)
        # exact weighted correlations decide the static shear subset (the
        # same 0.15-margin rule as ops.batched._sniff_shear, but from the
        # chain's cached correlation matrix instead of a subsample pass)
        corr = np.asarray(self.getCorrelationMatrix())[np.ix_(idx, idx)]
        sel = [k for k, (a, b) in enumerate(pairs) if abs(corr[a, b]) > 0.15]
        enable_shear = False if not sel else (True if len(sel) == len(pairs) else tuple(sel))

        if has:
            limits_lo = jnp.asarray(lo)
            limits_hi = jnp.asarray(hi)
        per_dev = jnp.asarray(per) if per.any() else None
        contours_dev = jnp.asarray(np.array(contours, np.float32))

        # Single-dispatch fast path: when no host rescue can fire — no hard
        # limits or periodic axes, no meanlikes grids, no corr-adaptive
        # fine>256 pairs (|corr| >= ~0.87), and no sheared-assist candidates
        # (|corr| >= 0.5 AND measurably non-Gaussian) — programs A and B
        # fuse into ONE device dispatch and the only host sync is the
        # packed diagnostics readback. Saves a dispatch + readback round
        # trip. The fragile flags are still honored post-hoc from the
        # diagnostics buffer.
        abs_corr = np.abs(np.asarray(corr, float))
        np.fill_diagonal(abs_corr, 0.0)
        max_corr_val = float(abs_corr.max(initial=0.0))
        single = mesh is None and not has and like_w is None and max_corr_val < 0.866
        if single and max_corr_val >= 0.5:
            cum = self._fast_cum_score()[np.ix_(np.asarray(idx), np.asarray(idx))]
            single = not any(
                abs(corr[a, b]) >= 0.5 and cum[a, b] > 0.25 for a, b in pairs
            )
        if single:
            from getdist_tpu.ops.batched import _triangle_program

            d1, d2 = _triangle_program(
                dev_s,
                dev_w,
                jnp.asarray(pairs_arr[:, 0]),
                jnp.asarray(pairs_arr[:, 1]),
                contours_dev,
                None,
                None,
                None,
                256,
                False,
                max_corr=float(self.max_corr_2D),
                enable_shear=enable_shear,
                bandwidth_scale_1d=bs1,
                bandwidth_scale_2d=bs2,
            )
            d2 = dict(d2)
            k_pairs = len(pairs)
            diag = np.asarray(d2["diag"])
            frag = diag[:k_pairs] > 0.5
            rx_h = diag[k_pairs : 2 * k_pairs]
            ry_h = diag[2 * k_pairs : 3 * k_pairs]
            regrid = {}
            if frag.any():
                plan = self._fast_regrid_plan(
                    idx, pairs, d1, None, None, per, scale_2d, fragile=frag, fragile_only=True
                )
                regrid = self._fast_regrid_exec(
                    plan, idx, pairs, d1, contours, None, None, per, scale_2d
                )
            d2["regrid"] = regrid
            self._fast_rescue_clamped_pairs(
                idx, pairs, d1, d2, contours, None, None, per, scale_2d, rx_host=rx_h, ry_host=ry_h
            )
            return d1, d2, pairs

        # program A: all 1D densities (small; host rescue planning needs its
        # neff/range outputs, so it is synced first)
        if has:
            d1 = all_1d_densities(
                dev_s, dev_w, limits_lo=limits_lo, limits_hi=limits_hi, periodic=per_dev,
                like_weights=like_w, bandwidth_scale=bs1,
            )
        else:
            d1 = all_1d_densities(dev_s, dev_w, like_weights=like_w, bandwidth_scale=bs1)
        # program B: all-pairs 2D densities, dispatched asynchronously (it
        # consumes program A's device outputs without a host round-trip)
        d2 = all_2d_densities(
            dev_s,
            dev_w,
            jnp.asarray(pairs_arr[:, 0]),
            jnp.asarray(pairs_arr[:, 1]),
            d1["neff"],
            d1["range"][0],
            d1["range"][1],
            contours_dev,
            fine_bins=256,
            active_lo=d1["active_lo"] if has else None,
            active_hi=d1["active_hi"] if has else None,
            periodic=per_dev,
            bandwidth_scale=bs2,
            sigma_range=d1["sigma_range"],
            max_corr=float(self.max_corr_2D),
            enable_shear=enable_shear,
            like_weights=like_w,
            export_hists=True,
        )
        d2 = dict(d2)
        hists = d2.pop("hists", None)
        lo_a = lo if has else None
        hi_a = hi if has else None
        # one packed host readback of the small per-param planning fields
        # (each np.asarray would otherwise pay its own device-to-host copy;
        # the buffer is packed inside program A itself); only waits
        # on program A, so the host keeps overlapping the asynchronously-
        # executing program B
        packed = np.asarray(d1["host_pack"])
        d1h = {
            "neff": packed[:p],
            "sigma_range": packed[p : 2 * p],
            "range0": packed[2 * p : 3 * p],
            "range1": packed[3 * p : 4 * p],
            "bandwidth": packed[4 * p : 5 * p],
        }
        # host rescue planning overlapped with the device 2D program:
        # dispatch is async, so this host work (plus the wide-1D rescue)
        # runs while the device executes program B
        plan = self._fast_regrid_plan(
            idx, pairs, d1, lo_a, hi_a, per, scale_2d, fragile=None, d1_host=d1h
        )
        if has:
            d1 = self._fast_rescue_wide_bounded_1d(idx, d1, lo, hi, d1_host=d1h)
        regrid = self._fast_regrid_exec(
            plan, idx, pairs, d1, contours, lo_a, hi_a, per, scale_2d, hists=hists, mesh=mesh
        )
        # program B's packed diagnostics (fragile flags + kernel widths in
        # bin units): ONE readback — the pipeline's only sync on the
        # all-pairs program
        k_pairs = len(pairs)
        diag = np.asarray(d2["diag"])
        frag = diag[:k_pairs] > 0.5
        rx_h = diag[k_pairs : 2 * k_pairs]
        ry_h = diag[2 * k_pairs : 3 * k_pairs]
        plan = self._fast_regrid_plan(
            idx, pairs, d1, lo_a, hi_a, per, scale_2d, fragile=frag, fragile_only=True, d1_host=d1h
        )
        regrid.update(
            self._fast_regrid_exec(
                plan, idx, pairs, d1, contours, lo_a, hi_a, per, scale_2d, hists=hists, mesh=mesh
            )
        )
        d2["regrid"] = regrid
        self._fast_rescue_clamped_pairs(
            idx, pairs, d1, d2, contours, lo if has else None, hi if has else None, per, scale_2d,
            rx_host=rx_h, ry_host=ry_h, mesh=mesh,
        )
        return d1, d2, pairs

    def _fast_rescue_wide_bounded_1d(self, idx, d1, lo, hi, d1_host=None):
        """Serve hard-limited params whose kernel covers a large fraction
        of the support from the host convention.

        The fused 1D boundary correction uses analytic frequency-domain
        kernel moments; at kernel sigma ~ range/3 with cuts (zoo 1D shape
        "flat") it drifts a few 1e-3 from the reference's masked spatial
        iteration while picking the identical bandwidth. For those few
        params, recompute host-side at the device-chosen width (passed as
        a fixed smoothing scale in fine bins) and resample onto the fused
        grid. No-op for unbounded chains.
        """
        if d1_host is not None:
            bw = np.asarray(d1_host["bandwidth"], float)
            bmin = np.asarray(d1_host["range0"], float)
            bmax = np.asarray(d1_host["range1"], float)
        else:
            bw = np.asarray(d1["bandwidth"], float)
            bmin = np.asarray(d1["range"][0], float)
            bmax = np.asarray(d1["range"][1], float)
        span = np.maximum(bmax - bmin, 1e-30)
        flagged = [
            i
            for i, j in enumerate(idx)
            if (np.isfinite(lo[i]) or np.isfinite(hi[i])) and bw[i] / span[i] > 0.15
        ]
        if not flagged:
            return d1
        p_rows = np.array(d1["P"], float)
        for i in flagged:
            # fixed positive smooth_scale_1D >= 1 is in COARSE (num_bins)
            # bin units (get1DDensityGridData convention)
            par = self._initParamRanges(idx[i])
            coarse_width = (par.range_max - par.range_min) / (self.num_bins - 1)
            width_bins = max(bw[i] / coarse_width, 1.001)
            dens = self.get1DDensityGridData(idx[i], smooth_scale_1D=float(width_bins), meanlikes=False)
            xg = np.clip(np.asarray(d1["x"][i], float), dens.x[0], dens.x[-1])
            vals = dens.Prob(xg)
            peak = vals.max()
            if peak > 0:
                p_rows[i] = vals / peak
        d1 = dict(d1)
        d1["P"] = p_rows
        return d1

    def _fast_rescue_clamped_pairs(self, idx, pairs, d1, d2, contours, lo, hi, per, scale_2d=1.0,
                                   rx_host=None, ry_host=None, mesh=None):
        """Re-run pairs whose kernel width saturated the fused program's
        fixed convolution window (rx/ry at winw/2.5 bins).

        The reference sizes its window from the bandwidth with no cap
        (``mcsamples.py:1884`` winw = 2.5*width), so near-uniform bounded
        distributions legitimately need very wide kernels; the fused
        program's static window under-smooths them (zoo shape "flat":
        0.19 max-grid error before this pass). The rescue re-runs just
        those pairs with a near-half-grid window and serves its results.
        """
        from getdist_tpu.ops.batched import all_2d_densities

        regrid = d2.get("regrid", {})
        base_cap = 30 / 2.5

        def regrid_cap(entry):
            n_fine = int(np.asarray(entry["P"]).shape[0])
            return max(30, int(round(n_fine / 9.0))) / 2.5

        if rx_host is not None:
            rxs, rys = rx_host, ry_host
        else:
            rxs, rys = np.asarray(d2["rx"]), np.asarray(d2["ry"])
        saturated = []
        for k, key in enumerate(pairs):
            entry = regrid.get(key)
            if entry is not None:
                widest = max(float(entry["rx"]), float(entry["ry"]))
                cap = regrid_cap(entry)
            else:
                widest, cap = max(float(rxs[k]), float(rys[k])), base_cap
            if widest >= cap - 1e-3:
                saturated.append(key)
        if not saturated:
            return
        fine = 256
        pa = jnp.asarray(np.array([a for a, _ in saturated], np.int32))
        pb = jnp.asarray(np.array([b for _, b in saturated], np.int32))
        bounded = lo is not None or hi is not None
        dev_samples, dev_weights = self._fast_device_view(idx, native=True)
        if mesh is not None:
            from functools import partial as _partial

            from getdist_tpu.parallel import reductions as _reductions
            from getdist_tpu.parallel.mesh import shard_samples

            dev_samples, dev_weights = shard_samples(mesh, dev_samples, dev_weights)
            all_2d = _partial(_reductions.sharded_all_2d_densities, mesh)
        else:
            all_2d = all_2d_densities
        d2w = all_2d(
            dev_samples,
            dev_weights,
            pa,
            pb,
            d1["neff"],
            d1["range"][0],
            d1["range"][1],
            jnp.asarray(np.array(contours, np.float32)),
            fine_bins=fine,
            bandwidth_scale=None if scale_2d == 1.0 else jnp.float32(scale_2d),
            active_lo=d1["active_lo"] if bounded else None,
            active_hi=d1["active_hi"] if bounded else None,
            periodic=jnp.asarray(per) if per is not None and per.any() else None,
            sigma_range=d1["sigma_range"],
            max_corr=float(self.max_corr_2D),
            winw=fine // 2 - 2,
        )
        for i, key in enumerate(saturated):
            regrid[key] = {name: d2w[name][i] for name in ("P", "contours", "rx", "ry", "corr", "neff")}
        d2["regrid"] = regrid

    def _fast_regrid_plan(self, idx, pairs, d1, lo, hi, per, scale_2d=1.0, fragile=None,
                          fragile_only=False, d1_host=None):
        """Host half of the regrid rescue for tightly-correlated pairs: pick
        the pairs to re-run at the reference's corr-adaptive fine grid
        (mcsamples.py:1812-1819 scales fine_bins_2D by the degeneracy angle)
        and compute their f64 bandwidth overrides. Pure host + d1-sync work:
        :meth:`fastTriangleDensities` runs it while the device executes the
        asynchronously-dispatched all-pairs 2D program. Returns a list of
        ``(fine, plist, override)`` groups for :meth:`_fast_regrid_exec`.

        Strongly-correlated shearable pairs (|corr| >= 0.5) get their
        bandwidth matrix from the host f64 sample-space sheared re-binning
        (:meth:`_optimize_bandwidth_sheared`, the parity helper itself): at
        high correlation the in-program frequency-space shear of the coarse
        histogram is not accurate enough (zoo shapes tight / bimodal
        WJ3/WJ4).

        ``fragile`` (per-pair bools reported by the fused program): pairs
        whose f32 AMISE correlation search sat on a knife edge — odd-psi
        clamp bound or the 10%-win acceptance band — get their bandwidth
        matrix from the f64 host optimizer (the reference branch itself,
        :meth:`getAutoBandwidth2D`); zoo shapes 'rotating'/'trimodal WJ2'
        are served this way (host and device otherwise pick opposite-sign
        kernel correlations, ~2e-2 grid error)."""
        max_corr = float(self.max_corr_2D)
        corr = np.asarray(self.getCorrelationMatrix())[np.ix_(idx, idx)]
        par_objs = [self.paramNames.names[j] for j in idx]

        cum_cache = [None]

        def cum_gate(a, b):
            # actual non-Gaussian pair structure: |k31| + |k13| + |k22| of
            # the standardized weighted samples. Hard zoo shapes measure
            # 0.4-3.4, Gaussian chains <= 0.11 — below 0.25 host f64 and
            # device f32 land on the same bandwidths to ~1e-3 (the ISJ
            # optimum is flat there), so a host assist would change
            # nothing. Computed on device from the cached chain
            # (see _fast_cum_score), one small program per chain.
            if cum_cache[0] is None:
                cum_cache[0] = self._fast_cum_score()[np.ix_(np.asarray(idx), np.asarray(idx))]
            return cum_cache[0][a, b] > 0.25

        if fragile is not None and fragile.ndim > 1:
            fragile = None  # diagnostics mode (GETDIST_TPU_FRAGILE_SIGNAL=debug)
        if fragile is not None and fragile.any():
            # gate the device's blind-search flags on the same score
            fragile = np.array([bool(f) and cum_gate(a, b) for f, (a, b) in zip(fragile, pairs)])
        if fragile_only and (fragile is None or not fragile.any()):
            return []

        def limited(k):
            info = par_objs[k]
            return bool(getattr(info, "has_limits_bot", False) or getattr(info, "has_limits_top", False))

        groups = {}
        for k, (a, b) in enumerate(pairs):
            cc_raw = float(corr[a, b])
            cc = float(np.clip(cc_raw, -max_corr, max_corr))
            fine = 256
            if abs(cc) >= 0.1:
                angle_scale = max(0.2, np.sqrt(1 - min(max_corr, abs(cc)) ** 2))
                if int(1 / angle_scale) > 1:
                    scaled = 192 * int(3 / angle_scale) // 3
                    if scaled > 256:
                        fine = scaled
            # the O(N)-per-pair host re-binning assist is reserved for pairs
            # that are BOTH strongly correlated and measurably non-Gaussian:
            # only there can the host/device ISJ root selection diverge
            # (multi-root knife edges); Gaussian correlated pairs keep the
            # in-program frequency-space sheared bandwidths
            assist = (
                0.5 <= abs(cc_raw) <= max_corr
                and not (limited(a) and limited(b))
                and cum_gate(a, b)
            )
            frag = bool(fragile is not None and fragile[k]) and not assist
            if fragile_only:
                # post-2D-program pass: only pairs whose in-program bandwidth
                # search was flagged fragile (everything else was already
                # handled in the overlapped pre-pass)
                if frag:
                    groups.setdefault((fine, False, True), []).append((a, b))
            elif fine > 256 or assist or frag:
                groups.setdefault((fine, assist, frag), []).append((a, b))
        plan = []
        for (fine, assist, frag), plist in groups.items():
            override = None
            if assist:
                # host-exact sheared bandwidths (the parity helper itself):
                # at high correlation the optimizer's ISJ root selection can
                # sit on a knife edge where a single f32-shifted histogram
                # count picks a different fixed point, so the f64 host path
                # is the only way to reproduce the reference branch exactly;
                # samples are host-resident, and only |corr| >= 0.5 pairs
                # pay the per-pair host re-binning
                neff_h = d1_host["neff"] if d1_host else np.asarray(d1["neff"])
                sr_h = d1_host["sigma_range"] if d1_host else np.asarray(d1["sigma_range"])
                order = int(self.mult_bias_correction_order)
                hx = np.empty(len(plist))
                hy = np.empty(len(plist))
                c = np.empty(len(plist))
                for i, (a, b) in enumerate(plist):
                    pair_neff = float(min(neff_h[a], neff_h[b]))
                    parx = self._initParamRanges(idx[a])
                    pary = self._initParamRanges(idx[b])
                    try:
                        wx_d, wy_d, cc = self._optimize_bandwidth_sheared(
                            parx, pary, idx[a], idx[b], pair_neff, 256
                        )
                    except ValueError:
                        # the reference's optimizer-failure fallback: plug-in
                        # widths at the clipped sample correlation
                        plug = pair_neff ** (-1.0 / 6)
                        wx_d, wy_d = sr_h[a] * plug, sr_h[b] * plug
                        cc = np.clip(corr[a, b], -max_corr, max_corr)
                    if order:
                        rescale = 1.1 * pair_neff ** (1.0 / 6 - 1.0 / (2 + 4 * (1 + order)))
                        wx_d, wy_d = wx_d * rescale, wy_d * rescale
                    hx[i], hy[i], c[i] = wx_d, wy_d, cc
                override = (hx, hy, c)
            elif frag:
                # f64 host bandwidths through the reference branch itself
                # (getAutoBandwidth2D shears/plains by |corr| exactly as the
                # host KDE path does); only flagged pairs pay the host
                # re-binning, and the density convolution still runs on
                # device with the override
                neff_h = d1_host["neff"] if d1_host else np.asarray(d1["neff"])
                hx = np.empty(len(plist))
                hy = np.empty(len(plist))
                c = np.empty(len(plist))
                for i, (a, b) in enumerate(plist):
                    parx = self._initParamRanges(idx[a])
                    pary = self._initParamRanges(idx[b])
                    _, actual_corr = self._pair_correlation(idx[a], idx[b], parx, pary)
                    ix_, _sx, x_lo, x_hi = self._binSamples(self.samples[:, idx[a]], parx, 256)
                    iy_, _sy, y_lo, y_hi = self._binSamples(self.samples[:, idx[b]], pary, 256)
                    hist, _ = self._make2Dhist(ix_, iy_, 256, 256)
                    hx[i], hy[i], c[i] = self.getAutoBandwidth2D(
                        hist, parx, pary, idx[a], idx[b], actual_corr, x_hi - x_lo, y_hi - y_lo,
                        256, mult_bias_correction_order=self.mult_bias_correction_order,
                        N_eff=float(min(neff_h[a], neff_h[b])),
                    )
                override = (hx, hy, c)
            plan.append((fine, plist, override))
        return plan

    def _fast_regrid_exec(self, plan, idx, pairs, d1, contours, lo, hi, per, scale_2d=1.0, hists=None,
                          mesh=None):
        """Device half of the regrid rescue: re-run each planned group.
        ``hists`` (the all-pairs program's exported device pair histograms)
        lets fine=256 groups skip the O(N) re-binning entirely — the rerun
        then costs only the grid-local stages. Reuse is gated off under x64
        (there the rescue reruns historically bin in f64, and the exported
        histograms are f32-binned)."""
        regrid = {}
        if not plan:
            return regrid
        import jax

        from getdist_tpu.ops.batched import all_2d_densities

        max_corr = float(self.max_corr_2D)
        reuse_ok = hists is not None and not jax.config.jax_enable_x64
        pair_pos = {key: k for k, key in enumerate(pairs)}
        dev_samples, dev_weights = self._fast_device_view(idx, native=True)
        if mesh is not None:
            from functools import partial as _partial

            from getdist_tpu.parallel import reductions as _reductions
            from getdist_tpu.parallel.mesh import shard_samples

            dev_samples, dev_weights = shard_samples(mesh, dev_samples, dev_weights)
            run_2d = _partial(_reductions.sharded_all_2d_densities, mesh)
        else:
            run_2d = all_2d_densities
        for fine, plist, override_np in plan:
            pa = jnp.asarray(np.array([a for a, _ in plist], np.int32))
            pb = jnp.asarray(np.array([b for _, b in plist], np.int32))
            override = None
            if override_np is not None:
                override = tuple(jnp.asarray(v, jnp.float32) for v in override_np)
            hin = None
            if reuse_ok and fine == 256:
                sel = jnp.asarray(np.array([pair_pos[key] for key in plist], np.int32))
                hin = jnp.take(hists, sel, axis=0)
            d2x = run_2d(
                dev_samples,
                dev_weights,
                pa,
                pb,
                d1["neff"],
                d1["range"][0],
                d1["range"][1],
                jnp.asarray(np.array(contours, np.float32)),
                fine_bins=fine,
                bandwidth_scale=None if scale_2d == 1.0 else jnp.float32(scale_2d),
                bandwidth_override=override,
                active_lo=d1["active_lo"] if lo is not None or hi is not None else None,
                active_hi=d1["active_hi"] if lo is not None or hi is not None else None,
                periodic=jnp.asarray(per) if per.any() else None,
                sigma_range=d1["sigma_range"],
                max_corr=max_corr,
                winw=max(30, int(round(fine / 9.0))),
                hists_in=hin,
            )
            for i, key in enumerate(plist):
                regrid[key] = {name: d2x[name][i] for name in ("P", "contours", "rx", "ry", "corr", "neff")}
        return regrid

    def _makeNDhist(self, ixs, xsizes):
        if len(ixs) != len(xsizes):
            raise ValueError("need one bin size per index array")
        flatixv = self._flattenValues(ixs, xsizes)
        rebuilt = self._unflattenValues(flatixv, xsizes)
        if np.any(np.asarray(ixs) != np.asarray(rebuilt)):
            raise ValueError("ND flat-index round-trip failed")
        # np.array (not asarray): device arrays give read-only views, and the
        # caller divides the histogram in place by the edge mask
        hist = np.array(_bincount(flatixv, self.weights, int(np.prod(xsizes)))).reshape(xsizes[::-1], order="C")
        return hist, flatixv

    def _unflattenValues(self, q, xsizes):
        ndim = len(xsizes)
        if ndim == 1:
            return [q]
        strides = [np.prod(xsizes[:k]) for k in range(ndim)]
        ixs = [np.array(q) for _ in range(ndim)]
        ixs[ndim - 1] = q // strides[ndim - 1]
        consumed = 0
        for k in range(ndim - 2, -1, -1):
            consumed = consumed + ixs[k + 1] * strides[k + 1]
            remainder = q - consumed
            ixs[k] = remainder // strides[k] if k > 0 else remainder
        return ixs

    def _flattenValues(self, ixs, xsizes):
        q = ixs[0]
        for i in range(1, len(ixs)):
            q = q + np.prod(xsizes[0:i]) * ixs[i]
        return q

    def _setRawEdgeMaskND(self, parv, prior_mask):
        ndim = len(parv)
        vrap = parv[::-1]
        if len(prior_mask.shape) != ndim:
            raise ValueError("prior_mask dimensionality does not match the parameter list")
        slices: Any = [slice(None) for _ in range(ndim)]
        for i in range(ndim):
            if vrap[i].has_limits_bot:
                slices[i] = 0
                prior_mask[tuple(slices)] /= 2
                slices[i] = slice(None)
            if vrap[i].has_limits_top:
                slices[i] = prior_mask.shape[i] - 1
                prior_mask[tuple(slices)] /= 2
                slices[i] = slice(None)

    def _pair_correlation(self, j, j2, parx, pary):
        """(working corr, raw corr) for a pair: zeroed when negligible,
        clipped to max_corr_2D when fully degenerate."""
        if abs(self.max_corr_2D) > 1:
            raise SettingError("max_corr_2D must be below 1")
        raw = self.getCorrelationMatrix()[j2][j]
        corr = raw
        if abs(abs(corr) - 1.0) <= 1e-8:
            logging.warning("pair %s/%s is fully correlated", parx.name, pary.name)
            corr = np.sign(corr) * self.max_corr_2D
        logging.debug("2D pair %s/%s: errs %s, %s; corr %s", parx.name, pary.name, parx.err, pary.err, corr)
        if abs(corr) < 0.1:
            corr = 0.0
        return corr, raw

    def _degeneracy_adapted_bins(self, corr, base_fine_bins):
        """(fine_bins, coarse nbin2D): more bins along tight degeneracies
        (reference ``mcsamples.py:1812-1819``)."""
        tight = min(self.max_corr_2D, abs(corr))
        angle_scale = max(0.2, np.sqrt(1 - tight**2))
        nbin2D = int(round(self.num_bins_2D / angle_scale))
        fine_bins = base_fine_bins
        if corr:
            stretched = 192 * int(3 / angle_scale) // 3
            if base_fine_bins < stretched and int(1 / angle_scale) > 1:
                fine_bins = stretched
        return fine_bins, nbin2D

    @staticmethod
    def _anisotropic_window(rx, ry, corr, winw):
        """Normalized 2D Gaussian window with covariance [[ry^2, rxy],
        [rxy, rx^2]] over a (2 winw+1)^2 stencil."""
        precision = np.linalg.inv(np.array([[ry**2, rx * ry * corr], [rx * ry * corr, rx**2]]))
        gy, gx = np.mgrid[-winw : winw + 1, -winw : winw + 1]
        quad = gy**2 * precision[0, 0] + gx**2 * precision[1, 1] + 2 * precision[1, 0] * gy * gx
        window = np.exp(-quad / 2)
        return window / np.sum(window)

    @staticmethod
    def _conv_mode_2d(parx, pary):
        if parx.periodic:
            return "periodic_both" if pary.periodic else "periodic_x"
        return "periodic_y" if pary.periodic else "same"

    def _meanlikes_fine_2d(self, flatix, xsize, ysize):
        # np.array: mutated in place later (device arrays view read-only)
        flat = np.array(_bincount(flatix, self._likelihood_weights(), xsize * ysize))
        return flat.reshape((ysize, xsize))

    @staticmethod
    def _meanlikes_smooth_2d(finebinlikes, bins2D, Win, mode, convolvesize, mult_bias_order):
        """Smoothed mean-likelihood surface, de-biased like the density and
        divided by it where it carries weight."""
        smoothed = convolve2D(finebinlikes, Win, mode, largest_size=convolvesize)
        if mult_bias_order:
            carried = smoothed > 0
            finebinlikes[carried] /= smoothed[carried]
            second = convolve2D(finebinlikes, Win, mode, largest_size=convolvesize)
            second[carried] *= smoothed[carried]
            smoothed = second
        floor = 1e-4 * np.max(bins2D)
        smoothed[bins2D > floor] /= bins2D[bins2D > floor]
        smoothed[bins2D <= floor] = 0
        return smoothed

    def get2DDensityGridData(
        self, j, j2, num_plot_contours=None, get_density=False, meanlikes=False, mask_function: callable = None,
        **kwargs
    ):
        """Compute the marginalized 2D KDE density for a parameter pair.

        Full reference pipeline (``mcsamples.py:1748-2010``): corr-adaptive
        fine binning (device scatter-add) -> anisotropic auto bandwidth
        matrix (with Cholesky shearing for correlated pairs) -> device 2D
        FFT convolution (periodic modes per axis) -> linear boundary kernel
        -> multiplicative bias iterations -> optional mask -> contour levels.
        """
        if self.needs_update:
            self.updateBaseStatistics()
        if not kwargs and mask_function is None and self._fused_route_enabled():
            if not meanlikes or self.loglikes is not None:
                density = self._fused_2d_lookup(j, j2, num_plot_contours, meanlikes=meanlikes)
                if density is not None:
                    return density
        stopwatch = time.time()
        j, parx = self._parAndNumber(j)
        j2, pary = self._parAndNumber(j2)
        if None in (j, j2):
            return None
        for axis_index in (j, j2):
            self._initParamRanges(axis_index)

        pick = lambda name: kwargs.get(name, getattr(self, name))  # noqa: E731
        base_fine_bins_2D = pick("fine_bins_2D")
        boundary_order = pick("boundary_correction_order")
        mult_bias_order = pick("mult_bias_correction_order")
        smooth_scale_2D = float(pick("smooth_scale_2D"))
        has_prior = bool(parx.has_limits or pary.has_limits or mask_function)

        corr, actual_corr = self._pair_correlation(j, j2, parx, pary)
        fine_bins_2D, nbin2D = self._degeneracy_adapted_bins(corr, base_fine_bins_2D)
        xsize = ysize = fine_bins_2D

        ixs, step_x, x_lo, x_hi = self._binSamples(self.samples[:, j], parx, fine_bins_2D)
        iys, step_y, y_lo, y_hi = self._binSamples(self.samples[:, j2], pary, fine_bins_2D)
        pair_hist, flat_cells = self._make2Dhist(ixs, iys, xsize, ysize)
        finebinlikes = self._meanlikes_fine_2d(flat_cells, xsize, ysize) if meanlikes else None

        # rx/ry are kernel widths in fine-bin units
        if smooth_scale_2D < 0:
            hx, hy, corr = self.getAutoBandwidth2D(
                pair_hist, parx, pary, j, j2, actual_corr, x_hi - x_lo, y_hi - y_lo,
                base_fine_bins_2D, mult_bias_correction_order=mult_bias_order,
            )
            rx = hx * abs(smooth_scale_2D) / step_x
            ry = hy * abs(smooth_scale_2D) / step_y
        elif smooth_scale_2D < 1.0:
            rx = smooth_scale_2D * parx.err / step_x
            ry = smooth_scale_2D * pary.err / step_y
        else:
            rx = ry = smooth_scale_2D * fine_bins_2D / nbin2D

        widest = float(max(rx, ry))
        logging.debug("kernel corr %s, fine-bin widths %s x %s", corr, rx, ry)
        if widest < 2:
            logging.warning("%s/%s: fine_bins_2D too coarse for the optimal 2D kernel", parx.name, pary.name)
        winw = max(1, int(round(2.5 * widest)))
        Win = self._anisotropic_window(rx, ry, corr, winw)

        logging.debug("2D binning+bandwidth took %s s at %s bins", time.time() - stopwatch, fine_bins_2D)
        stopwatch = time.time()
        convolvesize = xsize + 2 * winw + Win.shape[0]  # oversized for fast fft padding choice
        conv_mode = self._conv_mode_2d(parx, pary)
        surface = convolve2D(pair_hist, Win, conv_mode, largest_size=convolvesize)

        like_surface = None
        if meanlikes:
            like_surface = self._meanlikes_smooth_2d(finebinlikes, surface, Win, conv_mode, convolvesize, mult_bias_order)
            del finebinlikes

        need_mask = has_prior and boundary_order >= 0 or mult_bias_order or mask_function
        prior_mask = masked_out = None
        if need_mask:
            # pad by winw so 'valid' convolutions return (ysize, xsize)
            prior_mask = np.ones((2 * winw + ysize, 2 * winw + xsize))
            if mask_function:
                mask_function(
                    x_lo - winw * step_x, y_lo - winw * step_y, step_x, step_y, prior_mask
                )
                masked_out = prior_mask[winw:-winw, winw:-winw] < 1e-8

        fully_periodic = parx.periodic and pary.periodic
        if has_prior and boundary_order >= 0 and not fully_periodic:
            self._setEdgeMask2D(parx, pary, prior_mask, winw)
            self._boundary_correct_2d(surface, pair_hist, prior_mask, Win, winw, boundary_order, conv_mode, convolvesize)

        if mult_bias_order and not fully_periodic:
            self._setAllEdgeMask2D(
                prior_mask, winw, periodic_x=parx.periodic, periodic_y=pary.periodic
            )
            self._mult_bias_correct_2d(
                surface, pair_hist, prior_mask, Win, conv_mode, convolvesize, mult_bias_order, masked_out
            )

        if mask_function:
            surface[masked_out] = 0

        views = [(parx.range_min, parx.range_max), (pary.range_min, pary.range_max)]
        density = Density2D(
            np.linspace(x_lo, x_hi, xsize),
            np.linspace(y_lo, y_hi, ysize),
            surface,
            mask=None if not mask_function else np.asarray(masked_out),
            view_ranges=views,
        )
        density.normalize("max", in_place=True)
        if get_density:
            return density

        ncontours = len(self.contours)
        if num_plot_contours:
            ncontours = min(int(num_plot_contours), ncontours)
        logging.debug("2D convolutions took %s s", time.time() - stopwatch)
        density.contours = density.getContourLevels(self.contours[:ncontours])
        if meanlikes:
            like_surface /= np.max(like_surface)
        density.likes = like_surface
        return density

    @staticmethod
    def _mult_bias_correct_2d(surface, pair_hist, prior_mask, Win, conv_mode, convolvesize, order, masked_out):
        """Multiplicative bias iterations in place: divide out the current
        estimate, re-smooth, multiply back (reference ``mcsamples.py:1921-1944``)."""
        mask_mass = convolve2D(prior_mask, Win, "valid", largest_size=convolvesize)
        for _ in range(order):
            flattened = pair_hist.copy()
            significant = surface > np.max(surface) * 1e-8
            flattened[significant] /= surface[significant]
            surface *= convolve2D(flattened, Win, conv_mode, largest_size=convolvesize)
            if masked_out is not None:
                surface[~masked_out] /= mask_mass[~masked_out]
            else:
                surface /= mask_mass

    # -- ND densities ---------------------------------------------------------------

    def get2DDensity(self, x, y, normalized=False, **kwargs):
        """Density2D for a pair of parameters (max-normalized by default)."""
        if self.needs_update:
            self.updateBaseStatistics()
        density = self.get2DDensityGridData(x, y, get_density=True, **kwargs)
        if normalized:
            density.normalize(in_place=True)
        return density

    def _make2Dhist(self, ixs, iys, xsize, ysize):
        flatix = ixs + iys * xsize
        hist = np.asarray(_bincount2d(ixs, iys, self.weights, xsize, ysize))
        return hist, flatix

    def _getScaleForParam(self, par):
        # Half-width-at-50% based scale; also primes the 1D density cache.
        density = self.get1DDensity(par)
        mn, mx, bot_hit, top_hit = density.getLimits(0.5, accuracy_factor=1)
        if bot_hit or top_hit:
            return (mx - mn) / 0.675
        return (mx - mn) / (2 * 0.675)

    @staticmethod
    def _boundary_correct_2d(bins2D, histbins, prior_mask, Win, winw, order, mode, convolvesize):
        """Boundary-kernel correction in place: renormalize by the clipped
        window mass (order 0), or solve the 2D linear boundary-kernel system
        (order 1, Jones 1993 family) wherever the mask convolution carries
        weight (reference ``mcsamples.py:1921-1961``)."""

        def mask_conv(window):
            return convolve2D(prior_mask, window, "valid", largest_size=convolvesize)

        a00 = mask_conv(Win)
        live = a00 * bins2D > np.max(bins2D) * 1e-8
        a00 = a00[live]
        normed = bins2D[live] / a00
        if order == 0:
            bins2D[live] = normed
            return
        if order != 1:
            raise SettingError("2D boundary_correction_order supports only 0 and 1")
        # window moments against the mask: m[jk] pairs x-power j with y-power k
        dx = np.arange(-winw, winw + 1)[None, :]
        dy = dx.reshape(-1, 1)
        tilted_x, tilted_y = Win * dx, Win * dy
        m = {
            jk: mask_conv(w)[live]
            for jk, w in (
                ("10", tilted_x), ("01", tilted_y),
                ("20", tilted_x * dx), ("02", tilted_y * dy), ("11", tilted_y * dx),
            )
        }
        m00, m10, m01 = a00, m["10"], m["01"]
        m20, m02, m11 = m["20"], m["02"], m["11"]
        firstP_x = convolve2D(histbins, tilted_x, mode, largest_size=convolvesize)[live]
        firstP_y = convolve2D(histbins, tilted_y, mode, largest_size=convolvesize)[live]
        det = m20 * m01**2 + m10**2 * m02 - m00 * m02 * m20 + m11**2 * m00 - 2 * m01 * m10 * m11
        corrected = (
            bins2D[live] * (m11**2 - m02 * m20)
            + firstP_x * (m10 * m02 - m01 * m11)
            + firstP_y * (m01 * m20 - m10 * m11)
        ) / det
        # clamped log-space update keeps the correction positive and bounded
        bins2D[live] = normed * np.exp(np.minimum(corrected / normed, 4) - 1)

    def _setAllEdgeMask2D(self, prior_mask, winw, periodic_x=False, periodic_y=False):
        if not periodic_x:
            prior_mask[:, :winw] = 0
            prior_mask[:, -winw:] = 0
        if not periodic_y:
            prior_mask[:winw:] = 0
            prior_mask[-winw:, :] = 0

    def _setEdgeMask2D(self, parx, pary, prior_mask, winw):
        # Edge masks only on non-periodic axes (periodic axes have no edges).
        col = np.s_[:]
        specs = (
            (parx, (col, winw), (col, np.s_[:winw]), (col, -(winw + 1)), (col, np.s_[-winw:])),
            (pary, (winw, col), np.s_[:winw:], (-(winw + 1), col), (np.s_[-winw:], col)),
        )
        for par, bot_edge, bot_zero, top_edge, top_zero in specs:
            if par.periodic:
                continue
            if par.has_limits_bot:
                prior_mask[bot_edge] /= 2
                prior_mask[bot_zero] = 0
            if par.has_limits_top:
                prior_mask[top_edge] /= 2
                prior_mask[top_zero] = 0

    def get1DDensityGridData(self, j, paramConfid=None, meanlikes=False, **kwargs):
        """Compute the marginalized 1D KDE density for a parameter.

        Full reference pipeline (``mcsamples.py:1517-1686``): device fine
        binning -> auto ISJ bandwidth -> device FFT convolution (periodic
        for periodic parameters) -> boundary kernel correction order 0/1/2
        -> multiplicative bias iterations -> peak-normalized Density1D.
        """
        if self.needs_update:
            self.updateBaseStatistics()
        if not kwargs and self._fused_route_enabled() and (not meanlikes or self.loglikes is not None):
            density = self._fused_1d_lookup(j, paramConfid, meanlikes=meanlikes)
            if density is not None:
                return density
        index = self._parAndNumber(j)[0]
        if index is None:
            return None

        par = self._initParamRanges(index, paramConfid)
        pick = lambda name: kwargs.get(name, getattr(self, name))  # noqa: E731
        num_bins, fine_bins = pick("num_bins"), pick("fine_bins")
        smooth_scale_1D = pick("smooth_scale_1D")
        boundary_order = pick("boundary_correction_order")
        mult_bias_order = pick("mult_bias_correction_order")

        span = par.range_max - par.range_min
        if span <= 0:
            raise MCSamplesError(f"{par.name} has an empty parameter range")
        coarse_width = span / (num_bins - 1)

        bin_indices, fine_width, binmin, binmax = self._binSamples(self.samples[:, index], par, fine_bins)
        bins = np.asarray(_bincount(bin_indices, self.weights, fine_bins))

        finebinlikes = self._fine_like_bins(bin_indices, fine_bins) if meanlikes else None

        # smoothing scale in fine-bin units, from the requested convention
        if smooth_scale_1D <= 0:
            # automatic bandwidth (periodic treated like bounded here; the
            # DCT-boundary error is comparable)
            bandwidth = self.getAutoBandwidth1D(bins, par, index, mult_bias_order, boundary_order) * (binmax - binmin)
            bandwidth = min(bandwidth, span / 4)
            smooth_1D = bandwidth * abs(smooth_scale_1D) / fine_width
        elif smooth_scale_1D < 1.0:
            smooth_1D = smooth_scale_1D * par.err / fine_width
        else:
            smooth_1D = smooth_scale_1D * coarse_width / fine_width

        if smooth_1D < 2:
            logging.warning("%s: fine_bins too coarse to resolve the smoothing kernel", par.name)
        smooth_1D = min(max(1.0, smooth_1D), fine_bins // 2)

        logging.debug("%s 1D: sigma_range %s, std %s, kernel %s fine bins", par.name, par.sigma_range, par.err, smooth_1D)

        support = (fine_bins - 1) if par.periodic else fine_bins
        winw = min(int(round(2.5 * smooth_1D)), support // 2 - 2)
        kernel = Kernel1D(winw, smooth_1D)

        conv_mode = "periodic" if par.periodic else "same"
        smoothed = convolve1D(bins, kernel.Win, conv_mode)
        grid = np.linspace(binmin, binmax, fine_bins)
        density1D = Density1D(grid, P=smoothed, view_ranges=[par.range_min, par.range_max])
        uncorrected = smoothed.copy() if meanlikes else None

        if par.has_limits and not par.periodic and boundary_order >= 0:
            self._boundary_correct_1d(density1D, bins, par, kernel, winw, fine_bins, boundary_order)
        elif not par.periodic and boundary_order == 2:
            self._interior_order2_correct_1d(density1D, bins, kernel)

        if mult_bias_order:
            self._mult_bias_correct_1d(density1D, bins, par, kernel, fine_bins, conv_mode, mult_bias_order)

        density1D.normalize("max", in_place=True)
        if not kwargs:
            self.density1D[par.name] = density1D

        if meanlikes:
            density1D.likes = self._mean_likes_1d(density1D, finebinlikes, kernel, conv_mode, uncorrected)
        else:
            density1D.likes = None
        return density1D

    def _likelihood_weights(self):
        """Per-sample weights for mean-likelihood shading surfaces."""
        return self.weights * np.exp(self.mean_loglike - self.loglikes)

    def _fine_like_bins(self, bin_indices, fine_bins):
        """Likelihood-weighted fine histogram for mean-like shading."""
        if self.shade_likes_is_mean_loglikes:
            w = self.weights * self.loglikes
        else:
            w = self._likelihood_weights()
        # np.array: mutated in place downstream (device arrays view read-only)
        return np.array(_bincount(bin_indices, w, fine_bins))

    @staticmethod
    def _interior_order2_correct_1d(density1D, bins, kernel):
        """Higher-order kernel in the interior (no boundary): subtract the
        second-moment bias term in clamped log space."""
        curved = kernel.Win * kernel.x**2
        secondP = convolve1D(bins, curved, "same")
        m2 = np.sum(curved)
        m4 = np.dot(curved, kernel.x**2)
        corrected = (density1D.P * m4 - m2 * secondP) / (m4 - m2**2)
        positive = density1D.P > 0
        density1D.P[positive] *= np.exp(np.minimum(corrected[positive] / density1D.P[positive], 2) - 1)

    def _mean_likes_1d(self, density1D, finebinlikes, kernel, conv_mode, uncorrected):
        """Smoothed mean-likelihood curve aligned with the corrected density."""
        live = density1D.P > 0
        finebinlikes[live] /= density1D.P[live]
        binlikes = convolve1D(finebinlikes, kernel.Win, conv_mode)
        binlikes[live] *= density1D.P[live] / uncorrected[live]
        if self.shade_likes_is_mean_loglikes:
            floor = np.min(binlikes)
            binlikes = np.where((binlikes - floor) < 30, np.exp(-(binlikes - floor)), 0)
            binlikes[uncorrected == 0] = 0
        binlikes /= np.max(binlikes)
        return binlikes

    # -- 2D densities ---------------------------------------------------------------

    @staticmethod
    def _boundary_correct_1d(density1D, bins, par, kernel, winw, fine_bins, order):
        """Boundary-kernel correction in place: renormalize by the clipped
        window mass (order 0) or solve the linear/quadratic boundary-kernel
        moment system (orders 1/2, Jones 1993 family); reference
        ``mcsamples.py:1600-1647``."""
        prior_mask = np.ones(2 * winw + fine_bins)
        if par.has_limits_bot:
            prior_mask[winw] = 0.5
            prior_mask[:winw] = 0
        if par.has_limits_top:
            prior_mask[-(winw + 1)] = 0.5
            prior_mask[-winw:] = 0

        def mask_conv(window):
            return convolve1D(prior_mask, window, "valid")

        m0 = mask_conv(kernel.Win)
        live = np.nonzero(m0 * density1D.P)
        m0 = m0[live]
        normed = density1D.P[live] / m0
        if order == 0:
            density1D.P[live] = normed
            return
        if order > 2:
            raise SettingError("boundary_correction_order supports only 0, 1 and 2")
        tilted = kernel.Win * kernel.x
        m1 = mask_conv(tilted)[live]
        m2 = mask_conv(tilted * kernel.x)[live]
        firstP = convolve1D(bins, tilted, "same")[live]
        if order == 1:
            corrected = (density1D.P[live] * m2 - firstP * m1) / (m0 * m2 - m1**2)
        else:
            m3 = mask_conv(tilted * kernel.x**2)[live]
            m4 = mask_conv(tilted * kernel.x**3)[live]
            secondP = convolve1D(bins, tilted * kernel.x, "same")[live]
            det = m4 * m2 * m0 - m4 * m1**2 - m2**3 - m3**2 * m0 + 2 * m1 * m2 * m3
            corrected = (
                density1D.P[live] * (m4 * m2 - m3**2) + firstP * (m2 * m3 - m4 * m1) + secondP * (m3 * m1 - m2**2)
            ) / det
        # clamped log-space update keeps the correction positive and bounded
        density1D.P[live] = normed * np.exp(np.minimum(corrected / normed, 4) - 1)

    @staticmethod
    def _mult_bias_correct_1d(density1D, bins, par, kernel, fine_bins, convolution_mode, order):
        """Multiplicative bias iterations in place: divide out the current
        estimate, re-smooth, multiply back (reference
        ``mcsamples.py:1649-1666``)."""
        if not par.periodic:
            edge_weight = np.ones(fine_bins)
            if par.has_limits_bot:
                edge_weight[0] *= 0.5
            if par.has_limits_top:
                edge_weight[-1] *= 0.5
            a0 = convolve1D(edge_weight, kernel.Win, "same")
        for _ in range(order):
            current = density1D.P.copy()
            current[current == 0] = 1
            resmoothed = convolve1D(bins / current, kernel.Win, convolution_mode)
            density1D.setP(density1D.P * resmoothed)
            if not par.periodic:
                density1D.P /= a0

    def get1DDensity(self, name, **kwargs):
        """Cached Density1D for a named parameter."""
        if self.needs_update:
            self.updateBaseStatistics()
        if not kwargs:
            density = self.density1D.get(name)
            if density is not None:
                return density
        return self.get1DDensityGridData(name, **kwargs)

    def getAutoBandwidth2D(
        self, bins, parx, pary, paramx, paramy, corr, rangex, rangey, base_fine_bins_2D,
        mult_bias_correction_order=None, min_corr=0.2, N_eff=None, use_2D_Neff=False,
        sheared_result=None,
    ):
        """Bandwidth matrix (hx, hy, c) in parameter units via 2D ISJ in
        (optionally Cholesky-sheared) coordinates (reference
        ``mcsamples.py:1285-1419``)."""
        if N_eff is None:
            want_2d = use_2D_Neff if use_2D_Neff is not None else self.use_effective_samples_2D
            if want_2d and abs(corr) < 0.999:
                N_eff = self.getEffectiveSamplesGaussianKDE_2d(paramx, paramy)
            else:
                neffs = (self._get1DNeff(parx, paramx), self._get1DNeff(pary, paramy))
                N_eff = min(neffs)
        logging.debug("AutoBandwidth2D %s/%s: N_eff %s at corr %s", parx.name, pary.name, N_eff, corr)

        plugin_width = N_eff ** (-1.0 / 6)
        clipped_corr = np.clip(corr, -self.max_corr_2D, self.max_corr_2D)
        both_limited = parx.has_limits and pary.has_limits

        def fallback_widths(ex):
            msg = f"2D kernel density bandwidth optimizer failed for {parx.name}, {pary.name}. Using fallback width: {ex}"
            if getattr(self, "raise_on_bandwidth_errors", False):
                raise BandwidthError(msg)
            logging.warning(msg)
            return parx.sigma_range * plugin_width, pary.sigma_range * plugin_width, clipped_corr

        if abs(corr) > self.max_corr_2D or (both_limited and corr > 0.8):
            # too degenerate to optimize: plug-in widths at clipped correlation
            hx, hy, c = parx.sigma_range * plugin_width, pary.sigma_range * plugin_width, clipped_corr
        elif abs(corr) > min_corr and not both_limited:
            # sheared_result: the same branch precomputed by the batched
            # driver (_sheared_bandwidths_batch) — identical values, the
            # O(N)-per-pair re-binning vectorized across pairs
            if sheared_result is not None:
                hx, hy, c = fallback_widths(sheared_result) if isinstance(sheared_result, Exception) \
                    else sheared_result
            else:
                try:
                    hx, hy, c = self._optimize_bandwidth_sheared(parx, pary, paramx, paramy, N_eff, base_fine_bins_2D)
                except ValueError as e:
                    hx, hy, c = fallback_widths(e)
        else:
            seed_t = (min(pary.sigma_range / rangey, parx.sigma_range / rangex) * plugin_width) ** 2
            try:
                opt = kde.KernelOptimizer2D(
                    bins, N_eff, corr, do_correlation=not (parx.has_limits or pary.has_limits), fallback_t=seed_t
                )
                hx, hy, c = opt.get_h()
                hx, hy = hx * rangex, hy * rangey
            except ValueError as e:
                hx, hy, c = fallback_widths(e)

        logging.debug("relative widths %s, %s at kernel corr %s", hx / parx.err, hy / pary.err, c)
        order = self.mult_bias_correction_order if mult_bias_correction_order is None else mult_bias_correction_order
        if order:
            # higher-order estimator: widen by the N-scaling mismatch factor
            scale = 1.1 * N_eff ** (1.0 / 6 - 1.0 / (2 + 4 * (1 + order)))
            hx, hy = hx * scale, hy * scale
            logging.debug("rescaled widths %s, %s (corr %s, factor %s)", hx / parx.err, hy / pary.err, c, scale)
        return hx, hy, c

    def _sheared_bandwidths_batch(self, jobs, nbins):
        """Batched twin of :meth:`_optimize_bandwidth_sheared`: identical
        per-pair values (the shear/bin/optimize arithmetic is elementwise
        and runs on the same operands in the same order), with the three
        O(N)-per-pair host passes vectorized across pairs and the 2D
        histograms computed by the multi-threaded native kernel. Returns
        ``{(paramx, paramy): (hx, hy, c) | ValueError}`` — failures carry
        the exception so the caller applies the reference fallback.

        ``jobs``: list of (parx, pary, paramx, paramy, N_eff).
        """
        from getdist_tpu import _native

        out = {}
        lead_cache = {}
        chunk_size = 24
        n = self.samples.shape[0]
        for start in range(0, len(jobs), chunk_size):
            chunk = jobs[start : start + chunk_size]
            metas = []
            resid_rows = np.empty((len(chunk), n), np.float64)
            for i, (parx, pary, paramx, paramy, n_eff) in enumerate(chunk):
                lead_par, other = (pary, paramx) if pary.has_limits else (parx, paramy)
                lead = paramy if pary.has_limits else paramx
                pair_cov = self.getCov(pars=[lead, other])
                root = np.linalg.cholesky(pair_cov)
                unshear = root / root[0, 0]
                resid_rows[i] = (root[0, 0] * self.samples[:, other] - root[1, 0] * self.samples[:, lead]) / root[1, 1]
                if lead not in lead_cache:
                    bound_lo = lead_par.range_min if lead_par.has_limits_bot else None
                    bound_hi = lead_par.range_max if lead_par.has_limits_top else None
                    lead_cache[lead] = kde.bin_samples(
                        self.samples[:, lead], nbins=nbins, range_min=bound_lo, range_max=bound_hi
                    )
                metas.append((parx, pary, paramx, paramy, n_eff, lead, unshear))
            # vectorized kde.bin_samples over the residual rows (identical
            # elementwise arithmetic: lo/hi per row, 10% pad, (x-lo)/dx)
            lo = resid_rows.min(axis=1)
            hi = resid_rows.max(axis=1)
            pad = (hi - lo) * 0.1
            rmin = lo - pad
            width = (hi + pad) - rmin
            dx = width / (nbins - 1)
            resid_ix = ((resid_rows - rmin[:, None]) / dx[:, None]).astype(int)
            leads = sorted({m[5] for m in metas})
            lead_pos = {lead: i for i, lead in enumerate(leads)}
            ix_rows = np.ascontiguousarray(
                np.concatenate(
                    [np.stack([lead_cache[lead][0] for lead in leads]), resid_ix], axis=0
                ),
                np.int32,
            )
            pair_list = [(lead_pos[m[5]], len(leads) + i) for i, m in enumerate(metas)]
            hists = _native.pair_histograms(ix_rows, self.weights, pair_list, nbins)
            for i, (parx, pary, paramx, paramy, n_eff, lead, unshear) in enumerate(metas):
                if hists is not None:
                    hist = hists[i]
                else:
                    hist, _ = self._make2Dhist(lead_cache[lead][0], resid_ix[i], nbins, nbins)
                try:
                    opt = kde.KernelOptimizer2D(
                        hist, n_eff, 0, do_correlation=not (parx.has_limits or pary.has_limits)
                    )
                    h1, h2, c12 = opt.get_h()
                except ValueError as e:
                    out[(paramx, paramy)] = e
                    continue
                h1 *= lead_cache[lead][1]
                h2 *= width[i]
                kernel_cov = unshear @ np.array([[h1 * h1, h1 * h2 * c12], [h1 * h2 * c12, h2 * h2]]) @ unshear.T
                widths = np.sqrt(kernel_cov.diagonal())
                c = kernel_cov[0, 1] / (widths[0] * widths[1])
                if pary.has_limits:
                    out[(paramx, paramy)] = (widths[1], widths[0], c)
                else:
                    out[(paramx, paramy)] = (widths[0], widths[1], c)
        return out

    def _optimize_bandwidth_sheared(self, parx, pary, paramx, paramy, N_eff, nbins):
        """2D bandwidth for a correlated pair: shear the samples so the pair
        decorrelates (keeping a bounded axis untouched as the first
        coordinate), optimize an axis-aligned kernel on the sheared
        histogram, and map the kernel covariance back through the shear
        (reference ``mcsamples.py:1347-1391``)."""
        lead_par, other = (pary, paramx) if pary.has_limits else (parx, paramy)
        lead = paramy if pary.has_limits else paramx
        bound_lo = lead_par.range_min if lead_par.has_limits_bot else None
        bound_hi = lead_par.range_max if lead_par.has_limits_top else None

        pair_cov = self.getCov(pars=[lead, other])
        root = np.linalg.cholesky(pair_cov)
        # second coordinate = residual of `other` against `lead`, rescaled to
        # the lead's sigma; unshear maps unit-lead coords back to parameters
        unshear = root / root[0, 0]
        sheared = (root[0, 0] * self.samples[:, other] - root[1, 0] * self.samples[:, lead]) / root[1, 1]

        lead_ix, lead_scale = kde.bin_samples(
            self.samples[:, lead], nbins=nbins, range_min=bound_lo, range_max=bound_hi
        )
        resid_ix, resid_scale = kde.bin_samples(sheared, nbins=nbins)
        hist, _ = self._make2Dhist(lead_ix, resid_ix, nbins, nbins)
        opt = kde.KernelOptimizer2D(hist, N_eff, 0, do_correlation=not (parx.has_limits or pary.has_limits))
        h1, h2, c12 = opt.get_h()
        h1 *= lead_scale
        h2 *= resid_scale
        kernel_cov = unshear @ np.array([[h1 * h1, h1 * h2 * c12], [h1 * h2 * c12, h2 * h2]]) @ unshear.T
        widths = np.sqrt(kernel_cov.diagonal())
        c = kernel_cov[0, 1] / (widths[0] * widths[1])
        if pary.has_limits:
            return widths[1], widths[0], c
        return widths[0], widths[1], c

    # -- 1D densities ---------------------------------------------------------------

    def getAutoBandwidth1D(self, bins, par, param, mult_bias_correction_order=None, kernel_order=1, N_eff=None):
        """ISJ bandwidth (in units of the bin range), with rule-of-thumb
        fallback and the higher-order rescale h * N^(1/5 - 1/(4m+5)) when
        multiplicative bias correction is used (reference
        ``mcsamples.py:1237-1283``)."""
        if N_eff is None:
            N_eff = self._get1DNeff(par, param)
        h = kde.gaussian_kde_bandwidth_binned(bins, Neff=N_eff)
        top, bottom = max(par.param_max, par.range_max), min(par.param_min, par.range_min)
        bin_range = top - bottom
        floor = 0.01 * N_eff ** (-1.0 / 5) * (par.range_max - par.range_min) / bin_range
        if h is None or h < floor:
            hnew = 1.06 * par.sigma_range * N_eff ** (-1.0 / 5) / bin_range
            suppressed = par.name in self.no_warning_params or (
                self.no_warning_chi2_params and ("chi2_" in par.name or "minuslog" in par.name)
            )
            if not suppressed:
                msg = (
                    f"ISJ bandwidth for {par.name} tiny or undetermined "
                    f"(h={h}, N_eff={N_eff}); falling back to h={hnew}"
                )
                if getattr(self, "raise_on_bandwidth_errors", False):
                    raise BandwidthError(msg)
                logging.warning(msg)
            h = hnew

        par.kde_h = h
        if mult_bias_correction_order is None:
            m = self.mult_bias_correction_order
        else:
            m = mult_bias_correction_order
        if kernel_order > 1:
            m = max(m, 1)
        if not m:
            return h
        # rescale the Parzen-optimal width for the higher-order
        # (bias-corrected) estimator's N scaling
        return h * N_eff ** (1.0 / 5 - 1.0 / (4 * m + 5))

    def _get1DNeff(self, par, param):
        N_eff = getattr(par, "N_eff_kde", None)
        if N_eff is None:
            N_eff = par.N_eff_kde = self.getEffectiveSamplesGaussianKDE(param, scale=par.sigma_range)
        return N_eff

    # -- bandwidths ----------------------------------------------------------------

    def _binSamples(self, paramVec, par, num_fine_bins, borderfrac=0.1):
        """Fine-bin index per sample over an edge-padded range; first and
        last bins are half width (device scatter targets)."""
        pad = (par.range_max - par.range_min) * borderfrac
        binmin = min(par.param_min, par.range_min) - (0 if par.has_limits_bot else pad)
        binmax = max(par.param_max, par.range_max) + (0 if par.has_limits_top else pad)
        fine_width = (binmax - binmin) / (num_fine_bins - 1)
        ix = ((paramVec - binmin) / fine_width + 0.5).astype(np.int64)
        return ix, fine_width, binmin, binmax

    @staticmethod
    def _peak_scale(quantiles, lo, hi, err):
        """Peak-structure width from 10%-quantile spacings (simplified
        Janssen 95): the smallest span of 4 consecutive deciles, in sigma
        units of a unit Gaussian (whose tightest such span is 1.049 sd)."""
        knots = np.concatenate(([lo], quantiles, [hi]))
        spans = knots[4:] - knots[:-4]
        tightest = np.min(spans) / 1.049
        if np.all(spans > err * 1.049) and np.all(spans < tightest * 1.5):
            return tightest  # very flat distribution
        return min(err, tightest)

    def _snap_range_to_limits(self, par, smooth_1D):
        """Pull range ends onto nearby hard priors, or drop the limit flag
        (and pad the range) when the samples sit far from the bound."""
        if par.has_limits_bot:
            clear_of_limit = par.range_min - par.limmin > 2 * smooth_1D and par.param_min - par.limmin > smooth_1D
            if clear_of_limit:
                par.has_limits_bot = False
            else:
                par.range_min = par.limmin
        if par.has_limits_top:
            clear_of_limit = par.limmax - par.range_max > 2 * smooth_1D and par.limmax - par.param_max > smooth_1D
            if clear_of_limit:
                par.has_limits_top = False
            else:
                par.range_max = par.limmax
        if not par.has_limits_bot:
            par.range_min -= 2 * smooth_1D
        if not par.has_limits_top:
            par.range_max += 2 * smooth_1D
        par.has_limits = par.has_limits_top or par.has_limits_bot

    def _initParam(self, par, paramVec, mean=None, sddev=None, paramConfid=None):
        """Set par.err/mean/param_min/param_max/range_min/range_max and the
        peak-structure scale sigma_range (reference ``mcsamples.py:
        1427-1484``); snaps range ends to hard limits when nearby."""
        par.mean = paramVec.mean() if mean is None else mean
        par.err = paramVec.std() if sddev is None else sddev
        par.param_min = np.min(paramVec)
        par.param_max = np.max(paramVec)
        paramConfid = paramConfid or self.initParamConfidenceData(paramVec)
        deciles = np.linspace(0.1, 0.9, 9)
        probe = np.concatenate(([self.range_confidence, 1 - self.range_confidence], deciles))
        levels = self.confidence(paramConfid, probe)
        par.range_min, par.range_max = levels[0], levels[1]
        par.sigma_range = self._peak_scale(levels[2:], par.param_min, par.param_max, par.err)
        if self.range_ND_contour >= 0 and self.likeStats:
            if self.range_ND_contour >= par.ND_limit_bot.size:
                raise SettingError("range_ND_contour must be -1 (disabled) or a valid contour-level index")
            nd_lo = par.ND_limit_bot[self.range_ND_contour]
            nd_hi = par.ND_limit_top[self.range_ND_contour]
            par.range_min = min(max(par.range_min - par.err, nd_lo), par.range_min)
            par.range_max = max(max(par.range_max + par.err, nd_hi), par.range_max)
        self._snap_range_to_limits(par, par.sigma_range * 0.4)
        return par

    def _initParamRanges(self, j, paramConfid=None):
        if isinstance(j, str):
            j = self.index[j]
        cache = getattr(self, "_param_range_cache", None)
        if paramConfid is None and cache is not None and j in cache:
            # _initParam is idempotent for fixed settings but costs an
            # O(N log N) confidence argsort per call; the cache is dropped
            # whenever samples or analysis settings change
            return cache[j]
        paramVec = self.samples[:, j]
        info = self.paramNames.names[j]
        par = self._initParam(info, paramVec, self.means[j], self.sddev[j], paramConfid)
        if paramConfid is None and cache is not None:
            cache[j] = par
        return par

    def getLower(self, name):
        """Lower hard bound for a named parameter, or None."""
        par = self.paramNames.parWithName(name)
        return getattr(par, "limmin", None) if par else None

    # -- parameter range/structure estimation ------------------------------------

    def getUpper(self, name):
        """Upper hard bound for a named parameter, or None."""
        par = self.paramNames.parWithName(name)
        return getattr(par, "limmax", None) if par else None

    def getBounds(self):
        """ParamBounds with only the limits that are actually active."""
        bounds = ParamBounds()
        bounds.names = self.paramNames.list()
        for par in self.paramNames.names:
            if par.has_limits_bot:
                bounds.lower[par.name] = par.limmin
            if par.has_limits_top:
                bounds.upper[par.name] = par.limmax
        return bounds

    def _readRanges(self):
        if self.root:
            sidecar = self.root + ".ranges"
            if os.path.isfile(sidecar):
                self.ranges = ParamBounds(sidecar)
                return
            yaml_info = cobaya_interface.cobaya_params_file(self.root)
            if yaml_info:
                self.ranges = ParamBounds(yaml_info)
                return
        self.ranges = ParamBounds()

    def getFractionIndices(self, weights, n):
        """Row indices splitting total weight into n equal fractions."""
        cumsum = np.cumsum(weights)
        targets = np.linspace(0, 1, n, endpoint=False) * self.norm
        return np.append(np.searchsorted(cumsum, targets), len(self.weights))

    # -- ranges / limits --------------------------------------------------------

    def writeCorrelationMatrix(self, filename=None):
        """Write the correlation matrix to text."""
        target = filename or self.rootdirname + ".corr"
        np.savetxt(target, self.getCorrelationMatrix(), fmt="%15.7E")

    def writeCovMatrix(self, filename=None):
        """Write the non-derived parameter covariance to .covmat text."""
        self.getCovMat().saveToFile(filename or self.rootdirname + ".covmat")

    def getCovMat(self):
        """CovMat of the non-derived parameters."""
        n_free = self.paramNames.numNonDerived()
        return covmat.CovMat(matrix=self.fullcov[:n_free, :n_free], paramNames=self.paramNames.list()[:n_free])

    def writeThinData(self, fname, thin_ix, cool=1):
        """Write samples at the given indices, optionally cooled."""
        nparams = self.samples.shape[1]
        if cool != 1:
            logging.info("writing thinned samples cooled by %s", cool)
        if self.loglikes is None:
            raise ValueError("thinned output needs likelihood values")
        MaxL = np.max(self.loglikes)
        with open(fname, "w", encoding="utf-8") as handle:
            for i, row in enumerate(thin_ix):
                if cool == 1:
                    handle.write("%f" % 1.0)
                    handle.write("%f" % (self.loglikes[row]))
                else:
                    newL = self.loglikes[row] * cool
                    handle.write("%16.7E" % (np.exp(-(newL - self.loglikes[row]) - MaxL * (1 - cool))))
                    handle.write("%16.7E" % newL)
                handle.writelines("%16.7E" % (self.samples[i][j]) for j in range(nparams))
                handle.write("\n")
        print("Wrote ", len(thin_ix), " thinned samples")

    def makeSingleSamples(self, filename="", single_thin=None, random_state=None):
        """Random unit-weight samples (or write them to a file)."""
        if single_thin is None:
            equiv = self.norm / self.max_mult
            single_thin = max(1, equiv / self.max_scatter_points)
        draws = np.random.default_rng(random_state).random(self.numrows)
        if not filename:
            return self.samples[draws <= self.weights / (self.max_mult * single_thin)]
        with open(filename, "w", encoding="utf-8") as handle:
            for i, draw in enumerate(draws):
                if draw <= self.weights[i] / self.max_mult / single_thin:
                    handle.write("%16.7E" % 1.0)
                    handle.write("%16.7E" % (self.loglikes[i]))
                    handle.writelines("%16.7E" % (self.samples[i][j]) for j in range(self.n))
                    handle.write("\n")

    def updateBaseStatistics(self):
        """Refresh basic statistics, limits, and the ND confidence region."""
        # full covariance first: getVars (inside the base update) then reads
        # the variances off its diagonal instead of a second O(N x p) pass
        self.means = None
        self.fullcov = None
        self._setCov()
        super().updateBaseStatistics()
        weight_ceiling = (self.mean_mult * self.numrows) / min(self.numrows // 2, 500)
        n_outliers = np.sum(self.weights > weight_ceiling)
        if n_outliers:
            logging.warning("%s of samples carry outlier weights", float(n_outliers) / self.numrows)

        self.indep_thin = 0
        self.done_1Dbins = False
        self.density1D = dict()
        self._fused_cache = None
        self._param_range_cache = {}
        self._initLimits(self.ini)
        for par in self.paramNames.names:
            par.N_eff_kde = None
        self._setLikeStats()
        return self

    # -- unit-weight sampling / file outputs -----------------------------------

    def cool(self, cool=None):
        """Cool the samples by the given factor (default: stored
        temperature)."""
        stored = self.properties
        if cool is None:
            if not stored.hasKey("temperature"):
                raise ValueError("no stored temperature on these samples: pass the cooling factor explicitly")
            cool = stored.float("temperature")
        if cool == 1:
            return
        if stored.float("cooled", 1) != 1:
            logging.warning("samples were already cooled (factor %s)", stored.float("cooled"))
        super().cool(cool)
        stored.params["cooled"] = cool
        if stored.hasKey("temperature"):
            stored.params["temperature"] = stored.float("temperature") / cool

    def readChains(self, files_or_samples, weights=None, loglikes=None):
        """Load samples (files or arrays), remove burn-in, delete fixed
        parameters, and combine into a single samples array."""
        self.loadChains(self.root, files_or_samples, weights=weights, loglikes=loglikes)

        grid_item = self.jobItem
        grid_handled = grid_item is not None and hasattr(grid_item, "isImportanceJob") and (
            grid_item.isImportanceJob or grid_item.isBurnRemoved()
        )
        if self.ignore_frac and not grid_handled:
            self.removeBurnFraction(self.ignore_frac)
            chains.print_load_line(f"Removed {self.ignore_frac} as burn in")
        elif not int(self.ignore_rows):
            chains.print_load_line("Removed no burn in")

        self.deleteFixedParams()
        if self.chains is not None:
            self.makeSingle()
        self.updateBaseStatistics()
        return self

    def updateSettings(self, settings: Mapping[str, Any] | None = None, ini=None, doUpdate=True):
        """Apply settings from an ini file and/or dict of overrides."""
        if settings is not None and not isinstance(settings, Mapping):
            raise TypeError("settings must be a mapping of option overrides")
        if not ini:
            ini = self.ini or IniFile(getdist_tpu.default_getdist_settings)
        else:
            ini = IniFile(ini) if isinstance(ini, str) else copy.deepcopy(ini)
        ini.params.update(settings or {})
        self.ini = ini
        self.initParameters(ini)
        self._param_range_cache = {}
        if doUpdate and self.samples is not None:
            self.updateBaseStatistics()

    def _initLimits(self, ini=None):
        shared_spec = ini.string("all_limits", "") if ini else ""
        self.markers = {}
        for par in self.paramNames.names:
            spec = shared_spec
            if ini and not spec:
                spec = ini.string("limits[%s]" % par.name) if "limits[%s]" % par.name in ini.params else ""
            pieces = spec.split()
            if len(pieces) == 2:
                self.ranges.setRange(par.name, pieces)
            par.limmin, par.limmax = self.ranges.getLower(par.name), self.ranges.getUpper(par.name)
            par.has_limits_bot = par.limmin is not None
            par.has_limits_top = par.limmax is not None
            par.periodic = par.name in self.ranges.periodic
            marker_key = "marker[%s]" % par.name
            if ini and marker_key in ini.params:
                spec = ini.string(marker_key)
                if spec:
                    self.markers[par.name] = float(spec)

    def initParameters(self, ini):
        """Read all analysis settings from an IniFile onto this object."""
        self._setBurnOptions(ini)
        for name in (
            "range_ND_contour",
            "range_confidence",
            "num_bins",
            "fine_bins",
            "num_bins_2D",
            "fine_bins_2D",
            "smooth_scale_1D",
            "smooth_scale_2D",
        ):
            ini.setAttr(name, self)
        for name, default in (("boundary_correction_order", 1), ("mult_bias_correction_order", 1)):
            ini.setAttr(name, self, default)
        for name in (
            "num_bins_ND",
            "max_scatter_points",
            "credible_interval_threshold",
            "subplot_size_inch",
            "subplot_size_inch2",
            "subplot_size_inch3",
            "plot_output",
            "force_twotail",
        ):
            ini.setAttr(name, self)
        if self.force_twotail:
            logging.warning("force_twotail set: all limits treated as two-tail")
        ini.setAttr("max_corr_2D", self)

        if ini.hasKey("contours"):
            ini.setAttr("contours", self)
        elif ini.hasKey("num_contours"):
            n_levels = ini.int("num_contours", 2)
            self.contours = np.array([ini.float("contour" + str(i + 1)) for i in range(n_levels)])
        # threshold for the edge bin to allow two-tail limits
        self.max_frac_twotail = []
        for i, level in enumerate(self.contours):
            gauss_edge = np.exp(-1.0 * math.pow(norm.ppf((1 - level) / 2), 2) / 2)
            self.max_frac_twotail.append(ini.float("max_frac_twotail" + str(i + 1), gauss_edge) if ini else gauss_edge)

        ini.setAttr("converge_test_limit", self, self.contours[-1])
        for name, default in (
            ("corr_length_thin", None),
            ("corr_length_steps", None),
            ("no_warning_params", []),
            ("no_warning_chi2_params", True),
        ):
            if default is None:
                ini.setAttr(name, self)
            else:
                ini.setAttr(name, self, default)
        self.batch_path = ini.string("batch_path", default=self.batch_path, allowEmpty=False)

    def _setBurnOptions(self, ini):
        ini.setAttr("ignore_rows", self)
        self.ignore_lines = int(self.ignore_rows)
        self.ignore_frac = self.ignore_rows if not self.ignore_lines else 0
        ini.setAttr("min_weight_ratio", self)

    def parLabel(self, i):
        """Latex label for a parameter index or name."""
        info = self.paramNames.parWithName(i) if isinstance(i, str) else self.paramNames.names[i]
        return info.label

    def parName(self, i, starDerived=False):
        """Name of the i'th parameter."""
        return self.paramNames.name(i, starDerived)

    def setRanges(self, ranges):
        """Set hard prior bounds from a list/array/dict/ParamBounds; a
        [min, max, True] triplet marks a periodic parameter."""
        if isinstance(ranges, np.ndarray) and ranges.ndim == 2 and ranges.shape[1] == 2:
            ranges = ranges.tolist()
        if isinstance(ranges, (list, tuple)):
            for i, window in enumerate(ranges):
                self.ranges.setRange(self.parName(i), window)
        elif isinstance(ranges, Mapping):
            for name, window in ranges.items():
                self.ranges.setRange(name, window)
        elif isinstance(ranges, ParamBounds):
            self.ranges = copy.deepcopy(ranges)
        else:
            raise ValueError("ranges must be a list/array, dict, or ParamBounds")
        self.needs_update = True

    def copy(self, label=None, settings=None) -> "MCSamples":
        """Deep copy, optionally with a new label / modified settings."""
        new = copy.deepcopy(self)
        if label:
            new.label = label
        if settings is not None:
            new.needs_update = True
            new.updateSettings(settings)
        return new



def getRootFileName(rootdir):
    """Root name of the chain files found in a directory."""
    root_file_name = ""
    for sep in ("_", "."):
        chain_files = glob.glob(os.path.join(rootdir, "*" + sep + "*.txt"))
        if chain_files:
            chain_file0 = chain_files[0]
            rindex = chain_file0.rindex(sep)
            root_file_name = chain_file0[:rindex]
            break
    return root_file_name


def _assert_api():  # keep re-exports referenced
    assert MCSamplesFromCobaya and ParamError
