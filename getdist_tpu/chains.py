"""Weighted sample containers and multi-chain management.

Getdist-compatible API (reference ``getdist/chains.py``) in two layers:

* :mod:`getdist_tpu.samplemath` — stateless array algorithms (thinning,
  confidence tables, lag estimators, Gelman-Rubin), testable in isolation;
* this module — the stateful containers: :class:`WeightedSamples` caches
  moments and a device-array mirror, :class:`Chains` adds parameter naming
  and per-chain offset views.

Heavy statistics (weighted moments as matmuls, sorts, lag kernels) run
on device via ``getdist_tpu.ops.stats`` when the backend keeps reference
accuracy; one-shot host paths otherwise.  Mutations (thin/filter/burn) are
host-side numpy, where data-dependent shapes are natural, and invalidate the
device mirror.
"""

import os
import pickle
import re
from copy import deepcopy
from warnings import warn

import numpy as np

import jax.numpy as jnp

from getdist_tpu import samplemath as smath
from getdist_tpu.ops import autoConvolve
from getdist_tpu.ops import stats as _stats
from getdist_tpu.paramnames import ParamInfo, ParamNames, escapeLatex
from getdist_tpu.samplemath import ParamConfidenceData  # noqa: F401  (public re-export)

# Whether to print chain names and burn-in details when loading from file.
print_load_details = True

# Per-call statistics (autocorrelation FFTs, adaptive-lag N_eff terms, sorts)
# run on the host by default: each is a one-shot op where a device dispatch
# (plus a jit compile) costs far more than the computation.
# GETDIST_TPU_DEVICE_OPS=1 forces the device kernels. Bulk fused pipelines
# are always device-resident.
_use_device_ops = bool(os.environ.get("GETDIST_TPU_DEVICE_OPS"))

_int_types = (int, np.integer)
_seq_types = (list, tuple)


class WeightedSampleError(Exception):
    """Error in a WeightedSamples operation."""


class ParamError(WeightedSampleError):
    """A bad parameter was requested."""


class ParSamples:
    """Attribute-bundle container for named parameter sample vectors."""


# ---------------------------------------------------------------------------


class WeightedSamples:
    """A set of weighted parameter samples.

    :ivar weights: (N,) weights per sample
    :ivar loglikes: (N,) -log(posterior) per sample, or None
    :ivar samples: (N, n) parameter values
    :ivar n: number of parameters
    :ivar numrows: number of samples
    """

    precision = "%.8e"  # text output format for saveAsText

    def __init__(
        self,
        filename=None,
        ignore_rows=0,
        samples=None,
        weights=None,
        loglikes=None,
        name_tag=None,
        label=None,
        files_are_chains=True,
        min_weight_ratio=1e-30,
    ):
        """
        :param filename: plain text chain file to load
        :param ignore_rows: int >= 1 rows, or float < 1 fraction, to skip as burn-in
        :param samples: (N, n) array (or list of vectors) of parameter values
        :param weights: (N,) weights (default all 1)
        :param loglikes: (N,) -log(posterior)
        :param name_tag: name for this sample set
        :param label: latex label
        :param files_are_chains: False if the file has no weight/loglike columns
        :param min_weight_ratio: drop samples below this ratio of the max weight
        """
        self.min_weight_ratio = min_weight_ratio
        self._device_cache = None
        if filename:
            self.name_tag = name_tag if name_tag else os.path.basename(filename)
            table = loadNumpyTxt(filename, skiprows=ignore_rows)
            if not len(table):
                raise WeightedSampleError(f"chain file {filename} contains no samples")
            self.setColData(table, are_chains=files_are_chains)
        else:
            self.name_tag = name_tag
            if samples is not None and int(ignore_rows) > 0:
                print_load_line(f"Removed {ignore_rows} lines as burn in")
            trimmed = (slice_or_none(arr, ignore_rows) for arr in (samples, weights, loglikes))
            self.setSamples(*trimmed)
        self.needs_update = True
        self.label = label

    # -- setup ---------------------------------------------------------------
    def setColData(self, coldata, are_chains=True):
        """Set samples from a file-loaded array; first two columns are
        weight and -log(like) unless are_chains=False."""
        if not are_chains:
            self.setSamples(coldata)
            return
        w, nll, values = coldata[:, 0], coldata[:, 1], coldata[:, 2:]
        self.setSamples(values, w, nll)

    @staticmethod
    def _as_sample_matrix(samples):
        """Coerce vectors / vector lists / arrays to a contiguous (N, n) f64."""
        if isinstance(samples, _seq_types):
            samples = np.column_stack(samples)
        samples = np.asarray(samples, dtype=np.float64)
        if samples.ndim < 2:
            samples = samples.reshape(-1, 1)
        return np.ascontiguousarray(samples)

    def setSamples(self, samples, weights=None, loglikes=None, min_weight_ratio=None):
        """Set samples/weights/loglikes from arrays; applies the min-weight
        filter unless min_weight_ratio is negative."""
        self.weights = None if weights is None else np.ascontiguousarray(weights, dtype=np.float64)
        self.loglikes = None if loglikes is None else np.ascontiguousarray(loglikes, dtype=np.float64)
        if samples is None:
            self.samples = None
        else:
            self.samples = self._as_sample_matrix(samples)
            self.numrows, self.n = self.samples.shape
            ratio = self.min_weight_ratio if min_weight_ratio is None else min_weight_ratio
            if ratio is not None and ratio >= 0:
                self.setMinWeightRatio(ratio)
        self._weightsChanged()

    def changeSamples(self, samples):
        """Replace samples keeping weights and loglikes."""
        kept_w, kept_l = self.weights, self.loglikes
        self.setSamples(samples, kept_w, kept_l)

    def _weightsChanged(self):
        w = self.weights
        if w is None and self.samples is not None:
            # unweighted: unit weight per row
            self.weights = np.ones(self.numrows, dtype=np.float64)
            self.norm = np.float64(len(self.weights))
        elif w is not None:
            self.norm = w.sum()
        for stale in ("means", "mean_loglike", "diffs", "fullcov", "correlationMatrix", "vars", "sddev"):
            setattr(self, stale, None)
        self.needs_update = True
        self._device_cache = None
        # fused-pipeline device residency + derived host sniffs (MCSamples)
        self._fast_chain_cache = None
        self._param_range_cache = {}

    # -- device bridge ---------------------------------------------------------
    def _device_stats_ok(self):
        """Whether the basic per-statistic calls (means/vars/cov) should run
        through jax. On the CPU backend with x64 this is free and
        bit-stable, so it is the default. The GPU requires the
        GETDIST_TPU_DEVICE_OPS opt-in: these ops are tiny next to their
        host->device transfer, and the fused pipelines do their own single
        f32 upload regardless.

        ``_force_host_stats`` pins these to numpy regardless of backend:
        the parity modes need the covariance/correlation inputs of their
        bandwidth optimizers BIT-IDENTICAL across processes — scipy's
        fsolve/TNC stopping points shift by their own ~1e-4 tolerance
        under 1-ulp input wobbles (measured round 4 on the 'skew' zoo
        shape: XLA-CPU vs numpy covariance differed by 1.8e-16 in one
        correlation entry and moved the returned bandwidth by 1.5e-4)."""
        if getattr(self, "_force_host_stats", False):
            return False
        import jax

        from getdist_tpu import backend

        if backend.platform() == "cpu":
            return jax.config.jax_enable_x64
        return _use_device_ops

    def _dev(self):
        """Device-resident (samples, weights, loglikes) arrays, cached until
        the host copies mutate. This is the host->HBM boundary."""
        if self._device_cache is None:
            self._device_cache = (
                jnp.asarray(self.samples),
                jnp.asarray(self.weights),
                None if self.loglikes is None else jnp.asarray(self.loglikes),
            )
        return self._device_cache

    # -- naming ----------------------------------------------------------------
    def getName(self):
        """The name tag of these samples."""
        return self.name_tag

    def getLabel(self):
        """The latex label for the samples."""
        return self.label if self.label else escapeLatex(self.getName())

    # -- parameter access --------------------------------------------------------
    def _makeParamvec(self, par):
        if not isinstance(par, _int_types):
            return par
        if 0 <= par < self.n:
            return self.samples[:, par]
        if par == -1:
            if self.loglikes is None:
                raise WeightedSampleError("par=-1 requested but these samples carry no logLikes")
            return self.loglikes
        if par == -2:
            return self.weights
        raise WeightedSampleError(f"no parameter with index {par}")

    def __getitem__(self, item):
        return self._makeParamvec(item)

    # -- moments -------------------------------------------------------------
    def setMeans(self):
        """Compute and cache weighted means (device matvec)."""
        if self._device_stats_ok():
            dev_samples, dev_weights, dev_loglikes = self._dev()
            self.means = np.array(_stats.weighted_mean(dev_samples, dev_weights))
            self.mean_loglike = (
                None
                if self.loglikes is None
                else float(np.asarray(_stats.weighted_mean(dev_loglikes, dev_weights)))
            )
        else:
            self.means = self.weights @ self.samples / self.norm
            self.mean_loglike = (
                None if self.loglikes is None else float(self.weights @ self.loglikes / self.norm)
            )
        return self.means

    def getMeans(self, pars=None):
        """Weighted parameter means (cached)."""
        means = self.means if self.means is not None else self.setMeans()
        return means if pars is None else np.array([means[i] for i in pars])

    def getVars(self):
        """Weighted parameter variances (cached; also sets sddev)."""
        means = self.getMeans()
        if self.fullcov is not None:
            # the full covariance (when already computed) holds the variances;
            # skip the extra O(N x p) centered pass
            self.vars = self.fullcov.diagonal().copy()
        elif self._device_stats_ok():
            dev_samples, dev_weights, _ = self._dev()
            self.vars = np.array(_stats.weighted_var(dev_samples, dev_weights, jnp.asarray(means)))
        else:
            centered = self.samples - means
            self.vars = self.weights @ (centered * centered) / self.norm
        self.sddev = np.sqrt(self.vars)
        return self.vars

    def setDiffs(self):
        """Cache the array of parameter differences from the means."""
        self.diffs = self.mean_diffs()
        return self.diffs

    def weighted_sum(self, paramVec, where=None):
        """sum_i w_i p_i (optionally over a sample filter)."""
        vec = self._makeParamvec(paramVec)
        return self.weights @ vec if where is None else vec[where] @ self.weights[where]

    def get_norm(self, where=None):
        """Sum of sample weights."""
        if where is not None:
            return self.weights[where].sum()
        if self.norm is None:
            self.norm = self.weights.sum()
        return self.norm

    def mean(self, paramVec, where=None):
        """Weighted mean of a parameter vector (or list of them)."""
        norm = self.get_norm(where)
        if isinstance(paramVec, _seq_types):
            sums = [self.weighted_sum(entry, where) for entry in paramVec]
            return np.array(sums) / norm
        return self.weighted_sum(paramVec, where) / norm

    def mean_diff(self, paramVec, where=None):
        """p - mean(p) for one parameter vector."""
        whole_column = isinstance(paramVec, _int_types) and paramVec >= 0 and where is None
        if whole_column:
            cached = self.diffs
            if cached is not None:
                return cached[paramVec]
            centered = self.samples[:, paramVec] - self.getMeans()[paramVec]
            return centered
        vec = self._makeParamvec(paramVec)
        if where is None:
            return vec - self.mean(vec)
        return vec[where] - self.mean(vec, where)

    def mean_diffs(self, pars=None, where=None):
        """List of p_i - mean(p_i) arrays."""
        if pars is None:
            pars = self.n
        if isinstance(pars, _int_types) and pars >= 0:
            if where is not None:
                pars = range(pars)
            else:
                means = self.getMeans()
                columns = (self.samples[:, i] - means[i] for i in range(pars))
                return list(columns)
        return [self.mean_diff(entry, where) for entry in pars]

    def var(self, paramVec, where=None):
        """Weighted variance of a parameter vector (or list of them)."""
        if isinstance(paramVec, _seq_types):
            return np.array([self.var(entry) for entry in paramVec])
        centered = self.mean_diff(paramVec, where)
        w = self.weights if where is None else self.weights[where]
        return (centered * centered) @ w / self.get_norm(where)

    def std(self, paramVec, where=None):
        """Weighted standard deviation."""
        variance = self.var(paramVec, where)
        return np.sqrt(variance)

    def cov(self, pars=None, where=None):
        """Weighted covariance for the given parameter vectors/indices
        (all parameters by default). All-parameter case runs as a single
        device matmul."""
        if pars is None and where is None:
            if self._device_stats_ok():
                dev_samples, dev_weights, _ = self._dev()
                # writable: callers legitimately mutate covariances (covToCorr copy=False)
                return np.array(_stats.weighted_cov(dev_samples, dev_weights))
            centered = self.samples - self.getMeans()
            return (centered * self.weights[:, None]).T @ centered / self.norm
        block = np.column_stack(self.mean_diffs(pars, where))
        w = self.weights if where is None else self.weights[where]
        return (block * w[:, None]).T @ block / self.get_norm(where)

    def corr(self, pars=None):
        """Weighted correlation matrix."""
        return covToCorr(self.cov(pars), copy=True)

    def getCov(self, nparam=None, pars=None):
        """Covariance matrix (cached full version), optionally a submatrix."""
        full = self.fullcov if self.fullcov is not None else self._setCov()
        return full[np.ix_(pars, pars)] if pars is not None else full[:nparam, :nparam]

    def _setCov(self):
        self.fullcov = self.cov()
        return self.fullcov

    def getCorrelationMatrix(self):
        """Correlation matrix of all parameters (cached)."""
        if self.correlationMatrix is None:
            self.correlationMatrix = covToCorr(self.getCov(), copy=True)
        return self.correlationMatrix

    def getSignalToNoise(self, params, noise=None, R=None, eigs_only=False):
        """Signal-to-noise eigenvalues for the given parameters."""
        return getSignalToNoise(self.cov(params), noise=noise, R=R, eigs_only=eigs_only)

    # -- correlation structure --------------------------------------------------
    def getAutocorrelation(self, paramVec, maxOff=None, weight_units=True, normalized=True):
        """Weighted autocorrelation of a parameter, in weight units by
        default (reference ``chains.py:423-447``)."""
        maxOff = maxOff if maxOff is not None else self.n - 1
        weighted = self.mean_diff(paramVec) * self.weights
        if _use_device_ops:
            curve = np.array(autoConvolve(jnp.asarray(weighted), n=maxOff + 1, normalize=True))
        else:
            curve = smath.autocorr_fft(np.asarray(weighted), maxOff + 1)
        if normalized:
            curve = curve / self.var(paramVec)
        return curve * len(weighted) / self.get_norm() if weight_units else curve

    def getCorrelationLength(self, j, weight_units=True, min_corr=0.05, corr=None):
        """Autocorrelation length (reference ``chains.py:449-466``)."""
        if corr is None:
            corr = self.getAutocorrelation(j, maxOff=self.numrows // 10, weight_units=weight_units)
        return smath.acl_from_curve(corr, min_corr)

    def getEffectiveSamples(self, j=0, min_corr=0.05):
        """N_eff = sum(w) / correlation length for parameter j."""
        acl = self.getCorrelationLength(j, min_corr=min_corr)
        return self.get_norm() / acl

    def _independent_draws(self):
        """True when the sampler produces uncorrelated draws, making the
        KDE N_eff the simple weight-based formula."""
        return getattr(self, "sampler", "") in ("nested", "uncorrelated")

    def _weight_based_neff(self):
        norm = self.get_norm()
        return norm * norm / float(self.weights @ self.weights)

    def getEffectiveSamplesGaussianKDE(self, paramVec, h=0.2, scale=None, maxoff=None, min_corr=0.05):
        """Effective sample number for the leading MISE term of a Gaussian
        KDE, accounting for sample correlation with adaptive lag sampling.

        Semantics match the reference (``chains.py:477-574``): a fiducial
        kernel of width h*sigma, pair sums over lags with a subtracted
        uncorrelated baseline, early exit below min_corr, and step-sampled
        lags for long correlation lengths; the lag drivers live in
        :func:`getdist_tpu.samplemath.kde_pair_sum_adaptive`.
        """
        if self._independent_draws():
            return self._weight_based_neff()
        d = self._makeParamvec(paramVec)
        if not scale:
            scale = self.std(d)
        kernel_std = h * scale
        if maxoff is None:
            maxoff = 4 + int(1.5 * self.getCorrelationLength(d, weight_units=False))
        maxoff = min(maxoff, self.numrows // 10)

        if _use_device_ops:
            dev_d, dev_w = jnp.asarray(d), jnp.asarray(self.weights)

            def pair_term(k):
                return float(_stats.kde_lag_correlation(dev_d, dev_w, k, kernel_std))

        else:
            host_d, host_w = np.asarray(d, float), np.asarray(self.weights, float)

            def pair_term(k):
                return smath.kde_lag_term_1d(host_d, host_w, k, kernel_std)

        N = smath.kde_pair_sum_adaptive(pair_term, self.weights, self.numrows, maxoff, min_corr)
        norm = self.get_norm()
        return norm * norm / N

    def getEffectiveSamplesGaussianKDE_2d(self, i, j, h=0.3, maxoff=None, min_corr=0.05):
        """2D variant of the KDE effective-sample estimate (reference
        ``chains.py:576-635``)."""
        if self._independent_draws():
            return self._weight_based_neff()
        d1, d2 = self._makeParamvec(i), self._makeParamvec(j)
        pair_cov = self.cov([d1, d2])
        if abs(pair_cov[0, 1]) > 0.999 * np.sqrt(pair_cov[0, 0] * pair_cov[1, 1]):
            # fully degenerate pair: the 1D estimate is the right answer
            return self.getEffectiveSamplesGaussianKDE(i, h=h, min_corr=min_corr)
        kernel_inv = np.linalg.inv(pair_cov) / h**2
        if maxoff is None:
            acl = max(self.getCorrelationLength(d, weight_units=False) for d in (d1, d2))
            maxoff = int(acl * 1.5) + 4
        maxoff = min(maxoff, self.numrows // 10)

        if _use_device_ops:
            dev1, dev2, dev_w = jnp.asarray(d1), jnp.asarray(d2), jnp.asarray(self.weights)
            dev_kinv = jnp.asarray(kernel_inv)

            def pair_term(k):
                return float(_stats.kde_lag_correlation_2d(dev1, dev2, dev_w, k, dev_kinv))

        else:
            h1, h2, hw = np.asarray(d1, float), np.asarray(d2, float), np.asarray(self.weights, float)

            def pair_term(k):
                return smath.kde_lag_term_2d(h1, h2, hw, k, kernel_inv)

        N = smath.kde_pair_sum_scan(pair_term, self.weights, self.numrows, maxoff, min_corr)
        return self.get_norm() ** 2 / N

    # -- confidence limits ------------------------------------------------------
    def thin_indices(self, factor, weights=None):
        """Indices making unit-weight samples, assuming integer weights."""
        return self.thin_indices_single_samples(factor, self.weights if weights is None else weights)

    @staticmethod
    def thin_indices_and_weights(factor, weights):
        """(unique indices, new counts) for weight-preserving thinning."""
        ix = WeightedSamples.thin_indices_single_samples(factor, weights)
        return np.unique(ix, return_counts=True)

    @staticmethod
    def thin_indices_single_samples(factor, weights):
        """Exact integer-weight partition thinning (see
        :func:`getdist_tpu.samplemath.thin_exact`)."""
        try:
            return smath.thin_exact(factor, weights)
        except ValueError as e:
            raise WeightedSampleError(str(e)) from None

    def random_single_samples_indices(self, random_state=None, thin=None, max_samples=None):
        """Random unit-weight sample indices drawn proportionally to weight."""
        if max_samples is None:
            thin = thin or 1
        elif thin is not None:
            raise WeightedSampleError("thin and max_samples cannot both be given")
        else:
            w_max = np.max(self.weights)
            thin = max(1, self.norm / w_max / max_samples)
        rng = np.random.default_rng(random_state)
        keep_prob = self.weights / (np.max(self.weights) * thin)
        return np.nonzero(rng.random(self.numrows) <= keep_prob)[0]

    def thin(self, factor):
        """Thin to unit-weight samples by the given integer factor."""
        ix = self.thin_indices(factor)
        self.setSamples(
            self.samples[ix, :],
            loglikes=None if self.loglikes is None else self.loglikes[ix],
            min_weight_ratio=-1,
        )

    def weighted_thin(self, factor):
        """Thin preserving (integer) weights."""
        ix, counts = self.thin_indices_and_weights(factor, self.weights)
        self.setSamples(
            self.samples[ix, :],
            loglikes=None if self.loglikes is None else self.loglikes[ix],
            weights=counts,
            min_weight_ratio=-1,
        )

    def filter(self, where):
        """Keep only samples matching the index list / boolean filter."""
        kept_loglikes = self.loglikes[where] if self.loglikes is not None else None
        self.setSamples(self.samples[where, :], self.weights[where], kept_loglikes, min_weight_ratio=-1)

    def reweightAddingLogLikes(self, logLikes):
        """Importance-reweight by adding -log(likelihood) values."""
        offset = np.min(logLikes)
        if self.loglikes is not None:
            self.loglikes = self.loglikes + logLikes
        self.weights = np.asarray(self.weights, dtype=np.float64) * np.exp(offset - logLikes)
        self._weightsChanged()

    def cool(self, cool):
        """Multiply -log(likes) by ``cool`` and reweight accordingly."""
        if self.loglikes is None:
            raise WeightedSampleError("cool() needs likelihood values, which these samples lack")
        best = np.min(self.loglikes)
        cooled = self.loglikes * cool
        self.weights = np.asarray(self.weights, dtype=np.float64) * np.exp(
            (self.loglikes - cooled) - best * (1 - cool)
        )
        self.loglikes = cooled
        self._weightsChanged()

    def deleteZeros(self):
        """Remove zero-weight samples."""
        self.filter(self.weights > 0)

    def setMinWeightRatio(self, min_weight_ratio=1e-30):
        """Remove samples below min_weight_ratio of the maximum weight."""
        if self.weights is None or min_weight_ratio < 0:
            return
        cutoff = np.max(self.weights) * min_weight_ratio
        if np.min(self.weights) < cutoff:
            self.filter(self.weights > cutoff)

    def deleteFixedParams(self):
        """Remove parameters that never vary; returns (indices, values)."""
        fixed, values = [], []
        for col in range(self.samples.shape[1]):
            vec = self.samples[:, col]
            # cheap first/last probe before the full-column scan
            if np.isclose(vec[0], vec[-1], equal_nan=True):
                center = np.average(vec)
                if np.allclose(vec, center, rtol=1e-12, atol=0, equal_nan=True):
                    fixed.append(col)
                    values.append(center)
        if fixed:
            # rebuilding the sample matrix copies O(N x p): skip when nothing varies
            kept = np.delete(self.samples, fixed, axis=1)
            self.changeSamples(kept)
        return fixed, values

    def removeBurn(self, remove=0.3):
        """Remove burn-in: a fraction (< 1) or number (>= 1) of initial rows."""
        cut = int(remove) if remove >= 1 else int(round(self.numrows * remove))
        if self.weights is not None:
            self.weights = self.weights[cut:]
        if self.loglikes is not None:
            self.loglikes = self.loglikes[cut:]
        self.changeSamples(self.samples[cut:, :])

    def twoTailLimits(self, paramVec, confidence):
        """Two-tail equal-area confidence limits by sample counting."""
        tail = (1 - confidence) / 2
        return self.confidence(paramVec, np.array([tail, 1 - tail]))

    def initParamConfidenceData(self, paramVec, start=0, end=None, weights=None):
        """Cache sorted values/cumulative weights for repeated confidence
        queries on one parameter."""
        w = self.weights if weights is None else weights
        values = self._makeParamvec(paramVec)[start:end]
        argsort = (lambda v: np.asarray(jnp.argsort(jnp.asarray(v)))) if _use_device_ops else np.argsort
        return smath.sorted_weight_table(values, w[start : start + len(values)], argsort=argsort)

    def confidence(self, paramVec, limfrac, upper=False, start=0, end=None, weights=None):
        """Tail-count confidence limit(s): the parameter value where limfrac
        of the total weight is further in the tail."""
        if isinstance(paramVec, ParamConfidenceData):
            table = paramVec
        else:
            table = self.initParamConfidenceData(paramVec, start, end, weights)
        return smath.tail_value(table, limfrac, upper)

    # -- output -------------------------------------------------------------
    def saveAsText(self, root, chain_index=None, make_dirs=False):
        """Save as a getdist-format text chain file."""
        parent = os.path.dirname(root)
        if make_dirs and not os.path.exists(parent):
            os.makedirs(parent)
        if root.endswith(".txt"):
            root = root[: -len(".txt")]
        suffix = "" if chain_index is None else f"_{chain_index + 1}"
        loglikes = self.loglikes if self.loglikes is not None else np.zeros(self.numrows)
        columns = np.column_stack([self.weights, loglikes, self.samples])
        np.savetxt(root + suffix + ".txt", columns, fmt=self.precision)


# ---------------------------------------------------------------------------


class Chains(WeightedSamples):
    """One or more chains of weighted samples with named parameters.

    Adds a name->index map, getParams() attribute bundles, per-chain views
    via chain_offsets (no copying), and Gelman-Rubin diagnostics.
    """

    paramNames = None
    jobItem = None

    def __init__(
        self,
        root=None,
        jobItem=None,
        paramNamesFile=None,
        names=None,
        labels=None,
        renames=None,
        sampler=None,
        **kwargs,
    ):
        """
        :param root: optional file root
        :param jobItem: optional grid jobItem with chainRoot/batchPath
        :param paramNamesFile: .paramnames file for names
        :param names: list of name strings
        :param labels: list of latex labels
        :param renames: dict of parameter aliases
        :param sampler: 'mcmc' (default), 'nested' or 'uncorrelated'
        :param kwargs: passed to :class:`WeightedSamples`
        """
        self.jobItem = jobItem
        self.root = root
        self.chains = None
        self.chain_offsets = None
        super().__init__(**kwargs)
        self.ignore_lines = float(kwargs.get("ignore_rows") or 0)
        name_source = paramNamesFile or self._sidecar_names(root) or names
        self.setParamNames(name_source)
        if labels is not None:
            self.paramNames.setLabels(labels)
        if renames is not None:
            self.updateRenames(renames)
        self.sampler = "mcmc"
        if isinstance(sampler, str):
            self.setSampler(sampler)

    @staticmethod
    def _sidecar_names(root):
        """A names source next to the chain files: .paramnames text or a
        Cobaya yaml."""
        if not root:
            return None
        candidate = root + ".paramnames"
        if os.path.exists(candidate):
            return candidate
        from getdist_tpu import cobaya_interface

        return cobaya_interface.cobaya_params_file(root)

    def setSampler(self, sampler):
        """Set the sampler type ('mcmc', 'nested' or 'uncorrelated')."""
        sampler = sampler.lower()
        if sampler not in ("mcmc", "nested", "uncorrelated"):
            warn(f"Sampler type '{sampler}' not recognised; treating as MCMC.")
            sampler = "mcmc"
        self.sampler = sampler

    def setParamNames(self, names=None):
        """Set parameter names from a ParamNames, filename, or name list."""
        match names:
            case ParamNames():
                self.paramNames = deepcopy(names)
            case str():
                self.paramNames = ParamNames(names)
            case None:
                self.paramNames = ParamNames(default=self.n) if self.samples is not None else None
            case _:
                self.paramNames = ParamNames(names=names)
        if self.paramNames:
            self._getParamIndices()
        self.needs_update = True

    def getParamNames(self):
        """The :class:`~.paramnames.ParamNames` for these samples."""
        return self.paramNames

    def _getParamIndices(self):
        declared = len(self.paramNames.names)
        if self.samples is not None and declared != self.n:
            raise WeightedSampleError(
                f"{declared} names declared but the sample array has {self.n} parameters"
            )
        self.index = {info.name: i for i, info in enumerate(self.paramNames.names)}
        return self.index

    def _parAndNumber(self, name):
        """(index, ParamInfo) for a name, index, or ParamInfo."""
        if isinstance(name, ParamInfo):
            name = name.name
        if isinstance(name, str):
            slot = self.index.get(name)
            if slot is None:
                return None, None
            name = slot
        if isinstance(name, _int_types):
            info = self.paramNames.names[name]
            return name, info
        raise ParamError(f"Unknown parameter type {name}")

    def getRenames(self):
        """Dict of renames known to each parameter."""
        return self.paramNames.getRenames()

    def updateRenames(self, renames):
        """Merge a rename dict into the parameter aliases."""
        self.paramNames.updateRenames(renames)

    # -- named vectors --------------------------------------------------------
    def setParams(self, obj):
        """Attach obj.<name> sample vectors for every parameter; dotted
        names create sub-objects (obj.aa.bb.cc)."""
        # two passes: first grow every intermediate node, then bind values —
        # a leaf that is also a prefix of another name gets its vector on
        # node.value instead of clobbering the sub-object
        paths = [info.name.split(".") for info in self.paramNames.names]
        for path in paths:
            node = obj
            for part in path[:-1]:
                if not hasattr(node, part):
                    setattr(node, part, ParSamples())
                node = getattr(node, part)
        for column, path in enumerate(paths):
            node = obj
            for part in path[:-1]:
                node = getattr(node, part)
            leaf = getattr(node, path[-1], None)
            if isinstance(leaf, ParSamples):
                leaf.value = self.samples[:, column]
            else:
                setattr(node, path[-1], self.samples[:, column])
        return obj

    def getParams(self):
        """A ParSamples bundle with a vector attribute per parameter."""
        return self.setParams(ParSamples())

    def getParamSampleDict(self, ix, want_derived=True):
        """Dict of parameter values for one sample row."""
        row = {
            "weight": self.weights[ix],
            "loglike": None if self.loglikes is None else self.loglikes[ix],
        }
        for i, info in enumerate(self.paramNames.names):
            if want_derived or not info.isDerived:
                row[info.name] = self.samples[ix, i]
        return row

    def _makeParamvec(self, par):
        if self.needs_update:
            self.updateBaseStatistics()
        if isinstance(par, ParamInfo):
            par = par.name
        if not isinstance(par, str):
            resolved = super()._makeParamvec(par)
            return resolved
        column = self.index.get(par)
        if column is not None:
            return self.samples[:, column]
        special = {"weight": self.weights, "loglike": self.loglikes}
        if par in special:
            return special[par]
        raise ParamError(f"no parameter named {par}")

    def updateBaseStatistics(self):
        """Recompute means/vars and multiplicity stats after changes."""
        self.needs_update = False
        self.setMeans()
        self.getVars()
        self._getParamIndices()
        self.max_mult, self.mean_mult = self.weights.max(), self.norm / self.numrows
        return self

    def updateChainBaseStatistics(self):
        # legacy name
        return self.updateBaseStatistics()

    def addDerived(self, paramVec, name, **kwargs):
        """Append a derived parameter vector with the given name."""
        if self.paramNames.parWithName(name):
            raise ValueError(f"Parameter with name {name} already exists")
        widened = np.c_[self.samples, paramVec]
        self.changeSamples(widened)
        return self.paramNames.addDerived(name, **kwargs)

    # -- multi-chain management ----------------------------------------------
    @staticmethod
    def _nesting_depth(obj):
        """How many times obj can be indexed at [0] (1 = vector, 2 = array,
        3 = list of arrays)."""
        depth = 0
        while True:
            try:
                obj = obj[0]
                depth += 1
            except (TypeError, IndexError):
                return depth

    def loadChains(self, root, files_or_samples, weights=None, loglikes=None, ignore_lines=None):
        """Load chains from a list of files, a single array, or a list of
        arrays; returns True if anything was loaded."""
        self.chains = []
        self.samples = self.weights = self.loglikes = None
        if ignore_lines is None:
            ignore_lines = self.ignore_lines
        if files_or_samples is None or (hasattr(files_or_samples, "__len__") and not len(files_or_samples)):
            raise ValueError("loadChains got nothing to load")
        from_files = isinstance(files_or_samples, str) or isinstance(files_or_samples[0], str)
        if from_files:
            if weights is not None or loglikes is not None:
                raise ValueError("weights/loglikes arguments only apply to in-memory arrays")
            count = self._chains_from_files(root, files_or_samples, ignore_lines)
        else:
            count = self._chains_from_arrays(files_or_samples, weights, loglikes, ignore_lines)
        self._weightsChanged()
        return count > 0

    def _chains_from_files(self, root, files, ignore_lines):
        if isinstance(files, str):
            files = [files]
        if not self.name_tag:
            self.name_tag = os.path.basename(root)
        for fname in files:
            print_load_line(fname)
            try:
                self.chains.append(
                    WeightedSamples(fname, ignore_rows=ignore_lines, min_weight_ratio=self.min_weight_ratio)
                )
            except WeightedSampleError:
                print_load_line(f"Ignored file {fname} (likely empty)")
        if not self.chains:
            raise WeightedSampleError(f"no chains found for root {root}")
        return len(self.chains)

    def _chains_from_arrays(self, arrays, weights, loglikes, ignore_lines):
        depth = self._nesting_depth(arrays)
        if depth in (1, 2):
            self.chains = None
            trimmed = (slice_or_none(block, ignore_lines) for block in (arrays, weights, loglikes))
            self.setSamples(*trimmed, self.min_weight_ratio)
            if self.paramNames is None:
                self.paramNames = ParamNames(default=self.n)
            return 1
        if depth != 3:
            raise ValueError("expected a sample array, or a list of sample arrays or file names")
        for i, block in enumerate(arrays):
            w_i = weights[i] if weights is not None else None
            ll_i = loglikes[i] if loglikes is not None else None
            self.chains.append(
                WeightedSamples(
                    samples=block,
                    loglikes=ll_i,
                    weights=w_i,
                    ignore_rows=ignore_lines,
                    min_weight_ratio=self.min_weight_ratio,
                )
            )
        if self.paramNames is None:
            first_n = self.chains[0].n
            self.paramNames = ParamNames(default=first_n)
        return len(self.chains)

    def makeSingle(self):
        """Concatenate separate chains into one array, recording offsets."""
        if not self.chains:
            raise ValueError("makeSingle() needs separated chains, and there are none")
        lengths = [chain.samples.shape[0] for chain in self.chains]
        self.chain_offsets = np.cumsum(np.array([0] + lengths))
        first = self.chains[0]
        self.setSamples(
            np.vstack([c.samples for c in self.chains]),
            None if first.weights is None else np.hstack([c.weights for c in self.chains]),
            None if first.loglikes is None else np.hstack([c.loglikes for c in self.chains]),
            min_weight_ratio=-1,
        )
        self.chains = None
        self.needs_update = True
        return self

    def getSeparateChains(self):
        """Per-chain WeightedSamples views (no copies when combined)."""
        if self.chains is not None:
            return self.chains
        if self.chain_offsets is None:
            raise WeightedSampleError("these samples were never combined from separate chains")
        return [
            WeightedSamples(
                samples=self.samples[lo:hi],
                weights=self.weights[lo:hi],
                loglikes=None if self.loglikes is None else self.loglikes[lo:hi],
            )
            for lo, hi in zip(self.chain_offsets[:-1], self.chain_offsets[1:])
        ]

    def filter(self, where):
        """Filter samples, fixing up chain offsets so chains stay splittable."""
        if self.chains is not None:
            raise ValueError("chains are still separated: makeSingle first, or filter each chain")
        if self.chain_offsets is not None:
            kept = [
                np.count_nonzero(where[lo:hi])
                for lo, hi in zip(self.chain_offsets[:-1], self.chain_offsets[1:])
            ]
            self.chain_offsets = np.cumsum(np.array([0] + kept))
        super().filter(where)

    def weighted_thin(self, factor):
        """Weight-preserving thin, applied per chain when chains exist."""
        if not self.chains and self.chain_offsets is None:
            return super().weighted_thin(factor)
        was_split = self.chains
        parts = self.getSeparateChains()
        for part in parts:
            part.weighted_thin(factor)
        self.chains = parts
        if not was_split:
            self.makeSingle()
        self.needs_update = True

    def removeBurnFraction(self, ignore_frac):
        """Remove burn-in fraction from combined samples or each chain."""
        if self.samples is None:
            for chain in self.chains:
                chain.removeBurn(ignore_frac)
            return
        self.removeBurn(ignore_frac)
        self.chains = None
        self.needs_update = True

    def deleteFixedParams(self):
        """Delete non-varying parameters, updating names and any ranges."""
        if self.samples is None:
            # separated chains: detect on the first, drop from the rest
            lead, *rest = self.chains
            fixed, values = lead.deleteFixedParams()
            for chain in rest:
                chain.changeSamples(np.delete(chain.samples, fixed, axis=1))
        else:
            fixed, values = super().deleteFixedParams()
            self.chains = None
        bounds = getattr(self, "ranges", None)
        if bounds is not None:
            for ix, value in zip(fixed, values):
                bounds.setFixed(self.paramNames.names[ix].name, value)
        self.paramNames.deleteIndices(fixed)
        self._getParamIndices()

    # -- convergence ------------------------------------------------------------
    def getGelmanRubinEigenvalues(self, nparam=None, chainlist=None):
        """var(mean)/mean(var) eigenvalues over orthogonalized parameters
        (Brooks & Gelman)."""
        chainlist = chainlist if chainlist is not None else self.getSeparateChains()
        nparam = nparam if nparam else self.paramNames.numNonDerived()
        # Per-chain moments are device reductions; the (p, p) eigen-solve is
        # tiny and runs on host with numpy for bit-stable diagnostics text.
        return smath.gelman_rubin_eigs(
            self.getMeans()[:nparam],
            [chain.getMeans()[:nparam] for chain in chainlist],
            [chain.getCov(nparam) for chain in chainlist],
        )

    def getGelmanRubin(self, nparam=None, chainlist=None):
        """Worst-eigenvalue R-1 statistic (should be << 1 when converged)."""
        eigs = self.getGelmanRubinEigenvalues(nparam, chainlist)
        return np.max(eigs)

    # -- output -----------------------------------------------------------------
    def saveAsText(self, root, chain_index=None, make_dirs=False):
        """Save samples and .paramnames metadata as text."""
        super().saveAsText(root, chain_index, make_dirs)
        if not chain_index:
            self.saveTextMetadata(root)

    def saveTextMetadata(self, root):
        """Save metadata (.paramnames) alongside chain text files."""
        self.paramNames.saveAsText(root + ".paramnames")

    def __getstate__(self):
        """Pickle without the device-resident caches (they rebuild lazily
        and a cached f32 chain copy would double the pickle size)."""
        state = self.__dict__.copy()
        state["_device_cache"] = None
        state["_fast_chain_cache"] = None
        return state

    def savePickle(self, filename):
        """Pickle this object to a file."""
        with open(filename, "wb") as stream:
            pickle.dump(self, stream, protocol=pickle.HIGHEST_PROTOCOL)


# -- module-level chain-file and matrix helpers ------------------------------


def print_load_line(message):
    if print_load_details:
        print(message)


def last_modified(files):
    """Latest modification time among the files that exist."""
    stamps = (os.path.getmtime(fname) for fname in files if os.path.exists(fname))
    return max(stamps)


def slice_or_none(x, start=None, end=None):
    # Tolerate integer-valued float row counts (the reference crashes on
    # x[0.0:] for in-memory multi-chain loads; we coerce instead).
    if isinstance(start, float) and start == int(start):
        start = int(start)
    if isinstance(end, float) and end == int(end):
        end = int(end)
    if not hasattr(x, "__getitem__"):
        return None
    return x[start:end]


def chainFiles(root, chain_indices=None, ext=".txt", separator="_", first_chain=0, last_chain=-1, chain_exclude=None):
    """List chain sample files for a root name, applying index filters."""
    return smath.match_chain_files(root, chain_indices, ext, separator, first_chain, last_chain, chain_exclude)


def hasChainFiles(file_root, ext=".txt"):
    found = (chainFiles(file_root, ext=ext, separator=sep, last_chain=1) for sep in "_.")
    return any(found)


def findChainFileRoot(chain_dir, root, search_subdirectories=True):
    """Find a chain root under a directory tree; returns full path root or None."""
    root = re.sub(r"[/\\]", re.escape(os.sep), root)
    direct = os.path.join(chain_dir, root)
    if hasChainFiles(direct):
        return direct
    if search_subdirectories:
        for base, dirs, _files in os.walk(chain_dir):
            for subdir in dirs:
                candidate = os.path.join(base, subdir, root)
                if hasChainFiles(candidate):
                    return candidate
    return None


def loadNumpyTxt(fname, skiprows=None):
    """Load a numpy array from a whitespace-separated text file.

    Uses the native multi-threaded parser (getdist_tpu._native) when
    available, falling back to np.loadtxt (reference ``chains.py:115``)."""
    try:
        from getdist_tpu import _native

        data = _native.load_chain_text(fname, skiprows or 0)
        if data is not None:
            return np.atleast_2d(data)
    except Exception:
        pass
    try:
        table = np.loadtxt(fname, skiprows=skiprows or 0)
    except ValueError:
        print(f"Error reading {fname}")
        raise
    return np.atleast_2d(table)


def covToCorr(cov, copy=True):
    """Covariance matrix -> correlation matrix (zero-variance rows kept)."""
    return smath.corr_from_cov(cov, copy=copy)


def getSignalToNoise(C, noise=None, R=None, eigs_only=False):
    """Signal-to-noise eigen-analysis: eigenvalues (and rotation) of
    R C R^T with R the inverse Cholesky root of the noise matrix."""
    try:
        return smath.sn_eigendecomp(C, noise, R, eigs_only)
    except ValueError as e:
        raise WeightedSampleError(str(e)) from None
