"""The reference KDE test-distribution zoo and MISE sweep harness.

Re-creates every shape of the reference's distribution battery
(``/root/reference/getdist/tests/test_distributions.py:129-258``) — the
shape parameters ARE the spec being matched — plus mean-integrated-square-
error sweeps over bandwidth scalings with bandwidth-failure counting
(``:87-126``), runnable over both the host parity path and the fused
device path so the fused approximations (histogram shearing, fixed lag
grid, histogram quantiles) are stressed on the hard shapes (hammer,
rotating, tight r=0.99, quadrimodal).
"""

import numpy as np

from getdist_tpu.gaussian_mixtures import Gaussian1D, Gaussian2D, Mixture1D, Mixture2D, make_2D_Cov

DEFAULT_NSAMP = 10000


def shapes_1d():
    """All reference 1D shapes, keyed by label."""
    r2 = np.sqrt
    battery = [
        Gaussian1D(0, 0.5, label="Gaussian"),
        Mixture1D([0, 1], [1, 0.4], [0.6, 0.4], label="skew"),
        Mixture1D([0, 0], [1, 3], [0.8, 0.2], label="tailed"),
        Mixture1D([0, 0.3], [1, 2], [0.6, 0.4], label="broad"),
        Gaussian1D(0, 3, xmin=-1, xmax=2, label="flat"),
        Mixture1D([0, 1.5, 3], [1, 1, 1], [0.4, 0.2, 0.4], label="flat top"),
        Mixture1D([0, 2], [0.5, 0.5], [0.6, 0.4], label="bimodal 1"),
        Mixture1D([0, 2], [0.2, 0.5], [0.5, 0.5], label="bimodal 2"),
        Mixture1D([0, 2, 5], [0.2, 0.7, 0.4], label="trimodal"),
    ]
    battery += [Gaussian1D(0, 1, xmin=cut, label=f"Gaussian [x>{cut}]") for cut in (-1.5, -1, -0.5, 0, 1, 1.5)]
    assert r2  # quiet linter; kept for parity with shapes_2d
    return {shape.label: shape for shape in battery}


def shapes_2d(include_cut_gaussians=False):
    """All reference 2D shapes, keyed by label (Wand & Jones 93 multimodal
    examples included)."""
    skew_cov = make_2D_Cov(np.sqrt(0.5), 1, 0.1)
    battery = [
        Gaussian2D([0, 0], (0.7, 1, 0.3), label="Gaussian"),
        Mixture2D(
            [[0, 0], [2, 1.8]], [(np.sqrt(0.5), 1, 0.9), (1, 1, 0.8)], [0.6, 0.4], xmin=-1, label="bending"
        ),
        Mixture2D([[0, 0], [1, 1.8]], [(np.sqrt(0.5), 1, 0.9), (0.3, 1, -0.7)], [0.5, 0.5], label="hammer"),
        Mixture2D([[0, 0], [0, 1.2]], [skew_cov, skew_cov / 4], [0.5, 0.5], label="skew"),
        Mixture2D([[0, 0], [0, 0.2]], [skew_cov, skew_cov * 8], [0.9, 0.1], label="broad tail"),
        Mixture2D([[0, 0], [0, 0.2]], [(1, 1, 0.5), (2, 2, -0.5)], [0.6, 0.4], label="rotating"),
        Mixture2D([[0, 0], [2.5, 3.5]], [(1, 1, 0.99), (1, 1.5, 0.98)], [0.6, 0.4], label="tight"),
        Gaussian2D([0, 0], (0.7, 1, 0.95), ymin=0.3, xmax=1.2, label="cut correlated"),
        Gaussian2D([0, 0], (1, 2, 0), ymin=-1, ymax=2.1, xmin=-1, xmax=0.2, label="flat"),
        # Wand & Jones 93 multimodal examples
        Mixture2D([[-1, 0], [1, 0]], [(2 / 3, 2 / 3, 0)] * 2, label="bimodal WJ1"),
        Mixture2D([[-1.5, 0], [1.5, 0]], [(0.25, 1, 0)] * 2, label="bimodal WJ2"),
        Mixture2D([[-1, 1], [1, -1]], [(2 / 3, 2 / 3, 0.6)] * 2, label="bimodal WJ3"),
        Mixture2D([[1, -1], [-1, 1]], [(2 / 3, 2 / 3, 0.7), (2 / 3, 2 / 3, 0)], label="bimodal WJ4"),
        Mixture2D(
            [[-1.2, 1.2], [1.2, -1.2], [0, 0]],
            [(0.6, 0.6, 0.3), (0.6, 0.6, -0.6), (0.25, 0.25, 0.2)],
            weights=[9, 9, 2],
            label="trimodal WJ1",
        ),
        Mixture2D(
            [[-1.2, 0], [1.2, 0], [0, 0]],
            [(0.6, 0.6, 0.7), (0.6, 0.6, 0.7), (0.25, 0.25, -0.7)],
            label="trimodal WJ2",
        ),
        Mixture2D(
            [[-1, 0], [1, 2 * np.sqrt(3) / 3], [1, -2 * np.sqrt(3) / 3]],
            [(0.6, 0.7, 0.6), (0.6, 0.7, 0), (0.4, 0.7, 0)],
            weights=[3, 3, 1],
            label="trimodal WJ3",
        ),
        Mixture2D(
            [[-1, 1], [-1, -1], [1, -1], [1, 1]],
            [(2 / 3, 2 / 3, 0.4), (2 / 3, 2 / 3, 0.6), (2 / 3, 2 / 3, -0.7), (2 / 3, 2 / 3, -0.5)],
            weights=[1, 3, 1, 3],
            label="quadrimodal",
        ),
    ]
    if include_cut_gaussians:
        battery += [
            Gaussian2D([0, 0], (0.7, 1, 0.3), xmin=cut, label=f"Gaussian [x>{cut}]")
            for cut in (-2, -1, -0.5, 0, 1, 1.5, 2)
        ]
    return {shape.label: shape for shape in battery}


def mise_sweep_2d(prob, nsamp=DEFAULT_NSAMP, nsim=20, scales=np.arange(0.6, 1.5, 0.1), settings=None, fused=False):
    """2D MISE vs bandwidth scaling, over the parity path (``get2DDensity``)
    or the fused device path (``fastDensities`` with scaled bandwidths).

    Returns (scales, mise array). Matches the reference harness
    ``test_distributions.py:86-101``.
    """
    mise = np.zeros(np.size(scales))
    for sim in range(nsim):
        samps = prob.MCSamples(nsamp, settings=settings, random_state=sim)
        truth, truth_shape = None, None
        for i, scale in enumerate(scales):
            if fused:
                density = _fused_2d_density(samps, scale)
            else:
                density = samps.get2DDensity("x", "y", smooth_scale_2D=-scale)
            density.normalize()
            if truth is None or density.P.shape != truth_shape:
                # grid size can change with scale (corr-adaptive regrid /
                # wide-kernel rescue), so the truth grid tracks the density
                xg, yg = np.meshgrid(density.x, density.y)
                truth = prob.pdf(xg, yg)
                truth /= density.integrate(truth)
                truth_shape = truth.shape
            mise[i] += np.sum((truth - density.P) ** 2) / np.sum(truth**2)
    return scales, mise / (nsim - 1)


def mise_sweep_1d(prob, nsamp=DEFAULT_NSAMP, nsim=50, scales=np.arange(0.6, 1.5, 0.1), settings=None, fused=False):
    """1D MISE vs bandwidth scaling with bandwidth-failure counting
    (reference ``test_distributions.py:103-126``). Returns
    (scales, mise array, n_failures)."""
    from getdist_tpu.mcsamples import BandwidthError

    mise = np.zeros(np.size(scales))
    failures = 0
    for sim in range(nsim):
        samps = prob.MCSamples(nsamp, settings=settings, random_state=sim)
        samps.raise_on_bandwidth_errors = False
        try:
            truth = None
            for i, scale in enumerate(scales):
                if fused:
                    density = _fused_1d_density(samps, scale)
                else:
                    density = samps.get1DDensity("x", smooth_scale_1D=-scale)
                density.normalize()
                if truth is None:
                    truth = prob.pdf(density.x)
                    if prob.lims is not None:
                        truth /= density.integrate(truth)
                mise[i] += np.sum((truth - density.P) ** 2) / np.sum(truth**2)
        except BandwidthError:
            failures += 1
    return scales, mise / max(1, nsim - failures - 1), failures


def _fused_2d_density(samps, scale):
    """Fused-path 2D density at a scaled auto bandwidth; the fused program
    exposes the density post-normalization, so scale via its own setting."""
    samps.updateSettings({"smooth_scale_2D": -float(scale)})
    samps._fused_cache = None
    _, dens2 = samps.fastDensities()
    density = dens2[(samps.parName(0), samps.parName(1))]
    return density


def _fused_1d_density(samps, scale):
    samps.updateSettings({"smooth_scale_1D": -float(scale)})
    samps._fused_cache = None
    d1, _ = samps.fastDensities()
    return d1[samps.parName(0)]
