"""Fisher-matrix forecasting helpers.

Small host-side toolkit for the Fisher-forecast workflow that getdist-style
analyses pair with sampled chains: build Gaussian forecast posteriors from
Fisher (inverse-covariance) matrices, marginalize/condition them, combine
independent experiments, and extract the confidence-ellipse geometry used
for forecast plots. Complements :class:`~getdist_tpu.gaussian_mixtures.GaussianND`
(which accepts ``is_inv_cov=True`` Fisher input, as the reference's
``gaussian_mixtures.py:439-457`` does) with the matrix algebra around it.

All functions are plain numpy over (p, p) arrays: Fisher matrices are tiny,
so device dispatch would be pure overhead.
"""

import numpy as np

__all__ = [
    "fisher_to_cov",
    "marginalize_fisher",
    "condition_fisher",
    "combine_fishers",
    "fisher_sigma",
    "figure_of_merit",
    "confidence_ellipse",
    "gaussian_from_fisher",
]


def _as_matrix(fisher):
    m = np.atleast_2d(np.asarray(fisher, float))
    if m.shape[0] != m.shape[1]:
        raise ValueError("Fisher matrix must be square, got %r" % (m.shape,))
    return m


def fisher_to_cov(fisher):
    """Parameter covariance implied by a Fisher matrix (its inverse)."""
    return np.linalg.inv(_as_matrix(fisher))


def marginalize_fisher(fisher, keep):
    """Fisher matrix for a parameter subset with the REST marginalized over:
    invert, slice the covariance, re-invert (the Schur complement of the
    dropped block). ``keep``: index list into the parameter order."""
    cov = fisher_to_cov(fisher)
    keep = np.asarray(keep, int)
    return np.linalg.inv(cov[np.ix_(keep, keep)])

def condition_fisher(fisher, keep):
    """Fisher matrix for a subset with the REST held FIXED: plain slicing
    (conditioning tightens constraints; marginalizing loosens them)."""
    keep = np.asarray(keep, int)
    return _as_matrix(fisher)[np.ix_(keep, keep)]


def combine_fishers(*fishers):
    """Combined forecast from independent experiments: Fisher matrices add."""
    if not fishers:
        raise ValueError("need at least one Fisher matrix")
    total = _as_matrix(fishers[0]).copy()
    for f in fishers[1:]:
        total += _as_matrix(f)
    return total


def fisher_sigma(fisher, marginalized=True):
    """Per-parameter forecast standard deviations. ``marginalized=True``
    (default) marginalizes over the other parameters (sqrt of the inverse's
    diagonal); otherwise conditions on them (1/sqrt of the diagonal)."""
    m = _as_matrix(fisher)
    if marginalized:
        return np.sqrt(np.diagonal(fisher_to_cov(m)))
    return 1.0 / np.sqrt(np.diagonal(m))


def figure_of_merit(fisher, i=0, j=1):
    """DETF-style figure of merit for a parameter pair: 1/sqrt(det C_ij)
    with C_ij the marginalized 2x2 covariance (proportional to the inverse
    area of the 68% ellipse)."""
    cov = fisher_to_cov(fisher)
    sub = cov[np.ix_([i, j], [i, j])]
    return 1.0 / np.sqrt(np.linalg.det(sub))


def confidence_ellipse(fisher, i=0, j=1, contour=0.95):
    """(semi_major, semi_minor, angle_deg) of the marginalized 2D forecast
    ellipse at the given probability content — the geometry
    :meth:`~getdist_tpu.plots.GetDistPlotter.add_2d_covariance` draws.

    The axes scale with sqrt(-2 ln(1-contour)) (2D Gaussian containment),
    along the eigenvectors of the marginalized 2x2 covariance; the angle is
    measured from the +x axis, in degrees.
    """
    from scipy.stats import chi2

    cov = fisher_to_cov(fisher)
    sub = cov[np.ix_([i, j], [i, j])]
    evals, evecs = np.linalg.eigh(sub)
    # eigh returns ascending; major axis last
    scale = np.sqrt(chi2.ppf(contour, df=2))
    semi_minor, semi_major = np.sqrt(evals) * scale
    major_vec = evecs[:, 1]
    angle = np.degrees(np.arctan2(major_vec[1], major_vec[0]))
    return float(semi_major), float(semi_minor), float(angle)


def gaussian_from_fisher(fisher, means=None, names=None, labels=None, **kwargs):
    """Forecast posterior as a :class:`~getdist_tpu.gaussian_mixtures.GaussianND`
    (plot/marginalize/condition/sample like any analytic distribution)."""
    from getdist_tpu.gaussian_mixtures import GaussianND

    m = _as_matrix(fisher)
    if means is None:
        means = np.zeros(m.shape[0])
    return GaussianND(means, m, is_inv_cov=True, names=names, labels=labels, **kwargs)
