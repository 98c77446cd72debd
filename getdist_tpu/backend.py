"""The one place that reads JAX's platform and says what it offers.

getdist_tpu runs on two platforms: ``cpu`` (tests, and the host parity
oracle) and ``gpu`` (an NVIDIA card). Any other platform raises instead of
being mistaken for one of them.
"""

import jax

__all__ = ["platform", "fused_route_default", "pair_hist_route", "native_f64_fft"]

_SUPPORTED = ("cpu", "gpu")


def platform():
    """JAX's default platform, checked against the supported ones."""
    name = jax.default_backend()
    if name not in _SUPPORTED:
        raise RuntimeError(f"unsupported JAX platform {name!r}: getdist_tpu runs on {' or '.join(_SUPPORTED)}")
    return name


def fused_route_default():
    """Whether density queries go through the fused device pipeline by
    default. On the CPU the host path stays the default: it is the
    reference-exact oracle the fused path is tested against."""
    return platform() == "gpu"


def pair_hist_route():
    """How 256-bin pair histograms are built (:mod:`getdist_tpu.ops.histograms`):
    ``"cuda"``, the shared-memory CUDA kernel, on the GPU; ``"scatter"``,
    an XLA scatter-add, on the CPU."""
    return "cuda" if platform() == "gpu" else "scatter"


def native_f64_fft():
    """Whether f64 and c128 FFTs run natively (numpy on the CPU, cuFFT on
    the GPU), so the parity device mode can convolve in float64."""
    return platform() in _SUPPORTED
