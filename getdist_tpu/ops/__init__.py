"""Device-side numerical kernels (jit/vmap, one CUDA histogram kernel).

Layer L0-L2 of the framework: FFT/DCT primitives, convolution engines,
weighted-sample binning and statistics, ISJ bandwidth optimization, and the
1D/2D KDE density pipelines. Everything in this package is functional,
shape-static, and safe to ``jax.jit`` / ``jax.vmap`` / shard with ``pjit``.
"""

from getdist_tpu.ops.fft import dct, idct, dct2d, idct2d, next_fast_len
from getdist_tpu.ops.convolve import (
    convolve1D,
    convolve2D,
    convolveFFT,
    convolveFFTn,
    convolve1D_periodic,
    convolve2D_periodic,
    autoConvolve,
    autoCorrelation,
    convolveGaussian,
    convolveGaussianDCT,
    convolveGaussianTrunc,
)

__all__ = [
    "dct",
    "idct",
    "dct2d",
    "idct2d",
    "next_fast_len",
    "convolve1D",
    "convolve2D",
    "convolveFFT",
    "convolveFFTn",
    "convolve1D_periodic",
    "convolve2D_periodic",
    "autoConvolve",
    "autoCorrelation",
    "convolveGaussian",
    "convolveGaussianDCT",
    "convolveGaussianTrunc",
]
