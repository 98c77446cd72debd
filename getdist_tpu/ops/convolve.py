"""FFT convolution engines (1D/2D/ND, aperiodic + periodic).

Re-design of the reference's ``getdist/convolve.py`` for XLA: the reference
keeps id()-keyed FFT caches (``convolve.py:371-436``) and a precomputed
fast-size table; under ``jit`` both are unnecessary — repeated kernel FFTs
constant-fold and padding sizes are chosen at trace time from static shapes
(``next_fast_len``). Unlike the reference, which switches to direct
``np.convolve`` for small arrays (``convolve.py:199-202``), we always use
the FFT path: on TPU a single fused FFT is faster than a data-dependent
branch, and it is identical math.

Modes follow the reference semantics exactly:
  * ``full``/``same``/``valid`` linear convolution (``convolve.py:371-436``)
  * ``periodic`` circular convolution where the input's duplicated boundary
    bin is folded (last bin added to first) and the kernel is roll-centered
    (``convolve.py:215-367``).
"""

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from getdist_tpu.ops.fft import dct, dct2d, idct, idct2d, next_fast_len

__all__ = [
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
    "dct2d",
    "idct2d",
    "nearestFFTnumber",
]


def nearestFFTnumber(x):
    """Smallest fast (5-smooth) FFT size >= x; reference-named entry point
    (``convolve.py:192``), scalar or array."""
    if np.ndim(x) == 0:
        return next_fast_len(int(x))
    return np.asarray([next_fast_len(int(v)) for v in np.ravel(x)]).reshape(np.shape(x))


@partial(jax.jit, static_argnames=("mode", "largest_size"))
def convolveFFT(x, y, mode="same", largest_size=0):
    """1D linear convolution of ``x`` with ``y`` via zero-padded rFFT.

    Matches reference ``convolveFFT`` (``convolve.py:371-401``): pad to a
    fast size >= len(x)+len(y)-1, multiply spectra, inverse-transform, then
    slice according to ``mode``.
    """
    size = x.shape[0] + y.shape[0] - 1
    fsize = next_fast_len(max(largest_size, size))
    xfft = jnp.fft.rfft(x, fsize)
    yfft = jnp.fft.rfft(y, fsize)
    res = jnp.fft.irfft(xfft * yfft, fsize)[:size]
    if mode == "same":
        start = (y.shape[0] - 1) // 2
        return res[start : start + x.shape[0]]
    elif mode == "full":
        return res
    elif mode == "valid":
        return res[y.shape[0] - 1 : x.shape[0]]
    raise ValueError(f"unknown convolution mode {mode!r}")


def _centered(arr, newshape):
    # Center slice, as reference ``_centered`` (convolve.py:439-444).
    slices = tuple(slice((cur - new) // 2, (cur - new) // 2 + new) for cur, new in zip(arr.shape, newshape))
    return arr[slices]


@partial(jax.jit, static_argnames=("mode", "largest_size"))
def convolveFFTn(in1, in2, mode="same", largest_size=0):
    """ND linear convolution via real FFTs (reference ``convolveFFTn``,
    ``convolve.py:405-436``)."""
    s1 = in1.shape
    s2 = in2.shape
    size = tuple(a + b - 1 for a, b in zip(s1, s2))
    fsize = tuple(next_fast_len(max(largest_size, s)) for s in size)
    axes = tuple(range(-len(fsize), 0))
    xfft = jnp.fft.rfftn(in1, fsize, axes)
    yfft = jnp.fft.rfftn(in2, fsize, axes)
    ret = jnp.fft.irfftn(xfft * yfft, fsize, axes)[tuple(slice(0, s) for s in size)]
    if mode == "full":
        return ret
    elif mode == "same":
        return _centered(ret, s1)
    elif mode == "valid":
        return _centered(ret, tuple(a - b + 1 for a, b in zip(s1, s2)))
    raise ValueError(f"unknown convolution mode {mode!r}")


@jax.jit
def convolve1D_periodic(x, y):
    """Circular 1D convolution where ``x`` carries a duplicated boundary bin
    (last == first up to half-weighting): fold last bin into first, convolve
    circularly with the roll-centered kernel, then re-append the first bin
    (reference ``convolve1D_periodic``, ``convolve.py:326-367``)."""
    x_circ = x[:-1].at[0].add(x[-1])
    n = x_circ.shape[0]
    m = y.shape[0]
    hpad = jnp.zeros(n, dtype=y.dtype).at[:m].set(y)
    hpad = jnp.roll(hpad, -(m // 2))
    res = jnp.fft.irfft(jnp.fft.rfft(x_circ) * jnp.fft.rfft(hpad), n)
    return jnp.concatenate([res, res[:1]])


@partial(jax.jit, static_argnames=("periodic_x", "periodic_y"))
def convolve2D_periodic(x, y, periodic_x=True, periodic_y=True):
    """2D convolution periodic in either/both axes (reference
    ``convolve2D_periodic``, ``convolve.py:215-323``). Axis convention:
    axis 0 is y, axis 1 is x; periodic axes carry a duplicated boundary
    bin that gets folded before the circular FFT and re-emitted after."""
    if not (periodic_x or periodic_y):
        return convolveFFTn(x, y, "same")
    ky, kx = y.shape
    if periodic_x and periodic_y:
        x_circ = x[:-1, :-1]
        x_circ = x_circ.at[0, :].add(x[-1, :-1])
        x_circ = x_circ.at[:, 0].add(x[:-1, -1])
        x_circ = x_circ.at[0, 0].add(x[-1, -1])
    elif periodic_x:
        x_circ = x[:, :-1].at[:, 0].add(x[:, -1])
    else:
        x_circ = x[:-1, :].at[0, :].add(x[-1, :])
    n_y, n_x = x_circ.shape
    hpad = jnp.zeros((n_y, n_x), dtype=y.dtype).at[:ky, :kx].set(y)
    hpad = jnp.roll(hpad, -(ky // 2), axis=0)
    hpad = jnp.roll(hpad, -(kx // 2), axis=1)
    res = jnp.fft.irfftn(jnp.fft.rfftn(x_circ) * jnp.fft.rfftn(hpad), (n_y, n_x), axes=(0, 1))
    # Re-append duplicated boundary rows/cols.
    if periodic_x:
        res = jnp.concatenate([res, res[:, :1]], axis=1)
    if periodic_y:
        res = jnp.concatenate([res, res[:1, :]], axis=0)
    return res


def convolve1D(x, y, mode, largest_size=0, cache=None, cache_args=None):
    """1D convolution dispatcher (reference ``convolve1D``,
    ``convolve.py:196-202``). ``cache``/``cache_args`` accepted for API
    compatibility; under jit the compiler caches kernel FFTs instead."""
    if mode == "periodic":
        return convolve1D_periodic(x, y)
    return convolveFFT(x, y, mode, largest_size=largest_size)


def convolve2D(x, y, mode, largest_size=0, cache=None, cache_args=None):
    """2D convolution dispatcher (reference ``convolve2D``,
    ``convolve.py:205-212``)."""
    if mode in ("periodic", "periodic_both"):
        return convolve2D_periodic(x, y, periodic_x=True, periodic_y=True)
    elif mode == "periodic_x":
        return convolve2D_periodic(x, y, periodic_x=True, periodic_y=False)
    elif mode == "periodic_y":
        return convolve2D_periodic(x, y, periodic_x=False, periodic_y=True)
    return convolveFFTn(x, y, mode, largest_size)


@partial(jax.jit, static_argnames=("n", "normalize"))
def autoConvolve(x, n=None, normalize=True):
    """Auto-covariance ``result[k] = sum_i x_i x_{i+k}`` for k = 0..n-1.

    Same quantity as reference ``autoConvolve`` (``convolve.py:458-478``),
    computed directly from the rFFT power spectrum (the reference's
    fftpack packed-format + DCT-I trick is an equivalent formulation it
    itself documents at ``convolve.py:466-468``).
    """
    n = n or x.shape[0]
    s = next_fast_len(2 * x.shape[0])
    xt = jnp.fft.rfft(x, s)
    res = jnp.fft.irfft(xt * jnp.conj(xt), s)[:n]
    if normalize:
        res = res / jnp.arange(x.shape[0], x.shape[0] - n, -1, dtype=x.dtype)
    return res


@partial(jax.jit, static_argnames=("n", "normalized", "start_index"))
def autoCorrelation(x, n=None, normalized=True, start_index=0):
    """Normalized autocorrelation (reference ``autoCorrelation``,
    ``convolve.py:447-455``)."""
    result = autoConvolve(x - jnp.mean(x), n, normalize=True)
    if normalized:
        result = result / result[0]
    return result[start_index:]


@partial(jax.jit, static_argnames=("sigma", "pad_sigma", "mode"))
def convolveGaussianDCT(x, sigma, pad_sigma=4.0, mode="same"):
    """1D Gaussian smoothing via DCT multiplier, with optional zero padding
    (reference ``convolveGaussianDCT``, ``convolve.py:482-512``). ``sigma``
    is in pixel units and must be a static python float (the pad size
    depends on it)."""
    sigma = float(sigma)
    fill = int(pad_sigma * sigma)
    if fill > 0:
        s = next_fast_len(x.shape[0] + 2 * fill)
        fill2 = s - x.shape[0] - fill
        padded_x = jnp.pad(x, (fill, fill2))
    else:
        padded_x = x
    s = padded_x.shape[0]
    hnorm = sigma / float(s)
    gauss = jnp.exp(-((jnp.arange(s, dtype=x.dtype) * (jnp.pi * hnorm)) ** 2) / 2.0)
    res = idct(dct(padded_x) * gauss) / (2 * s)
    if fill == 0:
        return res
    elif mode == "same":
        return res[fill:-fill2]
    elif mode == "valid":
        return res[fill * 2 : -fill2 - fill]
    raise ValueError("mode not supported for convolveGaussianDCT")


@partial(jax.jit, static_argnames=("sigma", "sigma_range"))
def convolveGaussian(x, sigma, sigma_range=4.0):
    """Fast periodic-boundary Gaussian smoothing via rFFT multiplier
    (reference ``convolveGaussian``, ``convolve.py:515-536``). ``sigma``
    must be static (pad size depends on it)."""
    sigma = float(sigma)
    fill = int(sigma_range * sigma)
    actual_size = x.shape[0] + 2 * fill
    s = next_fast_len(actual_size) if fill > 0 else actual_size
    hnorm = sigma / float(s)
    # Gaussian multiplier on rfft frequencies: exp(-2 (pi k sigma / s)^2)
    k = jnp.arange(s // 2 + 1, dtype=x.dtype)
    gauss = jnp.exp(-((k * (jnp.pi * hnorm)) ** 2) * 2)
    res = jnp.fft.irfft(jnp.fft.rfft(x, s) * gauss, s)
    return res[: x.shape[0]]


@partial(jax.jit, static_argnames=("sigma", "sigma_range", "mode"))
def convolveGaussianTrunc(x, sigma, sigma_range=4.0, mode="same"):
    """Truncated, renormalized Gaussian kernel convolution (reference
    ``convolveGaussianTrunc``, ``convolve.py:539-562``)."""
    sigma_f = float(sigma)
    fill = int(sigma_range * sigma_f)
    actual_size = x.shape[0] + 2 * fill
    s = next_fast_len(actual_size)
    points = jnp.arange(-fill, fill + 1, dtype=x.dtype)
    win = jnp.exp(-((points / sigma) ** 2) / 2.0)
    win = win / jnp.sum(win)
    res = jnp.fft.irfft(jnp.fft.rfft(x, s) * jnp.fft.rfft(win, s), s)[:actual_size]
    if mode == "same":
        return res[fill:-fill] if fill else res
    elif mode == "full":
        return res
    elif mode == "valid":
        return res[2 * fill : -2 * fill] if fill else res
    raise ValueError(f"unknown convolution mode {mode!r}")


# ---------------------------------------------------------------------------
# host (numpy) twins — the parity path's per-pair convolutions run on grids
# of a few hundred bins where one device dispatch (+ a per-shape jit
# compile) costs orders of magnitude more than the FFT itself. Same
# padding/slicing semantics as the jit versions.
# ---------------------------------------------------------------------------


def convolveFFT_host(x, y, mode="same", largest_size=0):
    """numpy twin of :func:`convolveFFT`."""
    size = x.shape[0] + y.shape[0] - 1
    fsize = next_fast_len(max(largest_size, size))
    res = np.fft.irfft(np.fft.rfft(x, fsize) * np.fft.rfft(y, fsize), fsize)[:size]
    if mode == "same":
        start = (y.shape[0] - 1) // 2
        return res[start : start + x.shape[0]]
    elif mode == "full":
        return res
    elif mode == "valid":
        return res[y.shape[0] - 1 : x.shape[0]]
    raise ValueError(f"unknown convolution mode {mode!r}")


def convolveFFTn_host(in1, in2, mode="same", largest_size=0):
    """numpy twin of :func:`convolveFFTn`."""
    s1, s2 = in1.shape, in2.shape
    size = tuple(a + b - 1 for a, b in zip(s1, s2))
    fsize = tuple(next_fast_len(max(largest_size, s)) for s in size)
    axes = tuple(range(-len(fsize), 0))
    ret = np.fft.irfftn(np.fft.rfftn(in1, fsize, axes) * np.fft.rfftn(in2, fsize, axes), fsize, axes)[
        tuple(slice(0, s) for s in size)
    ]
    if mode == "full":
        return ret
    elif mode == "same":
        slices = tuple(slice((cur - new) // 2, (cur - new) // 2 + new) for cur, new in zip(ret.shape, s1))
        return ret[slices]
    elif mode == "valid":
        newshape = tuple(a - b + 1 for a, b in zip(s1, s2))
        slices = tuple(slice((cur - new) // 2, (cur - new) // 2 + new) for cur, new in zip(ret.shape, newshape))
        return ret[slices]
    raise ValueError(f"unknown convolution mode {mode!r}")


def convolve1D_periodic_host(x, y):
    """numpy twin of :func:`convolve1D_periodic`."""
    x_circ = np.array(x[:-1])
    x_circ[0] += x[-1]
    n = x_circ.shape[0]
    m = y.shape[0]
    hpad = np.zeros(n, dtype=np.asarray(y).dtype)
    hpad[:m] = y
    hpad = np.roll(hpad, -(m // 2))
    res = np.fft.irfft(np.fft.rfft(x_circ) * np.fft.rfft(hpad), n)
    return np.concatenate([res, res[:1]])


def convolve2D_periodic_host(x, y, periodic_x=True, periodic_y=True):
    """numpy twin of :func:`convolve2D_periodic`."""
    if not (periodic_x or periodic_y):
        return convolveFFTn_host(x, y, "same")
    ky, kx = y.shape
    if periodic_x and periodic_y:
        x_circ = np.array(x[:-1, :-1])
        x_circ[0, :] += x[-1, :-1]
        x_circ[:, 0] += x[:-1, -1]
        x_circ[0, 0] += x[-1, -1]
    elif periodic_x:
        x_circ = np.array(x[:, :-1])
        x_circ[:, 0] += x[:, -1]
    else:
        x_circ = np.array(x[:-1, :])
        x_circ[0, :] += x[-1, :]
    n_y, n_x = x_circ.shape
    hpad = np.zeros((n_y, n_x), dtype=np.asarray(y).dtype)
    hpad[:ky, :kx] = y
    hpad = np.roll(hpad, -(ky // 2), axis=0)
    hpad = np.roll(hpad, -(kx // 2), axis=1)
    res = np.fft.irfftn(np.fft.rfftn(x_circ) * np.fft.rfftn(hpad), (n_y, n_x), axes=(0, 1))
    if periodic_x:
        res = np.concatenate([res, res[:, :1]], axis=1)
    if periodic_y:
        res = np.concatenate([res, res[:1, :]], axis=0)
    return res


def convolve1D_host(x, y, mode, largest_size=0, cache=None, cache_args=None):
    """Host dispatcher matching :func:`convolve1D`."""
    if mode == "periodic":
        return convolve1D_periodic_host(x, y)
    return convolveFFT_host(np.asarray(x, float), np.asarray(y, float), mode, largest_size=largest_size)


def convolve2D_host(x, y, mode, largest_size=0, cache=None, cache_args=None):
    """Host dispatcher matching :func:`convolve2D`."""
    if mode in ("periodic", "periodic_both"):
        return convolve2D_periodic_host(x, y, periodic_x=True, periodic_y=True)
    elif mode == "periodic_x":
        return convolve2D_periodic_host(x, y, periodic_x=True, periodic_y=False)
    elif mode == "periodic_y":
        return convolve2D_periodic_host(x, y, periodic_x=False, periodic_y=True)
    return convolveFFTn_host(np.asarray(x, float), np.asarray(y, float), mode, largest_size)
