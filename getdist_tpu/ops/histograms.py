"""Weighted 1D and pair histograms of precomputed bin indices.

The plain route for both is one XLA scatter-add into a flat (rows * bins)
buffer: on the GPU XLA emits atomic adds, on the CPU a loop. On the GPU,
256-bin f32 pair histograms (the fused pipeline's shape) instead run a
hand-written CUDA kernel (``cuda/pair_hist.cu``) that accumulates each
pair's tile in shared memory; :func:`getdist_tpu.backend.pair_hist_route`
makes that choice. Sums are taken in the weights' dtype: for integer
weights every bin total below 2**24 (f32) is exact in any order;
fractional f32 weights carry the rounding of an f32 sum taken in an
order the atomics choose.

The CUDA library is built from the committed source into
``cuda/build/`` at first use, or ahead of time with
``python -m getdist_tpu.ops.histograms``.
"""

import ctypes
import functools
import os
import shutil
import subprocess
import tempfile

import numpy as np

import jax
import jax.numpy as jnp

from getdist_tpu import backend

__all__ = ["row_histograms", "pair_histograms", "build_cuda_library"]

_CUDA_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "cuda")
_CUDA_SOURCE = os.path.join(_CUDA_DIR, "pair_hist.cu")
_CUDA_LIBRARY = os.path.join(_CUDA_DIR, "build", "libpairhist.so")
_FFI_TARGET = "getdist_pair_hist"
# flat int32 bin offsets of one scatter must stay below 2**31
_MAX_FLAT = 2**31 - 1
# H100 SXM streaming multiprocessors. One 128 KB tile fits per SM at a time,
# so ask for ~8 blocks per SM (a short last wave), each with at least 64k
# samples to amortise zeroing and flushing its tile
_SMS = 132
_MIN_SAMPLES_PER_BLOCK = 65536


def row_histograms(ix_rows, weights, nbins):
    """(R, nbins) weighted histograms of (R, N) index rows in [0, nbins)."""
    r = ix_rows.shape[0]
    flat = ix_rows + (jnp.arange(r, dtype=ix_rows.dtype) * nbins)[:, None]
    hist = jnp.zeros(r * nbins, weights.dtype).at[flat].add(jnp.broadcast_to(weights, flat.shape))
    return hist.reshape(r, nbins)


def pair_histograms(ix_rows, weights, pair_a, pair_b, nbins):
    """(K, nbins, nbins) weighted 2D histograms, rows = b, cols = a.

    ``ix_rows``: (R, N) index rows in [0, nbins); ``pair_a``/``pair_b``:
    (K,) row positions of each pair's x and y parameter.
    """
    if nbins == 256 and weights.dtype == jnp.float32 and backend.pair_hist_route() == "cuda":
        return _cuda_pair_histograms(ix_rows, weights, pair_a, pair_b)
    return _scatter_pair_histograms(ix_rows, weights, pair_a, pair_b, nbins)


def _scatter_pair_histograms(ix_rows, weights, pair_a, pair_b, nbins):
    k = pair_a.shape[0]
    ix_rows = ix_rows.astype(jnp.int32)
    step = max(1, _MAX_FLAT // (nbins * nbins))
    if k > step:
        return jnp.concatenate(
            [
                _scatter_pair_histograms(ix_rows, weights, pair_a[s : s + step], pair_b[s : s + step], nbins)
                for s in range(0, k, step)
            ]
        )
    base = (jnp.arange(k, dtype=jnp.int32) * (nbins * nbins))[:, None]
    flat = base + ix_rows[pair_b] * nbins + ix_rows[pair_a]
    hist = jnp.zeros(k * nbins * nbins, weights.dtype).at[flat].add(jnp.broadcast_to(weights, flat.shape))
    return hist.reshape(k, nbins, nbins)


def _pad_samples(ix_rows, weights, multiple=4):
    """uint8 index rows and weights padded with zero-weight samples to a
    multiple of ``multiple`` (the kernel's vector width)."""
    pad = (-ix_rows.shape[1]) % multiple
    ix8 = ix_rows.astype(jnp.uint8)
    if pad:
        ix8 = jnp.pad(ix8, ((0, 0), (0, pad)))
        weights = jnp.pad(weights, (0, pad))
    return ix8, weights


def _sample_splits(n_pairs, n_samples):
    """Sample slices per half tile: enough blocks to fill the card, each
    with enough samples to amortise its shared-memory tile."""
    want = -(-8 * _SMS // (2 * max(n_pairs, 1)))
    return int(max(1, min(want, n_samples // _MIN_SAMPLES_PER_BLOCK)))


def _cuda_pair_histograms(ix_rows, weights, pair_a, pair_b):
    _register_cuda_target()
    ix8, w = _pad_samples(ix_rows, weights)
    k = pair_a.shape[0]
    out = jax.ShapeDtypeStruct((k, 256, 256), jnp.float32)
    return jax.ffi.ffi_call(_FFI_TARGET, out)(
        ix8,
        w,
        pair_a.astype(jnp.int32),
        pair_b.astype(jnp.int32),
        splits=np.int64(_sample_splits(k, ix8.shape[1])),
    )


def _nvcc():
    for cand in (
        shutil.which("nvcc"),
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "the GPU pair-histogram kernel needs nvcc (the CUDA toolkit) to build "
        f"{_CUDA_SOURCE}; set CUDA_HOME or put nvcc on PATH"
    )


def _nvcc_command(nvcc, out_path):
    return [
        nvcc,
        "-gencode",
        "arch=compute_90a,code=sm_90a",
        "-std=c++17",
        "-O3",
        "-shared",
        "-Xcompiler",
        "-fPIC",
        "-I",
        jax.ffi.include_dir(),
        "-o",
        out_path,
        _CUDA_SOURCE,
    ]


def build_cuda_library(force=False):
    """Compile ``cuda/pair_hist.cu`` into ``cuda/build/libpairhist.so``
    (skipped when the library is newer than its source) and return its path."""
    if (
        not force
        and os.path.exists(_CUDA_LIBRARY)
        and os.path.getmtime(_CUDA_LIBRARY) >= os.path.getmtime(_CUDA_SOURCE)
    ):
        return _CUDA_LIBRARY
    os.makedirs(os.path.dirname(_CUDA_LIBRARY), exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=os.path.dirname(_CUDA_LIBRARY))
    os.close(fd)
    try:
        proc = subprocess.run(_nvcc_command(_nvcc(), tmp), capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {_CUDA_SOURCE}:\n{proc.stderr[-4000:]}")
        os.replace(tmp, _CUDA_LIBRARY)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return _CUDA_LIBRARY


@functools.cache
def _register_cuda_target():
    lib = ctypes.cdll.LoadLibrary(build_cuda_library())
    jax.ffi.register_ffi_target(_FFI_TARGET, jax.ffi.pycapsule(lib.PairHist), platform="CUDA")
    return lib


if __name__ == "__main__":
    print(build_cuda_library(force=True))
