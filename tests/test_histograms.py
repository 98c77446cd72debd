"""Pair and 1D histograms (ops/histograms.py), the GPU kernel's wrapper,
and the FFT convolution route, against plain numpy references."""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from getdist_tpu import backend
from getdist_tpu.ops import histograms
from getdist_tpu.ops.batched import _conv2d_same_batch, _conv2d_same_kf, _gauss_kernel_2d


def _add_at_pairs(ix, w, pairs, nbins):
    out = np.zeros((len(pairs), nbins, nbins))
    for k, (a, b) in enumerate(pairs):
        np.add.at(out[k], (ix[b], ix[a]), w)
    return out


@pytest.mark.parametrize(
    "n, nbins, weights, n_pairs",
    [
        (4096, 256, "int", 6),
        (4099, 256, "int", 6),  # N not a multiple of the kernel's vector width
        (5000, 256, "frac", 3),
        (3001, 256, "zeros", 4),  # zero-weight samples contribute nothing
        (2048, 384, "int", 2),  # a parity-mode corr-adaptive width
        (1000, 256, "int", 1),
    ],
)
def test_pair_histograms_match_add_at(n, nbins, weights, n_pairs):
    rng = np.random.default_rng(n + nbins)
    p = 5
    ix = rng.integers(0, nbins, (p, n)).astype(np.int32)
    if weights == "int":
        w = rng.integers(1, 5, n).astype(np.float32)
    elif weights == "frac":
        w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    else:
        w = rng.integers(0, 3, n).astype(np.float32)
        w[::2] = 0
    pairs = [(a, b) for a in range(p) for b in range(a + 1, p)][:n_pairs]
    got = np.asarray(
        histograms.pair_histograms(
            jnp.asarray(ix),
            jnp.asarray(w),
            jnp.asarray([a for a, _ in pairs]),
            jnp.asarray([b for _, b in pairs]),
            nbins,
        )
    )
    want = _add_at_pairs(ix, w.astype(np.float64), pairs, nbins)
    assert got.shape == (n_pairs, nbins, nbins)
    if weights == "frac":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_array_equal(got, want)


def test_pair_histograms_chunk_past_int32_offsets(monkeypatch):
    """Pair lists whose flat bin offsets would pass 2**31 are binned in
    chunks of pairs; shrink the limit so a small case takes that branch."""
    rng = np.random.default_rng(1)
    ix = jnp.asarray(rng.integers(0, 64, (4, 500)).astype(np.int32))
    w = jnp.asarray(rng.integers(1, 3, 500).astype(np.float32))
    pairs = [(0, 1), (0, 2), (1, 3), (2, 3), (0, 3)]
    pa, pb = jnp.asarray([a for a, _ in pairs]), jnp.asarray([b for _, b in pairs])
    whole = np.asarray(histograms.pair_histograms(ix, w, pa, pb, 64))
    monkeypatch.setattr(histograms, "_MAX_FLAT", 2 * 64 * 64)
    chunked = np.asarray(histograms.pair_histograms(ix, w, pa, pb, 64))
    np.testing.assert_array_equal(chunked, whole)
    np.testing.assert_array_equal(whole, _add_at_pairs(np.asarray(ix), np.asarray(w, np.float64), pairs, 64))


@pytest.mark.parametrize("weights", ["int", "frac"])
def test_row_histograms_match_bincount(weights):
    rng = np.random.default_rng(7)
    ix = rng.integers(0, 1024, (3, 20000)).astype(np.int32)
    w = (rng.integers(1, 5, 20000) if weights == "int" else rng.uniform(0.5, 2, 20000)).astype(np.float32)
    got = np.asarray(histograms.row_histograms(jnp.asarray(ix), jnp.asarray(w), 1024))
    want = np.stack([np.bincount(r, weights=w.astype(np.float64), minlength=1024) for r in ix])
    np.testing.assert_allclose(got, want, rtol=1e-6 if weights == "frac" else 0)


@pytest.mark.parametrize("n", [100, 101, 102, 103])
def test_pad_samples_to_vector_width(n):
    ix = jnp.asarray(np.arange(3 * n, dtype=np.int32).reshape(3, n) % 256)
    w = jnp.ones(n, jnp.float32)
    ix8, w_pad = histograms._pad_samples(ix, w)
    assert ix8.dtype == jnp.uint8
    assert ix8.shape == (3, -(-n // 4) * 4) and w_pad.shape == (ix8.shape[1],)
    np.testing.assert_array_equal(np.asarray(ix8)[:, :n], np.asarray(ix))
    assert np.all(np.asarray(w_pad)[n:] == 0)


def test_sample_splits_fill_the_card():
    # the headline 435 pairs already give ~7 blocks per SM: two splits
    assert histograms._sample_splits(435, 1_000_000) == 2
    # few pairs: split the samples, but keep >= 64k samples per block
    assert histograms._sample_splits(1, 1_000_000) == 15
    assert histograms._sample_splits(1, 10_000) == 1
    assert histograms._sample_splits(0, 10_000) == 1


@pytest.mark.parametrize(
    "route, nbins, dtype, expect_cuda",
    [
        ("cuda", 256, jnp.float32, True),
        ("cuda", 384, jnp.float32, False),  # the kernel is 256 wide only
        ("cuda", 256, jnp.float64, False),  # f64 sums go through the scatter
        ("scatter", 256, jnp.float32, False),
    ],
)
def test_pair_histograms_choose_kernel(monkeypatch, route, nbins, dtype, expect_cuda):
    monkeypatch.setattr(backend, "pair_hist_route", lambda: route)
    chosen = []
    monkeypatch.setattr(histograms, "_cuda_pair_histograms", lambda *a: chosen.append("cuda") or "cuda")
    ix = jnp.zeros((2, 8), jnp.int32)
    with jax.enable_x64(dtype == jnp.float64):
        out = histograms.pair_histograms(ix, jnp.ones(8, dtype), jnp.asarray([0]), jnp.asarray([1]), nbins)
    assert (out == "cuda") == expect_cuda and bool(chosen) == expect_cuda


def test_cuda_build_command_targets_hopper():
    cmd = histograms._nvcc_command("/opt/cuda/bin/nvcc", "/tmp/out.so")
    assert cmd[0] == "/opt/cuda/bin/nvcc"
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert cmd[-1] == histograms._CUDA_SOURCE and os.path.exists(cmd[-1])
    assert jax.ffi.include_dir() in cmd


def test_cuda_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(histograms.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    monkeypatch.setattr(histograms, "_CUDA_LIBRARY", str(tmp_path / "build" / "libpairhist.so"))
    with pytest.raises(RuntimeError, match="nvcc"):
        histograms.build_cuda_library(force=True)
    assert os.listdir(tmp_path / "build") == []  # no half-written library left


@pytest.mark.gpu
def test_cuda_pair_histograms_match_add_at(gpu):
    rng = np.random.default_rng(3)
    ix = rng.integers(0, 256, (6, 300_001)).astype(np.int32)
    w = rng.integers(1, 5, 300_001).astype(np.float32)
    pairs = [(a, b) for a in range(6) for b in range(a + 1, 6)]
    got = np.asarray(
        histograms._cuda_pair_histograms(
            jnp.asarray(ix), jnp.asarray(w), jnp.asarray([a for a, _ in pairs]), jnp.asarray([b for _, b in pairs])
        )
    )
    np.testing.assert_array_equal(got, _add_at_pairs(ix, w.astype(np.float64), pairs, 256))


def _numpy_conv(grid, kern, pad, offset, size):
    spec = np.fft.rfftn(grid, (pad, pad), axes=(0, 1)) * np.fft.rfftn(kern, (pad, pad), axes=(0, 1))
    return np.fft.irfftn(spec, (pad, pad), axes=(0, 1))[offset : offset + size, offset : offset + size]


@pytest.mark.parametrize("dtype, tol", [(jnp.float32, 1e-5), (jnp.float64, 1e-12)])
def test_fft_same_convolution_matches_numpy(dtype, tol):
    rng = np.random.default_rng(5)
    n, winw, pad = 64, 8, 96
    grids = rng.poisson(20.0, (3, n, n)).astype(np.float64)
    kern = np.asarray(
        jax.vmap(lambda a, b, c: _gauss_kernel_2d(a, b, c, winw, jnp.float64))(
            jnp.asarray([1.5, 2.5, 3.0]), jnp.asarray([2.0, 1.2, 3.0]), jnp.asarray([0.3, -0.5, 0.0])
        )
    )
    with jax.enable_x64(dtype == jnp.float64):
        got = np.asarray(_conv2d_same_batch(jnp.asarray(grids, dtype), jnp.asarray(kern, dtype), pad), np.float64)
    for k in range(3):
        want = _numpy_conv(grids[k], kern[k], pad, winw, n)
        assert np.max(np.abs(got[k] - want)) <= tol * np.max(want)


def test_fft_extended_offset_convolution_matches_numpy():
    """The 'valid' slice of an extended frame (offset 2*winw), the
    convention of the edge-mask convolutions."""
    rng = np.random.default_rng(6)
    n, winw = 48, 6
    ext = n + 2 * winw
    pad = 96
    masks = rng.uniform(0, 1, (2, ext, ext))
    kern = np.asarray(
        jax.vmap(lambda a, b: _gauss_kernel_2d(a, b, 0.2, winw, jnp.float64))(jnp.asarray([1.5, 2.0]), jnp.asarray([2.0, 1.0]))
    )
    kf = jnp.fft.rfftn(jnp.asarray(kern), (pad, pad), axes=(1, 2))
    full = _conv2d_same_kf(jnp.asarray(masks), kf, pad, 0)  # offset-0 slice of the full conv
    for k in range(2):
        spec = np.fft.rfftn(masks[k], (pad, pad), axes=(0, 1)) * np.fft.rfftn(kern[k], (pad, pad), axes=(0, 1))
        want = np.fft.irfftn(spec, (pad, pad), axes=(0, 1))[2 * winw : 2 * winw + n, 2 * winw : 2 * winw + n]
        got = np.asarray(full[k])[2 * winw : 2 * winw + n, 2 * winw : 2 * winw + n]
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 * np.max(want))
