// Multi-threaded exact pair-histogram kernel for the parity path.
//
// The reference computes each pair's 2D histogram with np.bincount over
// flattened indices (getdist mcsamples.py:1821-1827); at 435 pairs x 1M
// samples that is ~9 s of single-threaded numpy on the bench host. This
// kernel computes the same f64 scatter adds (bit-identical: f64 addition
// order per pair is the same sample order np.bincount uses) with pairs
// fanned out across threads.
//
// Exposed via ctypes from getdist_tpu._native (graceful numpy fallback).

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

extern "C" {

// ixs: (p, n) int32 row-major bin indices per parameter (already clipped
// to [0, nbins)); w: (n,) f64 weights; pair_a/pair_b: (k,) parameter rows;
// out: (k, nbins*nbins) f64, zero-initialized by the caller.
int gdt_pair_hists(const int32_t* ixs, int64_t n, int64_t p, const double* w,
                   const int64_t* pair_a, const int64_t* pair_b, int64_t k,
                   int64_t nbins, double* out, int n_threads) {
    if (n < 0 || p <= 0 || k <= 0 || nbins <= 0) return 1;
    for (int64_t j = 0; j < k; ++j) {
        if (pair_a[j] < 0 || pair_a[j] >= p || pair_b[j] < 0 || pair_b[j] >= p) return 2;
    }
    if (n_threads < 1) n_threads = 1;
    int64_t cells = nbins * nbins;

    auto work = [&](int64_t k_lo, int64_t k_hi) {
        for (int64_t j = k_lo; j < k_hi; ++j) {
            const int32_t* ia = ixs + pair_a[j] * n;
            const int32_t* ib = ixs + pair_b[j] * n;
            double* h = out + j * cells;
            // rows = b, cols = a (the _make2Dhist / ops.histograms layout).
            // Indices are documented pre-clipped, but clamp defensively
            // (branch-predictable, ~free): an out-of-range value from a
            // caller-contract violation must not become a silent
            // out-of-bounds heap write in multi-threaded code —
            // gdt_bin_columns clips, so this matches its semantics.
            for (int64_t i = 0; i < n; ++i) {
                int64_t a = ia[i];
                int64_t b = ib[i];
                a = a < 0 ? 0 : (a >= nbins ? nbins - 1 : a);
                b = b < 0 ? 0 : (b >= nbins ? nbins - 1 : b);
                h[b * nbins + a] += w[i];
            }
        }
    };

    if (n_threads == 1 || k == 1) {
        work(0, k);
        return 0;
    }
    std::vector<std::thread> threads;
    int64_t per = (k + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per;
        int64_t hi = lo + per < k ? lo + per : k;
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
    return 0;
}

// Column binning: the host parity path's kde_bandwidth.bin_samples inner
// loop ((x - lo) / dx floored int cast, clip to [0, nbins)); vectorized
// here with threads over columns. samples: (n, p) f64 row-major; out:
// (p, n) int32.
int gdt_bin_columns(const double* samples, int64_t n, int64_t p,
                    const double* range_min, const double* dx,
                    int64_t nbins, int32_t* out, int n_threads) {
    if (n < 0 || p <= 0 || nbins <= 0) return 1;
    if (n_threads < 1) n_threads = 1;

    auto work = [&](int64_t c_lo, int64_t c_hi) {
        for (int64_t c = c_lo; c < c_hi; ++c) {
            double lo = range_min[c];
            double d = dx[c];
            int32_t* row = out + c * n;
            for (int64_t i = 0; i < n; ++i) {
                // match numpy bit-for-bit: ((x - lo) / dx).astype(int)
                // truncates toward 0 — a true division, NOT multiplication
                // by the reciprocal (1-ulp differences at bin boundaries
                // would shift single counts and flip knife-edge ISJ roots)
                double v = (samples[i * p + c] - lo) / d;
                int64_t b = (int64_t)v;
                if (b < 0) b = 0;
                if (b >= nbins) b = nbins - 1;
                row[i] = (int32_t)b;
            }
        }
    };

    if (n_threads == 1 || p == 1) {
        work(0, p);
        return 0;
    }
    std::vector<std::thread> threads;
    int64_t per = (p + n_threads - 1) / n_threads;
    for (int t = 0; t < n_threads; ++t) {
        int64_t lo = t * per;
        int64_t hi = lo + per < p ? lo + per : p;
        if (lo >= hi) break;
        threads.emplace_back(work, lo, hi);
    }
    for (auto& th : threads) th.join();
    return 0;
}

}  // extern "C"
