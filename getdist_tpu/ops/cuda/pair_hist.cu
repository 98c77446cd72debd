// Privatised shared-memory pair histograms for Hopper (sm_90a), called
// from JAX through the XLA FFI (getdist_tpu/ops/histograms.py).
//
// out[k, b, a] += w for every sample, with a = ix[pair_a[k], i] and
// b = ix[pair_b[k], i]. A 256x256 f32 tile (256 KB) exceeds a block's
// 227 KB of shared memory, so each block owns half the rows (128x256 f32 =
// 128 KB) of one pair's tile and a 1/splits slice of the samples.
// Shared-memory atomics accumulate; the flush is a plain store when one
// block owns the whole half tile (splits == 1), global atomics into a
// zeroed output otherwise. N must be a multiple of 4 (uchar4/float4 loads).

#include <cstdint>
#include <string>

#include <cuda_runtime.h>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kBins = 256;
constexpr int kHalf = 128;
constexpr int kThreads = 1024;

__device__ __forceinline__ void acc(float* hist, unsigned a, unsigned b, float w, unsigned half) {
  if ((b >> 7) == half) atomicAdd(&hist[(b & 127u) * kBins + a], w);
}

__global__ void __launch_bounds__(kThreads) pair_hist_kernel(
    const uint8_t* __restrict__ ix, const float* __restrict__ w, const int32_t* __restrict__ pa,
    const int32_t* __restrict__ pb, float* __restrict__ out, int64_t n, int splits) {
  extern __shared__ float hist[];
  const int k = blockIdx.x;
  const unsigned half = blockIdx.y;
  const int split = blockIdx.z;
  for (int i = threadIdx.x; i < kHalf * kBins; i += blockDim.x) hist[i] = 0.f;
  __syncthreads();

  const int64_t n4 = n / 4;
  const int64_t per = (n4 + splits - 1) / splits;
  const int64_t lo = per * split;
  const int64_t hi = min(n4, lo + per);
  const uchar4* ra = reinterpret_cast<const uchar4*>(ix + static_cast<int64_t>(pa[k]) * n);
  const uchar4* rb = reinterpret_cast<const uchar4*>(ix + static_cast<int64_t>(pb[k]) * n);
  const float4* w4p = reinterpret_cast<const float4*>(w);
  for (int64_t j = lo + threadIdx.x; j < hi; j += blockDim.x) {
    const uchar4 a4 = ra[j];
    const uchar4 b4 = rb[j];
    const float4 w4 = w4p[j];
    acc(hist, a4.x, b4.x, w4.x, half);
    acc(hist, a4.y, b4.y, w4.y, half);
    acc(hist, a4.z, b4.z, w4.z, half);
    acc(hist, a4.w, b4.w, w4.w, half);
  }
  __syncthreads();

  float* o = out + (static_cast<int64_t>(k) * kBins + half * kHalf) * kBins;
  if (splits == 1) {
    for (int i = threadIdx.x; i < kHalf * kBins; i += blockDim.x) o[i] = hist[i];
  } else {
    for (int i = threadIdx.x; i < kHalf * kBins; i += blockDim.x) {
      const float v = hist[i];
      if (v != 0.f) atomicAdd(&o[i], v);
    }
  }
}

ffi::Error PairHistImpl(cudaStream_t stream, ffi::Buffer<ffi::U8> ix, ffi::Buffer<ffi::F32> w,
                        ffi::Buffer<ffi::S32> pa, ffi::Buffer<ffi::S32> pb,
                        ffi::ResultBuffer<ffi::F32> out, int64_t splits) {
  const auto dims = ix.dimensions();
  if (dims.size() != 2) return ffi::Error::InvalidArgument("ix must be (P, N)");
  const int64_t n = dims[1];
  const int64_t k = pa.element_count();
  if (n % 4 != 0) return ffi::Error::InvalidArgument("N must be a multiple of 4");
  if (w.element_count() != n) return ffi::Error::InvalidArgument("weights must be (N,)");
  if (k == 0) return ffi::Error::Success();
  const size_t smem = sizeof(float) * kHalf * kBins;
  cudaFuncSetAttribute(pair_hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (splits > 1) {
    cudaMemsetAsync(out->typed_data(), 0, sizeof(float) * k * kBins * kBins, stream);
  }
  const dim3 grid(static_cast<unsigned>(k), 2, static_cast<unsigned>(splits));
  pair_hist_kernel<<<grid, kThreads, smem, stream>>>(ix.typed_data(), w.typed_data(), pa.typed_data(),
                                                      pb.typed_data(), out->typed_data(), n,
                                                      static_cast<int>(splits));
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return ffi::Error::Internal(std::string("pair_hist: ") + cudaGetErrorString(err));
  return ffi::Error::Success();
}

}  // namespace

XLA_FFI_DEFINE_HANDLER_SYMBOL(PairHist, PairHistImpl,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::Buffer<ffi::U8>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Attr<int64_t>("splits"));
