// KNRM's RBF kernel bank with segment pooling, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/knrm_pool/kernel.py::knrm_pool_pallas.  For each
// (candidate b, query term q) row of cos_norm (B, Q, n_b) it evaluates the
// 11 RBF kernels exp(-0.5 * ((c - mu_k) / sigma_k)^2) (mu_0 = 1.0 with
// sigma 1e-3, the exact-match kernel; mu_k = 1.1 - 0.2k with sigma 0.1),
// masks each segment by seg_mask (B, n_b), sums over the n_b segments and
// writes log1p of the 11 sums to out (B, Q, 11).
//
// What bounds it on the H100: at the serving shape (1,000 candidates x 6
// slots x n_b 20) the exponentials on the SFUs (at most 1.32M, ~0.3 us;
// a masked segment needs none) and the 0.8 MB moved (~0.25 us) -- far
// under a launch, so the kernel has to reach the whole card at once and
// keep its dependent chain short.  The TPU kernel kept the (block_q, n_b,
// 11) tile in VMEM so the 11x-inflated kernel tensor never reached HBM;
// here each CTA owns kRows consecutive (b, q) rows:
//
//  - it stages their kRows * n_b cos_norm floats (contiguous) and the
//    mask rows of their candidates (contiguous too) in shared memory,
//    in 16-byte vectors when the buffers are 16-byte aligned and n_b is a
//    multiple of 4, one float at a time otherwise;
//  - one thread per (row, kernel) output sums its kernel over the n_b
//    segments from shared memory, in segment order, as
//    exp2(a_k * (c - mu_k)^2) * m with a_k = -0.5 * log2(e) / sigma_k^2
//    folded into a float32 constant: no division, one multiply less than
//    the reference's form, and within 4% of the rtol 1e-5 / atol 1e-6
//    bar of the reference's exp (most on the exact-match kernel, c in
//    [0.99, 1.0], where c - 1 is exact);
//  - thread t writes element t of the CTA's (kRows, 11) output tile,
//    which is contiguous in out, so the store is coalesced.
//
// kRows = 16 gives 176 busy threads of 192 and 375 CTAs at the serving
// shape's 6,000 rows: every SM of the 132 holds two or three.
//
// Any n_b: past kChunk = 1,024 segments (2 * kRows * kChunk floats,
// 128 KB of shared memory) a CTA walks them in chunks of kChunk, staging
// each chunk's slice of its rows and mask rows in turn; each (row,
// kernel) thread carries its running sum from chunk to chunk, so the sum
// still runs over s = 0 .. n_b - 1 in order.  At n_b <= kChunk the
// kernel is compiled without the chunk loop (kChunked = false) and stages
// the rows whole, so its code, its bits and its time are as before.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kKernels = 11;
constexpr int kRows = 16;
constexpr int kThreads = 192;   // kRows * kKernels = 176, rounded to warps
constexpr int kChunk = 1024;    // segments staged at a time
static_assert(kRows * kKernels <= kThreads, "a thread per output");

// the reference's float32 constants, retrievers/knrm.py::MUS, and
// -0.5 * log2(e) / SIGMAS^2 of its float32 SIGMAS (1e-3 for the
// exact-match kernel, 0.1 for the rest), rounded once to float32
__constant__ float kMus[kKernels] = {1.0f,  0.9f,  0.7f,  0.5f,
                                     0.3f,  0.1f,  -0.1f, -0.3f,
                                     -0.5f, -0.7f, -0.9f};
__constant__ float kScale[kKernels] = {
    -721347.438f, -72.1347504f, -72.1347504f, -72.1347504f,
    -72.1347504f, -72.1347504f, -72.1347504f, -72.1347504f,
    -72.1347504f, -72.1347504f, -72.1347504f};

// n contiguous floats from src to dst, by the CTA's threads
template <bool kVec>
__device__ __forceinline__ void stage(float* __restrict__ dst,
                                      const float* __restrict__ src, int n) {
  if constexpr (kVec) {     // n % 4 == 0, src and dst 16-byte aligned
    for (int i = threadIdx.x; i < n / 4; i += blockDim.x)
      reinterpret_cast<float4*>(dst)[i] =
          __ldg(reinterpret_cast<const float4*>(src) + i);
  } else {
    for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = __ldg(src + i);
  }
}

// rows x w floats, row r read from src + r * stride and written to
// dst + r * ld: one chunk of several rows
template <bool kVec>
__device__ __forceinline__ void stage_rows(float* __restrict__ dst,
                                           const float* __restrict__ src,
                                           int rows, int w, int stride,
                                           int ld) {
  if constexpr (kVec) {     // w, stride, ld % 4 == 0, 16-byte aligned
    const int wv = w / 4;
    for (int i = threadIdx.x; i < rows * wv; i += blockDim.x) {
      const int r = i / wv, c = i - r * wv;
      reinterpret_cast<float4*>(dst + r * ld)[c] = __ldg(
          reinterpret_cast<const float4*>(src + (int64_t)r * stride) + c);
    }
  } else {
    for (int i = threadIdx.x; i < rows * w; i += blockDim.x) {
      const int r = i / w, c = i - r * w;
      dst[r * ld + c] = __ldg(src + (int64_t)r * stride + c);
    }
  }
}

template <bool kVec, bool kChunked>
__global__ void __launch_bounds__(kThreads) knrm_pool_kernel(
    const float* __restrict__ cos_norm, const float* __restrict__ seg_mask,
    float* __restrict__ out, int n_q, int n_b, int n_rows) {
  extern __shared__ __align__(16) float smem[];
  const int r0 = blockIdx.x * kRows;
  const int rows = min(kRows, n_rows - r0);
  const int b0 = r0 / n_q;
  const int n_cand = (r0 + rows - 1) / n_q - b0 + 1;
  const int t = threadIdx.x;
  const int r = t / kKernels, k = t - r * kKernels;
  if constexpr (!kChunked) {        // n_b <= kChunk: the rows whole
    float* c_s = smem;                              // (rows, n_b)
    float* m_s = smem + kRows * n_b;                // (n_cand, n_b)
    stage<kVec>(c_s, cos_norm + (int64_t)r0 * n_b, rows * n_b);
    stage<kVec>(m_s, seg_mask + (int64_t)b0 * n_b, n_cand * n_b);
    __syncthreads();
    if (r >= rows) return;
    const float mu = kMus[k], a = kScale[k];
    const float* c_row = c_s + r * n_b;
    const float* m_row = m_s + ((r0 + r) / n_q - b0) * n_b;
    float acc = 0.0f;
#pragma unroll 4
    for (int s = 0; s < n_b; ++s) {
      const float d = c_row[s] - mu;
      acc += exp2f(a * (d * d)) * m_row[s];
    }
    out[(int64_t)r0 * kKernels + t] = log1pf(acc);
  } else {                          // chunks of kChunk segments
    float* c_s = smem;                              // (rows, kChunk)
    float* m_s = smem + kRows * kChunk;             // (n_cand, kChunk)
    const bool busy = r < rows;
    const float mu = kMus[k], a = kScale[k];
    const float* c_row = c_s + r * kChunk;
    const float* m_row = m_s + (busy ? (r0 + r) / n_q - b0 : 0) * kChunk;
    float acc = 0.0f;
    for (int s0 = 0; s0 < n_b; s0 += kChunk) {
      const int w = min(kChunk, n_b - s0);
      if (s0 > 0) __syncthreads();  // every thread is done with the last
      stage_rows<kVec>(c_s, cos_norm + (int64_t)r0 * n_b + s0, rows, w, n_b,
                       kChunk);
      stage_rows<kVec>(m_s, seg_mask + (int64_t)b0 * n_b + s0, n_cand, w,
                       n_b, kChunk);
      __syncthreads();
      if (busy) {
#pragma unroll 4
        for (int s = 0; s < w; ++s) {
          const float d = c_row[s] - mu;
          acc += exp2f(a * (d * d)) * m_row[s];
        }
      }
    }
    if (busy) out[(int64_t)r0 * kKernels + t] = log1pf(acc);
  }
}

template <bool kVec, bool kChunked>
int launch(const float* cos_norm, const float* seg_mask, float* out,
           int n_q, int n_b, int rows, cudaStream_t stream) {
  const unsigned grid = (unsigned)((rows + kRows - 1) / kRows);
  // a tile's rows touch at most kRows candidates' masks
  const size_t smem =
      (size_t)2 * kRows * (kChunked ? kChunk : n_b) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        knrm_pool_kernel<kVec, kChunked>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  knrm_pool_kernel<kVec, kChunked><<<grid, kThreads, smem, stream>>>(
      cos_norm, seg_mask, out, n_q, n_b, rows);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

int knrm_pool_launch(const float* cos_norm, const float* seg_mask,
                     float* out, int n_cand, int n_q, int n_b,
                     cudaStream_t stream) {
  const int64_t rows = (int64_t)n_cand * n_q;
  if (rows == 0) return 0;
  if (rows > INT_MAX - kRows) return (int)cudaErrorInvalidValue;  // int32
  const bool vec = n_b % 4 == 0 && (uintptr_t)cos_norm % 16 == 0 &&
                   (uintptr_t)seg_mask % 16 == 0;
  const int n = (int)rows;
  if (n_b <= kChunk)
    return vec ? launch<true, false>(cos_norm, seg_mask, out, n_q, n_b, n,
                                     stream)
               : launch<false, false>(cos_norm, seg_mask, out, n_q, n_b, n,
                                      stream);
  return vec ? launch<true, true>(cos_norm, seg_mask, out, n_q, n_b, n,
                                  stream)
             : launch<false, true>(cos_norm, seg_mask, out, n_q, n_b, n,
                                   stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
