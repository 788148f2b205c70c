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
// What bounds it on the H100: the bytes.  A row reads n_b floats and
// writes 11; the 11 * n_b exponentials are ~15 flops per byte read, under
// the card's fp32 ridge of ~20.  The TPU kernel kept the (block_q, n_b,
// 11) tile in VMEM so the 11x-inflated kernel tensor never reached HBM;
// here one thread owns one row and keeps its 11 running sums in
// registers, so the only traffic is cos_norm in, the mask (shared by the
// Q rows of a candidate, served from L1/L2) and the (B, Q, 11) result out.
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kKernels = 11;
// the reference's float32 constants, retrievers/knrm.py::MUS and SIGMAS
__constant__ float kMus[kKernels] = {1.0f,  0.9f,  0.7f,  0.5f,
                                     0.3f,  0.1f,  -0.1f, -0.3f,
                                     -0.5f, -0.7f, -0.9f};
__constant__ float kSigmas[kKernels] = {0.001f, 0.1f, 0.1f, 0.1f,
                                        0.1f,   0.1f, 0.1f, 0.1f,
                                        0.1f,   0.1f, 0.1f};

__global__ void knrm_pool_kernel(const float* __restrict__ cos_norm,
                                 const float* __restrict__ seg_mask,
                                 float* __restrict__ out, int n_q, int n_b,
                                 int64_t n_rows) {
  const int64_t row = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= n_rows) return;
  const float* c_row = cos_norm + row * n_b;
  const float* m_row = seg_mask + (row / n_q) * n_b;
  float acc[kKernels];
#pragma unroll
  for (int k = 0; k < kKernels; ++k) acc[k] = 0.0f;
  for (int s = 0; s < n_b; ++s) {
    const float c = __ldg(c_row + s);
    const float m = __ldg(m_row + s);
#pragma unroll
    for (int k = 0; k < kKernels; ++k) {
      const float z = (c - kMus[k]) / kSigmas[k];
      acc[k] += expf(-0.5f * (z * z)) * m;
    }
  }
  float* o = out + row * kKernels;
#pragma unroll
  for (int k = 0; k < kKernels; ++k) o[k] = log1pf(acc[k]);
}

}  // namespace

extern "C" {

int knrm_pool_launch(const float* cos_norm, const float* seg_mask,
                     float* out, int n_cand, int n_q, int n_b,
                     cudaStream_t stream) {
  const int64_t rows = (int64_t)n_cand * n_q;
  if (rows == 0) return 0;
  const int threads = 128;
  knrm_pool_kernel<<<(unsigned)((rows + threads - 1) / threads), threads, 0,
                     stream>>>(cos_norm, seg_mask, out, n_q, n_b, rows);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
