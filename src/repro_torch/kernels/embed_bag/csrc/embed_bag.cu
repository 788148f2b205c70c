// EmbeddingBag(sum) for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/embed_bag/kernel.py::embed_bag_pallas.  Bag b covers
// the index positions [bag_ptr[b], bag_ptr[b + 1]); its output row is the
// sum of table[indices[p]] over those positions, in index order.  An
// entry below 0 is skipped (the pad id -1), an id >= V reads row V - 1
// (the reference's clipping gather) and an empty bag writes zeros.
// float32 sums in float32; bf16 rounds to bf16 after every add, as the
// TPU kernel's `out_ref += row.astype(out dtype)` does.
//
// What bounds it on the H100: the bytes.  A bag reads its live rows
// (D values each) and writes one row, one add per value read, so the
// bound is (live rows + bags) x D x the type's size over 3.35 TB/s.  The
// TPU kernel walked a sequential grid of one step per index and kept the
// bag's row resident in VMEM between consecutive steps.  Here blocks run
// in parallel and in no order, so one warp owns one whole bag: its lanes
// split the D columns (16-byte float4 loads when D is a multiple of 4 and
// the rows are 16-byte aligned: D = 128 float32 is one float4 per lane),
// and the warp walks the bag's rows in index order, keeping the sums in
// registers.  Nothing is shared between warps, so there are no atomics
// and the result is deterministic and independent of the launch's other
// bags: the same bag summed in two batches gives the same bits, which
// keeps the build's indexed == No-Index check exact.  The tables of the
// build (9,280 x 128 float32, 4.8 MB; a batch's 16,384 context rows,
// 8.4 MB) fit in the 50 MB L2.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;

__global__ void embed_bag_f32_kernel(const float* __restrict__ table,
                                     const int* __restrict__ indices,
                                     const int* __restrict__ bag_ptr,
                                     float* __restrict__ out, int n_rows,
                                     int d, int n_bags, int nnz, int vec) {
  const int bag = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) /
                        kWarp);
  const int lane = threadIdx.x % kWarp;
  if (bag >= n_bags) return;
  // bounds outside [0, nnz] clamp, so a bad bag_ptr reads nothing past
  // the indices
  const int start = min(max(__ldg(bag_ptr + bag), 0), nnz);
  const int end = min(max(__ldg(bag_ptr + bag + 1), start), nnz);
  float* o = out + (int64_t)bag * d;
  if (vec) {
    for (int c = lane * 4; c < d; c += kWarp * 4) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 4
      for (int p = start; p < end; ++p) {
        int r = __ldg(indices + p);
        if (r < 0) continue;
        r = min(r, n_rows - 1);
        const float4 v = __ldg(
            reinterpret_cast<const float4*>(table + (int64_t)r * d + c));
        acc.x += v.x;
        acc.y += v.y;
        acc.z += v.z;
        acc.w += v.w;
      }
      *reinterpret_cast<float4*>(o + c) = acc;
    }
    return;
  }
  for (int c = lane; c < d; c += kWarp) {
    float acc = 0.0f;
    for (int p = start; p < end; ++p) {
      int r = __ldg(indices + p);
      if (r < 0) continue;
      r = min(r, n_rows - 1);
      acc += __ldg(table + (int64_t)r * d + c);
    }
    o[c] = acc;
  }
}

__global__ void embed_bag_bf16_kernel(const __nv_bfloat16* __restrict__ table,
                                      const int* __restrict__ indices,
                                      const int* __restrict__ bag_ptr,
                                      __nv_bfloat16* __restrict__ out,
                                      int n_rows, int d, int n_bags,
                                      int nnz) {
  const int bag = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) /
                        kWarp);
  const int lane = threadIdx.x % kWarp;
  if (bag >= n_bags) return;
  // bounds outside [0, nnz] clamp, so a bad bag_ptr reads nothing past
  // the indices
  const int start = min(max(__ldg(bag_ptr + bag), 0), nnz);
  const int end = min(max(__ldg(bag_ptr + bag + 1), start), nnz);
  __nv_bfloat16* o = out + (int64_t)bag * d;
  for (int c = lane; c < d; c += kWarp) {
    float acc = 0.0f;
    for (int p = start; p < end; ++p) {
      int r = __ldg(indices + p);
      if (r < 0) continue;
      r = min(r, n_rows - 1);
      // the running sum is a bf16 value: round after every add
      acc = __bfloat162float(__float2bfloat16_rn(
          acc + __bfloat162float(table[(int64_t)r * d + c])));
    }
    o[c] = __float2bfloat16_rn(acc);
  }
}

}  // namespace

extern "C" {

// dtype: 0 float32, 1 bfloat16.  bag_ptr holds n_bags + 1 non-decreasing
// positions into the nnz indices.
int embed_bag_launch(const void* table, const int* indices,
                     const int* bag_ptr, void* out, int n_rows, int d,
                     int n_bags, int nnz, int dtype, cudaStream_t stream) {
  if (n_bags == 0 || d == 0) return 0;
  const int64_t threads = (int64_t)n_bags * kWarp;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  if (dtype == 0) {
    const int vec = (d % 4 == 0) &&
                    (reinterpret_cast<uintptr_t>(table) % 16 == 0) &&
                    (reinterpret_cast<uintptr_t>(out) % 16 == 0);
    embed_bag_f32_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(table), indices, bag_ptr,
        static_cast<float*>(out), n_rows, d, n_bags, nnz, vec);
  } else if (dtype == 1) {
    embed_bag_bf16_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(table), indices, bag_ptr,
        static_cast<__nv_bfloat16*>(out), n_rows, d, n_bags, nnz);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
