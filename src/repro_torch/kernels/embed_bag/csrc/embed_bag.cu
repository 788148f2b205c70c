// EmbeddingBag(sum) for Hopper (sm_90a), with two entries.
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/embed_bag/kernel.py::embed_bag_pallas, which sums
// table rows into bags sorted by id, in index order.  An entry below 0 is
// skipped (the pad id -1), an id >= V reads row V - 1 (the reference's
// clipping gather) and an empty bag writes zeros.  float32 sums in
// float32; bf16 rounds to bf16 after every add, as the TPU kernel's
// `out_ref += row.astype(out dtype)` does.
//
// The CSR entry (embed_bag_f32_kernel, embed_bag_bf16_kernel): bag b
// covers the index positions [bag_ptr[b], bag_ptr[b + 1]).
//
// The segment entry (embed_bag_segment_kernel), the build's path: per doc
// d, int64 rows (n_docs, n) (negative: skipped) fall in int64 bins
// (n_docs, n), clamped into [0, n_bins); out[d, j] sums the rows of bin
// j in token order.  It does the bagging itself, so a build batch's segment sums
// are one launch: before it the host side sorted the (doc, bin) keys,
// searched the bag bounds and cast them, about ten launches per call.
// One block per doc and group of 8 bins stages the doc's n (row, bin)
// pairs in shared memory (8 n bytes, 4 KB at n = 512); each warp takes
// one bin and finds its tokens 32 at a time with __ballot_sync, in token
// order.  The rows and their order are those of the sort-based bagging,
// so the sums are bitwise those of the CSR entry over the sorted bags.
//
// What bounds it on the H100: the bytes.  A bag reads its live rows
// (D values each) and writes one row, one add per value read, so the
// bound is (live rows + bags) x D x the type's size over 3.35 TB/s.  The
// TPU kernel walked a sequential grid of one step per index and kept the
// bag's row resident in VMEM between consecutive steps.  Here one warp
// owns one whole bag: its lanes split the D columns (16-byte float4 loads
// when D is a multiple of 4 and the rows are 16-byte aligned: D = 128
// float32 is one float4 per lane) and keep the sums in registers, so
// there are no atomics and the result is deterministic and independent of
// the launch's other bags (the same bag summed in two batches gives the
// same bits, which keeps the build's indexed == No-Index check exact).
// A bag is a chain of dependent loads (index, then row), and at the
// provider mix a doc whose tokens share one segment makes a bag hundreds
// of rows long, so the longest bag sets a launch's time.  The lanes load
// 32 of the bag's indices at once, coalesced, and broadcast them with
// __shfl_sync; the warp then issues the row loads of the next kAhead live
// rows before it adds them in order, so the chain is the adds, not one
// L2 round trip per row.  -1 entries leave the ballot's mask and never
// enter the load chain.  The tables of the build (9,280 x 128 float32,
// 4.8 MB; a batch's 16,384 context rows, 8.4 MB) fit in the 50 MB L2.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 5;
// PERF.md section 6 keeps the numbers): at the provider mix / at
// log_cond_prob's shape the segment entry takes 0.017 / 0.026 ms and the
// CSR entry 0.016 / 0.024 ms, against 0.024 / 0.048 ms for
// F.embedding_bag; the first version, one dependent load after another,
// took 0.032 / 0.064 ms for the CSR entry alone.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarp = 32;
constexpr int kThreads = 256;      // CSR entry: 8 bags per block
constexpr int kSegWarps = 8;       // segment entry: bins per block
constexpr int kAhead = 8;          // row loads in flight per warp
constexpr unsigned kFull = 0xffffffffu;

// Adds, in lane order, the table rows that the lanes hold in `r` (-1: no
// row): the live lanes leave the ballot's mask in order, kAhead at a
// time, each row broadcast to the warp; all kAhead loads are issued
// before the first add.  `r` and everything derived from the mask are
// warp-uniform, so the warp never diverges.
template <typename Load, typename Add>
__device__ __forceinline__ void add_chunk(int r, Load load, Add add) {
  using V = decltype(load(0));
  unsigned live = __ballot_sync(kFull, r >= 0);
  while (live) {
    int rows[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int got = __shfl_sync(kFull, r, live ? __ffs(live) - 1 : 0);
      rows[u] = live ? got : -1;
      live &= live - 1;
    }
    V v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (rows[u] >= 0) v[u] = load(rows[u]);
#pragma unroll
    for (int u = 0; u < kAhead; ++u)
      if (rows[u] >= 0) add(v[u]);
  }
}

// One warp sums the rows that row_at(i) gives for i in [0, n) (-1: none),
// in order of i, into out_row (D values).  float32.
template <typename RowAt>
__device__ __forceinline__ void warp_bag(const float* __restrict__ table,
                                         int d, int vec, int n,
                                         RowAt row_at, float* out_row,
                                         int lane) {
  if (vec) {
    for (int c0 = 0; c0 < d; c0 += kWarp * 4) {
      const int c = c0 + lane * 4;
      const bool on = c < d;
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      for (int base = 0; base < n; base += kWarp)
        add_chunk(
            row_at(base + lane),
            [&](int row) {
              return on ? __ldg(reinterpret_cast<const float4*>(
                              table + (int64_t)row * d + c))
                        : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
            },
            [&](const float4& x) {
              acc.x += x.x;
              acc.y += x.y;
              acc.z += x.z;
              acc.w += x.w;
            });
      if (on) *reinterpret_cast<float4*>(out_row + c) = acc;
    }
    return;
  }
  for (int c0 = 0; c0 < d; c0 += kWarp) {
    const int c = c0 + lane;
    const bool on = c < d;
    float acc = 0.0f;
    for (int base = 0; base < n; base += kWarp)
      add_chunk(
          row_at(base + lane),
          [&](int row) {
            return on ? __ldg(table + (int64_t)row * d + c) : 0.0f;
          },
          [&](float x) { acc += x; });
    if (on) out_row[c] = acc;
  }
}

// The same in bf16: the running sum is a bf16 value, rounded after every
// add.
template <typename RowAt>
__device__ __forceinline__ void warp_bag(
    const __nv_bfloat16* __restrict__ table, int d, int /*vec*/, int n,
    RowAt row_at, __nv_bfloat16* out_row, int lane) {
  for (int c0 = 0; c0 < d; c0 += kWarp) {
    const int c = c0 + lane;
    const bool on = c < d;
    float acc = 0.0f;
    for (int base = 0; base < n; base += kWarp)
      add_chunk(
          row_at(base + lane),
          [&](int row) {
            return on ? __bfloat162float(table[(int64_t)row * d + c]) : 0.0f;
          },
          [&](float x) {
            acc = __bfloat162float(__float2bfloat16_rn(acc + x));
          });
    if (on) out_row[c] = __float2bfloat16_rn(acc);
  }
}

// The CSR entry's body: one warp per bag.
template <typename T>
__device__ __forceinline__ void csr_bags(const T* __restrict__ table,
                                         const int* __restrict__ indices,
                                         const int* __restrict__ bag_ptr,
                                         T* __restrict__ out, int n_rows,
                                         int d, int n_bags, int nnz,
                                         int vec) {
  const int bag = (int)((blockIdx.x * (int64_t)blockDim.x + threadIdx.x) /
                        kWarp);
  const int lane = threadIdx.x % kWarp;
  if (bag >= n_bags) return;   // whole warps: blockDim is a multiple of 32
  // bounds outside [0, nnz] clamp, so a bad bag_ptr reads nothing past
  // the indices
  const int start = min(max(__ldg(bag_ptr + bag), 0), nnz);
  const int end = min(max(__ldg(bag_ptr + bag + 1), start), nnz);
  warp_bag(
      table, d, vec, end - start,
      [&](int i) {
        const int r = start + i < end ? __ldg(indices + start + i) : -1;
        return r < 0 ? -1 : min(r, n_rows - 1);
      },
      out + (int64_t)bag * d, lane);
}

// CUPTI names: embed_bag_f32_kernel / embed_bag_bf16_kernel
__global__ void embed_bag_f32_kernel(const float* table, const int* indices,
                                     const int* bag_ptr, float* out,
                                     int n_rows, int d, int n_bags, int nnz,
                                     int vec) {
  csr_bags<float>(table, indices, bag_ptr, out, n_rows, d, n_bags, nnz,
                  vec);
}
__global__ void embed_bag_bf16_kernel(const __nv_bfloat16* table,
                                      const int* indices, const int* bag_ptr,
                                      __nv_bfloat16* out, int n_rows, int d,
                                      int n_bags, int nnz, int vec) {
  csr_bags<__nv_bfloat16>(table, indices, bag_ptr, out, n_rows, d, n_bags,
                          nnz, vec);
}

template <typename T>
__global__ void __launch_bounds__(kSegWarps * kWarp)
    embed_bag_segment_kernel(const T* __restrict__ table,
                             const int64_t* __restrict__ rows,
                             const int64_t* __restrict__ bins,
                             T* __restrict__ out, int n_rows, int d, int n,
                             int n_bins, int vec) {
  extern __shared__ int seg_smem[];
  int* row_s = seg_smem;        // [n] clamped row, -1 skipped
  int* bin_s = seg_smem + n;    // [n] bin clamped into [0, n_bins)
  // block (doc, group): the doc's bins group * kSegWarps .. , one per warp
  const int n_groups = (n_bins + kSegWarps - 1) / kSegWarps;
  const int64_t doc = blockIdx.x / n_groups;
  const int bin = (int)(blockIdx.x % n_groups) * kSegWarps +
                  (int)threadIdx.x / kWarp;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int64_t r = rows[doc * n + i];
    const int64_t b = bins[doc * n + i];
    row_s[i] = r < 0 ? -1 : (int)(r < n_rows ? r : n_rows - 1);
    bin_s[i] = (int)(b < 0 ? 0 : (b < n_bins ? b : n_bins - 1));
  }
  __syncthreads();
  if (bin >= n_bins) return;   // whole warps
  warp_bag(
      table, d, vec, n,
      [&](int i) { return i < n && bin_s[i] == bin ? row_s[i] : -1; },
      out + (doc * n_bins + bin) * d, (int)threadIdx.x % kWarp);
}

template <typename T>
int launch_segment(const void* table, const int64_t* rows,
                   const int64_t* bins, void* out, int n_rows, int d,
                   int n_docs, int n, int n_bins, int vec,
                   cudaStream_t stream) {
  const int smem = 2 * n * (int)sizeof(int);
  const int64_t blocks =
      (int64_t)n_docs * ((n_bins + kSegWarps - 1) / kSegWarps);
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  embed_bag_segment_kernel<T>
      <<<(unsigned)blocks, kSegWarps * kWarp, smem, stream>>>(
          static_cast<const T*>(table), rows, bins, static_cast<T*>(out),
          n_rows, d, n, n_bins, vec);
  return (int)cudaGetLastError();
}

int aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
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
    const int vec = d % 4 == 0 && aligned16(table) && aligned16(out);
    embed_bag_f32_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const float*>(table), indices, bag_ptr,
        static_cast<float*>(out), n_rows, d, n_bags, nnz, vec);
  } else if (dtype == 1) {
    embed_bag_bf16_kernel<<<blocks, kThreads, 0, stream>>>(
        static_cast<const __nv_bfloat16*>(table), indices, bag_ptr,
        static_cast<__nv_bfloat16*>(out), n_rows, d, n_bags, nnz, 0);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// rows, bins (n_docs, n) int64 -> out (n_docs, n_bins, d); dtype as
// above.  8 n bytes of shared memory per block.
int embed_bag_segment_launch(const void* table, const int64_t* rows,
                             const int64_t* bins, void* out, int n_rows,
                             int d, int n_docs, int n, int n_bins, int dtype,
                             cudaStream_t stream) {
  if (n_docs == 0 || n_bins == 0 || d == 0) return 0;
  if (n_rows < 1 || n < 0) return (int)cudaErrorInvalidValue;
  if (dtype == 0)
    return launch_segment<float>(
        table, rows, bins, out, n_rows, d, n_docs, n, n_bins,
        d % 4 == 0 && aligned16(table) && aligned16(out), stream);
  if (dtype == 1)
    return launch_segment<__nv_bfloat16>(table, rows, bins, out, n_rows, d,
                                         n_docs, n, n_bins, 0, stream);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
