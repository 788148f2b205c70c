// SEINE's term x segment interaction pass for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/seg_interact/kernel.py::seg_interact_pallas, the
// paper's Vocab.cartesian(Segments).map(interaction).  For each doc b,
// term u and segment s it computes three atomic interaction values over
// the doc's tokens t with seg[b, t] == s:
//
//   dot   = sum_t e_u . e_t
//   cos   = sum_t (e_u . e_t) / (max(|e_u|, 1e-9) * max(|e_t|, 1e-9))
//   gauss = exp(max_t -(|e_u|^2 + |e_t|^2 - 2 e_u . e_t)), 0 if s is empty
//
// out (B, U, S, 3) f32 from e_term (B, U, De), e_tok (B, L, De), seg
// (B, L) int32 (a value outside [0, S) excludes the token) and term_ids
// (B, U) int32 (a negative id is a pad term: its rows are written as
// zeros and it costs nothing when a whole tile of terms is pad).
//
// Layout.  The TPU kernel padded every segment to one length Ls and ran a
// (vocab tile x segment) grid.  A TextTiling segment can span a whole doc,
// so padding each to the longest would multiply the work by up to S.
// Here segments are ragged: a block owns one doc and a tile of 64 terms
// and walks the doc's tokens in tiles of 64, in order.  Per token tile the
// 64 x 64 score tile e_u . e_t is a small f32 GEMM (64 threads, 8 x 8
// scores each, De staged through shared memory 16 at a time, sequential
// FMAs over De), parked in shared memory; then thread u walks the tile's
// tokens in order and folds each score into its term's (dot, cos, max)
// for the token's segment.  Running sums for the current segment stay in
// registers and are swapped with a per-(segment, term) table in shared
// memory only when the segment changes (TextTiling segments are
// contiguous, so that is about S times per doc).  Token tiles with no
// token in [0, S) are skipped.
//
// Deterministic.  Every (u, s) cell is accumulated by one thread in token
// order, every score by one thread in De order; no atomics.  A cell's
// value depends only on e_u and the doc's tokens, not on U, B or the
// tile the term lands in -- so the build's values (U = a doc's unique
// terms) and the No-Index path's (U = the query's terms) are the same
// bits.  Float32 FMA only: no TF32 or bf16 tensor cores.
//
// What bounds it on the H100.  A build batch (B = 32, U = 512, L = 512,
// De = 128) holds 17 MB of embeddings, but only ~180 terms and ~200
// tokens per doc are live: the function needs ~6 MB of their rows, the
// seg and id arrays, and writes 4 MB, ~3 us at 3.35 TB/s.  The products
// on the live pairs are ~0.3 GFLOP, ~4.5 us at the FP32 peak of 67
// TFLOP/s, so the operations bound it.  This first version is latency-bound instead: the products run on the
// FP32 pipes through a plain shared-memory tiling, a doc's live terms
// fill only ~3 blocks of 2 warps (about one block per SM at B = 32), and
// the OOV positions inside a token tile are multiplied too.  wgmma, TMA
// and compacting the live tokens are a later step.
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;  // 2 warps; thread i owns term i's sums
constexpr int kTU = 64;       // terms per block
constexpr int kTT = 64;       // tokens per tile
constexpr int kDK = 16;       // embedding depth staged per step
constexpr int kMicro = 8;     // each thread computes 8 x 8 scores
constexpr int kMaxSeg = 64;

__global__ void __launch_bounds__(kThreads)
    seg_interact_kernel(const float* __restrict__ e_term,
                        const float* __restrict__ e_tok,
                        const int* __restrict__ seg,
                        const int* __restrict__ term_ids,
                        float* __restrict__ out, int U, int L, int De,
                        int S) {
  __shared__ float a_s[kDK][kTU + 1];
  __shared__ float b_s[kDK][kTT + 1];
  __shared__ float score_s[kTU][kTT + 1];
  __shared__ float tok_t2[kTT];
  __shared__ float tok_inv[kTT];
  __shared__ int tok_seg[kTT];
  extern __shared__ float acc_s[];  // [S][3][kTU]: dot, cos, max

  const int b = blockIdx.x;
  const int u0 = blockIdx.y * kTU;
  const int tid = threadIdx.x;
  const int u = u0 + tid;
  const int64_t row_u = (int64_t)b * U + u;
  const bool live = u < U && __ldg(term_ids + row_u) >= 0;
  float* out_u = out + row_u * S * 3;

  if (!__syncthreads_or(live)) {  // a tile of pad terms
    if (u < U)
      for (int i = 0; i < S * 3; ++i) out_u[i] = 0.0f;
    return;
  }

  // the term's squared norm, sequential over De
  float v2 = 0.0f;
  if (u < U) {
    const float* e = e_term + row_u * De;
    for (int k = 0; k < De; ++k) v2 = fmaf(__ldg(e + k), __ldg(e + k), v2);
  }
  for (int s = 0; s < S; ++s) {
    acc_s[(s * 3 + 0) * kTU + tid] = 0.0f;
    acc_s[(s * 3 + 1) * kTU + tid] = 0.0f;
    acc_s[(s * 3 + 2) * kTU + tid] = -INFINITY;
  }

  const int tx = tid % kMicro, ty = tid / kMicro;
  const float* term_base = e_term + (int64_t)b * U * De;
  const float* tok_base = e_tok + (int64_t)b * L * De;
  int cur = -1;
  float r_dot = 0.0f, r_cos = 0.0f, r_max = -INFINITY;

  for (int t0 = 0; t0 < L; t0 += kTT) {
    const int t = t0 + tid;
    int sg = t < L ? __ldg(seg + (int64_t)b * L + t) : -1;
    const bool tok_live = sg >= 0 && sg < S;
    tok_seg[tid] = tok_live ? sg : -1;
    if (!__syncthreads_or(tok_live)) continue;  // uniform: no token here

    float acc[kMicro][kMicro];
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j) acc[i][j] = 0.0f;
    float t2 = 0.0f;

    for (int k0 = 0; k0 < De; k0 += kDK) {
#pragma unroll
      for (int i = 0; i < kDK * kTU / kThreads; ++i) {
        const int idx = i * kThreads + tid;
        const int r = idx / kDK, kk = idx % kDK, k = k0 + kk;
        a_s[kk][r] = (u0 + r < U && k < De)
                         ? __ldg(term_base + (int64_t)(u0 + r) * De + k)
                         : 0.0f;
        b_s[kk][r] = (t0 + r < L && k < De)
                         ? __ldg(tok_base + (int64_t)(t0 + r) * De + k)
                         : 0.0f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk)
        t2 = fmaf(b_s[kk][tid], b_s[kk][tid], t2);
#pragma unroll
      for (int kk = 0; kk < kDK; ++kk) {
        float av[kMicro], bv[kMicro];
#pragma unroll
        for (int i = 0; i < kMicro; ++i) av[i] = a_s[kk][ty + kMicro * i];
#pragma unroll
        for (int j = 0; j < kMicro; ++j) bv[j] = b_s[kk][tx + kMicro * j];
#pragma unroll
        for (int i = 0; i < kMicro; ++i)
#pragma unroll
          for (int j = 0; j < kMicro; ++j)
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }
    // zero-padded depth adds exact zeros, so every score is the plain
    // sequential FMA chain over k = 0 .. De - 1
#pragma unroll
    for (int i = 0; i < kMicro; ++i)
#pragma unroll
      for (int j = 0; j < kMicro; ++j)
        score_s[ty + kMicro * i][tx + kMicro * j] = acc[i][j];
    tok_t2[tid] = t2;
    tok_inv[tid] = 1.0f / fmaxf(sqrtf(t2), 1e-9f);
    __syncthreads();

    for (int j = 0; j < kTT; ++j) {
      const int s = tok_seg[j];
      if (s < 0) continue;
      if (s != cur) {  // swap this thread's running sums
        if (cur >= 0) {
          acc_s[(cur * 3 + 0) * kTU + tid] = r_dot;
          acc_s[(cur * 3 + 1) * kTU + tid] = r_cos;
          acc_s[(cur * 3 + 2) * kTU + tid] = r_max;
        }
        r_dot = acc_s[(s * 3 + 0) * kTU + tid];
        r_cos = acc_s[(s * 3 + 1) * kTU + tid];
        r_max = acc_s[(s * 3 + 2) * kTU + tid];
        cur = s;
      }
      const float sc = score_s[tid][j];
      r_dot += sc;
      r_cos = fmaf(sc, tok_inv[j], r_cos);
      const float d2 = (v2 + tok_t2[j]) - 2.0f * sc;
      r_max = fmaxf(r_max, -d2);
    }
    __syncthreads();  // the next tile overwrites score_s and tok_*
  }
  if (u >= U) return;
  if (cur >= 0) {
    acc_s[(cur * 3 + 0) * kTU + tid] = r_dot;
    acc_s[(cur * 3 + 1) * kTU + tid] = r_cos;
    acc_s[(cur * 3 + 2) * kTU + tid] = r_max;
  }
  const float inv_u = 1.0f / fmaxf(sqrtf(v2), 1e-9f);
  for (int s = 0; s < S; ++s) {
    float dot = 0.0f, cos = 0.0f, gauss = 0.0f;
    if (live) {
      dot = acc_s[(s * 3 + 0) * kTU + tid];
      cos = acc_s[(s * 3 + 1) * kTU + tid] * inv_u;
      const float m = acc_s[(s * 3 + 2) * kTU + tid];
      gauss = isfinite(m) ? expf(m) : 0.0f;
    }
    out_u[s * 3 + 0] = dot;
    out_u[s * 3 + 1] = cos;
    out_u[s * 3 + 2] = gauss;
  }
}

}  // namespace

extern "C" {

int seg_interact_launch(const float* e_term, const float* e_tok,
                        const int* seg, const int* term_ids, float* out,
                        int B, int U, int L, int De, int S,
                        cudaStream_t stream) {
  if (B == 0 || U == 0) return 0;
  if (S < 1 || S > kMaxSeg || De < 1) return (int)cudaErrorInvalidValue;
  const int dyn = S * 3 * kTU * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      seg_interact_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned)B, (unsigned)((U + kTU - 1) / kTU));
  seg_interact_kernel<<<grid, kThreads, dyn, stream>>>(
      e_term, e_tok, seg, term_ids, out, U, L, De, S);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
