// Causal or full grouped-query attention backward for Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package takes this gradient with
// jax.grad of models/layers.py::gqa_attention, the jnp stand-in its model
// names for src/repro/kernels/flash_attn (the Pallas kernel has no
// backward).  The port's forward is the hand-written flash_attn.cu, which
// autograd cannot differentiate, so its gradient is this kernel.
//
// Given q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd), the forward's output
// o (B, Sq, Hq, hd) and its per-row log-sum-exp lse (B, Hq, Sq) float32
// (ln sum_t exp(q . k_t / sqrt(hd)), as flash_attn.cu writes it), and dO
// (B, Sq, Hq, hd), all contiguous in one type, float32 or bfloat16, it
// writes dQ, dK and dV in that type:
//
//   D  = rowsum(dO o O)                       (per query row, float32)
//   P  = exp(S - lse),   S = q . k^T / sqrt(hd), 0 where masked
//   dP = dO . V^T,       dS = P o (dP - D)
//   dQ = dS . K / sqrt(hd),   dK = dS^T . Q / sqrt(hd),   dV = P^T . dO
//
// under the forward's causal mask (query s sees keys t <= s, both from 0)
// or none.  dK and dV of a KV head sum over its G = Hq / Hkv query heads,
// as the reference's gqa_attention computes in float32.
//
// Two kernels, no atomics, so the bits depend only on the inputs:
//   the dQ kernel, one block per (b, h, 64 query rows): D of its rows
//     (written to a float32 scratch for the second kernel), then over the
//     KV tiles at or below the diagonal: dP, S -> P -> dS, and dQ += dS .
//     K, the tiles in order;
//   the dK / dV kernel, one block per (b, kv head, 64 keys): over the G
//     query heads in order, and for each over the query tiles at or below
//     the diagonal in order: S^T -> P^T, dP^T -> dS^T, dV += P^T . dO and
//     dK += dS^T . Q.
// The second runs after the first on the stream and reads its D.  Blocks
// are numbered heaviest first.  No length needs to be a multiple of 64:
// tail rows load as zeros and are masked (a tail query's lse reads as
// +inf, so its P is 0).  A one-pass design that kept dQ's partial sums in
// a fixed-order scratch instead of recomputing S and dP would write and
// read (B, Hq, KV tile, query rows below it, hd) float32, 1.14 GB at
// stablelm-1.6b's shape: more time than the recompute.
//
// What bounds it on the H100.  At stablelm-1.6b's training shape (B 16,
// S 1,024, 32 / 32 heads of 64, causal, bf16) the five products do 10 hd
// flops per (query, key) pair at or below the diagonal, 1.72e11 flops,
// 0.174 ms at the bf16 tensor cores' 989 TFLOP/s; q, k, v, o, dO, lse in
// and dQ, dK, dV out are 0.54 GB, 0.161 ms at 3.35 TB/s.  This design
// does 20 hd: S and dP in both kernels, and dQ, dK and dV each from two
// bf16 parts, 3.44e11 flops, 0.348 ms.
//
// bfloat16 (the LM training path): flash_attn_bwd_dq_wgmma and
// flash_attn_bwd_dkdv_wgmma, warp-specialised as flash_attn.cu's forward
// (sm90.cuh holds the tiles, descriptors, barriers, TMA and wgmma forms).
// One producer warp issues every load with TMA (4-D tensor maps over (B,
// S, H, hd), 64-row boxes in the tile's swizzle; rows past the sequence
// land as zeros) into two-stage rings with a full and an empty mbarrier
// per stage; one consumer warpgroup runs all five products as wgmma, bf16
// x bf16 into float32 registers:
//   dQ kernel: Q and dO once, K and V through rings.  Per KV tile: S =
//     Q . K^T and dP = dO . V^T as m64n64k16 from shared memory, both
//     K-major; P = 2^(S scale log2 e - lse log2 e), the scale fused into
//     the exponent's FMA (q is never rounded after scaling); dS = P o (dP
//     - D); dQ += dS . K with dS from registers (the accumulator's
//     fragment is wgmma's register-A layout) and K read MN-major through
//     the transpose bit.  D comes from dO and O read once from device
//     memory by the 4 lanes that share a fragment row.
//   dK / dV kernel: K and V once, Q and dO through a ring; the producer's
//     32 lanes also write each query tile's 64 lse (exp2 units) and D
//     beside it, since they belong to the accumulator's column.  S^T = K .
//     Q^T and dP^T = V . dO^T (ss); P^T while dP^T runs; dV += P^T . dO
//     (rs, dO MN-major); dS^T = (P^T's two parts, summed) o (dP^T - D)
//     while dV runs; dK += dS^T . Q (rs).  Forming dS^T from P^T's parts
//     frees P^T's 32 registers: blocks of 160 threads get two to an SM
//     only at <= 168 registers a thread.
// P and dS enter their products as two bf16 parts, hi = bf16(x) and lo =
// bf16(x - hi), two wgmmas per 16-key step: hi + lo holds x to about
// 2^-16, which keeps the reference's float32 arithmetic (the forward's
// note: one bf16 rounding of p drifts a bf16 LM past 2e-2).  The causal
// mask runs only on tiles that straddle the diagonal, the key tail only on
// the dQ kernel's last tile (the dK / dV kernel never stores keys past
// Skv).  Epilogues: dQ and dK times 1/sqrt(hd), staged as bf16 through a
// tile no longer read, written with 16-byte stores.
//
// ptxas (-Xptxas -v, chip_smoke.py phase 0), registers a thread and
// spills: dQ 102 / 112 / 128 / 160 at hd 16 / 32 / 64 / 128, none; dK /
// dV 158 / 168 / 168 / 255, spilling 32 bytes at hd 64 and 8 at hd 128
// (hd 128 runs one block an SM).  No wgmma is serialized.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUPTI, both kernels;
// PERF.md section 6 row 8b keeps the numbers and their runs): 0.865 ms a
// call at stablelm's shape (dQ 0.321, dK / dV 0.544; 398 TFLOP/s of the
// design's 20 hd flops, 199 of the function's 10 hd), against 8.34 ms
// for the FMA kernels this replaces and 0.75 ms for the backward of
// scaled_dot_product_attention.  The serial chain of a dK / dV tile
// bounds it: without the dK product and the dS^T work before it the dK /
// dV kernel takes 0.304 ms; with P and dS in one bf16 part (not shipped:
// the precision above) the call takes 0.778 ms; without the exp2, 0.841.
// Issuing tile t's S and dP beside tile t - 1's dQ product, three dQ
// blocks an SM, and a third ring stage measured no faster.
//
// float32 (tests and the wiring check; its bar, rtol 1e-4 / atol 1e-5,
// rules out the bf16 and TF32 tensor cores): flash_attn_bwd_dq_kernel and
// flash_attn_bwd_dkdv_kernel, FMAs on the CUDA cores.  Each block is 256
// threads as a 16 x 16 grid, as the forward's float32 kernel: thread (ty,
// tx) owns tile rows 4 ty .. 4 ty + 3 and the columns tx + 16 j; the row
// tiles (Q pre-scaled by 1/sqrt(hd), dO, K, V) sit in shared memory as
// [64][hd + 4]; P and dS cross to the products that sum over the tile
// through a [64][68] buffer.  On the CUDA cores' 67 TFLOP/s (14 hd flops a
// pair) it can be no faster than 3.6 ms at stablelm's shape.
//
#include <cmath>
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------------------
// float32: FMAs from shared memory
// ---------------------------------------------------------------------------

constexpr int kThreads = 256;  // 16 x 16
constexpr int kB = 64;         // rows per tile: queries, and keys
constexpr int kRows = kB / 16; // tile rows per thread
constexpr int kCols = kB / 16; // tile columns per thread
constexpr int kLdP = kB + 4;   // the two half-warps hit other banks

// four consecutive values
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// a tile of 64 rows of HD values, rows [0, n_rows) from src (row stride
// `stride` elements) times s, the rest zero, into dst [64][HD + 4]
template <int HD>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int64_t stride, int n_rows,
                                          float s, float* dst) {
  constexpr int V = HD / 4;
  for (int i = threadIdx.x; i < kB * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows) x = load4(src + r * stride + c);
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + c) =
        make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
  }
}

// sum over the 16 lanes of a half-warp (one tile row)
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// acc[i][j] = a[4 ty + i] . b[tx + 16 j] over HD, a and b [64][HD + 4]
template <int HD>
__device__ __forceinline__ void tile_dots(const float* a, const float* b,
                                          int ty, int tx,
                                          float (&acc)[kRows][kCols]) {
  constexpr int LD = HD + 4;
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 bv[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j)
      bv[j] = *reinterpret_cast<const float4*>(b + (tx + 16 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float4 av =
          *reinterpret_cast<const float4*>(a + (ty * kRows + i) * LD + d);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        acc[i][j] = fmaf(av.x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av.y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av.z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av.w, bv[j].w, acc[i][j]);
      }
    }
  }
}

// out[4 ty + i][tx + 16 c] += sum_t w[4 ty + i][t] * x[t][tx + 16 c]:
// w [64][kLdP], x [64][HD + 4], t in key (or query) order
template <int HD>
__device__ __forceinline__ void tile_product(const float* w, const float* x,
                                             int ty, int tx,
                                             float (&out)[kRows][HD / 16]) {
  constexpr int LD = HD + 4;
  constexpr int NC = HD / 16;
#pragma unroll 4
  for (int t = 0; t < kB; ++t) {
    float xv[NC];
#pragma unroll
    for (int c = 0; c < NC; ++c) xv[c] = x[t * LD + tx + 16 * c];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const float wv = w[(ty * kRows + i) * kLdP + t];
#pragma unroll
      for (int c = 0; c < NC; ++c) out[i][c] = fmaf(wv, xv[c], out[i][c]);
    }
  }
}

// dQ of the 64 query rows q0 .. of head h, doc b, and their D
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ o,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ dsum, float* __restrict__ dq,
                             int Sq, int Skv, int Hq, int Hkv, int n_qt,
                             int causal, float scale) {
  constexpr int LD = HD + 4;
  constexpr int NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kB][LD], q / sqrt(hd)
  float* do_s = q_s + kB * LD;                   // [kB][LD]
  float* kv_s = do_s + kB * LD;                  // [kB][LD]: O, then V, K
  float* ds_s = kv_s + kB * LD;                  // [kB][kLdP]

  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);  // heaviest first
  const int bh = (int)(blockIdx.x / n_qt);
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = qt * kB, n_q = min(kB, Sq - q0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t q_stride = (int64_t)Hq * HD, kv_stride = (int64_t)Hkv * HD;
  const int64_t q_off = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD;
  const float* k_base = k + (int64_t)b * Skv * kv_stride + (int64_t)hk * HD;
  const float* v_base = v + (int64_t)b * Skv * kv_stride + (int64_t)hk * HD;

  load_tile<HD>(q + q_off, q_stride, n_q, scale, q_s);
  load_tile<HD>(dout + q_off, q_stride, n_q, 1.f, do_s);
  load_tile<HD>(o + q_off, q_stride, n_q, 1.f, kv_s);
  __syncthreads();

  // D and lse of this thread's rows; a tail row's lse is +inf
  float dr[kRows], lr[kRows];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int rl = ty * kRows + i, row = q0 + rl;
    float part = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c)
      part = fmaf(do_s[rl * LD + tx + 16 * c], kv_s[rl * LD + tx + 16 * c],
                  part);
    dr[i] = row_sum(part);
    lr[i] = row < Sq ? lse[(int64_t)bh * Sq + row] : INFINITY;
    if (tx == 0 && row < Sq) dsum[(int64_t)bh * Sq + row] = dr[i];
  }

  float acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;

  int n_kb = (Skv + kB - 1) / kB;
  if (causal) n_kb = min(n_kb, (min(q0 + kB, Sq) - 1) / kB + 1);
  for (int kb = 0; kb < n_kb; ++kb) {
    const int kv0 = kb * kB, n_kv = min(kB, Skv - kv0);
    float dp[kRows][kCols], s[kRows][kCols];
    __syncthreads();  // the last reads of kv_s (O or K) and ds_s are done
    load_tile<HD>(v_base + kv0 * kv_stride, kv_stride, n_kv, 1.f, kv_s);
    __syncthreads();
    tile_dots<HD>(do_s, kv_s, ty, tx, dp);
    __syncthreads();
    load_tile<HD>(k_base + kv0 * kv_stride, kv_stride, n_kv, 1.f, kv_s);
    __syncthreads();
    tile_dots<HD>(q_s, kv_s, ty, tx, s);
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        const bool keep = col < n_kv && !(causal && row < kv0 + col);
        const float p = keep ? expf(s[i][j] - lr[i]) : 0.f;
        ds_s[(ty * kRows + i) * kLdP + col] = p * (dp[i][j] - dr[i]);
      }
    }
    __syncthreads();
    tile_product<HD>(ds_s, kv_s, ty, tx, acc);
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int rl = ty * kRows + i;
    if (q0 + rl >= Sq) continue;
    float* out = dq + q_off + rl * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(out + tx + 16 * c, acc[i][c] * scale);
  }
}

// dK and dV of the 64 keys k0 .. of KV head hk, doc b
template <int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkdv_kernel(const float* __restrict__ q,
                               const float* __restrict__ k,
                               const float* __restrict__ v,
                               const float* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ dsum,
                               float* __restrict__ dk, float* __restrict__ dv,
                               int Sq, int Skv, int Hq, int Hkv, int n_kt,
                               int causal, float scale) {
  constexpr int LD = HD + 4;
  constexpr int NC = HD / 16;
  extern __shared__ float4 smem4[];
  float* k_s = reinterpret_cast<float*>(smem4);  // [kB][LD]
  float* v_s = k_s + kB * LD;                    // [kB][LD]
  float* q_s = v_s + kB * LD;                    // [kB][LD], q / sqrt(hd)
  float* do_s = q_s + kB * LD;                   // [kB][LD]
  float* w_s = do_s + kB * LD;                   // [kB][kLdP]: P^T, dS^T

  const int kt = (int)(blockIdx.x % n_kt);       // heaviest (first) first
  const int bk = (int)(blockIdx.x / n_kt);
  const int b = bk / Hkv, hk = bk % Hkv, G = Hq / Hkv;
  const int k0 = kt * kB, n_k = min(kB, Skv - k0);
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int64_t q_stride = (int64_t)Hq * HD, kv_stride = (int64_t)Hkv * HD;
  const int64_t kv_off = ((int64_t)b * Skv + k0) * kv_stride +
                         (int64_t)hk * HD;

  load_tile<HD>(k + kv_off, kv_stride, n_k, 1.f, k_s);
  load_tile<HD>(v + kv_off, kv_stride, n_k, 1.f, v_s);

  float dk_acc[kRows][NC], dv_acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) dk_acc[i][c] = dv_acc[i][c] = 0.f;

  const int n_qt = (Sq + kB - 1) / kB;
  const int qt0 = causal ? k0 / kB : 0;  // query tiles that see these keys
  for (int g = 0; g < G; ++g) {
    const int h = hk * G + g;
    const int64_t bh = (int64_t)b * Hq + h;
    for (int qt = qt0; qt < n_qt; ++qt) {
      const int q0 = qt * kB, n_q = min(kB, Sq - q0);
      const int64_t q_off = ((int64_t)b * Sq + q0) * q_stride +
                            (int64_t)h * HD;
      __syncthreads();  // the last tile's reads of q_s, do_s, w_s are done
      load_tile<HD>(q + q_off, q_stride, n_q, scale, q_s);
      load_tile<HD>(dout + q_off, q_stride, n_q, 1.f, do_s);
      __syncthreads();
      // S^T and dP^T: keys 4 ty + i against queries tx + 16 j
      float s[kRows][kCols], dp[kRows][kCols];
      tile_dots<HD>(k_s, q_s, ty, tx, s);
      tile_dots<HD>(v_s, do_s, ty, tx, dp);
      float lq[kCols], dq[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int row = q0 + tx + 16 * j;
        lq[j] = row < Sq ? lse[bh * Sq + row] : INFINITY;
        dq[j] = row < Sq ? dsum[bh * Sq + row] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const int kl = ty * kRows + i;
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          const int row = q0 + tx + 16 * j;
          const bool keep = kl < n_k && !(causal && row < k0 + kl);
          const float p = keep ? expf(s[i][j] - lq[j]) : 0.f;
          w_s[kl * kLdP + tx + 16 * j] = p;
          s[i][j] = p * (dp[i][j] - dq[j]);  // dS^T, kept for dK
        }
      }
      __syncthreads();
      tile_product<HD>(w_s, do_s, ty, tx, dv_acc);
      __syncthreads();
#pragma unroll
      for (int i = 0; i < kRows; ++i)
#pragma unroll
        for (int j = 0; j < kCols; ++j)
          w_s[(ty * kRows + i) * kLdP + tx + 16 * j] = s[i][j];
      __syncthreads();
      tile_product<HD>(w_s, q_s, ty, tx, dk_acc);
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int kl = ty * kRows + i;
    if (kl >= n_k) continue;
    float* out_k = dk + kv_off + kl * kv_stride;
    float* out_v = dv + kv_off + kl * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(out_k + tx + 16 * c, dk_acc[i][c]);
      store(out_v + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kThreadsWg = 160;   // one consumer warpgroup and a producer warp
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kStages = 2;        // stages of every ring

// four bf16 values of a and of b: acc + a . b in float32
__device__ __forceinline__ float fma4(uint2 a, uint2 b, float acc) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float2 x = __bfloat1622float2(pa[i]), y = __bfloat1622float2(pb[i]);
    acc = fmaf(x.x, y.x, acc);
    acc = fmaf(x.y, y.y, acc);
  }
  return acc;
}

// An accumulator c (64 rows x HD, f32) times s as bf16 into the warp's 16
// rows of the swizzled tile at `tile`, then 16-byte stores of the rows
// row0 + r < n_rows to out + (row0 + r) * stride; c[4 j + e] is (row r0 +
// 8 (e / 2), column 8 j + 2 tq + e % 2)
template <int HD>
__device__ __forceinline__ void store_rows(const float* c, float s,
                                           unsigned char* tile,
                                           __nv_bfloat16* out, int64_t stride,
                                           int row0, int n_rows) {
  using T = Tile<HD>;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int r0 = warp * 16 + lane / 4, tq = lane % 4;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(tile + T::off(r0 + 8 * hr, j) + 4 * tq) =
          pack_bf16(c[4 * j + 2 * hr] * s, c[4 * j + 2 * hr + 1] * s);
  __syncwarp();
  constexpr int C = HD / 8;
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = warp * 16 + i / C, cc = i % C;
    if (row0 + r < n_rows)
      *reinterpret_cast<uint4*>(out + (int64_t)(row0 + r) * stride + cc * 8) =
          *reinterpret_cast<const uint4*>(tile + T::off(r, cc));
  }
}

// dQ of the 64 query rows q0 .. of head h, doc b, and their D.  Warps 0-3
// are the consumer warpgroup, warp 4 the producer.
template <int HD>
__global__ void __launch_bounds__(kThreadsWg, 2)
    flash_attn_bwd_dq_wgmma(const __grid_constant__ CUtensorMap q_map,
                            const __grid_constant__ CUtensorMap k_map,
                            const __grid_constant__ CUtensorMap v_map,
                            const __grid_constant__ CUtensorMap do_map,
                            const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ dsum,
                            __nv_bfloat16* __restrict__ dq, int Sq, int Skv,
                            int Hq, int Hkv, int n_qt, int causal,
                            float scale, float scale_log2) {
  using T = Tile<HD>;
  constexpr int KS = kStages, VS = kStages;
  constexpr int NO = HD / 2;     // dQ accumulator values per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;

  // layout: Q, dO, the K ring, the V ring, then the barriers: Q and dO;
  // K stages full, empty; V stages full, empty
  const uint32_t q_s = base, do_s = base + T::BYTES;
  const uint32_t k_ring = base + 2 * T::BYTES;
  const uint32_t v_ring = k_ring + KS * T::BYTES;
  const uint32_t qdo_bar = v_ring + VS * T::BYTES;
  const uint32_t k_full = qdo_bar + 8, k_empty = k_full + 8 * KS;
  const uint32_t v_full = k_empty + 8 * KS, v_empty = v_full + 8 * VS;

  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);  // heaviest first
  const int bh = (int)(blockIdx.x / n_qt);
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = qt * kWgRows;
  int n_kb = (Skv + kWgRows - 1) / kWgRows;
  if (causal) n_kb = min(n_kb, (min(q0 + kWgRows, Sq) - 1) / kWgRows + 1);
  if (tid == 0) {
    mbar_init(qdo_bar, 1);
    for (int i = 0; i < KS; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(k_empty + 8 * i, 1);
    }
    for (int i = 0; i < VS; ++i) {
      mbar_init(v_full + 8 * i, 1);
      mbar_init(v_empty + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // use j = t / S of stage t % S completes its barriers' phase j
  if (warp == 4) {            // the producer warp: one lane issues all TMA
    if (lane == 0) {
      mbar_expect(qdo_bar, 2 * T::BYTES);
      tma_tile<HD>(q_s, &q_map, qdo_bar, h, q0, b);
      tma_tile<HD>(do_s, &do_map, qdo_bar, h, q0, b);
      for (int t = 0; t < n_kb; ++t) {
        const uint32_t kf = k_full + 8 * (t % KS), vf = v_full + 8 * (t % VS);
        if (t >= KS) mbar_wait(k_empty + 8 * (t % KS), (t / KS - 1) & 1);
        mbar_expect(kf, T::BYTES);
        tma_tile<HD>(k_ring + (t % KS) * T::BYTES, &k_map, kf, hk,
                     t * kWgRows, b);
        if (t >= VS) mbar_wait(v_empty + 8 * (t % VS), (t / VS - 1) & 1);
        mbar_expect(vf, T::BYTES);
        tma_tile<HD>(v_ring + (t % VS) * T::BYTES, &v_map, vf, hk,
                     t * kWgRows, b);
      }
    }
    return;
  }

  // D = rowsum(dO o O) and the lse in exp2 units of this thread's fragment
  // rows r0 and r0 + 8, each summed over the 4 lanes that share the row
  // (a tail row: D 0, lse +inf, so its P is 0)
  const int r0 = warp * 16 + g;
  float dr[2], l2[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + 8 * hr;
    float part = 0.f;
    if (row < Sq) {
      const int64_t off = (((int64_t)b * Sq + row) * Hq + h) * HD;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        const int col = (4 * c + tq) * 4;
        part = fma4(__ldg(reinterpret_cast<const uint2*>(dout + off + col)),
                    __ldg(reinterpret_cast<const uint2*>(o + off + col)),
                    part);
      }
    }
    dr[hr] = quad_sum(part);
    l2[hr] = row < Sq ? lse[(int64_t)bh * Sq + row] * kLog2e : INFINITY;
    if (tq == 0 && row < Sq) dsum[(int64_t)bh * Sq + row] = dr[hr];
  }

  float s[32], dp[32];          // S, then dS, and dP of one KV tile
  uint32_t da[16], db[16];      // dS = da + db in bf16: the A fragments
  float acc[NO];                // dQ, unscaled
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  auto release = [&](uint32_t bar) {
    if (tid == 0) mbar_arrive(bar);
  };
  auto issue_sdp = [&](int t) {
    issue_ss<HD>(s, q_s, k_ring + (t % KS) * T::BYTES);
    issue_ss<HD>(dp, do_s, v_ring + (t % VS) * T::BYTES);
    wgmma_commit();
  };
  auto issue_dq = [&](int t) {
    issue_rs<HD>(acc, da, db, k_ring + (t % KS) * T::BYTES);
    wgmma_commit();
  };
  // dS of tile t into s: s[i] is (row q0 + r0 + 8 ((i >> 1) & 1), key
  // 8 (i / 4) + 2 tq + (i & 1) of the tile); P = 2^(s scale log2(e) -
  // lse log2(e)) with the scale fused into the exponent's FMA; the causal
  // mask only on tiles that straddle the diagonal, the key tail only on
  // the last
  auto dsoftmax = [&](int t) {
    const int kv0 = t * kWgRows;
    if (kv0 + kWgRows > Skv || (causal && kv0 + kWgRows - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = kv0 + 8 * (i / 4) + 2 * tq + (i & 1);
        const int row = q0 + r0 + 8 * ((i >> 1) & 1);
        if (col >= Skv || (causal && col > row)) s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hr = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], scale_log2, -l2[hr])) * (dp[i] - dr[hr]);
    }
  };

  // Per KV tile: S and dP, dS, then dQ += dS . K.  Two blocks an SM
  // overlap one's elementwise work with the other's products (issuing
  // tile t's S and dP beside tile t - 1's dQ product measured slower).
  mbar_wait(qdo_bar, 0);
  for (int t = 0; t < n_kb; ++t) {
    mbar_wait(k_full + 8 * (t % KS), (t / KS) & 1);
    mbar_wait(v_full + 8 * (t % VS), (t / VS) & 1);
    wgmma_fence();
    issue_sdp(t);
    wgmma_wait<0>();
    fence_regs<32>(s);
    fence_regs<32>(dp);
    release(v_empty + 8 * (t % VS));
    dsoftmax(t);
    split_bf16(s, da, db);
    wgmma_fence();
    issue_dq(t);
    wgmma_wait<0>();
    fence_regs<NO>(acc);
    fence_frag<16>(da);
    fence_frag<16>(db);
    release(k_empty + 8 * (t % KS));
  }

  // dQ times 1/sqrt(hd), staged through the Q tile (no longer read)
  store_rows<HD>(acc, scale, smem, dq + (int64_t)b * Sq * Hq * HD +
                                       (int64_t)h * HD,
                 (int64_t)Hq * HD, q0, Sq);
}

// dK and dV of the 64 keys k0 .. of KV head hk, doc b.  Warps 0-3 are the
// consumer warpgroup, warp 4 the producer.
template <int HD>
__global__ void __launch_bounds__(kThreadsWg, HD >= 128 ? 1 : 2)
    flash_attn_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap q_map,
                              const __grid_constant__ CUtensorMap k_map,
                              const __grid_constant__ CUtensorMap v_map,
                              const __grid_constant__ CUtensorMap do_map,
                              const float* __restrict__ lse,
                              const float* __restrict__ dsum,
                              __nv_bfloat16* __restrict__ dk,
                              __nv_bfloat16* __restrict__ dv, int Sq,
                              int Skv, int Hq, int Hkv, int n_kt, int causal,
                              float scale, float scale_log2) {
  using T = Tile<HD>;
  constexpr int QS = kStages;
  constexpr int NO = HD / 2;     // dK and dV accumulator values per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;

  // layout: K, V, the Q ring, the dO ring, per stage the 64 queries' lse
  // (exp2 units) and D in float32, then the barriers: K and V; stages
  // full (TMA's bytes and the producer's 32 lanes), empty
  const uint32_t k_s = base, v_s = base + T::BYTES;
  const uint32_t q_ring = base + 2 * T::BYTES;
  const uint32_t do_ring = q_ring + QS * T::BYTES;
  const uint32_t vec = do_ring + QS * T::BYTES;
  constexpr int kVecBytes = 2 * kWgRows * 4;
  const uint32_t kv_bar = vec + QS * kVecBytes;
  const uint32_t full = kv_bar + 8, empty = full + 8 * QS;
  auto vec_at = [&](int stage) {
    return reinterpret_cast<float*>(smem + (vec - base) + stage * kVecBytes);
  };

  const int kt = (int)(blockIdx.x % n_kt);       // heaviest (first) first
  const int bk = (int)(blockIdx.x / n_kt);
  const int b = bk / Hkv, hk = bk % Hkv, G = Hq / Hkv;
  const int k0 = kt * kWgRows;
  const int n_qt = (Sq + kWgRows - 1) / kWgRows;
  const int qt0 = causal ? k0 / kWgRows : 0;     // query tiles that see k0 ..
  const int per_head = max(0, n_qt - qt0);
  const int n_tiles = G * per_head;              // head-major, then tiles
  if (tid == 0) {
    mbar_init(kv_bar, 1);
    for (int i = 0; i < QS; ++i) {
      mbar_init(full + 8 * i, 1 + 32);
      mbar_init(empty + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == 4) {            // the producer warp
    if (lane == 0) {
      mbar_expect(kv_bar, 2 * T::BYTES);
      tma_tile<HD>(k_s, &k_map, kv_bar, hk, k0, b);
      tma_tile<HD>(v_s, &v_map, kv_bar, hk, k0, b);
    }
    for (int n = 0; n < n_tiles; ++n) {
      const int stage = n % QS, h = hk * G + n / per_head;
      const int q0 = (qt0 + n % per_head) * kWgRows;
      const int64_t bh = (int64_t)b * Hq + h;
      const uint32_t bar = full + 8 * stage;
      if (n >= QS) mbar_wait(empty + 8 * stage, (n / QS - 1) & 1);
      if (lane == 0) {
        mbar_expect(bar, 2 * T::BYTES);
        tma_tile<HD>(q_ring + stage * T::BYTES, &q_map, bar, h, q0, b);
        tma_tile<HD>(do_ring + stage * T::BYTES, &do_map, bar, h, q0, b);
      }
      // a tail query: lse +inf and D 0, so its P and dS are 0
      float* v = vec_at(stage);
      for (int i = lane; i < kWgRows; i += 32) {
        const int row = q0 + i;
        v[i] = row < Sq ? lse[bh * Sq + row] * kLog2e : INFINITY;
        v[kWgRows + i] = row < Sq ? dsum[bh * Sq + row] : 0.f;
      }
      mbar_arrive(bar);
    }
    return;
  }

  const int r0 = warp * 16 + g;
  float st[32], dpt[32];         // S^T, then P^T; dP^T, then dS^T
  uint32_t pa[16], pb[16];       // P^T's two bf16 parts
  uint32_t da[16], db[16];       // dS^T's two bf16 parts
  float dka[NO], dva[NO];        // dK (unscaled) and dV
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
  mbar_wait(kv_bar, 0);
  // Per tile, in the order of the sum: S^T = K . Q^T and dP^T = V . dO^T
  // (ss), P^T while dP^T runs, dV += P^T . dO (rs), dS^T while dV runs,
  // dK += dS^T . Q (rs).  st[i] and dpt[i] are (key k0 + r0 + 8 ((i
  // >> 1) & 1), query q0 + c(i)), c(i) = 8 (i / 4) + 2 tq + (i & 1): lse
  // and D belong to the column.  Keys past Skv are never stored.
  for (int n = 0; n < n_tiles; ++n) {
    const int stage = n % QS;
    const int q0 = (qt0 + n % per_head) * kWgRows;
    const uint32_t q_t = q_ring + stage * T::BYTES;
    const uint32_t do_t = do_ring + stage * T::BYTES;
    const float* ls = vec_at(stage);
    const float* dd = ls + kWgRows;
    mbar_wait(full + 8 * stage, (n / QS) & 1);
    wgmma_fence();
    issue_ss<HD>(st, k_s, q_t);
    wgmma_commit();
    issue_ss<HD>(dpt, v_s, do_t);
    wgmma_commit();
    wgmma_wait<1>();             // S^T; dP^T runs on
    fence_regs<32>(st);
    // under the causal mask only the diagonal tile (q0 == k0) has a query
    // before a key
    const bool diag = causal && q0 < k0 + kWgRows - 1;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int c = 8 * (i / 4) + 2 * tq + (i & 1);
      const float p = ex2(fmaf(st[i], scale_log2, -ls[c]));
      st[i] = diag && q0 + c < k0 + r0 + 8 * ((i >> 1) & 1) ? 0.f : p;
    }
    split_bf16(st, pa, pb);
    wgmma_fence();
    issue_rs<HD>(dva, pa, pb, do_t);
    wgmma_commit();
    wgmma_wait<1>();             // dP^T; dV runs on
    fence_regs<32>(dpt);
    // dS^T from P^T's two parts (exact in float32), so that P^T itself
    // is not kept: two blocks an SM need at most 168 registers a thread
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int c = 8 * (i / 2) + 2 * tq;
      const float2 hi = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&pa[i]));
      const float2 lo = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&pb[i]));
      dpt[2 * i] = (hi.x + lo.x) * (dpt[2 * i] - dd[c]);
      dpt[2 * i + 1] = (hi.y + lo.y) * (dpt[2 * i + 1] - dd[c + 1]);
    }
    split_bf16(dpt, da, db);
    wgmma_fence();
    issue_rs<HD>(dka, da, db, q_t);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(dka);
    fence_regs<NO>(dva);
    fence_frag<16>(pa);
    fence_frag<16>(pb);
    fence_frag<16>(da);
    fence_frag<16>(db);
    if (tid == 0) mbar_arrive(empty + 8 * stage);
  }

  // dK times 1/sqrt(hd) and dV, staged through the K and V tiles
  const int64_t off = (int64_t)b * Skv * Hkv * HD + (int64_t)hk * HD;
  store_rows<HD>(dka, scale, smem, dk + off, (int64_t)Hkv * HD, k0, Skv);
  store_rows<HD>(dva, 1.f, smem + T::BYTES, dv + off, (int64_t)Hkv * HD, k0,
                 Skv);
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dsum, void* dq,
               void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
               int causal, float scale, cudaStream_t stream) {
  constexpr int LD = HD + 4;
  const int smem_dq = (3 * kB * LD + kB * kLdP) * (int)sizeof(float);
  const int smem_dkdv = (4 * kB * LD + kB * kLdP) * (int)sizeof(float);
  auto* fn_dq = flash_attn_bwd_dq_kernel<HD>;
  auto* fn_dkdv = flash_attn_bwd_dkdv_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      fn_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      fn_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + kB - 1) / kB, n_kt = (Skv + kB - 1) / kB;
  const int64_t blocks_dq = (int64_t)B * Hq * n_qt;
  const int64_t blocks_dkdv = (int64_t)B * Hkv * n_kt;
  if (blocks_dq > 0x7fffffff || blocks_dkdv > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  if (blocks_dq > 0) {
    fn_dq<<<(unsigned)blocks_dq, kThreads, smem_dq, stream>>>(
        tq, tk, tv, static_cast<const float*>(o), tdo, lse, dsum,
        static_cast<float*>(dq), Sq, Skv, Hq, Hkv, n_qt, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  fn_dkdv<<<(unsigned)blocks_dkdv, kThreads, smem_dkdv, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Skv, Hq, Hkv, n_kt, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, const void* o,
                const void* dout, const float* lse, float* dsum, void* dq,
                void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
                int causal, float scale, cudaStream_t stream) {
  using T = Tile<HD>;
  if (Sq == 0) {      // no query sees a key: dK and dV are 0
    const size_t n = (size_t)B * Skv * Hkv * HD * 2;
    cudaError_t err = cudaMemsetAsync(dk, 0, n, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, n, stream);
    return (int)err;
  }
  // the tiles and rings, the lse / D stages, 8 bytes per barrier, and
  // room to align the tiles to 1,024 bytes
  constexpr int S = kStages;
  const int smem_dq = (2 + 2 * S) * T::BYTES + 8 * (1 + 4 * S) + 1024;
  const int smem_dkdv = (2 + 2 * S) * T::BYTES + S * 2 * kWgRows * 4 +
                        8 * (1 + 2 * S) + 1024;
  auto* fn_dq = flash_attn_bwd_dq_wgmma<HD>;
  auto* fn_dkdv = flash_attn_bwd_dkdv_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      fn_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dq);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      fn_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_dkdv);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + kWgRows - 1) / kWgRows;
  const int n_kt = (Skv + kWgRows - 1) / kWgRows;
  const int64_t blocks_dq = (int64_t)B * Hq * n_qt;
  const int64_t blocks_dkdv = (int64_t)B * Hkv * n_kt;
  if (blocks_dq > 0x7fffffff || blocks_dkdv > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  CUtensorMap q_map, k_map, v_map, do_map;
  if (!make_map<HD>(&q_map, q, B, Sq, Hq) ||
      !make_map<HD>(&k_map, k, B, Skv, Hkv) ||
      !make_map<HD>(&v_map, v, B, Skv, Hkv) ||
      !make_map<HD>(&do_map, dout, B, Sq, Hq))
    return (int)cudaErrorInvalidValue;
  // exp(x / sqrt(hd) - lse) = exp2(x * scale * log2(e) - lse * log2(e))
  const float scale_log2 = scale * kLog2e;
  fn_dq<<<(unsigned)blocks_dq, kThreadsWg, smem_dq, stream>>>(
      q_map, k_map, v_map, do_map, static_cast<const __nv_bfloat16*>(o),
      static_cast<const __nv_bfloat16*>(dout), lse, dsum,
      static_cast<__nv_bfloat16*>(dq), Sq, Skv, Hq, Hkv, n_qt, causal, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fn_dkdv<<<(unsigned)blocks_dkdv, kThreadsWg, smem_dkdv, stream>>>(
      q_map, k_map, v_map, do_map, lse, dsum,
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), Sq,
      Skv, Hq, Hkv, n_kt, causal, scale, scale_log2);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int is_bf16, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* dsum,
              void* dq, void* dk, void* dv, int B, int Sq, int Skv, int Hq,
              int Hkv, int causal, float scale, cudaStream_t stream) {
  return is_bf16
             ? launch_bf16<HD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                               Skv, Hq, Hkv, causal, scale, stream)
             : launch_f32<HD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, Sq,
                              Skv, Hq, Hkv, causal, scale, stream);
}

}  // namespace

extern "C" {

// is_bf16: 0 for float32 tensors, 1 for bfloat16; hd in {16, 32, 64, 128};
// lse (B, Hq, Sq) from the forward; dsum (B, Hq, Sq) float32 scratch
int flash_attn_bwd_launch(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          float* dsum, void* dq, void* dk, void* dv, int B,
                          int Sq, int Skv, int Hq, int Hkv, int hd,
                          int is_bf16, int causal, float scale,
                          cudaStream_t stream) {
  if (B == 0 || Skv == 0) return 0;
  if (Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch_hd<16>(is_bf16, q, k, v, o, dout, lse, dsum, dq, dk, dv,
                           B, Sq, Skv, Hq, Hkv, causal, scale, stream);
    case 32:
      return launch_hd<32>(is_bf16, q, k, v, o, dout, lse, dsum, dq, dk, dv,
                           B, Sq, Skv, Hq, Hkv, causal, scale, stream);
    case 64:
      return launch_hd<64>(is_bf16, q, k, v, o, dout, lse, dsum, dq, dk, dv,
                           B, Sq, Skv, Hq, Hkv, causal, scale, stream);
    case 128:
      return launch_hd<128>(is_bf16, q, k, v, o, dout, lse, dsum, dq, dk,
                            dv, B, Sq, Skv, Hq, Hkv, causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
