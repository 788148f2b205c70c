// Causal or full grouped-query attention forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel
// src/repro/kernels/flash_attn/kernel.py::flash_attn_pallas.  In the
// model layout q (B, Sq, Hq, hd), k and v (B, Skv, Hkv, hd), contiguous,
// float32 or bfloat16, it computes
//
//   o[b, s, h] = softmax(q[b, s, h] . k[b, :, h / G]^T / sqrt(hd)) . v[b, :, h / G]
//
// with G = Hq / Hkv, under a causal mask (query s sees keys t <= s, both
// counted from 0) or none, and writes o (B, Sq, Hq, hd) in q's type.  The
// online softmax never writes the (Sq, Skv) scores to device memory.
// Rows that see no key yet keep m = -inf: the exponent uses m_safe = 0
// for them and their correction factor is 0, as the TPU kernel guards
// them; the output divides by max(l, 1e-30).  Under the causal mask the
// KV tiles wholly above the diagonal are never loaded (the TPU kernel
// masks them instead), and blocks are issued heaviest query tile first.
// No sequence length needs to be a multiple of a tile: the tail is
// zero-filled and masked.
//
// Given a (B, Hq, Sq) float32 lse buffer (training), both kernels also
// write each row's log-sum-exp, ln sum_t exp(q . k_t / sqrt(hd)) (+inf for
// a row that saw no key), which flash_attn_bwd.cu recomputes P from.  The
// lse is a template parameter: with a null buffer the instances that
// write none run, the code the serving and build paths ran before.
//
// What bounds it on the H100.  At the LM build's shape (B 32, S 512,
// Hq 24, Hkv 8, hd 128, bf16, causal) one launch moves 268 MB of q, k, v
// and o, 0.080 ms at 3.35 TB/s, and does 5.2e10 flops, 0.052 ms on the
// bf16 tensor cores: the bytes bound it.
//
// bfloat16 (the LM's path): flash_attn_kernel_bf16_wgmma, warp-
// specialised.  One block per (b, h, 64 query rows); blocks that read one
// KV head are numbered together so that its K and V come from L2 after
// the first read.  One consumer warpgroup runs both products on the
// tensor cores with wgmma, bf16 x bf16 into float32 registers:
//   S = Q . K^T  as m64n64k16 over hd / 16 steps, Q and K read from shared
//                memory, both K-major in the model layout;
//   O += P . V   as m64n{hd}k16 over the tile's 4 key steps, P from
//                registers (the S accumulator converted in place: its
//                fragment layout is wgmma's register-A layout) and V
//                from shared memory as it lands, MN-major, read through
//                the descriptor's transpose bit.  P goes in as two bf16
//                fragments, pa = bf16(p) and pb = bf16(p - pa), two
//                wgmmas per key step: pa + pb holds p to 2^-16, so P . V
//                keeps the TPU kernel's float32 arithmetic (p rounded to
//                bf16 alone drifts a bf16 LM past the reference's 2e-2
//                through its layers), for half again the tensor-core work.
// Step t issues S_t beside P . V_{t-1}, so the softmax of t overlaps the
// tensor cores' P . V of t - 1, and two blocks per SM overlap one's
// softmax with the other's products (two warpgroups per block, taking
// turns, measured no faster at the build's shape).  Scores are scaled by
// 1/sqrt(hd) * log2(e) in float32 on the accumulator, fused into the
// exponent's FMA (q is never rounded after scaling), and exponentiated
// with ex2.approx; the causal mask runs only
// on tiles that straddle the diagonal and the tail mask only on the last
// KV tile; the row max and row sum are reduced over the 4 lanes that hold
// a row with shuffles; l sums the float32 p.  One
// producer warp issues every load with TMA (4-D tensor maps over (B, S,
// H, hd), boxes of 64 rows into the 128-byte swizzle, 64-byte at hd 32,
// 32-byte at hd 16, that the wgmma descriptors name; rows past the
// sequence land as zeros): Q once, then K and V through two-stage rings
// with a full and an empty mbarrier per stage, so no consumer waits on a
// block-wide barrier.  Shared memory: 16 KB of Q and 64 KB for the K and
// V rings at hd 128.  O stays in float32 registers; the epilogue stages
// each warp's 16 rows through its Q rows in shared memory and writes bf16
// with 16-byte stores.  The tile layout, descriptors, barriers, TMA and
// wgmma helpers are in sm90.cuh, shared with flash_attn_bwd.cu.
//
// float32 (tests and the wiring check only; its bar, rtol 1e-4 / atol
// 1e-5, rules out the bf16 and TF32 tensor cores): flash_attn_kernel, FMAs
// fed from shared memory.  One block per (b, h, 64-row query tile), 256
// threads as a 16 x 16 grid: thread (ty, tx) owns query rows 4 ty .. 4 ty +
// 3; the query tile, pre-scaled by 1/sqrt(hd) as the TPU kernel does,
// stays in shared memory; each 64-row KV tile is staged into one shared
// buffer, K first, then V; the probabilities go through shared memory to
// the P . V product.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (chip_smoke.py phase 6;
// PERF.md section 6 keeps the numbers): at the build's shape the bf16
// kernel takes 0.21 ms (243 TFLOP/s, 2.65x its bound, 1.53x
// scaled_dot_product_attention; 0.20 ms with p rounded to bf16 alone);
// the first version, float32 FMAs for both types, took 2.03 ms.
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
constexpr int kBQ = 64;        // query rows per block
constexpr int kBK = 64;        // keys per KV tile
constexpr int kRows = kBQ / 16;  // query rows per thread
constexpr int kCols = kBK / 16;  // score columns per thread
constexpr int kLdP = kBK + 4;    // the two half-warps hit other banks

__device__ __forceinline__ float4 scale4(float4 x, float s) {
  return make_float4(x.x * s, x.y * s, x.z * s, x.w * s);
}

// a tile of 64 rows of HD values, rows [0, n_rows) from src (row stride
// `stride` elements), the rest zero, into dst [64][HD + 4] as float32
template <int HD>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          int64_t stride, int n_rows,
                                          float s, float* dst) {
  constexpr int V = HD / 4;
  for (int i = threadIdx.x; i < 64 * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 4;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < n_rows)
      x = __ldg(reinterpret_cast<const float4*>(src + r * stride + c));
    *reinterpret_cast<float4*>(dst + r * (HD + 4) + c) = scale4(x, s);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

// The log-sum-exp a row hands the backward: ln sum_t exp(q . k_t / sqrt(hd))
// from the online softmax's max m (in that natural domain) and sum l; +inf
// for a row that saw no key, so the backward's exp(s - lse) is 0 there
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? m + logf(l) : INFINITY;
}

// max / sum over the 16 lanes of a half-warp (one query row)
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename T, int HD, bool LSE>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, int Sq, int Skv, int Hq,
                      int Hkv, int n_qt, int causal, float scale) {
  constexpr int LD = HD + 4;
  constexpr int NC = HD / 16;  // output columns per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);  // [kBQ][LD]
  float* kv_s = q_s + kBQ * LD;                  // [kBK][LD], K then V
  float* p_s = kv_s + kBK * LD;                  // [kBQ][kLdP]

  // heaviest query tile first: the last tiles see the most keys
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);
  const int bh = (int)(blockIdx.x / n_qt);
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = qt * kBQ;
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;

  const int64_t q_stride = (int64_t)Hq * HD;
  const int64_t kv_stride = (int64_t)Hkv * HD;
  const T* q_base = q + ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD;
  const T* k_base = k + (int64_t)b * Skv * kv_stride + (int64_t)hk * HD;
  const T* v_base = v + (int64_t)b * Skv * kv_stride + (int64_t)hk * HD;

  load_tile<HD>(q_base, q_stride, min(kBQ, Sq - q0), scale, q_s);

  float m[kRows], l[kRows], acc[kRows][NC];
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[i][c] = 0.f;
  }

  int n_kb = (Skv + kBK - 1) / kBK;
  if (causal) n_kb = min(n_kb, (min(q0 + kBQ, Sq) - 1) / kBK + 1);

  for (int kb = 0; kb < n_kb; ++kb) {
    const int kv0 = kb * kBK;
    const int n_kv = min(kBK, Skv - kv0);
    __syncthreads();  // the last tile's P . V reads of kv_s are done
    load_tile<HD>(k_base + kv0 * kv_stride, kv_stride, n_kv, 1.f, kv_s);
    __syncthreads();

    float s[kRows][kCols];
#pragma unroll
    for (int i = 0; i < kRows; ++i)
#pragma unroll
      for (int j = 0; j < kCols; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 kv[kCols];
#pragma unroll
      for (int j = 0; j < kCols; ++j)
        kv[j] = *reinterpret_cast<const float4*>(kv_s + (tx + 16 * j) * LD + d);
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float4 qv =
            *reinterpret_cast<const float4*>(q_s + (ty * kRows + i) * LD + d);
#pragma unroll
        for (int j = 0; j < kCols; ++j) {
          s[i][j] = fmaf(qv.x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv.y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv.z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv.w, kv[j].w, s[i][j]);
        }
      }
    }

#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      const int row = q0 + ty * kRows + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        const int col = tx + 16 * j;
        if (col >= n_kv || (causal && row < kv0 + col)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[i][j] = expf(s[i][j] - m_safe);
        rs += s[i][j];
        p_s[(ty * kRows + i) * kLdP + tx + 16 * j] = s[i][j];
      }
      const float corr = m[i] == -INFINITY ? 0.f : expf(m[i] - m_safe);
      l[i] = l[i] * corr + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();  // every K read is done and P is written
    load_tile<HD>(v_base + kv0 * kv_stride, kv_stride, n_kv, 1.f, kv_s);
    __syncthreads();

#pragma unroll 4
    for (int t = 0; t < kBK; ++t) {
      float vv[NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) vv[c] = kv_s[t * LD + tx + 16 * c];
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        const float p = p_s[(ty * kRows + i) * kLdP + t];
#pragma unroll
        for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    const int row = q0 + ty * kRows + i;
    if (row >= Sq) continue;
    const float den = fmaxf(l[i], 1e-30f);
    if constexpr (LSE)
      if (tx == 0) lse[(int64_t)bh * Sq + row] = row_lse(m[i], l[i]);
    T* out = o + ((int64_t)b * Sq + row) * q_stride + (int64_t)h * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(out + tx + 16 * c, acc[i][c] / den);
  }
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma on the tensor cores
// ---------------------------------------------------------------------------

constexpr int kThreadsBf16 = 160;   // the warpgroup and a producer warp
constexpr int kBKV = 64;      // keys per KV tile
constexpr int kStages = 2;    // stages of the K ring and of the V ring

// One block's work: the 64 query rows q0 .. of query head h of doc b,
// against n_kb KV tiles
struct Item {
  int b, h, hk, q0, n_kb;
};

// Blocks are numbered so that the blocks that read one KV head (its G
// query heads x n_qt query tiles) are neighbours, heaviest query tile
// first (the last tiles see the most keys): they run together and read
// that head's K and V from device memory about once, then from L2.
__device__ __forceinline__ Item item_at(int i, int Sq, int Skv, int Hq,
                                        int Hkv, int n_qt, int causal) {
  const int G = Hq / Hkv;
  const int per_kv = G * n_qt;
  const int bk = i / per_kv, in_kv = i % per_kv;
  Item it;
  it.b = bk / Hkv;
  it.hk = bk % Hkv;
  it.h = it.hk * G + in_kv % G;
  it.q0 = (n_qt - 1 - in_kv / G) * kWgRows;
  const int n_kb_all = (Skv + kBKV - 1) / kBKV;
  const int last = min(it.q0 + kWgRows, Sq) - 1;
  it.n_kb = causal ? min(n_kb_all, last / kBKV + 1) : n_kb_all;
  return it;
}

// One consumer warpgroup (warps 0 .. 3) and one producer warp (warp 4).
template <int HD, bool LSE>
__global__ void __launch_bounds__(kThreadsBf16, 2)
    flash_attn_kernel_bf16_wgmma(const __grid_constant__ CUtensorMap q_map,
                                 const __grid_constant__ CUtensorMap k_map,
                                 const __grid_constant__ CUtensorMap v_map,
                                 __nv_bfloat16* __restrict__ o,
                                 float* __restrict__ lse, int Sq, int Skv,
                                 int Hq, int Hkv, int n_qt, int causal,
                                 float scale_log2) {
  using T = Tile<HD>;
  constexpr int NO = HD / 2;     // O accumulator values per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int64_t q_stride = (int64_t)Hq * HD;

  // layout: the Q tile, the K ring, the V ring, then the barriers: Q;
  // K and V stages full; K and V stages empty
  const uint32_t q_s = base;
  const uint32_t k_ring = base + T::BYTES;
  const uint32_t v_ring = k_ring + kStages * T::BYTES;
  const uint32_t q_bar = v_ring + kStages * T::BYTES;
  const uint32_t k_full = q_bar + 8, v_full = k_full + 8 * kStages;
  const uint32_t k_empty = v_full + 8 * kStages;
  const uint32_t v_empty = k_empty + 8 * kStages;
  const Item it = item_at(blockIdx.x, Sq, Skv, Hq, Hkv, n_qt, causal);
  const int n_kb = it.n_kb;
  if (tid == 0) {
    mbar_init(q_bar, 1);
    for (int i = 0; i < kStages; ++i) {
      mbar_init(k_full + 8 * i, 1);
      mbar_init(v_full + 8 * i, 1);
      mbar_init(k_empty + 8 * i, 1);
      mbar_init(v_empty + 8 * i, 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // a stage's barriers complete once per use: use j = t / kStages of
  // stage t % kStages has phase parity j & 1
  auto wait_stage = [&](uint32_t bar, int t) {
    mbar_wait(bar + 8 * (t % kStages), (t / kStages) & 1);
  };
  if (warp == 4) {            // the producer warp: one lane issues all TMA
    if (lane == 0) {
      mbar_expect(q_bar, T::BYTES);
      tma_tile<HD>(q_s, &q_map, q_bar, it.h, it.q0, it.b);
      for (int t = 0; t < n_kb; ++t) {
        const uint32_t off = (t % kStages) * T::BYTES;
        // K_t and V_t into the stages tile t - 2 left
        if (t >= kStages) wait_stage(k_empty, t - kStages);
        mbar_expect(k_full + 8 * (t % kStages), T::BYTES);
        tma_tile<HD>(k_ring + off, &k_map, k_full + 8 * (t % kStages),
                     it.hk, t * kBKV, it.b);
        if (t >= kStages) wait_stage(v_empty, t - kStages);
        mbar_expect(v_full + 8 * (t % kStages), T::BYTES);
        tma_tile<HD>(v_ring + off, &v_map, v_full + 8 * (t % kStages),
                     it.hk, t * kBKV, it.b);
      }
    }
    return;
  }
  // one lane of the consumer warpgroup releases a stage once its wgmma
  // reads are done
  auto release = [&](uint32_t bar, int t) {
    if (tid == 0) mbar_arrive(bar + 8 * (t % kStages));
  };
  float s[32];                   // S, then P in float32, of one KV tile
  uint32_t pa[16], pb[16];       // P = pa + pb in bf16: the A fragments
  float acc[NO];                 // O, unnormalised
  float m[2], l[2], corr[2];
  // this thread's fragment rows r0 and r0 + 8 of the block's 64
  const int r0 = warp * 16 + g;
  const int q0w = it.q0;
  // S = Q . K_t^T, 64 x 64 in float32
  auto issue_s = [&](int t) {
    issue_ss<HD>(s, q_s, k_ring + (t % kStages) * T::BYTES);
    wgmma_commit();
  };
  // O += P . V_t as pa . V_t + pb . V_t
  auto issue_pv = [&](int t) {
    issue_rs<HD>(acc, pa, pb, v_ring + (t % kStages) * T::BYTES);
    wgmma_commit();
  };
  // the online softmax of tile t on s: s[4 j + e] is (row r0 + 8 (e /
  // 2), key 8 j + 2 tq + e % 2); leaves p in s, and the corrections.
  // The row max is taken over the unscaled scores (the scale is > 0) and
  // the scale goes into the exponent's FMA: p = 2^(s * scale_log2 - m).
  auto softmax = [&](int t) {
    const int kv0 = t * kBKV;
    if (kv0 + kBKV > Skv || (causal && kv0 + kBKV - 1 > q0w)) {
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int col = kv0 + 8 * (i / 4) + 2 * tq + (i & 1);
        const int row = q0w + r0 + 8 * ((i >> 1) & 1);
        if (col >= Skv || (causal && col > row)) s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(mx) * scale_log2);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float* x = s + 4 * j + 2 * hr;
        x[0] = ex2(fmaf(x[0], scale_log2, -m_safe));
        x[1] = ex2(fmaf(x[1], scale_log2, -m_safe));
        rs += x[0] + x[1];
      }
      corr[hr] = m[hr] == -INFINITY ? 0.f : ex2(m[hr] - m_safe);
      l[hr] = l[hr] * corr[hr] + quad_sum(rs);
      m[hr] = m_new;
    }
  };
  // O to the new max, and P to two bf16 fragments (step kk's is s[8 kk
  // ..]): pa = bf16(p) and pb = bf16(p - pa), so pa + pb carries 16 of
  // p's bits and P . V keeps the float32 arithmetic of the TPU kernel
  // (rounding p to bf16 alone moves an LM's bf16 hidden states through
  // its layers past the reference's 2e-2)
  auto rescale_and_pack = [&]() {
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] *= corr[(i >> 1) & 1];
    split_bf16(s, pa, pb);
  };

  // Tile t's S runs in step t and its P . V in step t + 1, beside tile
  // t + 1's S, so the softmax of t + 1 overlaps the tensor cores' P . V
  // of t.  Step t waits for K_t and V_{t-1} and releases their stages
  // when the products that read them are done.
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  mbar_wait(q_bar, 0);
  wait_stage(k_full, 0);
  wgmma_fence();
  issue_s(0);
  wgmma_wait<0>();
  fence_regs<32>(s);
  release(k_empty, 0);
  softmax(0);
  rescale_and_pack();
  for (int t = 1; t < n_kb; ++t) {
    wait_stage(k_full, t);      // K_t and V_{t-1} have landed
    wait_stage(v_full, t - 1);
    wgmma_fence();
    issue_s(t);
    issue_pv(t - 1);
    wgmma_wait<1>();            // S_t; P . V_{t-1} runs on
    fence_regs<32>(s);
    release(k_empty, t);
    softmax(t);
    wgmma_wait<0>();
    fence_regs<NO>(acc);
    release(v_empty, t - 1);
    rescale_and_pack();
  }
  wait_stage(v_full, n_kb - 1);   // the last V
  wgmma_fence();
  issue_pv(n_kb - 1);
  wgmma_wait<0>();
  fence_regs<NO>(acc);
  // m is in the exp2 domain of the scaled scores: ln sum exp = (m +
  // log2 l) ln 2, the same log-sum-exp as the float32 kernel's
  if constexpr (LSE) {
    if (tq == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = q0w + r0 + 8 * hr;
        if (row < Sq)
          lse[((int64_t)it.b * Hq + it.h) * Sq + row] =
              l[hr] > 0.f ? (m[hr] + log2f(l[hr])) * 0.6931471805599453f
                          : INFINITY;
      }
    }
  }

  // epilogue: each warp writes its 16 rows as bf16 into its rows of
  // the warpgroup's Q tile (no longer read), then stores them with
  // 16-byte writes; acc[4 j + e] is (row r0 + 8 (e / 2), column 8 j +
  // 2 tq + e % 2)
  const float inv[2] = {1.f / fmaxf(l[0], 1e-30f), 1.f / fmaxf(l[1], 1e-30f)};
  unsigned char* o_s = smem;
#pragma unroll
  for (int j = 0; j < HD / 8; ++j)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr)
      *reinterpret_cast<uint32_t*>(o_s + T::off(r0 + 8 * hr, j) +
                                   4 * tq) =
          pack_bf16(acc[4 * j + 2 * hr] * inv[hr],
                    acc[4 * j + 2 * hr + 1] * inv[hr]);
  __syncwarp();
  constexpr int C = HD / 8;
  for (int i = lane; i < 16 * C; i += 32) {
    const int r = warp * 16 + i / C, c = i % C;
    const int row = q0w + r;
    if (row < Sq)
      *reinterpret_cast<uint4*>(o + ((int64_t)it.b * Sq + row) * q_stride +
                                (int64_t)it.h * HD + c * 8) =
          *reinterpret_cast<const uint4*>(o_s + T::off(r, c));
  }
}

template <int HD, bool LSE>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
               int causal, float scale, cudaStream_t stream) {
  const int smem = (2 * 64 * (HD + 4) + kBQ * kLdP) * (int)sizeof(float);
  auto* fn = flash_attn_kernel<float, HD, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int64_t blocks = (int64_t)B * Hq * n_qt;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  fn<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv, Hq,
      Hkv, n_qt, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD, bool LSE>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                int causal, float scale, cudaStream_t stream) {
  // the Q tile, the K ring and the V ring, then 8 bytes per barrier
  const int smem =
      (1 + 2 * kStages) * Tile<HD>::BYTES + 8 * (1 + 4 * kStages) + 1024;
  auto* fn = flash_attn_kernel_bf16_wgmma<HD, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + kWgRows - 1) / kWgRows;
  const int64_t blocks = (int64_t)B * Hq * n_qt;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  CUtensorMap q_map, k_map, v_map;
  if (!make_map<HD>(&q_map, q, B, Sq, Hq) ||
      !make_map<HD>(&k_map, k, B, Skv, Hkv) ||
      !make_map<HD>(&v_map, v, B, Skv, Hkv))
    return (int)cudaErrorInvalidValue;
  // exp(x / sqrt(hd)) = exp2(x * scale * log2(e)), in float32
  const float scale_log2 = scale * 1.4426950408889634f;
  fn<<<(unsigned)blocks, kThreadsBf16, smem, stream>>>(
      q_map, k_map, v_map, static_cast<__nv_bfloat16*>(o), lse, Sq, Skv, Hq,
      Hkv, n_qt, causal, scale_log2);
  return (int)cudaGetLastError();
}

// a null lse launches the instances that write none (the serving and
// build path's code, unchanged); otherwise those that also write it
template <int HD>
int launch_hd(int is_bf16, const void* q, const void* k, const void* v,
              void* o, float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
              int causal, float scale, cudaStream_t stream) {
  if (lse == nullptr)
    return is_bf16 ? launch_bf16<HD, false>(q, k, v, o, lse, B, Sq, Skv, Hq,
                                            Hkv, causal, scale, stream)
                   : launch_f32<HD, false>(q, k, v, o, lse, B, Sq, Skv, Hq,
                                           Hkv, causal, scale, stream);
  return is_bf16 ? launch_bf16<HD, true>(q, k, v, o, lse, B, Sq, Skv, Hq,
                                         Hkv, causal, scale, stream)
                 : launch_f32<HD, true>(q, k, v, o, lse, B, Sq, Skv, Hq, Hkv,
                                        causal, scale, stream);
}

}  // namespace

extern "C" {

// is_bf16: 0 for float32 tensors, 1 for bfloat16; hd in {16, 32, 64, 128};
// lse: null, or (B, Hq, Sq) float32 to receive each row's log-sum-exp
int flash_attn_launch(const void* q, const void* k, const void* v, void* o,
                      float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
                      int hd, int is_bf16, int causal, float scale,
                      cudaStream_t stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Skv < 1 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  switch (hd) {
    case 16:
      return launch_hd<16>(is_bf16, q, k, v, o, lse, B, Sq, Skv, Hq, Hkv,
                            causal, scale, stream);
    case 32:
      return launch_hd<32>(is_bf16, q, k, v, o, lse, B, Sq, Skv, Hq, Hkv,
                            causal, scale, stream);
    case 64:
      return launch_hd<64>(is_bf16, q, k, v, o, lse, B, Sq, Skv, Hq, Hkv,
                            causal, scale, stream);
    case 128:
      return launch_hd<128>(is_bf16, q, k, v, o, lse, B, Sq, Skv, Hq, Hkv,
                            causal, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
