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
// float32 (BERT4Rec's attention, serving and training; the tests and the
// wiring check): flash_attn_kernel_tf32_wgmma, every product on the
// tensor cores as split TF32 (sm90_tf32.cuh): each float32 operand as two
// TF32 parts, hi = tf32(x) and lo = tf32(x - hi), and three wgmma m64nNk8
// a k-step, lo . hi, hi . lo, hi . hi, which keeps float32's accuracy
// (one TF32 part misses rtol 1e-4 / atol 1e-5 on most values) at the
// tensor cores' 495 / 3 = 165 TFLOP/s, against the CUDA cores' 67.
// At BERT4Rec's (256, 200, 2 / 2, 32), full, the bound is then 2.62
// GFLOP over 165 TFLOP/s, 0.0159 ms, beside 52.4 MB at 3.35 TB/s, 0.0156.
// One warpgroup a block (64 query rows of one head), no producer warp:
// TF32 wgmma has no transpose bit and TMA cannot split a value in two, so
// a thread pass over every loaded tile writes its hi and lo parts in the
// major order each product needs (Q and K as loaded, V as V^T) while
// cp.async brings the next KV tile's raw rows.  S = Q . K^T runs while the
// threads split V; P goes to P . V from registers: the accumulator holds
// columns (2t, 2t + 1) where TF32's register-A fragment wants (t, t + 4),
// so V^T's keys are written in that permuted order (kpos) instead of
// moving P between lanes.  The tensor cores round their accumulator
// toward zero, so P . V runs into a fresh accumulator each KV tile and O
// = O corr + P . V is taken in registers.  Key tiles of 32 (16 at hd
// 128) keep 5 blocks an SM at hd 32 (Tf32Fwd): 200 keys are 7 tiles.
// The scale, the lse and the epilogue are the bf16 kernel's; o is written
// in float32 from the registers.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUPTI;
// scripts/flash_attn_f32_ab.py, PERF.md section 6 rows 8r and 8f keep
// the numbers and their runs): 0.092 ms at BERT4Rec's shape against 0.228
// for the FMA kernel this replaces and 0.246 for
// scaled_dot_product_attention in float32, 5.8x the bound; 1.46 ms at the
// build's shape in float32 against 1.78-1.95 and SDPA's 5.52.  Key tiles
// of 64 at three blocks an SM took 0.099 ms; S's and P . V's small terms
// in an accumulator apart from hi . hi (two shorter wgmma chains) and six
// blocks an SM measured no faster.  ptxas: 96 / 96 / 136 / 186 registers
// a thread at hd 16 / 32 / 64 / 128 (two more with the lse), hd 32
// spilling 4 bytes under the five-block bound.
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
#include "sm90_tf32.cuh"

namespace {

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

// ---------------------------------------------------------------------------
// float32: split TF32 on wgmma
// ---------------------------------------------------------------------------

// keys per KV tile: 32, or 16 at hd 128; shared memory 19 / 37 / 73 /
// 105 KB at hd 16 / 32 / 64 / 128, so 5 / 5 / 3 / 2 blocks an SM (the
// register bound for 5 is 102 a thread)
template <int HD>
struct Tf32Fwd {
  static constexpr int BN = HD <= 64 ? 32 : 16;
  static constexpr int MIN_BLOCKS = HD >= 128 ? 2 : (HD <= 32 ? 5 : 3);
  using QT = TfTile<kWgRows, HD>;   // Q, K-major over hd
  using KT = TfTile<BN, HD>;        // K; also V's raw rows
  using VT = TfTile<HD, BN>;        // V^T, K-major over keys in kpos order
  // Q hi, lo; K hi, lo; V^T hi, lo; V raw; room to align to 1,024 bytes
  static constexpr int SMEM =
      2 * QT::BYTES + 3 * KT::BYTES + 2 * VT::BYTES + 1024;
};

// One warpgroup a block: the 64 query rows q0 .. of head h of doc b.
template <int HD, bool LSE>
__global__ void __launch_bounds__(kTfThreads, Tf32Fwd<HD>::MIN_BLOCKS)
    flash_attn_kernel_tf32_wgmma(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 float* __restrict__ o,
                                 float* __restrict__ lse, int Sq, int Skv,
                                 int Hq, int Hkv, int n_qt, int causal,
                                 float scale_log2) {
  using F = Tf32Fwd<HD>;
  constexpr int BN = F::BN;
  constexpr int NS = BN / 2;     // S accumulator values per thread
  constexpr int NO = HD / 2;     // O accumulator values per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  auto at = [&](uint32_t a) { return smem + (a - base); };
  const uint32_t q_hi = base, q_lo = q_hi + F::QT::BYTES;
  const uint32_t k_hi = q_lo + F::QT::BYTES, k_lo = k_hi + F::KT::BYTES;
  const uint32_t v_raw = k_lo + F::KT::BYTES;
  const uint32_t vt_hi = v_raw + F::KT::BYTES, vt_lo = vt_hi + F::VT::BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  // the blocks of one KV head are neighbours, heaviest query tile first
  // (as item_at numbers the bf16 kernel's)
  const int G = Hq / Hkv, per_kv = G * n_qt;
  const int bk = (int)(blockIdx.x / per_kv);
  const int in_kv = (int)(blockIdx.x % per_kv);
  const int b = bk / Hkv, hk = bk % Hkv, h = hk * G + in_kv % G;
  const int q0 = (n_qt - 1 - in_kv / G) * kWgRows;
  int n_kb = (Skv + BN - 1) / BN;
  if (causal) n_kb = min(n_kb, (min(q0 + kWgRows, Sq) - 1) / BN + 1);
  const int64_t q_stride = (int64_t)Hq * HD, kv_stride = (int64_t)Hkv * HD;
  const int64_t kv_base = (int64_t)b * Skv * kv_stride + (int64_t)hk * HD;
  // K_t and V_t's raw rows, zeros past Skv
  auto load_kv = [&](int t) {
    const int64_t off = kv_base + (int64_t)t * BN * kv_stride;
    load_raw<BN, HD>(k_hi, k + off, kv_stride, Skv - t * BN, tid);
    load_raw<BN, HD>(v_raw, v + off, kv_stride, Skv - t * BN, tid);
    cp_async_commit();
  };

  float s[NS];                   // S, then P in float32, of one KV tile
  uint32_t ph[NS], pl[NS];       // P's hi and lo A fragments
  float acc[NO];                 // O, unnormalised
  float pv[NO];                  // P . V of one KV tile
  float m[2], l[2], corr[2];
  const int r0 = warp * 16 + g;  // fragment rows r0 and r0 + 8
  // the online softmax of tile t on s (s[4 j + e] is row r0 + 8 (e / 2),
  // key 8 j + 2 tq + e % 2), as the bf16 kernel's: the row max of the
  // unscaled scores, the scale in the exponent's FMA, p = 2^(s * scale_log2
  // - m); the causal mask only on tiles that straddle the diagonal, the
  // tail mask only on the last
  auto softmax = [&](int t) {
    const int kv0 = t * BN;
    if (kv0 + BN > Skv || (causal && kv0 + BN - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = kv0 + 8 * (i / 4) + 2 * tq + (i & 1);
        const int row = q0 + r0 + 8 * ((i >> 1) & 1);
        if (col >= Skv || (causal && col > row)) s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(s[4 * j + 2 * hr], s[4 * j + 2 * hr + 1]));
      const float m_new = fmaxf(m[hr], quad_max(mx) * scale_log2);
      const float m_safe = m_new == -INFINITY ? 0.f : m_new;
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
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

#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  m[0] = m[1] = -INFINITY;
  l[0] = l[1] = 0.f;
  load_raw<kWgRows, HD>(q_hi, q + ((int64_t)b * Sq + q0) * q_stride +
                                  (int64_t)h * HD,
                        q_stride, Sq - q0, tid);
  load_kv(0);
  cp_async_wait<0>();
  __syncthreads();
  split_tile<F::QT::BYTES>(at(q_hi), at(q_lo), tid);
  split_tile<F::KT::BYTES>(at(k_hi), at(k_lo), tid);
  fence_proxy_async();
  __syncthreads();
  // Per KV tile: S = Q . K^T on the tensor cores while the threads split
  // V into V^T's parts; the softmax; then, with K_{t+1} and V_{t+1} in
  // flight, P . V into a fresh accumulator, and O = O corr + P . V.
  for (int t = 0; t < n_kb; ++t) {
    wgmma_fence();
    issue_tf32_ss<BN, HD>(s, q_hi, q_lo, k_hi, k_lo, 0);
    wgmma_commit();
    split_tile_t<BN, HD, false>(at(v_raw), nullptr, at(vt_hi), at(vt_lo),
                                tid);
    fence_proxy_async();
    wgmma_wait<0>();
    fence_regs<NS>(s);
    softmax(t);
    split_acc_tf32<BN>(s, ph, pl);
    __syncthreads();   // S's reads of K and every part of V^T are done
    if (t + 1 < n_kb) load_kv(t + 1);
    wgmma_fence();
    issue_tf32_rs<HD, BN>(pv, ph, pl, vt_hi, vt_lo, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(pv);
    fence_frag<NS>(ph);
    fence_frag<NS>(pl);
#pragma unroll
    for (int i = 0; i < NO; ++i)
      acc[i] = fmaf(acc[i], corr[(i >> 1) & 1], pv[i]);
    if (t + 1 < n_kb) {
      cp_async_wait<0>();
      __syncthreads();   // K_{t+1} and V_{t+1} landed; P . V's reads done
      split_tile<F::KT::BYTES>(at(k_hi), at(k_lo), tid);
      fence_proxy_async();
      __syncthreads();
    }
  }
  // m is in the exp2 domain of the scaled scores: ln sum exp = (m + log2
  // l) ln 2, as the bf16 kernel writes it
  if constexpr (LSE) {
    if (tq == 0) {
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int row = q0 + r0 + 8 * hr;
        if (row < Sq)
          lse[((int64_t)b * Hq + h) * Sq + row] =
              l[hr] > 0.f ? (m[hr] + log2f(l[hr])) * 0.6931471805599453f
                          : INFINITY;
      }
    }
  }
  // acc[4 j + e] is (row r0 + 8 (e / 2), column 8 j + 2 tq + e % 2)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + 8 * hr;
    if (row >= Sq) continue;
    const float den = fmaxf(l[hr], 1e-30f);
    float* out = o + ((int64_t)b * Sq + row) * q_stride + (int64_t)h * HD;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * tq) =
          make_float2(acc[4 * j + 2 * hr] / den,
                      acc[4 * j + 2 * hr + 1] / den);
  }
}

template <int HD, bool LSE>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int Sq, int Skv, int Hq, int Hkv,
               int causal, float scale, cudaStream_t stream) {
  using F = Tf32Fwd<HD>;
  auto* fn = flash_attn_kernel_tf32_wgmma<HD, LSE>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + kWgRows - 1) / kWgRows;
  const int64_t blocks = (int64_t)B * Hq * n_qt;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  // exp(x / sqrt(hd)) = exp2(x * scale * log2(e)), in float32
  const float scale_log2 = scale * 1.4426950408889634f;
  fn<<<(unsigned)blocks, kTfThreads, F::SMEM, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, Sq, Skv, Hq,
      Hkv, n_qt, causal, scale_log2);
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
