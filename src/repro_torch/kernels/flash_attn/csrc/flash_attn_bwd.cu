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
// float32 (BERT4Rec's training; the tests and the wiring check):
// flash_attn_bwd_dq_tf32_wgmma and flash_attn_bwd_dkdv_tf32_wgmma, all
// five products on the tensor cores as split TF32 (sm90_tf32.cuh: two
// TF32 parts an operand, three products, 165 TFLOP/s at float32's
// accuracy), the same two kernels and dataflow as bf16.  At BERT4Rec's
// (256, 200, 2 / 2, 32), full, the bound is 6.55 GFLOP (10 hd a pair)
// over 165 TFLOP/s, 0.0397 ms, beside 105.3 MB at 3.35 TB/s, 0.0314.
// One warpgroup a block, no producer warp: a thread pass splits each
// tile that cp.async lands and writes the parts each product needs, K and
// K^T (dQ kernel), Q, Q^T, dO and dO^T (dK / dV kernel), the transposes'
// summed index in the kpos order that lets dS and P^T go to their products
// from the accumulator's registers.  Streamed tiles of 32 rows (16 at hd
// 64 and 128) keep three blocks an SM at hd 32 (Tf32Bwd).  The tensor
// cores round their accumulator toward zero: each tile's dS . K, P^T .
// dO and dS^T . Q goes into a fresh accumulator, added to dQ, dV and dK
// in registers (one accumulator across 1,024 causal queries put dK and dV
// past the bar), and at hd 64 and 128 S and dP are summed 32 values of hd
// an accumulator (mma_tf32_ss2; over all 128 at once dQ and dK of the
// build's shape sat at 1.06 of the bar, in chunks at 0.31-0.44).
//
// ptxas (-Xptxas -v, chip_smoke.py phase 0), registers a thread and
// spills: dQ 96 / 118 / 128 / 183 at hd 16 / 32 / 64 / 128, none; dK /
// dV 162 / 160 / 168 / 255, spilling 16 bytes at hd 128 (one block an
// SM).  Measured on an NVIDIA H100 80GB HBM3 at 700 W (CUPTI, both
// kernels; scripts/flash_attn_f32_ab.py, PERF.md section 6 rows 8rb and
// 8f): 0.281 ms a call at BERT4Rec's shape (dQ 0.120, dK / dV 0.160)
// against 0.642 for the FMA kernels this replaces and 0.60-0.71 for the
// backward of scaled_dot_product_attention in float32, 7.1x the bound;
// 5.89 ms at the build's shape against 5.86-7.79 and SDPA's 6.80.
//
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

// ---------------------------------------------------------------------------
// float32: split TF32 on wgmma
// ---------------------------------------------------------------------------

// Rows of a streamed tile (keys in the dQ kernel, queries in the dK / dV
// kernel): 32, or 16 at hd 64 and 128.  Shared memory: dQ 29 / 58 / 89 /
// 177 KB and dK / dV 34 / 66 / 97 / 194 KB at hd 16 / 32 / 64 / 128, so
// three blocks an SM at hd 32, two at hd 64 and one at hd 128.
template <int HD>
struct Tf32Bwd {
  static constexpr int BT = HD <= 32 ? 32 : 16;
  static constexpr int MIN_BLOCKS = HD >= 128 ? 1 : 3;
  // values of hd summed per accumulator in S and dP (mma_tf32_ss2)
  static constexpr int CK = HD <= 32 ? HD : 32;
  using RT = TfTile<kWgRows, HD>;   // the block's own rows: Q, dO or K, V
  using ST = TfTile<BT, HD>;        // a streamed tile: K, V or Q, dO
  using TT = TfTile<HD, BT>;        // one transposed, kpos order
  // Q, dO (hi, lo); K, V (hi, lo); K^T (hi, lo); alignment room
  static constexpr int SMEM_DQ =
      4 * RT::BYTES + 4 * ST::BYTES + 2 * TT::BYTES + 1024;
  // K, V; Q, dO; Q^T, dO^T (hi, lo each); two stages of BT lse and D
  static constexpr int SMEM_DKDV =
      4 * RT::BYTES + 4 * ST::BYTES + 4 * TT::BYTES + 2 * 2 * BT * 4 + 1024;
};

// dQ of the 64 query rows q0 .. of head h, doc b, and their D: one
// warpgroup a block.
template <int HD>
__global__ void __launch_bounds__(kTfThreads, Tf32Bwd<HD>::MIN_BLOCKS)
    flash_attn_bwd_dq_tf32_wgmma(const float* __restrict__ q,
                                 const float* __restrict__ k,
                                 const float* __restrict__ v,
                                 const float* __restrict__ o,
                                 const float* __restrict__ dout,
                                 const float* __restrict__ lse,
                                 float* __restrict__ dsum,
                                 float* __restrict__ dq, int Sq, int Skv,
                                 int Hq, int Hkv, int n_qt, int causal,
                                 float scale, float scale_log2) {
  using F = Tf32Bwd<HD>;
  constexpr int BT = F::BT;
  constexpr int NS = BT / 2;     // S and dP accumulator values per thread
  constexpr int NO = HD / 2;     // dQ accumulator values per thread
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  auto at = [&](uint32_t a) { return smem + (a - base); };
  const uint32_t q_hi = base, q_lo = q_hi + F::RT::BYTES;
  const uint32_t do_hi = q_lo + F::RT::BYTES, do_lo = do_hi + F::RT::BYTES;
  const uint32_t k_hi = do_lo + F::RT::BYTES, k_lo = k_hi + F::ST::BYTES;
  const uint32_t v_hi = k_lo + F::ST::BYTES, v_lo = v_hi + F::ST::BYTES;
  const uint32_t kt_hi = v_lo + F::ST::BYTES, kt_lo = kt_hi + F::TT::BYTES;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int qt = n_qt - 1 - (int)(blockIdx.x % n_qt);  // heaviest first
  const int bh = (int)(blockIdx.x / n_qt);
  const int b = bh / Hq, h = bh % Hq, hk = h / (Hq / Hkv);
  const int q0 = qt * kWgRows;
  int n_kb = (Skv + BT - 1) / BT;
  if (causal) n_kb = min(n_kb, (min(q0 + kWgRows, Sq) - 1) / BT + 1);
  const int64_t q_stride = (int64_t)Hq * HD, kv_stride = (int64_t)Hkv * HD;
  const int64_t q_off = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD;
  const int64_t kv_base = (int64_t)b * Skv * kv_stride + (int64_t)hk * HD;
  auto load_kv = [&](int t) {
    const int64_t off = kv_base + (int64_t)t * BT * kv_stride;
    load_raw<BT, HD>(k_hi, k + off, kv_stride, Skv - t * BT, tid);
    load_raw<BT, HD>(v_hi, v + off, kv_stride, Skv - t * BT, tid);
    cp_async_commit();
  };
  load_raw<kWgRows, HD>(q_hi, q + q_off, q_stride, Sq - q0, tid);
  load_raw<kWgRows, HD>(do_hi, dout + q_off, q_stride, Sq - q0, tid);
  load_kv(0);

  // D = rowsum(dO o O) and the lse in exp2 units of this thread's fragment
  // rows r0 and r0 + 8, each summed over the 4 lanes that share the row
  // (a tail row: D 0, lse +inf, so its P is 0), while the copies land
  const int r0 = warp * 16 + g;
  float dr[2], l2[2];
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    const int row = q0 + r0 + 8 * hr;
    float part = 0.f;
    if (row < Sq) {
      const int64_t off = q_off + (int64_t)(r0 + 8 * hr) * q_stride;
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {
        const int col = (4 * c + tq) * 4;
        const float4 x =
            __ldg(reinterpret_cast<const float4*>(dout + off + col));
        const float4 y =
            __ldg(reinterpret_cast<const float4*>(o + off + col));
        part = fmaf(x.x, y.x, part);
        part = fmaf(x.y, y.y, part);
        part = fmaf(x.z, y.z, part);
        part = fmaf(x.w, y.w, part);
      }
    }
    dr[hr] = quad_sum(part);
    l2[hr] = row < Sq ? lse[(int64_t)bh * Sq + row] * kLog2e : INFINITY;
    if (tq == 0 && row < Sq) dsum[(int64_t)bh * Sq + row] = dr[hr];
  }

  float s[NS], dp[NS];           // S, then dS, and dP of one KV tile
  uint32_t dh[NS], dl[NS];       // dS's hi and lo A fragments
  float acc[NO];                 // dQ, unscaled
  float part[NO];                // dS . K of one KV tile
#pragma unroll
  for (int i = 0; i < NO; ++i) acc[i] = 0.f;
  // dS of tile t into s (s[i] is row q0 + r0 + 8 ((i >> 1) & 1), key 8 (i
  // / 4) + 2 tq + (i & 1) of the tile), as the bf16 kernel forms it
  auto dsoftmax = [&](int t) {
    const int kv0 = t * BT;
    if (kv0 + BT > Skv || (causal && kv0 + BT - 1 > q0)) {
#pragma unroll
      for (int i = 0; i < NS; ++i) {
        const int col = kv0 + 8 * (i / 4) + 2 * tq + (i & 1);
        const int row = q0 + r0 + 8 * ((i >> 1) & 1);
        if (col >= Skv || (causal && col > row)) s[i] = -INFINITY;
      }
    }
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int hr = (i >> 1) & 1;
      s[i] = ex2(fmaf(s[i], scale_log2, -l2[hr])) * (dp[i] - dr[hr]);
    }
  };

  cp_async_wait<0>();
  __syncthreads();
  split_tile<F::RT::BYTES>(at(q_hi), at(q_lo), tid);
  split_tile<F::RT::BYTES>(at(do_hi), at(do_lo), tid);
  // Per KV tile: K_t's parts (and K^T's) and V_t's; S = Q . K^T and dP =
  // dO . V^T; with K_{t+1} and V_{t+1} in flight, dS, then dS . K into a
  // fresh accumulator, added to dQ.
  for (int t = 0; t < n_kb; ++t) {
    split_tile_t<BT, HD, true>(at(k_hi), at(k_lo), at(kt_hi), at(kt_lo),
                               tid);
    split_tile<F::ST::BYTES>(at(v_hi), at(v_lo), tid);
    fence_proxy_async();
    __syncthreads();
    mma_tf32_ss2<BT, HD, F::CK>(s, q_hi, q_lo, k_hi, k_lo, dp, do_hi, do_lo,
                                v_hi, v_lo);
    __syncthreads();   // S's and dP's reads of K_t and V_t are done
    if (t + 1 < n_kb) load_kv(t + 1);
    dsoftmax(t);
    split_acc_tf32<BT>(s, dh, dl);
    wgmma_fence();
    issue_tf32_rs<HD, BT>(part, dh, dl, kt_hi, kt_lo, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(part);
    fence_frag<NS>(dh);
    fence_frag<NS>(dl);
#pragma unroll
    for (int i = 0; i < NO; ++i) acc[i] += part[i];
    if (t + 1 < n_kb) {
      cp_async_wait<0>();
      __syncthreads();   // K_{t+1} and V_{t+1} landed; dQ's reads of K^T done
    }
  }

  // dQ times 1/sqrt(hd); acc[4 j + e] is (row r0 + 8 (e / 2), column 8 j
  // + 2 tq + e % 2)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (q0 + r0 + 8 * hr >= Sq) continue;
    float* out = dq + q_off + (int64_t)(r0 + 8 * hr) * q_stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j)
      *reinterpret_cast<float2*>(out + 8 * j + 2 * tq) =
          make_float2(acc[4 * j + 2 * hr] * scale,
                      acc[4 * j + 2 * hr + 1] * scale);
  }
}

// dK and dV of the 64 keys k0 .. of KV head hk, doc b: one warpgroup a
// block.
template <int HD>
__global__ void __launch_bounds__(kTfThreads, Tf32Bwd<HD>::MIN_BLOCKS)
    flash_attn_bwd_dkdv_tf32_wgmma(const float* __restrict__ q,
                                   const float* __restrict__ k,
                                   const float* __restrict__ v,
                                   const float* __restrict__ dout,
                                   const float* __restrict__ lse,
                                   const float* __restrict__ dsum,
                                   float* __restrict__ dk,
                                   float* __restrict__ dv, int Sq, int Skv,
                                   int Hq, int Hkv, int n_kt, int causal,
                                   float scale, float scale_log2) {
  using F = Tf32Bwd<HD>;
  constexpr int BT = F::BT;
  constexpr int NS = BT / 2;     // S^T and dP^T accumulator values
  constexpr int NO = HD / 2;     // dK and dV accumulator values
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);
  auto at = [&](uint32_t a) { return smem + (a - base); };
  const uint32_t k_hi = base, k_lo = k_hi + F::RT::BYTES;
  const uint32_t v_hi = k_lo + F::RT::BYTES, v_lo = v_hi + F::RT::BYTES;
  const uint32_t q_hi = v_lo + F::RT::BYTES, q_lo = q_hi + F::ST::BYTES;
  const uint32_t do_hi = q_lo + F::ST::BYTES, do_lo = do_hi + F::ST::BYTES;
  const uint32_t qt_hi = do_lo + F::ST::BYTES, qt_lo = qt_hi + F::TT::BYTES;
  const uint32_t dot_hi = qt_lo + F::TT::BYTES;
  const uint32_t dot_lo = dot_hi + F::TT::BYTES;
  const uint32_t vec = dot_lo + F::TT::BYTES;  // per stage: lse, then D

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, tq = lane % 4;
  const int kt = (int)(blockIdx.x % n_kt);       // heaviest (first) first
  const int bk = (int)(blockIdx.x / n_kt);
  const int b = bk / Hkv, hk = bk % Hkv, G = Hq / Hkv;
  const int k0 = kt * kWgRows;
  const int n_qt = (Sq + BT - 1) / BT;
  const int qt0 = causal ? k0 / BT : 0;          // query tiles that see k0 ..
  const int per_head = max(0, n_qt - qt0);
  const int n_tiles = G * per_head;              // head-major, then tiles
  const int64_t q_stride = (int64_t)Hq * HD, kv_stride = (int64_t)Hkv * HD;
  const int64_t kv_off = ((int64_t)b * Skv + k0) * kv_stride +
                         (int64_t)hk * HD;
  // tile n's Q and dO rows and its BT lse and D (zeros past Sq) into stage
  // n % 2 of the vectors
  auto load_tile = [&](int n) {
    const int h = hk * G + n / per_head;
    const int q0 = (qt0 + n % per_head) * BT;
    const int64_t bh = (int64_t)b * Hq + h;
    const int64_t off = ((int64_t)b * Sq + q0) * q_stride + (int64_t)h * HD;
    load_raw<BT, HD>(q_hi, q + off, q_stride, Sq - q0, tid);
    load_raw<BT, HD>(do_hi, dout + off, q_stride, Sq - q0, tid);
    const uint32_t stage = vec + (n % 2) * 2 * BT * 4;
    for (int i = tid; i < BT; i += kTfThreads) {
      const bool in = q0 + i < Sq;
      const int64_t row = in ? bh * Sq + q0 + i : 0;
      cp_async4(stage + 4 * i, lse + row, in ? 4 : 0);
      cp_async4(stage + 4 * (BT + i), dsum + row, in ? 4 : 0);
    }
    cp_async_commit();
  };
  load_raw<kWgRows, HD>(k_hi, k + kv_off, kv_stride, Skv - k0, tid);
  load_raw<kWgRows, HD>(v_hi, v + kv_off, kv_stride, Skv - k0, tid);
  cp_async_commit();
  if (n_tiles > 0) load_tile(0);

  const int r0 = warp * 16 + g;
  float st[NS], dpt[NS];         // S^T, then P^T; dP^T, then dS^T
  uint32_t xh[NS], xl[NS];       // P^T's, then dS^T's, hi and lo fragments
  float dka[NO], dva[NO];        // dK (unscaled) and dV
  float part[NO];                // one tile's dV, then its dK
#pragma unroll
  for (int i = 0; i < NO; ++i) dka[i] = dva[i] = 0.f;
  cp_async_wait<0>();
  __syncthreads();
  split_tile<F::RT::BYTES>(at(k_hi), at(k_lo), tid);
  split_tile<F::RT::BYTES>(at(v_hi), at(v_lo), tid);
  // Per tile, in the order of the sum: the parts of Q, dO and their
  // transposes; S^T = K . Q^T and dP^T = V . dO^T; P^T; with the next
  // tile in flight, P^T . dO, added to dV; dS^T while it
  // runs; dS^T . Q, added to dK (each product into a fresh accumulator).
  // st[i] and dpt[i] are (key k0 + r0 + 8 ((i >> 1) & 1), query q0 +
  // c(i)), c(i) = 8 (i / 4) + 2 tq + (i & 1): lse and D belong to the
  // column.  Keys past Skv are never stored.
  for (int n = 0; n < n_tiles; ++n) {
    const int q0 = (qt0 + n % per_head) * BT;
    const float* ls = reinterpret_cast<const float*>(
        at(vec + (n % 2) * 2 * BT * 4));
    const float* dd = ls + BT;
    split_tile_t<BT, HD, true>(at(q_hi), at(q_lo), at(qt_hi), at(qt_lo),
                               tid);
    split_tile_t<BT, HD, true>(at(do_hi), at(do_lo), at(dot_hi),
                               at(dot_lo), tid);
    fence_proxy_async();
    __syncthreads();
    mma_tf32_ss2<BT, HD, F::CK>(st, k_hi, k_lo, q_hi, q_lo, dpt, v_hi,
                                v_lo, do_hi, do_lo);
    // a tail query (lse and D read as 0) and, under the causal mask, a
    // query before the key give 0
    const bool edge = q0 + BT > Sq || (causal && q0 < k0 + kWgRows - 1);
#pragma unroll
    for (int i = 0; i < NS; ++i) {
      const int c = 8 * (i / 4) + 2 * tq + (i & 1);
      const float p = ex2(fmaf(st[i], scale_log2, -ls[c] * kLog2e));
      st[i] = edge && (q0 + c >= Sq ||
                       (causal && q0 + c < k0 + r0 + 8 * ((i >> 1) & 1)))
                  ? 0.f
                  : p;
    }
    split_acc_tf32<BT>(st, xh, xl);
    __syncthreads();   // S^T's and dP^T's reads of Q and dO are done
    if (n + 1 < n_tiles) load_tile(n + 1);
    wgmma_fence();
    issue_tf32_rs<HD, BT>(part, xh, xl, dot_hi, dot_lo, 0);
    wgmma_commit();
#pragma unroll
    for (int i = 0; i < NS; ++i)
      dpt[i] = st[i] * (dpt[i] - dd[8 * (i / 4) + 2 * tq + (i & 1)]);
    wgmma_wait<0>();
    fence_regs<NO>(part);
    fence_frag<NS>(xh);
    fence_frag<NS>(xl);
#pragma unroll
    for (int i = 0; i < NO; ++i) dva[i] += part[i];
    split_acc_tf32<BT>(dpt, xh, xl);
    wgmma_fence();
    issue_tf32_rs<HD, BT>(part, xh, xl, qt_hi, qt_lo, 0);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs<NO>(part);
    fence_frag<NS>(xh);
    fence_frag<NS>(xl);
#pragma unroll
    for (int i = 0; i < NO; ++i) dka[i] += part[i];
    if (n + 1 < n_tiles) {
      cp_async_wait<0>();
      __syncthreads();   // the next tile landed; dV's and dK's reads done
    }
  }

  // dK times 1/sqrt(hd) and dV; dka[4 j + e] is (key r0 + 8 (e / 2),
  // column 8 j + 2 tq + e % 2)
#pragma unroll
  for (int hr = 0; hr < 2; ++hr) {
    if (k0 + r0 + 8 * hr >= Skv) continue;
    const int64_t off = kv_off + (int64_t)(r0 + 8 * hr) * kv_stride;
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      const int col = 8 * j + 2 * tq;
      *reinterpret_cast<float2*>(dk + off + col) =
          make_float2(dka[4 * j + 2 * hr] * scale,
                      dka[4 * j + 2 * hr + 1] * scale);
      *reinterpret_cast<float2*>(dv + off + col) =
          make_float2(dva[4 * j + 2 * hr], dva[4 * j + 2 * hr + 1]);
    }
  }
}

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, const void* o,
               const void* dout, const float* lse, float* dsum, void* dq,
               void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
               int causal, float scale, cudaStream_t stream) {
  using F = Tf32Bwd<HD>;
  if (Sq == 0) {      // no query sees a key: dK and dV are 0
    const size_t n = (size_t)B * Skv * Hkv * HD * 4;
    cudaError_t err = cudaMemsetAsync(dk, 0, n, stream);
    if (err == cudaSuccess) err = cudaMemsetAsync(dv, 0, n, stream);
    return (int)err;
  }
  auto* fn_dq = flash_attn_bwd_dq_tf32_wgmma<HD>;
  auto* fn_dkdv = flash_attn_bwd_dkdv_tf32_wgmma<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      fn_dq, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM_DQ);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(
      fn_dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize, F::SMEM_DKDV);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + kWgRows - 1) / kWgRows;
  const int n_kt = (Skv + kWgRows - 1) / kWgRows;
  const int64_t blocks_dq = (int64_t)B * Hq * n_qt;
  const int64_t blocks_dkdv = (int64_t)B * Hkv * n_kt;
  if (blocks_dq > 0x7fffffff || blocks_dkdv > 0x7fffffff)
    return (int)cudaErrorInvalidConfiguration;
  // exp(x / sqrt(hd) - lse) = exp2(x * scale * log2(e) - lse * log2(e))
  const float scale_log2 = scale * kLog2e;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tdo = static_cast<const float*>(dout);
  fn_dq<<<(unsigned)blocks_dq, kTfThreads, F::SMEM_DQ, stream>>>(
      tq, tk, tv, static_cast<const float*>(o), tdo, lse, dsum,
      static_cast<float*>(dq), Sq, Skv, Hq, Hkv, n_qt, causal, scale,
      scale_log2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  fn_dkdv<<<(unsigned)blocks_dkdv, kTfThreads, F::SMEM_DKDV, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<float*>(dk),
      static_cast<float*>(dv), Sq, Skv, Hq, Hkv, n_kt, causal, scale,
      scale_log2);
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
