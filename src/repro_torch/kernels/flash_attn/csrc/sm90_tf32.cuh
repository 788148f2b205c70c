// Hopper (sm_90a) building blocks of the float32 flash_attn kernels in
// flash_attn.cu and flash_attn_bwd.cu, which run every product on the
// tensor cores as split TF32: each float32 operand x enters as two TF32
// parts, hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), and a product a . b
// is issued as lo_a . hi_b + hi_a . lo_b + hi_a . hi_b into one float32
// accumulator, three wgmma m64nNk8 a k-step of 8, always in that order.
// hi + lo holds x to about 2^-22 of it, so the product keeps float32's
// accuracy (one TF32 part alone misses rtol 1e-4 / atol 1e-5); the lo . lo
// term is below that and left out.  The tensor cores add into their
// accumulator rounding toward zero, so a sum over many tiles (O over the
// keys, dQ, dK and dV) is taken one tile at a time into a fresh
// accumulator and added to its float32 total in registers, rounded to
// nearest: kept in one accumulator across 1,024 queries, dK and dV drift
// past rtol 1e-4 under the causal mask, where the early keys' sums are
// large and one-signed.
//
// TF32 wgmma has no transpose bit: both shared-memory operands are
// K-major (the summed index contiguous).  Tiles hold ROWS rows of KE
// values, as column blocks of W bytes a row (W = 128, or 4 KE below 32
// values), each block [ROWS][W] in wgmma's W-byte swizzle, every tile on a
// 1,024-byte boundary: the byte layout of sm90.cuh's bf16 tiles, whose
// 32-byte k-step is 8 TF32 values here.  The thread pass that splits a
// loaded tile writes its two parts in whichever major order its product
// needs.
//
// P and dS go to their products from registers.  The accumulator holds
// columns (2t, 2t + 1) of each 8-column step in lane t of a quad, where
// the TF32 register-A fragment wants (t, t + 4); so a step's summed index
// is permuted, key (or query) 2j + e of each group of 8 taking place 4 e +
// j, and the B operand of such a product is written in the same order
// (kpos), rather than shuffling P or dS between lanes.
#pragma once

#include <cstdint>

#include "sm90.cuh"

namespace {

constexpr int kTfThreads = 128;   // a block: one warpgroup

template <int ROWS, int KE>
struct TfTile {
  static_assert(ROWS % 8 == 0 && KE % 8 == 0, "rows and values by 8");
  static constexpr int W = KE >= 32 ? 128 : 4 * KE;   // bytes per block row
  static constexpr int CPB = W / 16;                  // chunks per block row
  static constexpr int BYTES = ROWS * KE * 4;
  static constexpr uint64_t LAYOUT = W == 128 ? 1 : (W == 64 ? 2 : 3);

  // byte offset of 16-byte chunk c (values 4 c .. 4 c + 3) of row r
  __device__ static __forceinline__ uint32_t off(int r, int c) {
    const uint32_t o =
        (uint32_t)((c / CPB) * ROWS * W + r * W + (c % CPB) * 16);
    return o ^ (((o >> 7) & (CPB - 1)) << 4);
  }
  // byte offset of value e of row r
  __device__ static __forceinline__ uint32_t at(int r, int e) {
    return off(r, e / 4) + 4 * (e % 4);
  }
  // the descriptor of k-step kk (values 8 kk .. 8 kk + 7) of the tile at
  // shared address t
  __device__ static __forceinline__ uint64_t desc(uint32_t t, int kk) {
    return make_desc(t + (kk * 32 / W) * ROWS * W + (kk * 32) % W, 16, 8 * W,
                     LAYOUT);
  }
};

// where value p of a summed index goes in a B operand read against an A
// fragment made from an accumulator: 2 j + e of each 8 to 4 e + j
__device__ __forceinline__ int kpos(int p) {
  return (p & ~7) | ((p & 1) << 2) | ((p >> 1) & 3);
}

__device__ __forceinline__ uint32_t tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// x as hi = tf32(x) and lo = tf32(x - hi), both as float32 bit patterns
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

// An accumulator fragment (64 x N) as the hi and lo A fragments of its
// N / 8 k-steps: step kk's are hi[4 kk ..] and lo[4 kk ..], a0 .. a3 =
// (row g, place t), (g + 8, t), (g, t + 4), (g + 8, t + 4), which hold the
// accumulator's columns 2 t, 2 t, 2 t + 1, 2 t + 1 (see kpos)
template <int N>
__device__ __forceinline__ void split_acc_tf32(const float* x, uint32_t* hi,
                                               uint32_t* lo) {
#pragma unroll
  for (int kk = 0; kk < N / 8; ++kk) {
    split_tf32(x[4 * kk], hi[4 * kk], lo[4 * kk]);
    split_tf32(x[4 * kk + 2], hi[4 * kk + 1], lo[4 * kk + 1]);
    split_tf32(x[4 * kk + 1], hi[4 * kk + 2], lo[4 * kk + 2]);
    split_tf32(x[4 * kk + 3], hi[4 * kk + 3], lo[4 * kk + 3]);
  }
}

// 16 bytes from global to shared memory, bypassing L1; src_bytes 0 writes
// zeros (rows past a sequence)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes, likewise
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}
// this thread's writes to shared memory are seen by the async proxy
// (wgmma's operand reads) after the next barrier
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
// rows [0, n) of a (ROWS x KE) float32 block at src (row stride `stride`
// values; rows from n on as zeros) into the tile at shared address t, raw,
// with cp.async: a 16-byte chunk a copy, neighbouring threads on
// neighbouring chunks of a row
template <int ROWS, int KE>
__device__ __forceinline__ void load_raw(uint32_t t, const float* src,
                                         int64_t stride, int n, int tid) {
  using Tt = TfTile<ROWS, KE>;
  constexpr int C = KE / 4;
  for (int i = tid; i < ROWS * C; i += kTfThreads) {
    const int r = i / C, c = i % C;
    const bool in = r < n;
    cp_async16(t + Tt::off(r, c), src + (in ? r * stride + 4 * c : 0),
               in ? 16 : 0);
  }
}

// the raw float32 tile in `hi` as its two TF32 parts, hi in place and lo
// at the same offsets of `lo`
template <int BYTES>
__device__ __forceinline__ void split_tile(unsigned char* hi,
                                           unsigned char* lo, int tid) {
  for (int i = tid; i < BYTES / 16; i += kTfThreads) {
    uint4* h = reinterpret_cast<uint4*>(hi + 16 * i);
    const float4 x = *reinterpret_cast<const float4*>(h);
    uint4 a, b;
    split_tf32(x.x, a.x, b.x);
    split_tf32(x.y, a.y, b.y);
    split_tf32(x.z, a.z, b.z);
    split_tf32(x.w, a.w, b.w);
    *h = a;
    *reinterpret_cast<uint4*>(lo + 16 * i) = b;
  }
}

// the raw float32 (ROWS x KE) tile in `hi` as its two TF32 parts
// transposed, (KE x ROWS) tiles t_hi and t_lo whose values (the tile's
// rows) sit in kpos order; with KEEP also as split_tile does.  Neighbouring
// threads take neighbouring rows, so the transposed writes of a warp land
// in one row of t_hi and t_lo
template <int ROWS, int KE, bool KEEP>
__device__ __forceinline__ void split_tile_t(unsigned char* hi,
                                             unsigned char* lo,
                                             unsigned char* t_hi,
                                             unsigned char* t_lo, int tid) {
  using S = TfTile<ROWS, KE>;
  using T = TfTile<KE, ROWS>;
  for (int i = tid; i < ROWS * KE / 4; i += kTfThreads) {
    const int r = i % ROWS, c = i / ROWS;
    const uint32_t o = S::off(r, c);
    const float4 x = *reinterpret_cast<const float4*>(hi + o);
    uint32_t a[4], b[4];
    split_tf32(x.x, a[0], b[0]);
    split_tf32(x.y, a[1], b[1]);
    split_tf32(x.z, a[2], b[2]);
    split_tf32(x.w, a[3], b[3]);
    if constexpr (KEEP) {
      *reinterpret_cast<uint4*>(hi + o) = make_uint4(a[0], a[1], a[2], a[3]);
      *reinterpret_cast<uint4*>(lo + o) = make_uint4(b[0], b[1], b[2], b[3]);
    }
    const int p = kpos(r);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      *reinterpret_cast<uint32_t*>(t_hi + T::at(4 * c + e, p)) = a[e];
      *reinterpret_cast<uint32_t*>(t_lo + T::at(4 * c + e, p)) = b[e];
    }
  }
}

// D (64 x N, f32) (+)= A . B^T over one k-step of 8: A (64 x 8) and B
// (N x 8) tf32, both K-major in shared memory; scale_d 0 overwrites D
template <int N>
__device__ __forceinline__ void wgmma_tf32_ss(float* d, uint64_t da,
                                              uint64_t db, int scale_d) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, %16, %17, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "l"(da), "l"(db), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "l"(da), "l"(db), "r"(scale_d));
  } else {
    static_assert(N == 16, "N is one of 16, 32, 64");
  }
}

// D (64 x N, f32) (+)= A . B^T over one k-step of 8: A (64 x 8) tf32 in
// registers (wgmma's register-A fragment), B (N x 8) K-major in shared
// memory; scale_d 0 overwrites D
template <int N>
__device__ __forceinline__ void wgmma_tf32_rs(float* d, const uint32_t* a,
                                              uint64_t db, int scale_d) {
  if constexpr (N == 16) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (N == 32) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (N == 64) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else if constexpr (N == 128) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
        "{%0, %1, %2, %3, %4, %5, %6, %7, "
        "%8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, "
        "%24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, "
        "%40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, "
        "%56, %57, %58, %59, %60, %61, %62, %63}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
  } else {
    static_assert(N == 16, "N is one of 16, 32, 64, 128");
  }
}

// C (64 x N, f32) (+)= A . B^T over the NK k-steps from kk0 (all of KE
// by default), split TF32: A a (64 x KE) and B a (N x KE) tile pair (hi,
// lo), both K-major; acc 0 overwrites C
template <int N, int KE, int NK = KE / 8>
__device__ __forceinline__ void issue_tf32_ss(float* c, uint32_t a_hi,
                                              uint32_t a_lo, uint32_t b_hi,
                                              uint32_t b_lo, int acc,
                                              int kk0 = 0) {
  using TA = TfTile<64, KE>;
  using TB = TfTile<N, KE>;
#pragma unroll
  for (int i = 0; i < NK; ++i) {
    const int kk = kk0 + i;
    wgmma_tf32_ss<N>(c, TA::desc(a_lo, kk), TB::desc(b_hi, kk),
                     acc || i > 0);
    wgmma_tf32_ss<N>(c, TA::desc(a_hi, kk), TB::desc(b_lo, kk), 1);
    wgmma_tf32_ss<N>(c, TA::desc(a_hi, kk), TB::desc(b_hi, kk), 1);
  }
}

// C = A . B^T and D = E . F^T (64 x N, f32) over KE values, split TF32
// (operands as issue_tf32_ss takes them), waited for.  Each chunk of CK
// values goes into a fresh accumulator and is added to C or D in
// registers, rounded to nearest, so the tensor cores' round-toward-zero
// acts on a CK-value sum and not on the whole: over hd 128 in one
// accumulator the backward's S and dP drift past rtol 1e-4 / atol 1e-5
// on dQ and dK, whose rows cancel.  With CK = KE it is one pair of
// products.
template <int N, int KE, int CK>
__device__ __forceinline__ void mma_tf32_ss2(float* c, uint32_t a_hi,
                                             uint32_t a_lo, uint32_t b_hi,
                                             uint32_t b_lo, float* d,
                                             uint32_t e_hi, uint32_t e_lo,
                                             uint32_t f_hi, uint32_t f_lo) {
  constexpr int NC = N / 2;
  float pc[2][NC], pd[2][NC];
  auto add = [&](int ch) {
    float* x = pc[ch & 1];
    float* y = pd[ch & 1];
    fence_regs<NC>(x);
    fence_regs<NC>(y);
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      c[i] = ch == 0 ? x[i] : c[i] + x[i];
      d[i] = ch == 0 ? y[i] : d[i] + y[i];
    }
  };
#pragma unroll
  for (int ch = 0; ch < KE / CK; ++ch) {
    wgmma_fence();
    issue_tf32_ss<N, KE, CK / 8>(pc[ch & 1], a_hi, a_lo, b_hi, b_lo, 0,
                                 ch * CK / 8);
    issue_tf32_ss<N, KE, CK / 8>(pd[ch & 1], e_hi, e_lo, f_hi, f_lo, 0,
                                 ch * CK / 8);
    wgmma_commit();
    if (ch > 0) {
      wgmma_wait<1>();
      add(ch - 1);
    }
  }
  wgmma_wait<0>();
  add(KE / CK - 1);
}

// C (64 x N, f32) (+)= A . B^T over K values, split TF32: A's hi and lo
// fragments in registers (split_acc_tf32 of a 64 x K accumulator), B an
// (N x K) tile pair (hi, lo) whose values sit in kpos order; acc 0
// overwrites C
template <int N, int K>
__device__ __forceinline__ void issue_tf32_rs(float* c, const uint32_t* hi,
                                              const uint32_t* lo,
                                              uint32_t b_hi, uint32_t b_lo,
                                              int acc) {
  using TB = TfTile<N, K>;
#pragma unroll
  for (int kk = 0; kk < K / 8; ++kk) {
    wgmma_tf32_rs<N>(c, lo + 4 * kk, TB::desc(b_hi, kk), acc || kk > 0);
    wgmma_tf32_rs<N>(c, hi + 4 * kk, TB::desc(b_lo, kk), 1);
    wgmma_tf32_rs<N>(c, hi + 4 * kk, TB::desc(b_hi, kk), 1);
  }
}

}  // namespace
