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
// zeros, and a tile of pad terms costs one write of zeros).
//
// What bounds it on the H100.  A build batch (B = 32, U = 512, L = 512,
// De = 128, S = 20) holds ~180 live terms and ~200 live tokens per doc:
// ~0.3 GFLOP on the live pairs, 4.5 us at the FP32 peak of 67 TFLOP/s,
// against ~6 MB of live rows and output, ~2 us at 3.35 TB/s: operations
// bound it.  A No-Index request (B = 1,000 candidates, U = 6 query
// slots) does the same 0.3 GFLOP but reads ~1,000 x 200 live token rows,
// ~0.1 GB, ~31 us: bytes bound it.  The first version (one block of 2
// warps per doc and 64 terms, every token position multiplied) took
// 0.5437 ms per build batch on an NVIDIA H100 80GB HBM3 at 700 W: fewer
// live blocks than SMs, 2 warps each, 60% of each score tile spent on
// excluded positions, and no load in flight while it multiplied.
//
// The design:
//
// - Compaction.  A block first lists its doc's live positions (seg in
//   [0, S)) in token order, with a ballot and popc per warp, a window of
//   512 positions at a time (one window at the build's L = 512).  Token
//   tiles hold 64 live tokens, so only the last tile of a window carries
//   dead rows.
// - Term tiles sized to the launch.  A block owns one doc and TU = 8
//   terms (U <= 8) or 16: a TU x 64 score tile, 2 x 4 scores per thread,
//   so 64 or 128 threads.  The No-Index launch (U = 6) runs 1,000 blocks
//   of 2 warps over 8 term rows; the build's 32 tiles of 16 terms per doc
//   give ~380 live blocks of 4 warps, 3 per SM, all resident at once
//   (tiles of 32 with 4 x 4 scores per thread, half as many warps, were
//   slower at the build batch).  Live terms come first in every caller's
//   term_ids, so the dead tiles are the grid's last blocks.
// - Loads.  Each step stages a 32-deep slice (16 at TU = 8, to fit more
//   blocks per SM) of the tile's term rows and of its 64 live token rows
//   (gathered through the compacted list) with 16-byte cp.async (4-byte
//   when De % 4 != 0 or a base is not 16-byte aligned; the depth past De
//   is zero-filled) into a ring of 3 stages, so two steps are in flight
//   while one is multiplied.
// - Fold.  A tile's scores go through shared memory.  Thread (u, c) folds
//   the tile's live tokens 16c .. 16c + 15 (class c of 4) in order into
//   running (dot, cos, max) sums for the current segment, swapped with a
//   per-(class, segment, term) table in shared memory only when the
//   segment changes.  A cell is the 4 class partials added in class
//   order (max: their max): 16 serial steps per thread and tile, not 64.
//
// Measured on an NVIDIA H100 80GB HBM3 at 700 W (scripts/seg_interact_ab.py;
// PERF.md section 6 keeps the numbers): 0.041 ms per build batch (0.55
// before), 9x its bound, 7.3 TFLOP/s on the live pairs, 11% of the FP32
// peak, so latency bounds it, not the FP32 pipes, and the products stay
// on FMAs; 0.099 ms per No-Index request (1.15 before), 3x its byte
// bound: a 2-warp block waits on each 16-deep step's row slices.
//
// Any S: the grid's third axis walks chunks of kMaxSeg = 64 segments.
// The block of chunk c compacts only the live tokens whose segment lies
// in [64c, 64c + 64) (the others are left out as out-of-range tokens
// are), sizes its per-(class, segment, term) tables by the chunk's width
// and stores at segment offset 64c of each term's row of S * 3 floats.
// At S <= 64 there is one chunk, and the kernel is compiled without the
// chunk arithmetic (kChunked = false): the code, the work and the bits
// are as without chunks.
//
// Deterministic, and the same bits at any U, B or term tile.  A score is
// one FMA chain over k = 0 .. De - 1 (the zero-filled depth adds exact
// zeros), |e_t|^2 and |e_u|^2 likewise; a cell's sum runs over its
// tokens in the order (class, compacted position), which depends only on
// the doc's seg row; no atomics.  So the build's cells (U = a doc's
// unique terms, TU = 16) and the No-Index path's (U = the query's terms,
// TU = 8) are the same bits.  Float32 FMA only: no TF32 or bf16 tensor
// cores.
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTT = 64;       // live tokens per tile
constexpr int kSlice = 16;    // live tokens a fold thread walks per tile
constexpr int kClasses = kTT / kSlice;
constexpr int kLDS = kTT + 1; // score row stride (floats)
constexpr int kStages = 3;
constexpr int kWin = 512;     // positions compacted at a time
constexpr int kMaxSeg = 64;
constexpr int kMaxDevices = 64;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// copy `bytes` (0 .. VEC * 4) of global src to shared dst, zero-filling
// the rest of the VEC floats
template <int VEC>
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         int bytes) {
  if constexpr (VEC == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                     smem_u32(dst)),
                 "l"(src), "r"(bytes));
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// the shape of a block of TU terms: MI x 4 scores per thread, NT
// threads, DK-deep steps staged in rows of LDK floats (16-byte aligned,
// and 8 consecutive rows hit 8 different 16-byte bank groups), and its
// dynamic shared memory, in floats then ints
template <int TU>
struct Cfg {
  static constexpr int MI = 2;                 // term rows per thread
  static constexpr int GI = TU / MI;           // term groups
  static constexpr int NT = GI * 16;           // threads: 64 or 128
  static constexpr int DK = TU == 8 ? 16 : 32; // embedding depth per step
  static constexpr int LDK = DK + 4;
  static constexpr int kFloatsFixed = kStages * (TU + kTT) * LDK  // ring
                                      + TU * kLDS                // scores
                                      + 2 * kTT + TU;  // t2, 1/|e_t|, v2
  static constexpr int kIntsFixed = 2 * kWin + 4 + TU;  // list, warps, live
  static int smem_bytes(int S) {
    return (kFloatsFixed + kClasses * S * 3 * TU + kIntsFixed) * 4;
  }
};

template <int TU, int VEC, bool kChunked>
__global__ void __launch_bounds__(Cfg<TU>::NT)
    seg_interact_kernel(const float* __restrict__ e_term,
                        const float* __restrict__ e_tok,
                        const int* __restrict__ seg,
                        const int* __restrict__ term_ids,
                        float* __restrict__ out, int U, int L, int De,
                        int S) {
  using C = Cfg<TU>;
  constexpr int NT = C::NT, NW = NT / 32, MI = C::MI, GI = C::GI;
  constexpr int DK = C::DK, LDK = C::LDK;
  constexpr int CPR = DK / VEC;   // copies per staged row
  extern __shared__ float4 smem4[];
  float* a_st = reinterpret_cast<float*>(smem4);  // [kStages][TU][LDK]
  float* b_st = a_st + kStages * TU * LDK;         // [kStages][kTT][LDK]
  float* score_s = b_st + kStages * kTT * LDK;     // [TU][kLDS]
  float* tok_t2 = score_s + TU * kLDS;             // [kTT]
  float* tok_inv = tok_t2 + kTT;                   // [kTT]
  float* term_v2 = tok_inv + kTT;                  // [TU]
  // the block's segments [c0, c0 + SW): its chunk (one chunk: 0 and S)
  const int c0 = kChunked ? blockIdx.z * kMaxSeg : 0;
  const int SW = kChunked ? min(kMaxSeg, S - c0) : S;
  float* acc_s = term_v2 + TU;  // [kClasses][SW][3][TU]: dot, cos, max
  int* list_pos = reinterpret_cast<int*>(acc_s + kClasses * SW * 3 * TU);
  int* list_seg = list_pos + kWin;                 // [kWin]
  int* warp_cnt = list_seg + kWin;                 // [4]
  int* term_live = warp_cnt + 4;                   // [TU]

  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int u0 = blockIdx.y * TU;
  const int n_terms = min(TU, U - u0);
  const int per_term = SW * 3;
  float* out_b = out + ((int64_t)b * U + u0) * (S * 3) + c0 * 3;
  // where value e of the block's (term, segment, value) list goes: a
  // term's output row holds S * 3 values, the block's chunk SW * 3
  auto out_at = [&](int e) {
    return kChunked ? (e / per_term) * (S * 3) + e % per_term : e;
  };

  bool live = false;
  if (tid < TU) {
    live = tid < n_terms && __ldg(term_ids + (int64_t)b * U + u0 + tid) >= 0;
    term_live[tid] = live;
    term_v2[tid] = 0.0f;
  }
  if (!__syncthreads_or(live)) {  // a tile of pad terms
    for (int e = tid; e < n_terms * per_term; e += NT) out_b[out_at(e)] = 0.0f;
    return;
  }
  for (int i = tid; i < kClasses * per_term * TU; i += NT)
    acc_s[i] = (i / TU) % 3 == 2 ? -INFINITY : 0.0f;

  const float* term_base = e_term + ((int64_t)b * U + u0) * De;
  const float* tok_base = e_tok + (int64_t)b * L * De;
  const int* seg_b = seg + (int64_t)b * L;
  const int n_kc = (De + DK - 1) / DK;
  const int lane = tid & 31, warp = tid >> 5;
  const int gi = tid / 16, gj = tid % 16;        // score tile
  const int fu = tid % TU, fc = tid / TU;        // fold: term, class
  const bool fold = fc < kClasses && fu < n_terms && term_live[fu];
  int cur = -1;
  float r_dot = 0.0f, r_cos = 0.0f, r_max = -INFINITY;
  bool first_tile = true;

  for (int w0 = 0; w0 < L; w0 += kWin) {
    // compaction: the window's live positions, in order
    const int w_end = min(L, w0 + kWin);
    int n_live = 0;
    for (int p0 = w0; p0 < w_end; p0 += NT) {
      const int p = p0 + tid;
      const int s = p < w_end ? __ldg(seg_b + p) - c0 : -1;
      const bool on = s >= 0 && s < SW;
      const unsigned m = __ballot_sync(0xffffffffu, on);
      int before = __popc(m & ((1u << lane) - 1u)), total = __popc(m);
      if constexpr (NW > 1) {
        if (lane == 0) warp_cnt[warp] = total;
        __syncthreads();
        total = 0;
#pragma unroll
        for (int w = 0; w < NW; ++w) {
          const int c = warp_cnt[w];
          if (w < warp) before += c;
          total += c;
        }
      }
      if (on) {
        list_pos[n_live + before] = p;
        list_seg[n_live + before] = s;
      }
      n_live += total;
      __syncthreads();  // warp_cnt is reused; the list is complete
    }
    if (n_live == 0) continue;

    const int n_tiles = (n_live + kTT - 1) / kTT;
    const int n_steps = n_tiles * n_kc;
    // stage step i (tile i / n_kc, depth slice i % n_kc) into its slot
    auto load_step = [&](int i) {
      const int ti = i / n_kc, k0 = (i % n_kc) * DK;
      float* a = a_st + (i % kStages) * TU * LDK;
      float* bb = b_st + (i % kStages) * kTT * LDK;
      for (int x = tid; x < TU * CPR; x += NT) {
        const int r = x / CPR, k = (x % CPR) * VEC, kg = k0 + k;
        const bool ok = r < n_terms && kg < De;
        cp_async<VEC>(a + r * LDK + k,
                      ok ? term_base + (int64_t)r * De + kg : e_term,
                      ok ? min(VEC, De - kg) * 4 : 0);
      }
      for (int x = tid; x < kTT * CPR; x += NT) {
        const int r = x / CPR, k = (x % CPR) * VEC, kg = k0 + k;
        const int j = ti * kTT + r;
        const bool ok = j < n_live && kg < De;
        cp_async<VEC>(
            bb + r * LDK + k,
            ok ? tok_base + (int64_t)list_pos[j] * De + kg : e_tok,
            ok ? min(VEC, De - kg) * 4 : 0);
      }
    };
#pragma unroll
    for (int i = 0; i < kStages - 1; ++i) {
      if (i < n_steps) load_step(i);
      cp_async_commit();
    }

    float acc[MI][4];
    for (int i = 0; i < n_steps; ++i) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // step i landed; step i - 1's slot is free
      if (i + kStages - 1 < n_steps) load_step(i + kStages - 1);
      cp_async_commit();

      const int ti = i / n_kc, kc = i % n_kc;
      const float* a = a_st + (i % kStages) * TU * LDK;
      const float* bb = b_st + (i % kStages) * kTT * LDK;
      if (kc == 0) {
#pragma unroll
        for (int x = 0; x < MI; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = 0.0f;
      }
#pragma unroll
      for (int kk = 0; kk < DK; kk += 4) {
        float4 av[MI], bv[4];
#pragma unroll
        for (int x = 0; x < MI; ++x)
          av[x] = *reinterpret_cast<const float4*>(a + (gi + GI * x) * LDK +
                                                   kk);
#pragma unroll
        for (int y = 0; y < 4; ++y)
          bv[y] = *reinterpret_cast<const float4*>(bb + (gj + 16 * y) * LDK +
                                                   kk);
#pragma unroll
        for (int x = 0; x < MI; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            acc[x][y] = fmaf(av[x].x, bv[y].x, acc[x][y]);
            acc[x][y] = fmaf(av[x].y, bv[y].y, acc[x][y]);
            acc[x][y] = fmaf(av[x].z, bv[y].z, acc[x][y]);
            acc[x][y] = fmaf(av[x].w, bv[y].w, acc[x][y]);
          }
      }
      // squared norms, one FMA chain over k per row: the tile's tokens,
      // and in the first tile the block's terms
      const int n_rows = kTT + (first_tile ? TU : 0);
      for (int r = tid; r < n_rows; r += NT) {
        const bool is_tok = r < kTT;
        const float* row = is_tok ? bb + r * LDK : a + (r - kTT) * LDK;
        float* dst = is_tok ? tok_t2 + r : term_v2 + (r - kTT);
        float x = kc == 0 ? 0.0f : *dst;
#pragma unroll
        for (int kk = 0; kk < DK; kk += 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + kk);
          x = fmaf(v.x, v.x, x);
          x = fmaf(v.y, v.y, x);
          x = fmaf(v.z, v.z, x);
          x = fmaf(v.w, v.w, x);
        }
        *dst = x;
        if (is_tok && kc == n_kc - 1)
          tok_inv[r] = 1.0f / fmaxf(sqrtf(x), 1e-9f);
      }
      if (kc != n_kc - 1) continue;

      // the tile is scored: fold it
#pragma unroll
      for (int x = 0; x < MI; ++x)
#pragma unroll
        for (int y = 0; y < 4; ++y)
          score_s[(gi + GI * x) * kLDS + gj + 16 * y] = acc[x][y];
      __syncthreads();
      first_tile = false;
      if (fold) {
        const float v2 = term_v2[fu];
        const int j0 = fc * kSlice, n_here = min(kTT, n_live - ti * kTT);
        for (int j = j0; j < min(j0 + kSlice, n_here); ++j) {
          const int s = list_seg[ti * kTT + j];
          if (s != cur) {  // swap this thread's running sums
            if (cur >= 0) {
              float* p = acc_s + (fc * per_term + cur * 3) * TU + fu;
              p[0] = r_dot;
              p[TU] = r_cos;
              p[2 * TU] = r_max;
            }
            const float* p = acc_s + (fc * per_term + s * 3) * TU + fu;
            r_dot = p[0];
            r_cos = p[TU];
            r_max = p[2 * TU];
            cur = s;
          }
          const float sc = score_s[fu * kLDS + j];
          r_dot += sc;
          r_cos = fmaf(sc, tok_inv[j], r_cos);
          const float d2 = (v2 + tok_t2[j]) - 2.0f * sc;
          r_max = fmaxf(r_max, -d2);
        }
      }
    }
    cp_async_wait<0>();
    __syncthreads();  // the next window overwrites the list
  }

  if (cur >= 0) {
    float* p = acc_s + (fc * per_term + cur * 3) * TU + fu;
    p[0] = r_dot;
    p[TU] = r_cos;
    p[2 * TU] = r_max;
  }
  __syncthreads();
  // the block's output rows are contiguous: (term, segment, value)
  const int cls = per_term * TU;  // stride between class tables
  for (int e = tid; e < n_terms * per_term; e += NT) {
    const int u = e / per_term, rem = e % per_term, kind = rem % 3;
    float v = 0.0f;
    if (term_live[u]) {
      const float* p = acc_s + rem * TU + u;
      if (kind < 2) {
        v = ((p[0] + p[cls]) + p[2 * cls]) + p[3 * cls];
        if (kind == 1) v *= 1.0f / fmaxf(sqrtf(term_v2[u]), 1e-9f);
      } else {
        const float m =
            fmaxf(fmaxf(p[0], p[cls]), fmaxf(p[2 * cls], p[3 * cls]));
        v = isfinite(m) ? expf(m) : 0.0f;
      }
    }
    out_b[out_at(e)] = v;
  }
}

// the largest dynamic shared memory each kernel was allowed, per device:
// cudaFuncSetAttribute runs once per kernel and device, not per launch
template <int TU, int VEC, bool kChunked>
cudaError_t allow_smem(int bytes) {
  static std::atomic<int> allowed[kMaxDevices];
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && allowed[dev].load() >= bytes) return cudaSuccess;
  const int most = Cfg<TU>::smem_bytes(kMaxSeg);  // enough for every S
  err = cudaFuncSetAttribute(seg_interact_kernel<TU, VEC, kChunked>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (err == cudaSuccess && dev < kMaxDevices) allowed[dev].store(most);
  return err;
}

template <int TU, int VEC, bool kChunked>
int launch(const float* e_term, const float* e_tok, const int* seg,
           const int* term_ids, float* out, int B, int U, int L, int De,
           int S, cudaStream_t stream) {
  const int chunks = (S + kMaxSeg - 1) / kMaxSeg;
  const int smem = Cfg<TU>::smem_bytes(S < kMaxSeg ? S : kMaxSeg);
  cudaError_t err = allow_smem<TU, VEC, kChunked>(smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (U + TU - 1) / TU;
  if (tiles > 65535 || chunks > 65535)
    return (int)cudaErrorInvalidConfiguration;
  seg_interact_kernel<TU, VEC, kChunked>
      <<<dim3((unsigned)B, (unsigned)tiles, (unsigned)chunks), Cfg<TU>::NT,
         smem, stream>>>(
          e_term, e_tok, seg, term_ids, out, U, L, De, S);
  return (int)cudaGetLastError();
}

template <int TU>
int launch_tu(bool vec4, const float* e_term, const float* e_tok,
              const int* seg, const int* term_ids, float* out, int B, int U,
              int L, int De, int S, cudaStream_t stream) {
  // S <= kMaxSeg: one chunk, compiled without the chunk arithmetic
  if (S > kMaxSeg)
    return vec4 ? launch<TU, 4, true>(e_term, e_tok, seg, term_ids, out, B,
                                      U, L, De, S, stream)
                : launch<TU, 1, true>(e_term, e_tok, seg, term_ids, out, B,
                                      U, L, De, S, stream);
  return vec4 ? launch<TU, 4, false>(e_term, e_tok, seg, term_ids, out, B, U,
                                     L, De, S, stream)
              : launch<TU, 1, false>(e_term, e_tok, seg, term_ids, out, B, U,
                                     L, De, S, stream);
}

}  // namespace

extern "C" {

int seg_interact_launch(const float* e_term, const float* e_tok,
                        const int* seg, const int* term_ids, float* out,
                        int B, int U, int L, int De, int S,
                        cudaStream_t stream) {
  if (B == 0 || U == 0) return 0;
  if (S < 1 || De < 1 || L < 0)
    return (int)cudaErrorInvalidValue;
  const bool vec4 = De % 4 == 0 &&
                    reinterpret_cast<uintptr_t>(e_term) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(e_tok) % 16 == 0;
  // terms per block: 8 for a No-Index query's slots, else 16
  return U <= 8 ? launch_tu<8>(vec4, e_term, e_tok, seg, term_ids, out, B,
                               U, L, De, S, stream)
                : launch_tu<16>(vec4, e_term, e_tok, seg, term_ids, out, B,
                                U, L, De, S, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
