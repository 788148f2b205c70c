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
// or none.  dK and dV of a KV head sum over its G = Hq / Hkv query heads.
// All arithmetic is float32 (bf16 inputs are widened as they are loaded),
// as the reference's gqa_attention computes in float32.
//
// Two kernels, no atomics, so the bits depend only on the inputs:
//   flash_attn_bwd_dq_kernel, one block per (b, h, 64 query rows): D of
//     its rows (written to a float32 scratch for the second kernel), then
//     over the KV tiles at or below the diagonal: dP, S -> P -> dS, and
//     dQ += dS . K, each tile's keys in order;
//   flash_attn_bwd_dkdv_kernel, one block per (b, kv head, 64 keys): over
//     the G query heads in order, and for each over the query tiles at or
//     below the diagonal in order: S^T -> P^T, dP^T -> dS^T, dV += P^T .
//     dO and dK += dS^T . Q.
// The second runs after the first on the stream and reads its D.  Blocks
// are numbered heaviest first.  No length needs to be a multiple of 64:
// tail rows load as zeros and are masked (a tail query's lse reads as
// +inf, so its P is 0).
//
// Each block is 256 threads as a 16 x 16 grid, as the forward's float32
// kernel: thread (ty, tx) owns tile rows 4 ty .. 4 ty + 3 and the columns
// tx + 16 j; the row tiles (Q pre-scaled by 1/sqrt(hd), dO, K, V) sit in
// shared memory as float32 [64][hd + 4]; P and dS cross to the products
// that sum over the tile through a [64][68] buffer.  FMAs on the CUDA
// cores: the tensor cores, TMA and warp specialisation are later work.
//
// What bounds it on the H100.  At stablelm-1.6b's training shape (B 16,
// S 1,024, 32 / 32 heads of 64, causal, bf16) the five products do 10 hd
// flops per (query, key) pair at or below the diagonal, 1.72e11 flops,
// 0.174 ms at the bf16 tensor cores' 989 TFLOP/s; q, k, v, o, dO, lse in
// and dQ, dK, dV out are 0.54 GB, 0.161 ms at 3.35 TB/s.  On the CUDA
// cores' 67 TFLOP/s of float32 FMAs (and this kernel computes S and dP
// twice, once per kernel: 14 hd flops a pair) it can be no faster than
// 3.6 ms.  PERF.md section 6 (row 8b) keeps the measured times.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;  // 16 x 16
constexpr int kB = 64;         // rows per tile: queries, and keys
constexpr int kRows = kB / 16; // tile rows per thread
constexpr int kCols = kB / 16; // tile columns per thread
constexpr int kLdP = kB + 4;   // the two half-warps hit other banks

// four consecutive values as float32
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  const float2 a = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 b = __bfloat1622float2(
      *reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// a tile of 64 rows of HD values, rows [0, n_rows) from src (row stride
// `stride` elements) times s, the rest zero, into dst [64][HD + 4]
template <typename T, int HD>
__device__ __forceinline__ void load_tile(const T* __restrict__ src,
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
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                             const T* __restrict__ v, const T* __restrict__ o,
                             const T* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ dsum, T* __restrict__ dq,
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
  const T* k_base = k + (int64_t)b * Skv * kv_stride + (int64_t)hk * HD;
  const T* v_base = v + (int64_t)b * Skv * kv_stride + (int64_t)hk * HD;

  load_tile<T, HD>(q + q_off, q_stride, n_q, scale, q_s);
  load_tile<T, HD>(dout + q_off, q_stride, n_q, 1.f, do_s);
  load_tile<T, HD>(o + q_off, q_stride, n_q, 1.f, kv_s);
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
    load_tile<T, HD>(v_base + kv0 * kv_stride, kv_stride, n_kv, 1.f, kv_s);
    __syncthreads();
    tile_dots<HD>(do_s, kv_s, ty, tx, dp);
    __syncthreads();
    load_tile<T, HD>(k_base + kv0 * kv_stride, kv_stride, n_kv, 1.f, kv_s);
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
    T* out = dq + q_off + rl * q_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(out + tx + 16 * c, acc[i][c] * scale);
  }
}

// dK and dV of the 64 keys k0 .. of KV head hk, doc b
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
    flash_attn_bwd_dkdv_kernel(const T* __restrict__ q,
                               const T* __restrict__ k,
                               const T* __restrict__ v,
                               const T* __restrict__ dout,
                               const float* __restrict__ lse,
                               const float* __restrict__ dsum,
                               T* __restrict__ dk, T* __restrict__ dv,
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

  load_tile<T, HD>(k + kv_off, kv_stride, n_k, 1.f, k_s);
  load_tile<T, HD>(v + kv_off, kv_stride, n_k, 1.f, v_s);

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
      load_tile<T, HD>(q + q_off, q_stride, n_q, scale, q_s);
      load_tile<T, HD>(dout + q_off, q_stride, n_q, 1.f, do_s);
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
    T* out_k = dk + kv_off + kl * kv_stride;
    T* out_v = dv + kv_off + kl * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      store(out_k + tx + 16 * c, dk_acc[i][c]);
      store(out_v + tx + 16 * c, dv_acc[i][c]);
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, int Sq, int Skv, int Hq, int Hkv,
           int causal, float scale, cudaStream_t stream) {
  constexpr int LD = HD + 4;
  const int smem_dq = (3 * kB * LD + kB * kLdP) * (int)sizeof(float);
  const int smem_dkdv = (4 * kB * LD + kB * kLdP) * (int)sizeof(float);
  auto* fn_dq = flash_attn_bwd_dq_kernel<T, HD>;
  auto* fn_dkdv = flash_attn_bwd_dkdv_kernel<T, HD>;
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
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dout);
  if (blocks_dq > 0) {
    fn_dq<<<(unsigned)blocks_dq, kThreads, smem_dq, stream>>>(
        tq, tk, tv, static_cast<const T*>(o), tdo, lse, dsum,
        static_cast<T*>(dq), Sq, Skv, Hq, Hkv, n_qt, causal, scale);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  fn_dkdv<<<(unsigned)blocks_dkdv, kThreads, smem_dkdv, stream>>>(
      tq, tk, tv, tdo, lse, dsum, static_cast<T*>(dk), static_cast<T*>(dv),
      Sq, Skv, Hq, Hkv, n_kt, causal, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int launch_hd(int is_bf16, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* dsum,
              void* dq, void* dk, void* dv, int B, int Sq, int Skv, int Hq,
              int Hkv, int causal, float scale, cudaStream_t stream) {
  return is_bf16
             ? launch<__nv_bfloat16, HD>(q, k, v, o, dout, lse, dsum, dq, dk,
                                         dv, B, Sq, Skv, Hq, Hkv, causal,
                                         scale, stream)
             : launch<float, HD>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B,
                                 Sq, Skv, Hq, Hkv, causal, scale, stream);
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
