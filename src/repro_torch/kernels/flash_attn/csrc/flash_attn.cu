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
// counted from 0) or none, in float32, and writes o (B, Sq, Hq, hd) in
// q's type.  The online softmax never writes the (Sq, Skv) scores to
// device memory.
//
// Layout.  One block per (b, h, 64-row query tile), 256 threads as a
// 16 x 16 grid: thread (ty, tx) owns query rows 4 ty .. 4 ty + 3.  The
// query tile, pre-scaled by 1/sqrt(hd) as the TPU kernel does, stays in
// shared memory as float32; each 64-row KV tile is staged into one
// shared buffer, K first, then V.  Per KV tile a thread computes the 4 x 4
// scores of its rows against keys tx + 16 j (float4 reads along hd),
// masks them (causal, and keys past Skv in the tail tile: no sequence
// length needs to be a multiple of the tile), and the 16 threads of a
// row reduce its max and sum with warp shuffles.  The probabilities go
// through shared memory to the P . V product, where the thread owns the
// output columns tx + 16 c of its 4 rows.  Running max, denominator and
// the 4 x hd/16 accumulator stay in registers.  Rows that see no key yet
// keep m = -inf: the exponent uses m_safe = 0 for them and their
// correction factor is 0, as the TPU kernel guards them; the output
// divides by max(l, 1e-30).  Under the causal mask the KV tiles wholly
// above the diagonal are never loaded (the TPU kernel masks them
// instead), and blocks are issued heaviest query tile first.
//
// What bounds it on the H100.  At the LM build's shape (B 32, S 512,
// Hq 24, Hkv 8, hd 128, bf16) one launch moves 268 MB of q, k, v and o,
// 80 us at 3.35 TB/s, and does 5.2e10 causal flops, 52 us on the bf16
// tensor cores: the bytes bound it.  This first version is bound by its
// arithmetic instead: both products run as float32 FMAs fed from shared
// memory (a 67 TFLOP/s ceiling, and shared-memory reads per FMA cap it
// lower), each KV tile is read once per query tile (8 times at S 512),
// and 85 KB of shared memory per block at hd 128 leave two blocks per
// SM.  wgmma on bf16 tiles, TMA loads and a pipelined K/V ring are the
// later steps.
#include <cmath>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <int HD>
__device__ __forceinline__ void load_tile(
    const __nv_bfloat16* __restrict__ src, int64_t stride, int n_rows,
    float s, float* dst) {
  constexpr int V = HD / 8;
  for (int i = threadIdx.x; i < 64 * V; i += kThreads) {
    const int r = i / V, c = (i % V) * 8;
    uint4 raw = make_uint4(0u, 0u, 0u, 0u);
    if (r < n_rows)
      raw = __ldg(reinterpret_cast<const uint4*>(src + r * stride + c));
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
    const float2 f0 = __bfloat1622float2(h[0]);
    const float2 f1 = __bfloat1622float2(h[1]);
    const float2 f2 = __bfloat1622float2(h[2]);
    const float2 f3 = __bfloat1622float2(h[3]);
    float* d = dst + r * (HD + 4) + c;
    *reinterpret_cast<float4*>(d) =
        scale4(make_float4(f0.x, f0.y, f1.x, f1.y), s);
    *reinterpret_cast<float4*>(d + 4) =
        scale4(make_float4(f2.x, f2.y, f3.x, f3.y), s);
  }
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
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

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, int Sq,
                      int Skv, int Hq, int Hkv, int n_qt, int causal,
                      float scale) {
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
    T* out = o + ((int64_t)b * Sq + row) * q_stride + (int64_t)h * HD;
#pragma unroll
    for (int c = 0; c < NC; ++c) store(out + tx + 16 * c, acc[i][c] / den);
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B,
           int Sq, int Skv, int Hq, int Hkv, int causal, float scale,
           cudaStream_t stream) {
  const int smem = (2 * 64 * (HD + 4) + kBQ * kLdP) * (int)sizeof(float);
  auto* fn = flash_attn_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const int n_qt = (Sq + kBQ - 1) / kBQ;
  const int64_t blocks = (int64_t)B * Hq * n_qt;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidConfiguration;
  fn<<<(unsigned)blocks, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), Sq, Skv, Hq, Hkv, n_qt,
      causal, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v, void* o,
              int B, int Sq, int Skv, int Hq, int Hkv, int causal,
              float scale, cudaStream_t stream) {
  switch (hd) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale,
                           stream);
    case 32:
      return launch<T, 32>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale,
                           stream);
    case 64:
      return launch<T, 64>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale,
                           stream);
    case 128:
      return launch<T, 128>(q, k, v, o, B, Sq, Skv, Hq, Hkv, causal, scale,
                            stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// is_bf16: 0 for float32 tensors, 1 for bfloat16; hd in {16, 32, 64, 128}
int flash_attn_launch(const void* q, const void* k, const void* v, void* o,
                      int B, int Sq, int Skv, int Hq, int Hkv, int hd,
                      int is_bf16, int causal, float scale,
                      cudaStream_t stream) {
  if (B == 0 || Sq == 0) return 0;
  if (Skv < 1 || Hkv < 1 || Hq % Hkv != 0) return (int)cudaErrorInvalidValue;
  return is_bf16 ? launch_hd<__nv_bfloat16>(hd, q, k, v, o, B, Sq, Skv, Hq,
                                            Hkv, causal, scale, stream)
                 : launch_hd<float>(hd, q, k, v, o, B, Sq, Skv, Hq, Hkv,
                                    causal, scale, stream);
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
