// SEINE's serving lookup and first-stage posting scan for Hopper (sm_90a).
//
// csr_lookup_kernel replaces the Pallas TPU kernel
// src/repro/kernels/csr_lookup/kernel.py::csr_lookup_pallas.  It computes
// M_{q,d} (B, Q, n_b, n_f): for each (candidate b, query term q) the
// routed posting range [lo, hi) of the owning shard k is bisected for doc
// d in two levels -- over the shard's fence row (every tile-th doc id),
// then inside the one tile the fences select -- and the hit's
// (n_b, n_f) values row is copied out, or +0.0 written by select where
// the pair is absent.
//
// What bounds it on the H100: latency, not bandwidth.  A cell moves one
// 720-byte values row (n_b=20, n_f=9) but first walks a chain of ~25
// dependent 4-byte probes.  The TPU kernel staged the fence row and the
// winning tile in VMEM by DMA; here there is nothing to stage -- one warp
// per cell runs the probes straight from global memory (the fence rows
// and hot tiles stay in the 50 MB L2), every lane of the warp probing the
// same address so the chain costs one broadcast load per step, and then
// the 32 lanes copy the row with coalesced loads.  Enough warps are in
// flight (6,000 cells at the serving shape) to hide the probe latency.
//
// retrieve_block_kernel replaces
// src/repro/kernels/csr_lookup/kernel.py::retrieve_windows_pallas fused
// with the segment scatter that followed it (ref.py::merge_windows).
// Block (lane l, window w) bisects lane l's posting range for the doc
// block [blo, blo + block) and copies the w-th tile-wide window of those
// postings straight into their M rows.  Exclusive (term, doc) ownership
// means every output cell has at most one writer, so the scatter needs no
// atomics; the rows written are 0.0f + v, exactly what the reference's
// segment sum over zeros produces (a -0.0 value becomes +0.0), and the
// untouched cells keep the zeros of the memset that precedes the launch.
// It is bound by the bytes of the block's postings and of M.
//
// csr_lookup_packed_kernel and retrieve_block_packed_kernel are the same
// two kernels over tile-compressed doc ids (src/repro/core/codec.py): they
// replace csr_lookup_packed_pallas and retrieve_windows_packed_pallas (the
// latter fused, as above, with the decode and the merge that followed it).
// Each posting tile stores a frame base, a width class c in {0,4,8,16,32}
// and a word offset; the fence row stays raw.  The level-1 bisect is the
// same fence bisect, one load then picks up the winning tile's (c, base,
// word offset), and each level-2 probe decodes one packed word:
// base + ((word >> (bit & 31)) & mask) with a logical (uint32_t) shift, the
// raw word at c = 32.  A probe at r == tile reads into the row's trailing
// max_tile_words pad and is never consulted; word reads are clamped to the
// buffer all the same.  Under packed-q8 the values are int8 and each found
// row is dequantised as __fmul_rn(float(v), scale) -- one rounding, as the
// reference's single f32 multiply, never contracted into an FMA.
//
// Positions and offsets are int32 inside a shard (K * Nmax < 2^31, as in
// the reference); every values address is formed in 64 bits, since
// pos * n_b * n_f passes 2^31 at ~11.9M postings.
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ int floordiv(int a, int b) {  // b > 0
  int q = a / b;
  return (q * b > a) ? q - 1 : q;
}

// (a + b) // 2 for the non-negative positions of a bisect, without the
// int32 overflow of a + b
__device__ __forceinline__ int midpoint(int a, int b) {
  return (int)(((int64_t)a + b) >> 1);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

// doc id at shard-local position p; int32 max past the row end, which is
// the value the reference pads each row with up to a whole tile
__device__ __forceinline__ int doc_at(const int* __restrict__ row, int n,
                                      int p) {
  return p < n ? __ldg(row + p) : INT_MAX;
}

__global__ void csr_lookup_kernel(
    const int* __restrict__ shard, const int* __restrict__ lo,
    const int* __restrict__ hi, int pair_routed,
    const int* __restrict__ docs, const int* __restrict__ doc_ids,
    int n_max, const int* __restrict__ fences, int n_fence,
    const float* __restrict__ values, int row_len, float* __restrict__ out,
    int n_q, int n_cand, int n_shards, int tile, int fence_iter,
    int tile_iter) {
  const int lane = threadIdx.x & 31;
  const int64_t cell =
      (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (cell >= (int64_t)n_q * n_cand) return;
  const int b = (int)(cell / n_q);
  const int q = (int)(cell % n_q);
  // routing: per term (Q,) or, for doc-range sub-shards, per pair (Q, B)
  const int r = pair_routed ? q * n_cand + b : q;
  const int k = clampi(__ldg(shard + r), 0, n_shards - 1);
  const int lo0 = __ldg(lo + r), hi0 = __ldg(hi + r), d = __ldg(docs + b);
  const int* frow = fences + (int64_t)k * n_fence;
  const int* drow = doc_ids + (int64_t)k * n_max;

  // level 1: first fence jf in (j_lo, j_hi] with fences[jf] >= d, over
  // the tiles that intersect [lo, hi) only, where the fences are sorted
  const int j_lo = floordiv(lo0, tile);
  const int j_hi = max(floordiv(hi0 - 1, tile), j_lo);
  int flo = j_lo + 1, fhi = j_hi + 1;
  for (int i = 0; i < fence_iter; ++i) {
    const int mid = midpoint(flo, fhi);
    const bool go = (__ldg(frow + clampi(mid, 0, n_fence - 1)) < d) &&
                    (flo < fhi);
    flo = go ? mid + 1 : flo;
    fhi = go ? fhi : mid;
  }
  // the clamp keeps the tile in bounds for an empty range pinned at a
  // tile-aligned shard end; the window below is then empty
  const int jt = clampi(flo - 1, 0, n_fence - 1);
  const int base = jt * tile;

  // level 2: the bisect inside tile jt, over the window [w_lo, w_hi)
  const int w_hi = min(base + tile, hi0);
  int plo = max(base, lo0), phi = w_hi;
  for (int i = 0; i < tile_iter; ++i) {
    const int mid = midpoint(plo, phi);
    const bool go =
        (doc_at(drow, n_max, base + clampi(mid - base, 0, tile - 1)) < d) &&
        (plo < phi);
    plo = go ? mid + 1 : plo;
    phi = go ? phi : mid;
  }
  const int pos = plo;
  // the hit is in the tile, or -- when the bisect ran off the window's
  // right edge at a tile boundary still inside [lo, hi) -- the next
  // tile's first element, which is fence jt + 1
  const int v_at =
      pos < w_hi ? doc_at(drow, n_max, base + clampi(pos - base, 0, tile - 1))
                 : __ldg(frow + clampi(jt + 1, 0, n_fence - 1));
  const bool found = (pos < hi0) && (v_at == d);

  float* dst = out + cell * row_len;
  if (found) {
    const float* src =
        values + ((int64_t)k * n_max + clampi(pos, 0, n_max - 1)) * row_len;
    for (int j = lane; j < row_len; j += 32) dst[j] = __ldg(src + j);
  } else {
    for (int j = lane; j < row_len; j += 32) dst[j] = 0.0f;
  }
}

// first position p in [lo, hi) with ids[p] >= target; probes clamp to
// [0, n - 1] like the reference's clip gathers
__device__ __forceinline__ int bisect(const int* __restrict__ ids,
                                      int64_t n, int lo, int hi, int target,
                                      int n_iter) {
  for (int i = 0; i < n_iter; ++i) {
    const int mid = midpoint(lo, hi);
    const int64_t at = mid < 0 ? 0 : (mid >= n ? n - 1 : (int64_t)mid);
    const int v = __ldg(ids + at);
    const bool go = (v < target) && (lo < hi);
    lo = go ? mid + 1 : lo;
    hi = go ? hi : mid;
  }
  return lo;
}

__global__ void retrieve_block_kernel(
    const int* __restrict__ lane_lo, const int* __restrict__ lane_hi,
    const int* __restrict__ doc_ids, int64_t n_total, int bisect_iter,
    const float* __restrict__ values, int row_len, float* __restrict__ out,
    int n_q, int n_shards, int blo, int block, int window) {
  const int l = blockIdx.x;
  const int q = l / n_shards;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  // every warp bisects the lane for itself: the same few probes in each,
  // no shared memory and no barrier
  const int lo0 = __ldg(lane_lo + l), hi0 = __ldg(lane_hi + l);
  const int s_lo = bisect(doc_ids, n_total, lo0, hi0, blo, bisect_iter);
  const int s_hi = bisect(doc_ids, n_total, lo0, hi0, blo + block,
                          bisect_iter);
  const int first = blockIdx.y * window;
  const int last = min(first + window, s_hi - s_lo);
  for (int i = first + warp; i < last; i += n_warps) {
    const int p = s_lo + i;
    const int seg = __ldg(doc_ids + p) - blo;
    const float* src = values + (int64_t)p * row_len;
    float* dst = out + ((int64_t)seg * n_q + q) * row_len;
    for (int j = lane; j < row_len; j += 32)
      dst[j] = __fadd_rn(0.0f, __ldg(src + j));
  }
}

// ---------------------------------------------------------------------------
// packed codec
// ---------------------------------------------------------------------------

// One shard's packed layout: the fence row and the tile metadata rows of
// shard k, and its words row as a flat offset into the whole buffer.
struct PackedShard {
  const int* frow;    // (F,) raw fences
  const int* bits;    // (F,) width classes
  const int* base;    // (F,) frame bases
  const int* woff;    // (F + 1,) word offsets into the shard's words row
  int64_t word0;      // k * W
};

__device__ __forceinline__ PackedShard packed_shard(
    const int* fences, const int* bits, const int* base, const int* woff,
    int n_fence, int n_words, int k) {
  PackedShard s;
  s.frow = fences + (int64_t)k * n_fence;
  s.bits = bits + (int64_t)k * n_fence;
  s.base = base + (int64_t)k * n_fence;
  s.woff = woff + (int64_t)k * (n_fence + 1);
  s.word0 = (int64_t)k * n_words;
  return s;
}

// element at in-tile position r of a tile of width c and frame tb whose
// first word sits at flat index w0; reads clamp to the words buffer
__device__ __forceinline__ int decode_packed(const int* __restrict__ words,
                                             int64_t n_total, int64_t w0,
                                             int r, int c, int tb) {
  if (c == 0) return tb;
  const int bp = r * c;
  int64_t wi = w0 + (bp >> 5);
  wi = wi < 0 ? 0 : (wi >= n_total ? n_total - 1 : wi);
  const uint32_t wv = (uint32_t)__ldg(words + wi);
  if (c == 32) return (int)wv;
  const uint32_t mask = (1u << min(c, 16)) - 1u;
  return (int)((uint32_t)tb + ((wv >> (bp & 31)) & mask));
}

// first shard-local position p in [lo, hi) whose decoded id is >= target:
// the fence bisect over the raw fence row, then the in-tile bisect over
// decoded words; *v_at (when given) gets the decoded id at p, or the next
// raw fence when p is on the tile's right boundary
__device__ int packed_bisect(const PackedShard& s,
                             const int* __restrict__ words, int64_t n_total,
                             int n_fence, int lo, int hi, int target,
                             int tile, int fence_iter, int tile_iter,
                             int* v_at) {
  const int j_lo = floordiv(lo, tile);
  const int j_hi = max(floordiv(hi - 1, tile), j_lo);
  int flo = j_lo + 1, fhi = j_hi + 1;
  for (int i = 0; i < fence_iter && flo < fhi; ++i) {
    const int mid = midpoint(flo, fhi);
    const bool go = __ldg(s.frow + clampi(mid, 0, n_fence - 1)) < target;
    flo = go ? mid + 1 : flo;
    fhi = go ? fhi : mid;
  }
  const int jt = clampi(flo - 1, 0, n_fence - 1);
  const int base = jt * tile;
  const int c = __ldg(s.bits + jt);
  const int tb = __ldg(s.base + jt);
  const int64_t w0 = s.word0 + __ldg(s.woff + jt);
  int plo = max(base, lo), phi = min(base + tile, hi);
  for (int i = 0; i < tile_iter && plo < phi; ++i) {
    const int mid = midpoint(plo, phi);
    const bool go =
        decode_packed(words, n_total, w0, mid - base, c, tb) < target;
    plo = go ? mid + 1 : plo;
    phi = go ? phi : mid;
  }
  if (v_at != nullptr) {
    *v_at = plo - base < tile
                ? decode_packed(words, n_total, w0, plo - base, c, tb)
                : __ldg(s.frow + clampi(jt + 1, 0, n_fence - 1));
  }
  return plo;
}

template <bool kQuantized>
__device__ __forceinline__ float stored(const void* __restrict__ values,
                                        int64_t at, float scale) {
  if (kQuantized)
    return __fmul_rn((float)__ldg((const signed char*)values + at), scale);
  return __ldg((const float*)values + at);
}

template <bool kQuantized>
__global__ void csr_lookup_packed_kernel(
    const int* __restrict__ shard, const int* __restrict__ lo,
    const int* __restrict__ hi, int pair_routed,
    const int* __restrict__ docs, const int* __restrict__ words,
    int n_words, const int* __restrict__ bits,
    const int* __restrict__ tbase, const int* __restrict__ woff,
    const int* __restrict__ fences, int n_fence,
    const void* __restrict__ values, int n_max,
    const float* __restrict__ scale, int row_len, float* __restrict__ out,
    int n_q, int n_cand, int n_shards, int tile, int fence_iter,
    int tile_iter) {
  const int lane = threadIdx.x & 31;
  const int64_t cell =
      (int64_t)blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (cell >= (int64_t)n_q * n_cand) return;
  const int b = (int)(cell / n_q);
  const int q = (int)(cell % n_q);
  const int r = pair_routed ? q * n_cand + b : q;
  const int k = clampi(__ldg(shard + r), 0, n_shards - 1);
  const int hi0 = __ldg(hi + r), d = __ldg(docs + b);
  const PackedShard s =
      packed_shard(fences, bits, tbase, woff, n_fence, n_words, k);
  int v_at;
  const int pos = packed_bisect(s, words, (int64_t)n_shards * n_words,
                                n_fence, __ldg(lo + r), hi0, d, tile,
                                fence_iter, tile_iter, &v_at);
  const bool found = (pos < hi0) && (v_at == d);

  float* dst = out + cell * row_len;
  if (found) {
    const float sc = kQuantized ? __ldg(scale + r) : 1.0f;
    const int64_t src =
        ((int64_t)k * n_max + clampi(pos, 0, n_max - 1)) * row_len;
    for (int j = lane; j < row_len; j += 32)
      dst[j] = stored<kQuantized>(values, src + j, sc);
  } else {
    for (int j = lane; j < row_len; j += 32) dst[j] = 0.0f;
  }
}

// Block (lane l = (query slot q, shard k), window w): both packed bisects
// of the lane, then each live position of the w-th window decodes its id
// (unpack_at: its own tile's metadata and one word) and stores
// 0.0f + value into its M row.
template <bool kQuantized>
__global__ void retrieve_block_packed_kernel(
    const int* __restrict__ lane_lo, const int* __restrict__ lane_hi,
    const int* __restrict__ words, int n_words,
    const int* __restrict__ bits, const int* __restrict__ tbase,
    const int* __restrict__ woff, const int* __restrict__ fences,
    int n_fence, const void* __restrict__ values, int n_max,
    const float* __restrict__ lane_scale, int row_len,
    float* __restrict__ out, int n_q, int n_shards, int blo, int block,
    int tile, int fence_iter, int tile_iter) {
  const int l = blockIdx.x;
  const int q = l / n_shards, k = l % n_shards;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int n_warps = blockDim.x >> 5;
  const int64_t n_total = (int64_t)n_shards * n_words;
  const PackedShard s =
      packed_shard(fences, bits, tbase, woff, n_fence, n_words, k);
  const int shard0 = k * n_max;
  const int lo0 = __ldg(lane_lo + l) - shard0;
  const int hi0 = __ldg(lane_hi + l) - shard0;
  const int s_lo = packed_bisect(s, words, n_total, n_fence, lo0, hi0, blo,
                                 tile, fence_iter, tile_iter, nullptr);
  const int s_hi = packed_bisect(s, words, n_total, n_fence, lo0, hi0,
                                 blo + block, tile, fence_iter, tile_iter,
                                 nullptr);
  const float sc = kQuantized ? __ldg(lane_scale + l) : 1.0f;
  const int first = blockIdx.y * tile;
  const int last = min(first + tile, s_hi - s_lo);
  for (int i = first + warp; i < last; i += n_warps) {
    const int p = s_lo + i;
    const int jt = clampi(p / tile, 0, n_fence - 1);
    const int doc = decode_packed(
        words, n_total, s.word0 + __ldg(s.woff + jt),
        clampi(p - jt * tile, 0, tile - 1), __ldg(s.bits + jt),
        __ldg(s.base + jt));
    const int seg = doc - blo;
    if (seg < 0 || seg >= block) continue;
    const int64_t src = ((int64_t)shard0 + p) * row_len;
    float* dst = out + ((int64_t)seg * n_q + q) * row_len;
    for (int j = lane; j < row_len; j += 32)
      dst[j] = __fadd_rn(0.0f, stored<kQuantized>(values, src + j, sc));
  }
}

}  // namespace

extern "C" {

int csr_lookup_launch(const int* shard, const int* lo, const int* hi,
                      int pair_routed, const int* docs, const int* doc_ids,
                      int n_max, const int* fences, int n_fence,
                      const float* values, int row_len, float* out, int n_q,
                      int n_cand, int n_shards, int tile, int fence_iter,
                      int tile_iter, cudaStream_t stream) {
  const int64_t cells = (int64_t)n_q * n_cand;
  if (cells == 0) return 0;
  const int threads = 256, warps = threads / 32;
  const int64_t blocks = (cells + warps - 1) / warps;
  csr_lookup_kernel<<<(unsigned)blocks, threads, 0, stream>>>(
      shard, lo, hi, pair_routed, docs, doc_ids, n_max, fences, n_fence,
      values, row_len, out, n_q, n_cand, n_shards, tile, fence_iter,
      tile_iter);
  return (int)cudaGetLastError();
}

int retrieve_block_launch(const int* lane_lo, const int* lane_hi,
                          const int* doc_ids, int64_t n_total,
                          int bisect_iter, const float* values, int row_len,
                          float* out, int n_q, int n_shards, int blo,
                          int block, int window, cudaStream_t stream) {
  const size_t out_bytes = (size_t)block * n_q * row_len * sizeof(float);
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const int lanes = n_q * n_shards;
  if (lanes == 0 || n_total == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)lanes, (unsigned)((block + window - 1) / window));
  retrieve_block_kernel<<<grid, 256, 0, stream>>>(
      lane_lo, lane_hi, doc_ids, n_total, bisect_iter, values, row_len, out,
      n_q, n_shards, blo, block, window);
  return (int)cudaGetLastError();
}

int csr_lookup_packed_launch(
    const int* shard, const int* lo, const int* hi, int pair_routed,
    const int* docs, const int* words, int n_words, const int* bits,
    const int* tbase, const int* woff, const int* fences, int n_fence,
    const void* values, int quantized, int n_max, const float* scale,
    int row_len, float* out, int n_q, int n_cand, int n_shards, int tile,
    int fence_iter, int tile_iter, cudaStream_t stream) {
  const int64_t cells = (int64_t)n_q * n_cand;
  if (cells == 0) return 0;
  const int threads = 256, warps = threads / 32;
  const unsigned blocks = (unsigned)((cells + warps - 1) / warps);
  if (quantized)
    csr_lookup_packed_kernel<true><<<blocks, threads, 0, stream>>>(
        shard, lo, hi, pair_routed, docs, words, n_words, bits, tbase, woff,
        fences, n_fence, values, n_max, scale, row_len, out, n_q, n_cand,
        n_shards, tile, fence_iter, tile_iter);
  else
    csr_lookup_packed_kernel<false><<<blocks, threads, 0, stream>>>(
        shard, lo, hi, pair_routed, docs, words, n_words, bits, tbase, woff,
        fences, n_fence, values, n_max, scale, row_len, out, n_q, n_cand,
        n_shards, tile, fence_iter, tile_iter);
  return (int)cudaGetLastError();
}

int retrieve_block_packed_launch(
    const int* lane_lo, const int* lane_hi, const int* words, int n_words,
    const int* bits, const int* tbase, const int* woff, const int* fences,
    int n_fence, const void* values, int quantized, int n_max,
    const float* lane_scale, int row_len, float* out, int n_q, int n_shards,
    int blo, int block, int tile, int fence_iter, int tile_iter,
    cudaStream_t stream) {
  const size_t out_bytes = (size_t)block * n_q * row_len * sizeof(float);
  cudaError_t err = cudaMemsetAsync(out, 0, out_bytes, stream);
  if (err != cudaSuccess) return (int)err;
  const int lanes = n_q * n_shards;
  if (lanes == 0 || n_max == 0) return (int)cudaGetLastError();
  dim3 grid((unsigned)lanes, (unsigned)((block + tile - 1) / tile));
  if (quantized)
    retrieve_block_packed_kernel<true><<<grid, 256, 0, stream>>>(
        lane_lo, lane_hi, words, n_words, bits, tbase, woff, fences,
        n_fence, values, n_max, lane_scale, row_len, out, n_q, n_shards,
        blo, block, tile, fence_iter, tile_iter);
  else
    retrieve_block_packed_kernel<false><<<grid, 256, 0, stream>>>(
        lane_lo, lane_hi, words, n_words, bits, tbase, woff, fences,
        n_fence, values, n_max, lane_scale, row_len, out, n_q, n_shards,
        blo, block, tile, fence_iter, tile_iter);
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
