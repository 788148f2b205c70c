// SEINE's serving lookup and first-stage posting scan for Hopper (sm_90a).
//
// csr_lookup_kernel replaces the Pallas TPU kernel
// src/repro/kernels/csr_lookup/kernel.py::csr_lookup_pallas.  It computes
// M_{q,d} (B, Q, n_b, n_f): for each (candidate b, query term q) the
// routed posting range [lo, hi) of the owning shard k is searched for doc
// d -- over the shard's fence row (every tile-th doc id), then inside the
// one tile the fences select -- and the hit's (n_b, n_f) values row is
// copied out, or +0.0 written where the pair is absent.
//
// What bounds it on the H100: dependent rounds of loads, and the bytes each
// round moves.  A cell moves one 720-byte values row (n_b=20, n_f=9), and
// every load before that row depends on the one before: a bisect walks ~25
// of them.  The TPU kernel staged the fence row and the winning tile in
// VMEM by DMA.  Here one warp per cell (6,000 cells at the serving shape,
// one wave) runs warp_search, a k-ary search in rounds: the lanes load the
// last element of up to 32 * kProbes evenly spaced chunks of the range,
// all independent, and a ballot picks the first chunk whose last element
// is >= d.  All 6,000 warps move through the rounds together, so each
// round costs about a memory latency plus its bytes over the card's
// bandwidth, and a round that loads more sectors than it has to is as
// costly as one more round.  The chain:
//
//  1. routing: shard, lo, hi and the doc;
//  2. the fences of the term's own tiles only, (j_lo, j_hi], 8 probes per
//     lane: one round for any term of up to 256 tiles, every term of the
//     serving index at tile 256 (the fence rows stay in L1 and L2); an
//     empty range loads nothing.  A range of at most kWholeRange (4,096)
//     postings skips this and is searched whole in step 3, in as many
//     rounds as the fences and a tile would take;
//  3. the ids of the chosen tile inside [lo, hi): chunks of 32 ids (one
//     probe per lane: 8 sectors at tile 256), then the ids of the one
//     chunk left (one per lane); the probed value at the answer, or fence
//     jt + 1 when the answer is the window's right edge (a tile boundary
//     inside [lo, hi)), makes the hit check;
//  4. the row: copied as stored (-0.0 stays -0.0) in 16-byte vectors when
//     it is a multiple of 4 floats and both buffers are 16-byte aligned,
//     one float at a time otherwise.  Rows and M are loaded and stored
//     evict-first, so the doc ids (39 MB at the serving index) and fences
//     that the next requests search stay in the 50 MB L2.
//
// In a sorted range the first id >= d is unique, so the positions are the
// reference's bisect's and the output is bitwise the same.
//
// The first-stage scan replaces
// src/repro/kernels/csr_lookup/kernel.py::retrieve_windows_pallas fused
// with the segment scatter that followed it (ref.py::merge_windows): M
// (block, Q, n_b, n_f) of the docs [blo, blo + block) for the query's
// lanes (query slot q, shard k).  It is bound by writing M (4.4 MB at
// block 1,024, Q 6, n_b 20, n_f 9, most of it zeros) and reading the
// block's postings, so the work has to be spread over the card, M written
// once, and as few dependent loads as possible stand before the rows
// move.  Two kernels:
//
// lane_bounds_kernel runs once per scan (a query's 64 blocks): one thread
// per (lane, doc) bisects the lane for the doc, the first position whose
// id is >= it.  The bisect is the reference's (core.index._bisect, probes
// clamped to the row), stopped once its range is empty, where the
// reference's fixed-count loop stops moving; the positions are the same.
// A term posts once per doc, so the lane holds doc d iff its entries at d
// and d + 1 differ, at the first of them: the table is all the id work a
// block needs.
//
// retrieve_block_kernel runs once per block, one CTA of 256 threads per 4
// docs (256 CTAs at block 1,024, whatever the postings' spread over
// lanes).  One thread per (cell (doc, q), shard k) reads lane (q, k)'s two
// table entries (one round of loads, no ids) and leaves the posting, if
// any, in shared memory; exclusive (term, doc) ownership gives a cell at
// most one posting over its K lanes.  Then the CTA writes its 4 docs of
// M, a contiguous 4 * Q rows, once: the posting's row as 0.0f + v (a -0.0
// value becomes +0.0, as the reference's segment sum over zeros gives) or
// zeros, in 16-byte vectors (a 720-byte row is 45 of them) with eight
// loads in flight per thread; rows whose length is not a multiple of 4
// floats, or unaligned buffers, go one float at a time.  There is no
// memset: every cell of M is written by exactly one thread.
//
// csr_lookup_packed_kernel and lane_bounds_packed_kernel are the same
// kernels over tile-compressed doc ids (src/repro/core/codec.py): they
// replace csr_lookup_packed_pallas and the decode and bisects of
// retrieve_windows_packed_pallas, whose block launch,
// retrieve_block_packed_kernel, is retrieve_block_kernel over the packed
// index's values (f32, or int8 under packed-q8): the table holds every id
// it needs.  Each posting tile stores a frame base, a width class c in
// {0,4,8,16,32} and a word offset; the fence row stays raw.  An id decodes
// from one packed word: base + ((word >> (bit & 31)) & mask) with a
// logical (uint32_t) shift (the add wraps as the reference's int32 add),
// the raw word at c = 32, the base at c = 0.  The table's threads run the
// two-level bisect, one load per step.  The lookup, one warp per cell as
// the raw one, runs six dependent rounds where a bisect runs 12-20:
//
//  1. routing: shard, lo, hi, the doc and, under q8, the pair's scale;
//  2. warp_search over the term's own fences, as the raw lookup's (none
//     for a term inside one tile);
//  3. the chosen tile's (c, base, word offset).  Staging every fence
//     probe's tile metadata beside it, to save this round, was slower on
//     the H100: 7.40 against 6.66 us per launch at 6 x 1,000
//     (scripts/lookup_packed_ab.py), the staged probes costing more than
//     the round;
//  4. and 5. the tile's ids by warp_search over decoded probes, in the
//     raw lookup's id rounds: chunk ends, then the last chunk;
//  6. the row, as the raw lookup moves it (evict-first, 16-byte vectors
//     where aligned); under packed-q8 each int8 (a 180-byte row moves as
//     char4) is dequantised as __fmul_rn(float(v), scale) -- one rounding,
//     as the reference's single f32 multiply, never contracted into an
//     FMA.
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

constexpr unsigned kFullMask = 0xffffffffu;

// The first index in [a, b) of a sorted run whose value at(i) is >= d, or
// b if none, searched by a whole warp: each round splits [a, b) into at
// most 32 * kProbes chunks of `step` elements, loads every chunk's last
// element (kProbes independent loads per lane) and keeps the first chunk
// whose last element is >= d, less that element, which is the answer if
// nothing before it in the chunk is.  A range of at most 32 * kProbes
// elements takes one round (every element probed); before that, chunks
// hold at least kMinStep elements, so that a round reads no more sectors
// than it has probes.  An empty range loads nothing.  With kTrack, *v_at
// tracks the value at b: it is the probed value of the chunk end that
// became b, and keeps what the caller gave when no round finds one.
template <int kProbes, int kMinStep, bool kTrack, typename At>
__device__ __forceinline__ int warp_search(int a, int b, int d, int lane,
                                           At at, int* v_at) {
  constexpr int kChunks = 32 * kProbes;
  while (a < b) {
    const int n = b - a;
    const int step =
        n <= kChunks ? 1 : max(kMinStep, (n + kChunks - 1) / kChunks);
    const int chunks = step == 1 ? n : (n + step - 1) / step;
    int f[kProbes] = {};
#pragma unroll
    for (int i = 0; i < kProbes; ++i) {
      const int c = i * 32 + lane;
      if (i * 32 < chunks && c < chunks)
        f[i] = at(min(a + (c + 1) * step, b) - 1);
    }
    // the first chunk whose last element is >= d: the ballots are
    // independent; the lowest nonzero one names it
    unsigned ge[kProbes];
#pragma unroll
    for (int i = 0; i < kProbes; ++i)
      ge[i] = __ballot_sync(kFullMask, i * 32 + lane < chunks && f[i] >= d);
    int m = chunks;
#pragma unroll
    for (int i = kProbes - 1; i >= 0; --i)
      if (ge[i]) m = i * 32 + __ffs(ge[i]) - 1;
    if (kTrack && m < chunks) {
      int mine = f[0];
#pragma unroll
      for (int i = 1; i < kProbes; ++i)
        if (i == (m >> 5)) mine = f[i];
      *v_at = __shfl_sync(kFullMask, mine, m & 31);
    }
    if (m == chunks) {
      a = b;
    } else {
      const int a2 = a + m * step;
      b = min(a + (m + 1) * step, b) - 1;
      a = a2;
    }
  }
  return a;
}

// The raw lookup's search widths, (probes per lane, least chunk) of the
// fence search and of the id search, and the longest range searched whole,
// without the fences: the id search ends such a range in three rounds (32
// chunks of 128 ids, of 32, then 32 ids), as many as the fence round and a
// tile's two would take, but it loads fewer sectors: on an H100 the cut
// saves 0.4 us per launch at 6 x 1,000 cells and 2.9 us at the front end's
// coalesced (1, 41,728) grid (scripts/lookup_pool_ab.py, kWholeRange 4,096
// against 0).  kernel.py reads these lines, so that its plain version
// searches in the same rounds.
constexpr int kFenceProbes = 8, kFenceMinStep = 1;
constexpr int kIdProbes = 1, kIdMinStep = 32;
constexpr int kWholeRange = 4096;

// A lookup's M row, written by one warp: the stored f32 row (a -0.0 stays
// -0.0) or the int8 row dequantised as __fmul_rn(float(v), sc) -- one
// rounding, as the reference's single f32 multiply, never contracted into
// an FMA -- and +0.0 where the pair is absent; float4 (char4 under q8)
// vectors when the row is a multiple of 4 elements and both buffers are
// aligned.  Rows and M stream through the L2 (evict-first loads and
// stores), which keeps the ids and fences the next requests search there.
template <int kVec, bool kQuantized>
__device__ __forceinline__ void write_row(const void* __restrict__ values,
                                           int64_t src, bool found, float sc,
                                           int row_len, float* dst,
                                           int lane) {
  const int n_vec = row_len / kVec;
  if (!found) {
    for (int j = lane; j < n_vec; j += 32) {
      if constexpr (kVec == 4)
        __stcs(reinterpret_cast<float4*>(dst) + j,
               make_float4(0.f, 0.f, 0.f, 0.f));
      else
        __stcs(dst + j, 0.0f);
    }
    return;
  }
  for (int j = lane; j < n_vec; j += 32) {
    if constexpr (kQuantized && kVec == 4) {
      const char4 v = __ldcs(
          reinterpret_cast<const char4*>((const signed char*)values + src) +
          j);
      __stcs(reinterpret_cast<float4*>(dst) + j,
             make_float4(__fmul_rn((float)v.x, sc),
                         __fmul_rn((float)v.y, sc),
                         __fmul_rn((float)v.z, sc),
                         __fmul_rn((float)v.w, sc)));
    } else if constexpr (kQuantized) {
      __stcs(dst + j,
             __fmul_rn((float)__ldcs((const signed char*)values + src + j),
                       sc));
    } else if constexpr (kVec == 4) {
      __stcs(reinterpret_cast<float4*>(dst) + j,
             __ldcs(reinterpret_cast<const float4*>((const float*)values +
                                                    src) +
                    j));
    } else {
      __stcs(dst + j, __ldcs((const float*)values + src + j));
    }
  }
}

// One warp per (b, q) cell; every branch below is uniform over the warp.
template <int kVec>
__global__ void __launch_bounds__(256) csr_lookup_kernel(
    const int* __restrict__ shard, const int* __restrict__ lo,
    const int* __restrict__ hi, int pair_routed,
    const int* __restrict__ docs, const int* __restrict__ doc_ids,
    int n_max, const int* __restrict__ fences, int n_fence,
    const float* __restrict__ values, int row_len, float* __restrict__ out,
    int n_q, int n_cand, int n_shards, int tile) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (cell >= n_q * n_cand) return;
  const int b = cell / n_q;
  const int q = cell - b * n_q;
  // round 1, routing: per term (Q,) or, for doc-range sub-shards, per
  // pair (Q, B)
  const int r = pair_routed ? q * n_cand + b : q;
  const int k = clampi(__ldg(shard + r), 0, n_shards - 1);
  const int lo0 = __ldg(lo + r), hi0 = __ldg(hi + r), d = __ldg(docs + b);
  const int* frow = fences + (int64_t)k * n_fence;
  const int* drow = doc_ids + (int64_t)k * n_max;
  const auto fence = [&](int j) {
    return __ldg(frow + clampi(j, 0, n_fence - 1));
  };
  const auto id = [&](int p) { return doc_at(drow, n_max, max(p, 0)); };

  // the window to search for the first id >= d: a range of at most
  // kWholeRange postings is searched whole; a longer one is first narrowed
  // to the tile jt whose fence is the last below d (level 1: the first
  // fence >= d among the term's own, (j_lo, j_hi], where the fences are
  // sorted; 8 probes per lane, one round for up to 256 tiles), less
  // [lo, hi); fence jt + 1 stands in for the id at the window's end, a
  // tile boundary inside [lo, hi) when the window holds no id >= d
  int w_lo = lo0, w_hi = hi0, v_at = 0;
  if (hi0 - lo0 > kWholeRange) {
    const int j_lo = floordiv(lo0, tile);
    const int j_hi = max(floordiv(hi0 - 1, tile), j_lo);
    const int jf = warp_search<kFenceProbes, kFenceMinStep, false>(
        j_lo + 1, j_hi + 1, d, lane, fence, nullptr);
    // the clamp keeps the tile in bounds for an empty range pinned at a
    // tile-aligned shard end; the window below is then empty
    const int jt = clampi(jf - 1, 0, n_fence - 1);
    const int base = jt * tile;
    w_lo = max(base, lo0);
    w_hi = min(base + tile, hi0);
    v_at = fence(jt + 1);
  }
  // level 2: the first position in the window whose id is >= d (int32 max
  // past the row end), or the window's end (its start when it is empty):
  // chunks of 32 ids or more, one probe per lane, then the last chunk's
  // ids, one per lane -- two rounds of at most 8 + 5 sectors at tile 256
  const int pos = warp_search<kIdProbes, kIdMinStep, true>(
      w_lo, max(w_lo, w_hi), d, lane, id, &v_at);
  const bool found = (pos < hi0) && (v_at == d);

  // the row
  write_row<kVec, false>(
      values, ((int64_t)k * n_max + clampi(pos, 0, n_max - 1)) * row_len,
      found, 1.0f, row_len, out + (int64_t)cell * row_len, lane);
}

// first position p in [lo, hi) with ids[p] >= target; probes clamp to
// [0, n - 1] like the reference's clip gathers.  The loop ends once the
// range is empty, where the reference's fixed-count loop stops moving.
__device__ __forceinline__ int bisect(const int* __restrict__ ids,
                                      int64_t n, int lo, int hi,
                                      int64_t target) {
  while (lo < hi) {
    const int mid = midpoint(lo, hi);
    const int64_t at = mid < 0 ? 0 : (mid >= n ? n - 1 : (int64_t)mid);
    if ((int64_t)__ldg(ids + at) < target)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

// grid (edges / 256, lanes): bounds[l][i] for doc origin + i
__global__ void lane_bounds_kernel(const int* __restrict__ lane_lo,
                                   const int* __restrict__ lane_hi,
                                   const int* __restrict__ doc_ids,
                                   int64_t n_total, int64_t origin,
                                   int n_edges, int* __restrict__ bounds) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_edges) return;
  const int l = blockIdx.y;
  bounds[(int64_t)l * n_edges + i] = bisect(
      doc_ids, n_total, __ldg(lane_lo + l), __ldg(lane_hi + l), origin + i);
}

// docs per CTA and threads per CTA of the block kernel: 256 CTAs at block
// 1,024, and 256 threads x 8 vectors cover 4 docs x 6 slots x 45 vectors
// in one round of loads
constexpr int kScanDocs = 4;
constexpr int kScanThreads = 256;
constexpr int kScanUnroll = 8;

template <int kVec>
struct ScanVec;
template <>
struct ScanVec<1> {
  using type = float;
  __device__ static float zero() { return 0.0f; }
};
template <>
struct ScanVec<4> {
  using type = float4;
  __device__ static float4 zero() { return make_float4(0.f, 0.f, 0.f, 0.f); }
};

// 0.0f + v of the kVec stored values at element `at` of the values buffer
// (f32, or int8 dequantised by `scale`)
template <int kVec, bool kQuantized>
__device__ __forceinline__ typename ScanVec<kVec>::type scan_row(
    const void* __restrict__ values, int64_t at, float scale) {
  if constexpr (kVec == 1) {
    float v;
    if constexpr (kQuantized)
      v = __fmul_rn((float)__ldg((const signed char*)values + at), scale);
    else
      v = __ldg((const float*)values + at);
    return __fadd_rn(0.0f, v);
  } else {
    float4 r;
    if constexpr (kQuantized) {
      const char4 c = __ldg((const char4*)((const signed char*)values + at));
      r = make_float4(__fmul_rn((float)c.x, scale),
                      __fmul_rn((float)c.y, scale),
                      __fmul_rn((float)c.z, scale),
                      __fmul_rn((float)c.w, scale));
    } else {
      r = __ldg((const float4*)((const float*)values + at));
    }
    return make_float4(__fadd_rn(0.0f, r.x), __fadd_rn(0.0f, r.y),
                       __fadd_rn(0.0f, r.z), __fadd_rn(0.0f, r.w));
  }
}

// The body of both block kernels.  CTA s owns docs [s * kScanDocs, ...)
// of the block whose first table column is edge0, and writes their cells
// (doc, q) of M: the row of the posting the table puts there (scaled by
// its lane's scale under q8), or zeros.
template <int kVec, bool kQuantized>
__device__ __forceinline__ void scan_block(
    const int* __restrict__ bounds, int n_edges, int edge0,
    const void* __restrict__ values, const float* __restrict__ lane_scale,
    int row_len, float* __restrict__ out, int n_q, int n_shards,
    int block) {
  using V = typename ScanVec<kVec>::type;
  extern __shared__ int smem[];
  const int d0 = blockIdx.x * kScanDocs;
  const int cells = min(kScanDocs, block - d0) * n_q;
  int* src = smem;                                  // (doc, q) -> posting
  float* scl = reinterpret_cast<float*>(smem + kScanDocs * n_q);
  for (int c = threadIdx.x; c < cells; c += blockDim.x) src[c] = -1;
  __syncthreads();
  // one thread per (cell, shard k): the lane's two table entries, in one
  // round of loads; at most one lane of a cell's slot holds its doc
  for (int t = threadIdx.x; t < cells * n_shards; t += blockDim.x) {
    const int c = t / n_shards, d = c / n_q;
    const int l = (c - d * n_q) * n_shards + (t - c * n_shards);
    const int* at = bounds + (int64_t)l * n_edges + edge0 + d0 + d;
    const int lo = __ldg(at), hi = __ldg(at + 1);
    if (lo < hi) {
      src[c] = lo;
      if (kQuantized) scl[c] = __ldg(lane_scale + l);
    }
  }
  __syncthreads();
  // the CTA's rows of M, contiguous from dst; kScanUnroll loads are
  // issued before their stores
  float* dst = out + (int64_t)d0 * n_q * row_len;
  const int per_row = row_len / kVec;
  const int n_vec = cells * per_row;
  for (int v0 = threadIdx.x; v0 < n_vec; v0 += kScanUnroll * blockDim.x) {
    V x[kScanUnroll];
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int v = v0 + u * blockDim.x;
      x[u] = ScanVec<kVec>::zero();
      if (v < n_vec) {
        const int c = v / per_row;
        const int p = src[c];
        if (p >= 0)
          x[u] = scan_row<kVec, kQuantized>(
              values, (int64_t)p * row_len + (int64_t)(v - c * per_row) * kVec,
              kQuantized ? scl[c] : 1.0f);
      }
    }
#pragma unroll
    for (int u = 0; u < kScanUnroll; ++u) {
      const int v = v0 + u * blockDim.x;
      if (v < n_vec) reinterpret_cast<V*>(dst)[v] = x[u];
    }
  }
}

template <int kVec>
__global__ void __launch_bounds__(kScanThreads) retrieve_block_kernel(
    const int* __restrict__ bounds, int n_edges, int edge0,
    const float* __restrict__ values, int row_len, float* __restrict__ out,
    int n_q, int n_shards, int block) {
  scan_block<kVec, false>(bounds, n_edges, edge0, values, nullptr, row_len,
                          out, n_q, n_shards, block);
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
// decoded words (the lane-bounds table's search)
__device__ int packed_bisect(const PackedShard& s,
                             const int* __restrict__ words, int64_t n_total,
                             int n_fence, int lo, int hi, int64_t target,
                             int tile, int fence_iter, int tile_iter) {
  const int j_lo = floordiv(lo, tile);
  const int j_hi = max(floordiv(hi - 1, tile), j_lo);
  int flo = j_lo + 1, fhi = j_hi + 1;
  for (int i = 0; i < fence_iter && flo < fhi; ++i) {
    const int mid = midpoint(flo, fhi);
    const bool go =
        (int64_t)__ldg(s.frow + clampi(mid, 0, n_fence - 1)) < target;
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
        (int64_t)decode_packed(words, n_total, w0, mid - base, c, tb) <
        target;
    plo = go ? mid + 1 : plo;
    phi = go ? phi : mid;
  }
  return plo;
}

// One warp per (b, q) cell, as the raw lookup; every branch below is
// uniform over the warp.  At least 6 CTAs of 8 warps per SM (at most 40
// registers a thread; the raw lookup takes 38): 6,336 warps on 132 SMs
// hold the serving shape's 6,000 cells in one wave.  Left to itself ptxas
// took 48 registers, 5 CTAs per SM, and the launch 7.8 us where the cap
// gives 6.7 (H100, scripts/lookup_packed_ab.py).
template <int kVec, bool kQuantized>
__global__ void __launch_bounds__(256, 6) csr_lookup_packed_kernel(
    const int* __restrict__ shard, const int* __restrict__ lo,
    const int* __restrict__ hi, int pair_routed,
    const int* __restrict__ docs, const int* __restrict__ words,
    int n_words, const int* __restrict__ bits,
    const int* __restrict__ tbase, const int* __restrict__ woff,
    const int* __restrict__ fences, int n_fence,
    const void* __restrict__ values, int n_max,
    const float* __restrict__ scale, int row_len, float* __restrict__ out,
    int n_q, int n_cand, int n_shards, int tile) {
  const int lane = threadIdx.x & 31;
  const int cell = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  if (cell >= n_q * n_cand) return;
  const int b = cell / n_q;
  const int q = cell - b * n_q;
  // round 1, routing: per term (Q,) or per pair (Q, B), and the pair's
  // dequant scale under q8
  const int r = pair_routed ? q * n_cand + b : q;
  const int k = clampi(__ldg(shard + r), 0, n_shards - 1);
  const int lo0 = __ldg(lo + r), hi0 = __ldg(hi + r), d = __ldg(docs + b);
  const float sc = kQuantized ? __ldg(scale + r) : 1.0f;
  const PackedShard s =
      packed_shard(fences, bits, tbase, woff, n_fence, n_words, k);
  const int64_t n_total = (int64_t)n_shards * n_words;

  // round 2: the first fence >= d among the term's own, (j_lo, j_hi]:
  // tile jt is the one before it, or j_hi where none is (or the term lies
  // in one tile: no fence to search); the clamp keeps jt in bounds for an
  // empty range pinned at a tile-aligned shard end.  Fence jt + 1 stands
  // in for the id at the window's end (a tile boundary inside [lo, hi))
  // when the window holds no id >= d.  Round 3: tile jt's metadata.
  const int j_lo = floordiv(lo0, tile);
  const int j_hi = max(floordiv(hi0 - 1, tile), j_lo);
  int v_at = 0;
  const int jf = warp_search<kFenceProbes, kFenceMinStep, true>(
      j_lo + 1, j_hi + 1, d, lane,
      [&](int j) { return __ldg(s.frow + clampi(j, 0, n_fence - 1)); },
      &v_at);
  const int jt = clampi(jf - 1, 0, n_fence - 1);
  const int c = __ldg(s.bits + jt), tb = __ldg(s.base + jt);
  const int64_t w0 = s.word0 + __ldg(s.woff + jt);
  const int base = jt * tile;
  const int w_lo = max(base, lo0), w_hi = min(base + tile, hi0);

  // rounds 4 and 5: the first position in the window whose id is >= d,
  // or the window's end (its start when it is empty), over decoded probes
  // in the raw lookup's id rounds.  Loading a tile of c <= 16 whole (at
  // most 128 words, 4 per lane) and decoding it in one round instead was
  // 0.1-0.2 us faster at 6 x 1,000 but 0.8-1.2 us slower at the coalesced
  // (1, 41,728) grid on an H100 (scripts/lookup_packed_ab.py).
  const int pos = warp_search<kIdProbes, kIdMinStep, true>(
      w_lo, max(w_lo, w_hi), d, lane,
      [&](int p) {
        return decode_packed(words, n_total, w0, p - base, c, tb);
      },
      &v_at);
  const bool found = (pos < hi0) && (v_at == d);

  // round 6: the row
  write_row<kVec, kQuantized>(
      values, ((int64_t)k * n_max + clampi(pos, 0, n_max - 1)) * row_len,
      found, sc, row_len, out + (int64_t)cell * row_len, lane);
}

// lane_bounds_kernel over packed ids: the two-level packed bisect of the
// lane's shard-local range, stored as a flat position.  An empty lane is
// its own answer (the bisect returns lo there) and reads nothing.
__global__ void lane_bounds_packed_kernel(
    const int* __restrict__ lane_lo, const int* __restrict__ lane_hi,
    const int* __restrict__ words, int n_words, const int* __restrict__ bits,
    const int* __restrict__ tbase, const int* __restrict__ woff,
    const int* __restrict__ fences, int n_fence, int n_max, int n_shards,
    int tile, int fence_iter, int tile_iter, int64_t origin, int n_edges,
    int* __restrict__ bounds) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_edges) return;
  const int l = blockIdx.y, k = l % n_shards;
  const int shard0 = k * n_max;
  const int lo = __ldg(lane_lo + l) - shard0, hi = __ldg(lane_hi + l) - shard0;
  int pos = lo;
  if (lo < hi) {
    const PackedShard s =
        packed_shard(fences, bits, tbase, woff, n_fence, n_words, k);
    pos = packed_bisect(s, words, (int64_t)n_shards * n_words, n_fence, lo,
                        hi, origin + i, tile, fence_iter, tile_iter);
  }
  bounds[(int64_t)l * n_edges + i] = shard0 + pos;
}

// the block kernel of a packed index: values f32, or int8 with lane scales
template <int kVec, bool kQuantized>
__global__ void __launch_bounds__(kScanThreads) retrieve_block_packed_kernel(
    const int* __restrict__ bounds, int n_edges, int edge0,
    const void* __restrict__ values, const float* __restrict__ lane_scale,
    int row_len, float* __restrict__ out, int n_q, int n_shards,
    int block) {
  scan_block<kVec, kQuantized>(bounds, n_edges, edge0, values, lane_scale,
                               row_len, out, n_q, n_shards, block);
}

}  // namespace

extern "C" {

static bool vec_rows(const void* values, int elem_bytes, int row_len,
                     const float* out);

int csr_lookup_launch(const int* shard, const int* lo, const int* hi,
                      int pair_routed, const int* docs, const int* doc_ids,
                      int n_max, const int* fences, int n_fence,
                      const float* values, int row_len, float* out, int n_q,
                      int n_cand, int n_shards, int tile,
                      cudaStream_t stream) {
  const int64_t cells = (int64_t)n_q * n_cand;
  if (cells == 0) return 0;
  if (cells > INT_MAX) return (int)cudaErrorInvalidValue;  // int32 cells
  const int threads = 256, warps = threads / 32;
  const unsigned blocks = (unsigned)((cells + warps - 1) / warps);
  if (vec_rows(values, 4, row_len, out))
    csr_lookup_kernel<4><<<blocks, threads, 0, stream>>>(
        shard, lo, hi, pair_routed, docs, doc_ids, n_max, fences, n_fence,
        values, row_len, out, n_q, n_cand, n_shards, tile);
  else
    csr_lookup_kernel<1><<<blocks, threads, 0, stream>>>(
        shard, lo, hi, pair_routed, docs, doc_ids, n_max, fences, n_fence,
        values, row_len, out, n_q, n_cand, n_shards, tile);
  return (int)cudaGetLastError();
}

int lane_bounds_launch(const int* lane_lo, const int* lane_hi,
                       const int* doc_ids, int64_t n_total, int n_lanes,
                       int64_t origin, int n_edges, int* bounds,
                       cudaStream_t stream) {
  if (n_lanes == 0 || n_edges == 0) return 0;
  dim3 grid((unsigned)((n_edges + 255) / 256), (unsigned)n_lanes);
  lane_bounds_kernel<<<grid, 256, 0, stream>>>(lane_lo, lane_hi, doc_ids,
                                               n_total, origin, n_edges,
                                               bounds);
  return (int)cudaGetLastError();
}

// 16-byte vectors when every row starts 16-byte aligned in both buffers
static bool vec_rows(const void* values, int elem_bytes, int row_len,
                     const float* out) {
  return row_len % 4 == 0 &&
         (uintptr_t)values % (4 * elem_bytes) == 0 &&
         (uintptr_t)out % 16 == 0;
}

static size_t scan_smem(int n_q) {
  return (size_t)kScanDocs * n_q * (sizeof(int) + sizeof(float));
}

int retrieve_block_launch(const int* bounds, int n_edges, int edge0,
                          const void* values, int quantized,
                          const float* lane_scale, int row_len, float* out,
                          int n_q, int n_shards, int block,
                          cudaStream_t stream) {
  if (n_q == 0 || block == 0 || row_len == 0) return 0;
  if (quantized || lane_scale != nullptr) return (int)cudaErrorInvalidValue;
  const unsigned grid = (unsigned)((block + kScanDocs - 1) / kScanDocs);
  const float* v = (const float*)values;
  if (vec_rows(values, 4, row_len, out))
    retrieve_block_kernel<4><<<grid, kScanThreads, scan_smem(n_q), stream>>>(
        bounds, n_edges, edge0, v, row_len, out, n_q, n_shards, block);
  else
    retrieve_block_kernel<1><<<grid, kScanThreads, scan_smem(n_q), stream>>>(
        bounds, n_edges, edge0, v, row_len, out, n_q, n_shards, block);
  return (int)cudaGetLastError();
}

int csr_lookup_packed_launch(
    const int* shard, const int* lo, const int* hi, int pair_routed,
    const int* docs, const int* words, int n_words, const int* bits,
    const int* tbase, const int* woff, const int* fences, int n_fence,
    const void* values, int quantized, int n_max, const float* scale,
    int row_len, float* out, int n_q, int n_cand, int n_shards, int tile,
    cudaStream_t stream) {
  const int64_t cells = (int64_t)n_q * n_cand;
  if (cells == 0) return 0;
  if (cells > INT_MAX) return (int)cudaErrorInvalidValue;  // int32 cells
  const int threads = 256, warps = threads / 32;
  const unsigned blocks = (unsigned)((cells + warps - 1) / warps);
  const bool vec = vec_rows(values, quantized ? 1 : 4, row_len, out);
#define LOOKUP_ARGS                                                         \
  shard, lo, hi, pair_routed, docs, words, n_words, bits, tbase, woff,     \
      fences, n_fence, values, n_max, scale, row_len, out, n_q, n_cand,    \
      n_shards, tile
  if (quantized && vec)
    csr_lookup_packed_kernel<4, true><<<blocks, threads, 0, stream>>>(
        LOOKUP_ARGS);
  else if (quantized)
    csr_lookup_packed_kernel<1, true><<<blocks, threads, 0, stream>>>(
        LOOKUP_ARGS);
  else if (vec)
    csr_lookup_packed_kernel<4, false><<<blocks, threads, 0, stream>>>(
        LOOKUP_ARGS);
  else
    csr_lookup_packed_kernel<1, false><<<blocks, threads, 0, stream>>>(
        LOOKUP_ARGS);
#undef LOOKUP_ARGS
  return (int)cudaGetLastError();
}

int lane_bounds_packed_launch(
    const int* lane_lo, const int* lane_hi, const int* words, int n_words,
    const int* bits, const int* tbase, const int* woff, const int* fences,
    int n_fence, int n_max, int n_q, int n_shards, int tile, int fence_iter,
    int tile_iter, int64_t origin, int n_edges, int* bounds,
    cudaStream_t stream) {
  const int lanes = n_q * n_shards;
  if (lanes == 0 || n_edges == 0) return 0;
  dim3 grid((unsigned)((n_edges + 255) / 256), (unsigned)lanes);
  lane_bounds_packed_kernel<<<grid, 256, 0, stream>>>(
      lane_lo, lane_hi, words, n_words, bits, tbase, woff, fences, n_fence,
      n_max, n_shards, tile, fence_iter, tile_iter, origin, n_edges, bounds);
  return (int)cudaGetLastError();
}

int retrieve_block_packed_launch(const int* bounds, int n_edges, int edge0,
                                 const void* values, int quantized,
                                 const float* lane_scale, int row_len,
                                 float* out, int n_q, int n_shards, int block,
                                 cudaStream_t stream) {
  if (n_q == 0 || block == 0 || row_len == 0) return 0;
  const unsigned grid = (unsigned)((block + kScanDocs - 1) / kScanDocs);
  const size_t smem = scan_smem(n_q);
  const bool vec = vec_rows(values, quantized ? 1 : 4, row_len, out);
#define SCAN_ARGS                                                      \
  bounds, n_edges, edge0, values, lane_scale, row_len, out, n_q, n_shards, \
      block
  if (quantized && vec)
    retrieve_block_packed_kernel<4, true>
        <<<grid, kScanThreads, smem, stream>>>(SCAN_ARGS);
  else if (quantized)
    retrieve_block_packed_kernel<1, true>
        <<<grid, kScanThreads, smem, stream>>>(SCAN_ARGS);
  else if (vec)
    retrieve_block_packed_kernel<4, false>
        <<<grid, kScanThreads, smem, stream>>>(SCAN_ARGS);
  else
    retrieve_block_packed_kernel<1, false>
        <<<grid, kScanThreads, smem, stream>>>(SCAN_ARGS);
#undef SCAN_ARGS
  return (int)cudaGetLastError();
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
