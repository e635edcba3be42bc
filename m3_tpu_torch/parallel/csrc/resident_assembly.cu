// Resident lane assembly (kernel B-2): the chunk-lanes of a decode from
// residency, gathered on the card from the resident pool's page buffer and
// side planes. It replaces the XLA programs of m3_tpu/parallel/scan.py:
// _resident_gather (:456), _assemble_resident_lanes_traced (:505) and
// _assemble_resident_packed_traced (:560); the port's plain torch version of
// the same (parallel/scan.py _resident_gather and assemble_resident_*) is its
// twin.
//
// What it computes. A plan (resident/pool.py plan_chunked, padded to S
// series) gives per series s: page_rows[s, LP] (the pages of its stream, then
// zero pages), side_rows[s, SL] (its side pages), n_chunks[s], total_bits[s]
// and its block start as (block_hi[s], block_lo[s]). Lane (si, ci) is chunk
// ci of series si; it is valid when ci < n_chunks[si]. Its side row is slot
// ci % spc of side page side_rows[si, ci / spc] (10 u32 words, the layout of
// ops/sideplane.py), unpacked into the decoder state: prev_time re-based on
// the block start (0 when the row's pt_zero bit is set), prev_delta,
// prev_float_bits, prev_xor, int_val (hi, lo words), time_unit, sig, mult,
// is_float, the chunk's bit offset `off` and its fast-chunk flags. Then
// rel = off % 32, num_bits = clamp(total_bits - (off / 32) * 32, 0, CW * 32),
// first = (ci == 0), and its window: the CW words from word off / 32 of the
// stream, word w at page_rows[si, w / W] * W + w % W of the flat pool (the
// plan's trailing zero pages cover the end). An invalid lane is all zeros.
// The 17 state planes are written in fused.PACKED_LANE_PLANES order.
//
// Two layouts, as the twin gives them:
// - packed (B1's and R's input, fused.PackedLanes): lane j of npad (tiles of
//   tile_lanes lanes) is (j % S, j / S) in chunk-major order or (j / C, j % C)
//   in series-major order; lanes past n = S * C are padding (invalid).
//   Windows word-major [CW, npad], planes [17, npad], and one flag a tile: 1
//   when every lane is int-fast, else 2 when every lane is float-fast, else
//   0 (a fast flag of the side row, never on a first chunk; an invalid lane
//   counts as fast).
// - per field (B3's input, ops/chunked.lane_kwargs): series-major lanes,
//   windows lane-major [n, CW], planes [17, n].
// Every word equals the twin's, bit for bit.
//
// Design: series-tiled staging. A block takes kSeries (32) consecutive
// series of the padded plan and 512 threads.
// 1. Each series' n_chunks, total_bits and block start go to shared memory.
// 2. Each warp copies whole series by cp.async: a series' side rows (its
//    n_chunks rows lie in ceil(n_chunks / spc) side pages of spc x 40
//    contiguous bytes), then its stream words 0 .. ceil(total_bits / 32) + CW
//    (the span every window of the series lies in), walking its page_rows one
//    page run at a time. The copy takes the pool's words as they are, past
//    the stream's end and over the plan's trailing zero pages too, as the
//    twin's gather reads them. Consecutive threads copy consecutive words, so
//    the reads are coalesced, where one thread a lane read a window and a
//    side row of its own (chunk-major lanes put 32 series in a warp).
// 3. Every thread then builds lanes from shared memory. The block's lanes
//    are runs of the packed order: in chunk-major order the run
//    [ci * S + s0, ci * S + s0 + 32) of each chunk ci, in series-major order
//    one run [s0 * C, (s0 + 32) * C); consecutive threads take consecutive
//    lanes, so each plane and each window word is stored for consecutive
//    lanes (the windows of the lane-major per-field layout are stored a lane
//    at a time, as before).
// A series whose span exceeds its slot (the stream words the launch gives a
// series, which the wrapper sizes to the plan's longest span within the
// shared-memory budget) reads its windows from the pool by the direct page
// walk, in the same launch; with slot 0 (a plan whose chunks do not fit the
// budget) every series does, side rows included. The wrapper counts those
// series.
// Tile flags: a block ANDs its lanes' fast bits per tile in shared memory (a
// chunk's run lies in at most two tiles) and ANDs each result into the
// tile's word with one atomicAnd, so many blocks make up one tile, exactly
// and in any order; a second small launch maps the bits to 0/1/2. Padding
// lanes past n are zeroed by blocks of their own. Bound: the pool words of
// each series' stream, each valid lane's side row and the plan's vectors
// read once; windows, planes and tile flags written once.
//
// Without __CUDACC__ the same block code compiles as host C++
// (m3_resident_assembly_host), run a block at a time with one thread, so the
// CPU tests hold this source, its staged and direct routes and its per-tile
// AND, against the twin.

#include <cstdint>
#include <cstring>

#include "../../csrc/launch.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define M3_HD inline
#endif

namespace {

constexpr int kThreads = 512;
constexpr int kSeries = 32;       // series a block stages
constexpr int kSideWords = 10;
constexpr int kPlanes = 17;
constexpr int kMeta = 5;          // n_chunks, total_bits, block hi, block lo, staged words
constexpr int kPadLanes = 1024;   // padding lanes a block zeroes
constexpr int64_t kSmemBudget = 96 * 1024;  // bytes of shared memory a block may take

// The plan's per-series vectors and the pool's flat buffers.
struct Plan {
  const uint32_t* words;       // [num_pages * W]
  const uint32_t* side;        // [num_side_pages * spc * 10]
  const int32_t* page_rows;    // [S, LP]
  const int32_t* side_rows;    // [S, SL]
  const int32_t* n_chunks;     // [S]
  const int32_t* total_bits;   // [S]
  const uint32_t* block_hi;    // [S]
  const uint32_t* block_lo;    // [S]
  int64_t s, c;                // series (padded), chunks per series
  int lp, sl, w, spc, cw;
};

// Where the outputs go: planes [17, npad]; windows word-major [CW, npad]
// (lane_major == 0) or lane-major [npad, CW].
struct Out {
  uint32_t* windows;
  uint32_t* planes;
  int64_t npad;
  int lane_major;
};

// A launch's shape: lane order, tiles, and the shared memory of a block.
struct Geometry {
  int64_t n;              // s * c lanes; npad - n padding lanes follow
  int order;              // 0 chunk-major, 1 series-major
  int64_t tile_lanes;
  int slot;               // stream words a staged series may take (0: nothing staged)
  int side_stride;        // words of a series' side rows in shared memory (odd)
  int slot_stride;        // words of a series' stream slot (odd)
  int nslot;              // tile accumulators (0: no tile flags)
  int64_t series_blocks;
};

// A block's series and its shared memory.
struct Block {
  int64_t s0;
  int nb;
  uint32_t* meta;    // [kSeries, kMeta]
  uint32_t* acc;     // [nslot] fast bits per tile
  uint32_t* side;    // [kSeries, side_stride]
  uint32_t* stream;  // [kSeries, slot_stride]
};

M3_HD int64_t side_stride_of(int64_t c) { return (c * kSideWords) | 1; }
M3_HD int64_t most_slots(int64_t c) { return 2 * c + kSeries * c / 128 + 2; }

// The most stream words a staged series may take at c chunks and windows of
// cw words (odd, so that the slots of 32 series start on 32 banks), or 0 if
// the side rows leave no room for a window.
M3_HD int slot_cap(int64_t c, int cw) {
  const int64_t fixed = kSeries * kMeta + most_slots(c) + kSeries * side_stride_of(c);
  int64_t cap = (kSmemBudget / 4 - fixed) / kSeries;
  if (cap % 2 == 0) cap -= 1;
  return cap > cw ? (int)cap : 0;
}

// a / b in 32 bits where a fits (tens of instructions fewer than 64 bits)
M3_HD int64_t div_fast(int64_t a, int64_t b) {
  return a <= 0xffffffffLL && b <= 0xffffffffLL ? (int64_t)((uint32_t)a / (uint32_t)b) : a / b;
}

M3_HD Geometry geometry(const Plan& p, int order, int lane_major, int64_t tile_lanes, int slot,
                        bool flags) {
  Geometry g;
  g.n = p.s * p.c;
  g.order = order;
  g.tile_lanes = tile_lanes;
  g.slot = slot;
  g.side_stride = slot > 0 ? (int)side_stride_of(p.c) : 0;
  g.slot_stride = slot > 0 ? (slot | 1) : 0;
  g.nslot = !flags || lane_major ? 0
            : order == 0 ? (int)(2 * p.c)
                         : (int)((kSeries * p.c + tile_lanes - 1) / tile_lanes + 1);
  g.series_blocks = (p.s + kSeries - 1) / kSeries;
  return g;
}

M3_HD int64_t smem_words(const Geometry& g) {
  return kSeries * kMeta + g.nslot + (int64_t)kSeries * (g.side_stride + g.slot_stride);
}

M3_HD Block block_at(const Plan& p, const Geometry& g, int64_t b, uint32_t* sm) {
  Block k;
  k.s0 = b * kSeries;
  k.nb = (int)(p.s - k.s0 < kSeries ? p.s - k.s0 : kSeries);
  k.meta = sm;
  k.acc = k.meta + kSeries * kMeta;
  k.side = k.acc + g.nslot;
  k.stream = k.side + kSeries * g.side_stride;
  return k;
}

M3_HD void copy4(uint32_t* dst, const uint32_t* src) {
#ifdef __CUDA_ARCH__
  m3::cp_async4(dst, src);
#else
  *dst = *src;
#endif
}

M3_HD void and_into(uint32_t* word, uint32_t bits) {
#ifdef __CUDA_ARCH__
  atomicAnd(word, bits);
#else
  *word &= bits;
#endif
}

// A lane's fast bits into its tile accumulator. On the card the lanes of a
// warp that hold the same (slot, bits) send one atomicAnd between them (the
// lanes of a chunk's run share a slot, so a warp's 32 would otherwise queue
// on one shared-memory word); bits 3 change nothing and are not sent.
M3_HD void and_slot(uint32_t* acc, int64_t slot, int fast) {
#ifdef __CUDA_ARCH__
  const unsigned peers = __match_any_sync(__activemask(), (unsigned)(slot * 4 + fast));
  if (fast != 3 && (int)(threadIdx.x & 31) == __ffs(peers) - 1) atomicAnd(acc + slot, (uint32_t)fast);
#else
  if (fast != 3) acc[slot] &= (uint32_t)fast;
#endif
}

// Series si's vectors into meta, and the words its stream slot takes: its
// span (ceil(total_bits / 32) + cw words, within its page row) when that
// fits the slot, else 0 (the direct route).
M3_HD void series_meta(const Plan& p, const Geometry& g, int64_t si, uint32_t* meta) {
  const int32_t nc = p.n_chunks[si], tb = p.total_bits[si];
  int64_t span = (tb > 0 ? ((int64_t)tb + 31) / 32 : 0) + p.cw;
  const int64_t row = (int64_t)p.lp * p.w;
  if (span > row) span = row;
  meta[0] = (uint32_t)nc;
  meta[1] = (uint32_t)tb;
  meta[2] = p.block_hi[si];
  meta[3] = p.block_lo[si];
  meta[4] = g.slot > 0 && nc > 0 && span <= g.slot ? (uint32_t)span : 0u;
}

// Copies series si's side rows and (when staged) its stream words into its
// shared memory, threads lane, lane + nlanes, ... of its copiers taking
// consecutive words of each side page and each page of the stream.
M3_HD void stage_series(const Plan& p, int64_t si, const uint32_t* meta, uint32_t* side,
                        uint32_t* stream, int lane, int nlanes) {
  const int64_t nc = (int32_t)meta[0];
  for (int64_t q = 0; q * p.spc < nc; ++q) {
    const int64_t rows = nc - q * p.spc < p.spc ? nc - q * p.spc : p.spc;
    const uint32_t* src = p.side + (int64_t)p.side_rows[si * p.sl + q] * p.spc * kSideWords;
    uint32_t* dst = side + q * p.spc * kSideWords;
    for (int64_t e = lane; e < rows * kSideWords; e += nlanes) copy4(dst + e, src + e);
  }
  const int64_t staged = meta[4];
  for (int64_t q = 0; q * p.w < staged; ++q) {
    const int64_t words = staged - q * p.w < p.w ? staged - q * p.w : p.w;
    const uint32_t* src = p.words + (int64_t)p.page_rows[si * p.lp + q] * p.w;
    uint32_t* dst = stream + q * p.w;
    for (int64_t e = lane; e < words; e += nlanes) copy4(dst + e, src + e);
  }
}

M3_HD void store_window(const Out& o, int cw, int64_t j, int k, uint32_t x) {
  if (o.lane_major) o.windows[j * cw + k] = x;
  else o.windows[(int64_t)k * o.npad + j] = x;
}

// Word w of series si's stream, through its page row.
M3_HD uint32_t word_at(const Plan& p, int64_t si, int64_t w) {
  return p.words[(int64_t)p.page_rows[si * p.lp + w / p.w] * p.w + w % p.w];
}

// The direct route's window: word w0 + k of the stream is word (w0 + k) % W
// of page (w0 + k) / W of the series' page row, walked without a division a
// word, 16 words loaded before any is stored so that they are in flight
// together.
M3_HD void direct_window(const Plan& p, const Out& o, int64_t j, int64_t si, int64_t w0) {
  constexpr int kBatch = 16;
  const int32_t* pages = p.page_rows + si * p.lp;
  uint32_t pi = (uint32_t)w0 / (uint32_t)p.w, at = (uint32_t)w0 % (uint32_t)p.w;
  const uint32_t* page = p.words + (int64_t)pages[pi] * p.w;
  for (int k0 = 0; k0 < p.cw; k0 += kBatch) {
    uint32_t buf[kBatch];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int u = 0; u < kBatch; ++u) {
      buf[u] = 0;
      if (k0 + u < p.cw) {
        buf[u] = page[at];
        if (++at == (uint32_t)p.w) {
          at = 0;
          page = p.words + (int64_t)pages[++pi] * p.w;
        }
      }
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int u = 0; u < kBatch; ++u)
      if (k0 + u < p.cw) store_window(o, p.cw, j, k0 + u, buf[u]);
  }
}

// Lane j = (si, ci) into `o` from its side row `row` (null for an invalid
// lane) and its series' meta; its window from the staged stream words
// (`stream`, null on the direct route). Returns the fast flags a tile reads
// (bit 0 int-fast, bit 1 float-fast), both set for an invalid lane.
M3_HD int emit_lane(const Plan& p, const Out& o, int64_t j, int64_t si, int64_t ci,
                    const uint32_t* meta, const uint32_t* row, const uint32_t* stream) {
  const bool valid = row != nullptr;
  uint32_t r[kSideWords] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (valid)
    for (int k = 0; k < kSideWords; ++k) r[k] = row[k];
  const uint32_t w8 = r[8], w9 = r[9];
  const uint32_t off = w8 >> 11;
  const uint32_t rel = off & 31u;
  const int64_t w0 = off >> 5;
  uint32_t nbits = 0;
  uint32_t pt_hi = 0, pt_lo = 0;
  if (valid) {
    int64_t b = (int64_t)(int32_t)meta[1] - w0 * 32;
    const int64_t cap = (int64_t)p.cw * 32;
    nbits = (uint32_t)(b < 0 ? 0 : (b > cap ? cap : b));
    if (((w9 >> 6) & 1u) == 0) {
      const uint64_t rel_t = ((uint64_t)(w9 >> 20) << 32) | r[6];
      const uint64_t base = ((uint64_t)meta[2] << 32) | meta[3];
      const uint64_t t = rel_t + base;
      pt_hi = (uint32_t)(t >> 32);
      pt_lo = (uint32_t)t;
    }
  }
  const uint32_t planes[kPlanes] = {
      rel,                          // rel_pos
      nbits,                        // num_bits
      (valid && ci == 0) ? 1u : 0u, // first
      pt_hi, pt_lo,                 // prev_time
      (w9 >> 7) & 0x1FFFu, r[7],    // prev_delta
      r[0], r[1],                   // prev_float_bits
      r[2], r[3],                   // prev_xor
      r[4], r[5],                   // int_val
      (w8 >> 8) & 7u,               // time_unit
      (w8 >> 2) & 0x3Fu,            // sig
      (w9 >> 1) & 0x1Fu,            // mult
      w9 & 1u,                      // is_float
  };
  for (int k = 0; k < kPlanes; ++k) o.planes[(int64_t)k * o.npad + j] = planes[k];
  if (!valid) {
    for (int k = 0; k < p.cw; ++k) store_window(o, p.cw, j, k, 0u);
    return 3;
  }
  if (stream != nullptr) {
    const int64_t staged = meta[4];
    for (int k = 0; k < p.cw; ++k) {
      const int64_t w = w0 + k;
      store_window(o, p.cw, j, k, w < staged ? stream[w] : word_at(p, si, w));
    }
  } else {
    direct_window(p, o, j, si, w0);
  }
  return ci == 0 ? 0 : (int)(w8 & 3u);
}

// Local lane l of the block (l < nb * c): its series, chunk and packed
// index; then the lane, and its fast bits into the tile accumulators.
M3_HD void block_lane(const Plan& p, const Out& o, const Geometry& g, const Block& k, int64_t l) {
  int64_t i, ci;
  if (g.order == 0) {
    ci = div_fast(l, k.nb);
    i = l - ci * k.nb;
  } else {
    i = div_fast(l, p.c);
    ci = l - i * p.c;
  }
  const int64_t si = k.s0 + i;
  const int64_t j = g.order == 0 ? ci * p.s + si : si * p.c + ci;
  const uint32_t* meta = k.meta + i * kMeta;
  const uint32_t* row = nullptr;
  if (ci < (int32_t)meta[0]) {
    row = g.slot > 0 ? k.side + i * g.side_stride + ci * kSideWords
                     : p.side + ((int64_t)p.side_rows[si * p.sl + ci / p.spc] * p.spc +
                                 ci % p.spc) * kSideWords;
  }
  const uint32_t* stream = meta[4] > 0 ? k.stream + i * g.slot_stride : nullptr;
  const int fast = emit_lane(p, o, j, si, ci, meta, row, stream);
  if (g.nslot > 0) {
    const int64_t t = div_fast(j, g.tile_lanes);
    const int64_t slot = g.order == 0
        ? 2 * ci + (t != div_fast(ci * p.s + k.s0, g.tile_lanes) ? 1 : 0)
        : t - div_fast(k.s0 * p.c, g.tile_lanes);
    and_slot(k.acc, slot, fast);
  }
}

// Tile of accumulator `slot`.
M3_HD int64_t slot_tile(const Plan& p, const Geometry& g, const Block& k, int64_t slot) {
  return g.order == 0 ? div_fast((slot / 2) * p.s + k.s0, g.tile_lanes) + (slot & 1)
                      : div_fast(k.s0 * p.c, g.tile_lanes) + slot;
}

// An accumulator into its tile's word (one atomicAnd), unless every lane
// it saw was fast both ways.
M3_HD void flush_slot(const Plan& p, const Geometry& g, const Block& k, int64_t slot,
                      int64_t tiles, uint32_t* tile_words) {
  const uint32_t bits = k.acc[slot];
  const int64_t t = slot_tile(p, g, k, slot);
  if ((bits & 3u) != 3u && t < tiles) and_into(tile_words + t, bits);
}

// Padding lane j >= n: all zeros.
M3_HD void zero_lane(const Plan& p, const Out& o, int64_t j) {
  for (int k = 0; k < kPlanes; ++k) o.planes[(int64_t)k * o.npad + j] = 0u;
  for (int k = 0; k < p.cw; ++k) store_window(o, p.cw, j, k, 0u);
}

M3_HD int32_t tile_flag(int fast) { return (fast & 1) ? 1 : ((fast & 2) ? 2 : 0); }

}  // namespace

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(kThreads)
    resident_assembly_kernel(Plan p, Out o, Geometry g, int64_t tiles,
                             uint32_t* __restrict__ tile_words) {
  extern __shared__ uint32_t sm[];
  if (blockIdx.x >= g.series_blocks) {
    const int64_t base = g.n + (blockIdx.x - g.series_blocks) * (int64_t)kPadLanes;
    for (int l = threadIdx.x; l < kPadLanes; l += kThreads)
      if (base + l < o.npad) zero_lane(p, o, base + l);
    return;
  }
  const Block k = block_at(p, g, blockIdx.x, sm);
  for (int i = threadIdx.x; i < k.nb; i += kThreads) series_meta(p, g, k.s0 + i, k.meta + i * kMeta);
  for (int i = threadIdx.x; i < g.nslot; i += kThreads) k.acc[i] = ~0u;
  __syncthreads();
  if (g.slot > 0) {
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    for (int i = warp; i < k.nb; i += kThreads / 32)
      stage_series(p, k.s0 + i, k.meta + i * kMeta, k.side + i * g.side_stride,
                   k.stream + i * g.slot_stride, lane, 32);
    m3::cp_async_commit();
    m3::cp_async_wait<0>();
  }
  __syncthreads();
  const int64_t lanes = (int64_t)k.nb * p.c;
  for (int64_t l = threadIdx.x; l < lanes; l += kThreads) block_lane(p, o, g, k, l);
  if (g.nslot == 0) return;
  __syncthreads();
  for (int i = threadIdx.x; i < g.nslot; i += kThreads) flush_slot(p, g, k, i, tiles, tile_words);
}

// The tiles' AND of fast bits -> 1 int-fast, 2 float-fast, 0 general.
__global__ void tile_flags_kernel(uint32_t* words, int64_t tiles) {
  const int64_t t = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (t < tiles) words[t] = (uint32_t)tile_flag((int)words[t]);
}

}  // namespace

// The most stream words a launch may give a staged series at c chunks and
// windows of cw words (0: nothing can be staged).
extern "C" int m3_resident_assembly_slot_words(int64_t c, int cw) { return slot_cap(c, cw); }

// The lanes of a padded plan. Every pointer a device pointer; the plan's
// vectors have s entries (s * lp page rows, s * sl side rows). order: 0
// chunk-major, 1 series-major. lane_major 0: windows [cw, npad] and one
// tile flag a tile (npad a multiple of tile_lanes); lane_major 1: windows
// [npad, cw], tile_flags may be null. planes [17, npad] in all cases.
// slot_words: the stream words a staged series may take, at most
// m3_resident_assembly_slot_words(c, cw); a series whose span exceeds it
// takes the direct route, and 0 sends every series there.
extern "C" int m3_resident_assembly(const void* words, const void* side, const void* page_rows,
                                    const void* side_rows, const void* n_chunks,
                                    const void* total_bits, const void* block_hi,
                                    const void* block_lo, int64_t s, int64_t c, int lp, int sl,
                                    int w, int spc, int cw, int order, int lane_major,
                                    int64_t npad, int64_t tile_lanes, int slot_words,
                                    void* windows, void* planes, void* tile_flags, void* stream) {
  if (s <= 0 || c <= 0 || lp <= 0 || sl <= 0 || w <= 0 || spc <= 0 || cw <= 0 ||
      tile_lanes <= 0 || (order != 0 && order != 1) || npad < s * c || slot_words < 0 ||
      slot_words > slot_cap(c, cw))
    return (int)cudaErrorInvalidValue;
  if (!lane_major && npad % tile_lanes != 0) return (int)cudaErrorInvalidValue;
  const Plan p{(const uint32_t*)words, (const uint32_t*)side, (const int32_t*)page_rows,
               (const int32_t*)side_rows, (const int32_t*)n_chunks,
               (const int32_t*)total_bits, (const uint32_t*)block_hi,
               (const uint32_t*)block_lo, s, c, lp, sl, w, spc, cw};
  const Out o{(uint32_t*)windows, (uint32_t*)planes, npad, lane_major};
  const Geometry g = geometry(p, order, lane_major, tile_lanes, slot_words, tile_flags != nullptr);
  const int64_t tiles = lane_major ? 0 : npad / tile_lanes;
  const int64_t blocks = g.series_blocks + (npad - g.n + kPadLanes - 1) / kPadLanes;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  uint32_t* tw = g.nslot > 0 ? (uint32_t*)tile_flags : nullptr;
  cudaError_t e;
  if (tw != nullptr && (e = cudaMemsetAsync(tw, 0xff, tiles * 4, st)) != cudaSuccess) return (int)e;
  const size_t smem = (size_t)smem_words(g) * 4;
  int64_t resident = 0;  // raises the kernel's shared memory limit to this launch's
  if ((e = m3::resident_blocks(resident_assembly_kernel, kThreads, smem, &resident)) !=
      cudaSuccess)
    return (int)e;
  resident_assembly_kernel<<<(unsigned)blocks, kThreads, smem, st>>>(p, o, g, tiles, tw);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  if (tw != nullptr) {
    tile_flags_kernel<<<(unsigned)((tiles + 255) / 256), 256, 0, st>>>(tw, tiles);
    e = cudaGetLastError();
  }
  return (int)e;
}

#else  // host C++ build of the same block code, for the CPU tests

extern "C" int m3_resident_assembly_slot_words(int64_t c, int cw) { return slot_cap(c, cw); }

extern "C" int m3_resident_assembly_host(const uint32_t* words, const uint32_t* side,
                                         const int32_t* page_rows, const int32_t* side_rows,
                                         const int32_t* n_chunks, const int32_t* total_bits,
                                         const uint32_t* block_hi, const uint32_t* block_lo,
                                         int64_t s, int64_t c, int lp, int sl, int w, int spc,
                                         int cw, int order, int lane_major, int64_t npad,
                                         int64_t tile_lanes, int slot_words, uint32_t* windows,
                                         uint32_t* planes, int32_t* tile_flags) {
  if (s <= 0 || c <= 0 || cw <= 0 || tile_lanes <= 0 || (order != 0 && order != 1) ||
      npad < s * c || slot_words < 0 || slot_words > slot_cap(c, cw))
    return 1;
  if (!lane_major && npad % tile_lanes != 0) return 1;
  const Plan p{words, side, page_rows, side_rows, n_chunks, total_bits, block_hi, block_lo,
               s, c, lp, sl, w, spc, cw};
  const Out o{windows, planes, npad, lane_major};
  const Geometry g = geometry(p, order, lane_major, tile_lanes, slot_words, tile_flags != nullptr);
  const int64_t tiles = lane_major ? 0 : npad / tile_lanes;
  uint32_t* tw = g.nslot > 0 ? (uint32_t*)tile_flags : nullptr;
  if (tw != nullptr) memset(tw, 0xff, tiles * 4);
  std::vector<uint32_t> sm(smem_words(g));
  for (int64_t b = 0; b < g.series_blocks; ++b) {
    const Block k = block_at(p, g, b, sm.data());
    for (int i = 0; i < k.nb; ++i) series_meta(p, g, k.s0 + i, k.meta + i * kMeta);
    for (int i = 0; i < g.nslot; ++i) k.acc[i] = ~0u;
    if (g.slot > 0)
      for (int i = 0; i < k.nb; ++i)
        stage_series(p, k.s0 + i, k.meta + i * kMeta, k.side + i * g.side_stride,
                     k.stream + i * g.slot_stride, 0, 1);
    for (int64_t l = 0; l < (int64_t)k.nb * p.c; ++l) block_lane(p, o, g, k, l);
    for (int i = 0; i < g.nslot; ++i) flush_slot(p, g, k, i, tiles, tw);
  }
  for (int64_t j = g.n; j < npad; ++j) zero_lane(p, o, j);
  if (tw != nullptr)
    for (int64_t t = 0; t < tiles; ++t) tw[t] = (uint32_t)tile_flag((int)tw[t]);
  return 0;
}

#endif
