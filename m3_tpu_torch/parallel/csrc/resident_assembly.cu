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
// Design. One thread a lane, one block a tile (256 threads walk its lanes),
// so a tile's flag is one __syncthreads_and; consecutive threads take
// consecutive lanes, so the plane stores and the word-major window stores
// are coalesced. Each thread reads its window's CW consecutive words, 16 of
// them in flight at a time, and its side row (40 bytes); the page walk and
// the lane coordinates use no 64-bit division. Bound: the
// pool words of each valid lane's window and its side row read once, the
// windows and planes written once.
//
// Without __CUDACC__ the same lane code compiles as host C++
// (m3_resident_assembly_host), so the CPU tests hold this source against the
// twin.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __host__ __device__ __forceinline__
#else
#define M3_HD inline
#endif

namespace {

constexpr int kThreads = 256;
constexpr int kSideWords = 10;
constexpr int kPlanes = 17;

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

// Window words a thread loads before it stores them: its loads in flight.
constexpr int kBatch = 16;

// Where the outputs go: planes [17, npad]; windows word-major [CW, npad]
// (lane_major == 0) or lane-major [npad, CW].
struct Out {
  uint32_t* windows;
  uint32_t* planes;
  int64_t npad;
  int lane_major;
};

// Lane j's coordinates in the packed order (0 chunk-major, 1 series-major);
// j >= n gives an invalid lane.
M3_HD void lane_coords(const Plan& p, int64_t j, int64_t n, int order, int64_t* si,
                       int64_t* ci) {
  if (j >= n) {
    *si = 0;
    *ci = p.c;
    return;
  }
  const int64_t d = order == 0 ? p.s : p.c;
  int64_t q, r;
  if (n <= 0xffffffffLL) {  // a 32-bit division: tens of instructions fewer
    q = (uint32_t)j / (uint32_t)d;
    r = (uint32_t)j % (uint32_t)d;
  } else {
    q = j / d;
    r = j % d;
  }
  *si = order == 0 ? r : q;
  *ci = order == 0 ? q : r;
}

// Assemble lane j = (si, ci) into `o`; returns the fast flags a tile reads
// (bit 0 int-fast, bit 1 float-fast), both set for an invalid lane.
M3_HD int assemble_lane(const Plan& p, const Out& o, int64_t j, int64_t si, int64_t ci) {
  const bool valid = ci < (int64_t)p.n_chunks[si];
  uint32_t r[kSideWords] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
  if (valid) {
    // 32-bit: a chunk index fits, and a 64-bit division costs tens of
    // instructions
    const uint32_t c32 = (uint32_t)ci, spc = (uint32_t)p.spc;
    const int64_t sp = p.side_rows[si * p.sl + c32 / spc];
    const uint32_t* row = p.side + (sp * p.spc + c32 % spc) * kSideWords;
    for (int k = 0; k < kSideWords; ++k) r[k] = row[k];
  }
  const uint32_t w8 = r[8], w9 = r[9];
  const uint32_t off = w8 >> 11;
  const uint32_t rel = off & 31u;
  const int64_t w0 = off >> 5;
  uint32_t nbits = 0;
  uint32_t pt_hi = 0, pt_lo = 0;
  if (valid) {
    int64_t b = (int64_t)p.total_bits[si] - w0 * 32;
    const int64_t cap = (int64_t)p.cw * 32;
    nbits = (uint32_t)(b < 0 ? 0 : (b > cap ? cap : b));
    if (((w9 >> 6) & 1u) == 0) {
      const uint64_t rel_t = ((uint64_t)(w9 >> 20) << 32) | r[6];
      const uint64_t base = ((uint64_t)p.block_hi[si] << 32) | p.block_lo[si];
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
  // the window: word w0 + k of the stream is word (w0 + k) % W of page
  // (w0 + k) / W of the series' page row, walked without a division a word,
  // kBatch words loaded before any is stored so that they are in flight
  // together (a store waits for its load, and the next load issues after it)
  const int32_t* pages = p.page_rows + si * p.lp;
  uint32_t pi = (uint32_t)w0 / (uint32_t)p.w, at = (uint32_t)w0 % (uint32_t)p.w;
  const uint32_t* page = p.words + (int64_t)pages[pi] * p.w;
  for (int k0 = 0; k0 < p.cw; k0 += kBatch) {
    uint32_t buf[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      buf[u] = 0;
      if (valid && k0 + u < p.cw) {
        buf[u] = page[at];
        if (++at == (uint32_t)p.w) {
          at = 0;
          page = p.words + (int64_t)pages[++pi] * p.w;
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int k = k0 + u;
      if (k < p.cw) {
        if (o.lane_major) o.windows[j * p.cw + k] = buf[u];
        else o.windows[(int64_t)k * o.npad + j] = buf[u];
      }
    }
  }
  if (!valid) return 3;
  const uint32_t flags = w8 & 3u;
  return ci == 0 ? 0 : (int)flags;
}

M3_HD int32_t tile_flag(int fast) { return (fast & 1) ? 1 : ((fast & 2) ? 2 : 0); }

}  // namespace

#ifdef __CUDACC__

namespace {

__global__ void __launch_bounds__(kThreads)
    resident_assembly_kernel(Plan p, Out o, int64_t n, int order, int64_t tile_lanes,
                             int32_t* __restrict__ tile_flags) {
  const int64_t base = (int64_t)blockIdx.x * tile_lanes;
  int fast = 3;
  for (int64_t i = threadIdx.x; i < tile_lanes; i += kThreads) {
    const int64_t j = base + i;
    if (j >= o.npad) break;
    int64_t si, ci;
    lane_coords(p, j, n, order, &si, &ci);
    fast &= assemble_lane(p, o, j, si, ci);
  }
  const int all_int = __syncthreads_and(fast & 1);
  const int all_flt = __syncthreads_and(fast & 2);
  if (tile_flags != nullptr && threadIdx.x == 0)
    tile_flags[blockIdx.x] = tile_flag((all_int ? 1 : 0) | (all_flt ? 2 : 0));
}

}  // namespace

// The lanes of a padded plan. Every pointer a device pointer; the plan's
// vectors have s entries (s * lp page rows, s * sl side rows). order: 0
// chunk-major, 1 series-major. lane_major 0: windows [cw, npad] and one
// tile flag a tile (npad a multiple of tile_lanes); lane_major 1: windows
// [npad, cw], tile_flags may be null. planes [17, npad] in all cases.
extern "C" int m3_resident_assembly(const void* words, const void* side, const void* page_rows,
                                    const void* side_rows, const void* n_chunks,
                                    const void* total_bits, const void* block_hi,
                                    const void* block_lo, int64_t s, int64_t c, int lp, int sl,
                                    int w, int spc, int cw, int order, int lane_major,
                                    int64_t npad, int64_t tile_lanes, void* windows,
                                    void* planes, void* tile_flags, void* stream) {
  if (s <= 0 || c <= 0 || lp <= 0 || sl <= 0 || w <= 0 || spc <= 0 || cw <= 0 ||
      tile_lanes <= 0 || (order != 0 && order != 1) || npad < 0)
    return (int)cudaErrorInvalidValue;
  if (!lane_major && npad % tile_lanes != 0) return (int)cudaErrorInvalidValue;
  if (npad == 0) return 0;
  const int64_t tiles = (npad + tile_lanes - 1) / tile_lanes;
  if (tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const Plan p{(const uint32_t*)words, (const uint32_t*)side, (const int32_t*)page_rows,
               (const int32_t*)side_rows, (const int32_t*)n_chunks,
               (const int32_t*)total_bits, (const uint32_t*)block_hi,
               (const uint32_t*)block_lo, s, c, lp, sl, w, spc, cw};
  const Out o{(uint32_t*)windows, (uint32_t*)planes, npad, lane_major};
  resident_assembly_kernel<<<(unsigned)tiles, kThreads, 0, (cudaStream_t)stream>>>(
      p, o, s * c, order, tile_lanes, (int32_t*)tile_flags);
  return (int)cudaGetLastError();
}

#else  // host C++ build of the same lane code, for the CPU tests

extern "C" int m3_resident_assembly_host(const uint32_t* words, const uint32_t* side,
                                         const int32_t* page_rows, const int32_t* side_rows,
                                         const int32_t* n_chunks, const int32_t* total_bits,
                                         const uint32_t* block_hi, const uint32_t* block_lo,
                                         int64_t s, int64_t c, int lp, int sl, int w, int spc,
                                         int cw, int order, int lane_major, int64_t npad,
                                         int64_t tile_lanes, uint32_t* windows,
                                         uint32_t* planes, int32_t* tile_flags) {
  if (s <= 0 || c <= 0 || cw <= 0 || tile_lanes <= 0 || (order != 0 && order != 1))
    return 1;
  if (!lane_major && npad % tile_lanes != 0) return 1;
  const Plan p{words, side, page_rows, side_rows, n_chunks, total_bits, block_hi, block_lo,
               s, c, lp, sl, w, spc, cw};
  const Out o{windows, planes, npad, lane_major};
  for (int64_t base = 0; base < npad; base += tile_lanes) {
    int fast = 3;
    for (int64_t j = base; j < base + tile_lanes && j < npad; ++j) {
      int64_t si, ci;
      lane_coords(p, j, s * c, order, &si, &ci);
      fast &= assemble_lane(p, o, j, si, ci);
    }
    if (tile_flags != nullptr) tile_flags[base / tile_lanes] = tile_flag(fast);
  }
  return 0;
}

#endif
