// Step-grid consolidation (kernel B-1): decoded records onto a query's step
// grid. It replaces the XLA program of m3_tpu/query/plan.py:360-425 (stage 5
// of _build_program: forward fill, a vectorized upper bound per (series,
// step), the lookback test and the value pick) and the host _finalize_grid
// (:431-447); the port's plain torch version (query/plan.py
// consolidate_grid_reference) is its twin.
//
// What it computes. Records ts int64 [S, P], bits int64 [S, P] (f64 bits of
// a float point, else the int value), point_is_float and valid bool [S, P],
// mult uint8 [S, P] (a DecodeResult, row-major); the fetch window [lo, hi);
// grid int64 [T]; lookback. A record counts when it is valid and
// lo <= ts < hi; a row's counted records are in time order. For each row:
// - counts[row]: its counted records (int32);
// - for each step t of the grid, the pick is the last counted record with
//   ts <= t (an upper bound: the last of equal timestamps wins); the step is
//   kept when a pick exists and t - ts_pick < lookback (int64 arithmetic
//   that wraps as torch's does);
// - values[row, t] (f64): a kept step's value is bits viewed as f64 for a
//   float point, else (double)bits / 10^mult with the exact constants of
//   ops/decode.py _POW10 (mult clamped to 0..6, no pow()); a step that is
//   not kept is NaN (0x7ff8000000000000, torch.nan's bits).
// This is engine.consolidate_row's rule, bit for bit.
//
// Bound: bytes. Each record's valid byte and timestamp are read once, the
// kept steps' bits, point_is_float and mult once each at most, values and
// counts written once: 19 bytes a record at most and 8 a step.
//
// Design: a warp a row, and the next row's records in flight. A persistent
// grid (m3::resident_blocks) of blocks of as many warps as the block's
// shared memory holds, up to kWarpsMax (12 at P = 720, T = 726: one block
// of 384 threads an SM), and no more than spread the rows over every SM
// when they are few; warp w of the launch takes rows w, w + warps, ... and
// never waits on another warp (one __syncthreads, before the row loop,
// after the block has copied a grid of up to kGridSteps steps into shared
// memory). A warp walks its rows' tiles of up to kTileMax records (a row of
// P <= kTileMax is one tile) through its own slots in shared memory: three
// for a tile's valid bytes and two for its timestamps, filled by 16-byte
// cp.async copies of the 16-byte chunks that hold the tile (the chunks at
// the ends may hold bytes of the neighbouring rows, never of another page;
// those bytes are never read). At the top of tile i the warp waits for its
// copies (tile i's timestamps, tile i+1's valid bytes), issues tile i+1's
// timestamps only if tile i+1 has a valid record (a row of the plan past
// its match count reads no timestamp) and tile i+2's valid bytes, then
// computes tile i while they are in flight. Only ts and valid are staged:
// bits, point_is_float and mult are gathered for the kept steps only, and
// staging all five planes twice (27 KB a warp at P = 720) would leave 6
// warps an SM where these leave 12.
// 1. Compaction: kRounds rounds of 32 records at a time, a ballot over
//    "valid and in the window" each, and __popc of it; the counted
//    timestamps move down in place in the timestamp slot (a round writes
//    only below the records it read), their indices in the tile to a slot
//    of int16. The ballots' counts are the row's count.
// 2. A merge walk: a pass of the grid is 32 runs of `run` consecutive steps,
//    lane l the l-th (run = ceil(T / 32), at most kRunMax: 23 at T = 726,
//    one pass). A lane finds its first step's pick with one upper-bound
//    search over the compacted timestamps, then moves the pointer over the
//    next kWindow timestamps (read at once, counted by selects: the query's
//    records, a 10 s lattice with +-2 s of jitter, pass 0 to 2 a step)
//    and searches only past a full window: of equal timestamps the last
//    still wins. Where the grid steps back the lane searches again from
//    scratch. It takes the lookback test there and writes each step's pick
//    (the record's index in the row, -1 for a step not kept) to the warp's
//    pick slot. A later tile's pick replaces an earlier one's; a tile with
//    no record at or before a step leaves it.
// 3. Values in step order: after __syncwarp lane l takes steps l, l + 32,
//    ..., kBatch at a time: it reads their picks, gathers their bits,
//    point_is_float and mult from device memory (near-consecutive records;
//    a step not kept reads record 0, so there is no branch), divides by
//    10^mult from a table in constant memory and stores the values
//    coalesced (256 bytes a warp store).
// A row of more than one tile is walked tile by tile for each pass of the
// grid, its tiles restaged each pass; its values are written after the
// pass's last tile. The kernel is bound by its instructions and their
// latency, not by its copies (per-phase clock64() counters: every copy
// lands before the warp needs it), so every index within a row is 32-bit,
// nothing is prefetched that the warp would have to issue, and neither the
// merge's forward move nor a gather branches.
//
// Without __CUDACC__ the same source compiles as host C++
// (m3_consolidate_grid_host): one row at a time, tile by tile, the same
// compaction order, then the `lanes` runs of each pass's steps in turn
// through the same merge walk (merge_run), then the values; the tile, the
// lane count and the run are parameters, so the CPU tests hold the
// partition, the merge and the tiles against the twin.

#include <cstdint>
#include <cstring>

#include "../../csrc/launch.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __host__ __device__ __forceinline__
#define M3_D __device__ __forceinline__
#else
#include <vector>
#define M3_HD inline
#define M3_D inline
#endif

namespace {

constexpr int kLanes = 32;            // a warp: the lanes that share a row
constexpr int kRunMax = 24;           // steps a lane takes a pass (a pass: 768 steps)
constexpr int kTileMax = 8192;        // records a tile stages
constexpr int kWarpsMax = 12;         // warps a block
constexpr int64_t kGridSteps = 2048;  // a grid of up to this many steps sits in shared memory
constexpr int kWindow = 4;            // timestamps a forward move reads at once
constexpr int kBatch = 12;            // steps a lane gathers at once for the values
constexpr int kRounds = 4;            // compaction rounds of 32 records loaded at once
constexpr int64_t kNaNBits = 0x7ff8000000000000ll;

struct Args {
  const int64_t* ts;
  const int64_t* bits;
  const uint8_t* pif;
  const uint8_t* mult;
  const uint8_t* valid;
  int64_t s, p;
  int64_t lo, hi;
  const int64_t* grid;
  int64_t t;
  int64_t lookback;
  double* values;
  int32_t* counts;
};

// How the work of a row is cut: tiles of `tile` records; passes of
// `lanes` runs of `run` consecutive steps. Every index within a row is an
// int (p, t < 2^31).
struct Geom {
  int tile, ntiles, run, lanes, pass_steps, passes;
};

// tile 0: one tile up to kTileMax records; run 0: ceil(t / lanes), at most
// kRunMax.
M3_HD Geom geometry(int64_t p, int64_t t, int tile, int run, int lanes) {
  Geom g;
  g.tile = tile > 0 ? tile : (int)(p < kTileMax ? p : kTileMax);
  g.ntiles = (int)((p + g.tile - 1) / g.tile);
  if (run <= 0) {
    const int64_t r = (t + lanes - 1) / lanes;
    run = (int)(r < 1 ? 1 : (r > kRunMax ? kRunMax : r));
  }
  g.run = run;
  g.lanes = lanes;
  g.pass_steps = lanes * run;
  g.passes = t > 0 ? (int)((t + g.pass_steps - 1) / g.pass_steps) : 1;
  return g;
}

// The number of the first n compacted timestamps that are <= g.
M3_HD int upper(const int64_t* cts, int n, int64_t g) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cts[mid] <= g) lo = mid + 1;
    else hi = mid;
  }
  return lo;
}

// One lane's run of steps [a, b) of a pass (grid and pick start at the
// pass's first step), over a tile's n compacted records (timestamps cts,
// indices src in the tile, the tile starting at record p0 of the row):
// each step's pick, its record's index in the row when the step is kept,
// else -1. A step with no record of this tile at or before it keeps what
// an earlier tile gave it (`first`: this is the row's first tile, which
// sets every step). The first step searches; each later one at or after
// the step before it moves the pointer u (the count of timestamps <= the
// step) over the next kWindow timestamps, read at once, by selects, and
// searches the rest only when all of them are <= the step; a step back
// searches again. `last` carries cts[u - 1], the pick's timestamp.
M3_HD void merge_run(const int64_t* __restrict__ cts, const int16_t* __restrict__ src, int n,
                     int p0, const int64_t* __restrict__ grid, int a, int b, int64_t lookback,
                     bool first, int32_t* __restrict__ pick) {
  if (a >= b) return;
  int64_t g = grid[a];
  int u = upper(cts, n, g);
  int64_t last = u > 0 ? cts[u - 1] : 0;
  for (int st = a;;) {
    const int64_t next = st + 1 < b ? grid[st + 1] : 0;
    const int64_t age = (int64_t)((uint64_t)g - (uint64_t)last);
    const int rec = p0 + src[u > 0 ? u - 1 : 0];
    if (u > 0 || first) pick[st] = u > 0 && age < lookback ? rec : -1;
    if (++st >= b) break;
    if (next < g) {
      u = upper(cts, n, next);
      last = u > 0 ? cts[u - 1] : 0;
    } else {
      int64_t w[kWindow];
      int c = 0;
#pragma unroll
      for (int k = 0; k < kWindow; ++k) {
        w[k] = u + k < n ? cts[u + k] : 0;
        c += u + k < n && w[k] <= next;  // a prefix: the timestamps are in order
      }
#pragma unroll
      for (int k = 0; k < kWindow; ++k) last = c == k + 1 ? w[k] : last;
      u += c;
      if (c == kWindow) {
        u += upper(cts + u, n - u, next);
        last = cts[u - 1];
      }
    }
    g = next;
  }
}

// 10^m for m in 0..6, the constants of ops/decode.py _POW10 (m clamped).
#ifdef __CUDACC__
__constant__ double kPow10[7] = {1.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6};
#else
const double kPow10[7] = {1.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6};
#endif

M3_D double pow10(unsigned m) { return kPow10[m < 6 ? m : 6]; }

M3_HD double as_f64(int64_t b) {
  double d;
  memcpy(&d, &b, sizeof d);
  return d;
}

// The value of a kept step whose record holds bits b, point_is_float f and
// mult m.
M3_D double kept_value(int64_t b, uint8_t f, uint8_t m) {
  return f ? as_f64(b) : (double)b / pow10(m);
}

}  // namespace

#ifdef __CUDACC__

namespace {

__host__ __device__ __forceinline__ int round16(int x) { return (x + 15) & ~15; }

// A warp's shared memory, in bytes from its base: two timestamp slots,
// three valid slots (each a tile and the 16-byte chunks at its ends), the
// compacted records' indices (int16) and the pass's picks (int32).
struct Layout {
  int ts_slot, v_slot, v_off, src_off, pick_off, bytes;
};

Layout layout(const Geom& g) {
  Layout L;
  L.ts_slot = round16(g.tile * 8 + 32);
  L.v_slot = round16(g.tile + 32);
  L.v_off = 2 * L.ts_slot;
  L.src_off = L.v_off + 3 * L.v_slot;
  L.pick_off = L.src_off + round16(g.tile * 2);
  L.bytes = L.pick_off + round16(g.pass_steps * 4);
  return L;
}

// Where the byte at p lands in a slot that holds its 16-byte chunks.
__device__ __forceinline__ int shift16(const void* p) { return (int)((uintptr_t)p & 15); }

// Starts the warp's copies of the 16-byte chunks that hold bytes
// [src, src + n) into dst (16-byte aligned).
__device__ __forceinline__ void stage(unsigned char* dst, const void* src, int n, int lane) {
  const unsigned char* a = (const unsigned char*)((uintptr_t)src & ~(uintptr_t)15);
  const int chunks = (shift16(src) + n + 15) >> 4;
  for (int c = lane; c < chunks; c += kLanes) m3::cp_async16(dst + 16 * c, a + 16 * c);
}

// Whether any of the n bytes at slot + b is set (slot 16-byte aligned and
// staged through the chunk that holds the last of them); every lane gets
// the answer.
__device__ __forceinline__ bool any_set(const unsigned char* slot, int b, int n, int lane) {
  const uint32_t* w = reinterpret_cast<const uint32_t*>(slot);
  const int e = b + n, w0 = b >> 2, w1 = (e + 3) >> 2;
  uint32_t acc = 0;
  for (int i = w0 + lane; i < w1; i += kLanes) {
    uint32_t x = w[i];
    if (i == w0) x &= 0xffffffffu << (8 * (b & 3));
    if (i == w1 - 1 && (e & 3)) x &= 0xffffffffu >> (8 * (4 - (e & 3)));
    acc |= x;
  }
  return __any_sync(0xffffffffu, acc != 0);
}

// Compacts the counted records of a staged tile of len records (valid
// bytes v, timestamps ts) in place: their timestamps to ts[0, n), their
// indices in the tile to src[0, n), in order. Returns n (every lane).
// kRounds rounds of 32 records at a time, all their loads first: a round's
// stores go below the records it read.
__device__ __forceinline__ int compact(const unsigned char* __restrict__ v, int64_t* ts,
                                       int16_t* __restrict__ src, int len, int64_t lo,
                                       int64_t hi, int lane) {
  const unsigned below = (1u << lane) - 1u;
  int n = 0;
  for (int j0 = 0; j0 < len; j0 += kLanes * kRounds) {
    int64_t x[kRounds];
    bool f[kRounds];
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const int j = j0 + q * kLanes + lane;
      const bool has = j < len && v[j];
      x[q] = has ? ts[j] : 0;
      f[q] = has && x[q] >= lo && x[q] < hi;
    }
#pragma unroll
    for (int q = 0; q < kRounds; ++q) {
      const unsigned m = __ballot_sync(0xffffffffu, f[q]);
      if (f[q]) {
        const int pos = n + __popc(m & below);
        ts[pos] = x[q];
        src[pos] = (int16_t)(j0 + q * kLanes + lane);
      }
      n += __popc(m);
    }
  }
  return n;
}


// The steps of one pass of a row from their picks: lane l takes steps l,
// l + 32, ..., kBatch at a time, their records' planes (the row's, from
// bits, pif and mult) gathered before any value is stored to out; a step
// not kept gathers record 0 and stores NaN.
__device__ __forceinline__ void write_values(const int64_t* __restrict__ bits,
                                             const uint8_t* __restrict__ pif,
                                             const uint8_t* __restrict__ mult,
                                             double* __restrict__ out,
                                             const int32_t* __restrict__ pick, int steps,
                                             int lane) {
  for (int k0 = lane; k0 < steps; k0 += kLanes * kBatch) {
    int pk[kBatch];
    int64_t b[kBatch];
    uint8_t f[kBatch], m[kBatch];
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k = k0 + j * kLanes;
      pk[j] = k < steps ? pick[k] : -1;
      const int r = pk[j] < 0 ? 0 : pk[j];  // a step not kept reads record 0: no branch
      b[j] = __ldg(bits + r);
      f[j] = __ldg(pif + r);
      m[j] = __ldg(mult + r);
    }
#pragma unroll
    for (int j = 0; j < kBatch; ++j) {
      const int k = k0 + j * kLanes;
      if (k < steps) out[k] = pk[j] >= 0 ? kept_value(b[j], f[j], m[j]) : as_f64(kNaNBits);
    }
  }
}

// A warp's unit of work: one tile of one row, for one pass of the grid
// (for every pass when the row is one tile). next() moves to the warp's
// next unit without a division.
struct Cursor {
  int64_t row;
  int pass, k;
  __device__ __forceinline__ void next(const Geom& gm, int64_t warps) {
    if (++k < gm.ntiles) return;
    k = 0;
    if (gm.ntiles > 1 && ++pass < gm.passes) return;
    pass = 0;
    row += warps;
  }
};

template <bool kGridInSmem>
__global__ void __launch_bounds__(kWarpsMax * kLanes)
consolidate_grid_kernel(Args a, Geom gm, Layout L) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & (kLanes - 1);
  const int warps = blockDim.x / kLanes;
  const int warp = threadIdx.x / kLanes;
  const int t = (int)a.t;
  const int64_t* grid = a.grid;
  unsigned char* base = smem;
  if (kGridInSmem) {
    int64_t* g = reinterpret_cast<int64_t*>(smem);
    for (int i = threadIdx.x; i < t; i += blockDim.x) g[i] = a.grid[i];
    __syncthreads();  // the block's only barrier, before any warp's rows
    grid = g;
    base += round16(t * 8);
  }
  base += warp * L.bytes;
  int16_t* src = reinterpret_cast<int16_t*>(base + L.src_off);
  int32_t* pick = reinterpret_cast<int32_t*>(base + L.pick_off);
  auto tslot = [&](int i) { return base + i * L.ts_slot; };
  auto vslot = [&](int i) { return base + L.v_off + i * L.v_slot; };

  const int64_t nw = (int64_t)gridDim.x * warps;
  Cursor cur{(int64_t)blockIdx.x * warps + warp, 0, 0};
  if (cur.row >= a.s) return;
  Cursor nx1 = cur, nx2;
  nx1.next(gm, nw);
  nx2 = nx1;
  nx2.next(gm, nw);
  auto len_of = [&](const Cursor& c) {
    const int64_t left = a.p - (int64_t)c.k * gm.tile;
    return left < gm.tile ? (int)left : gm.tile;
  };
  auto valid_at = [&](const Cursor& c) { return a.valid + c.row * a.p + c.k * gm.tile; };
  auto ts_at = [&](const Cursor& c) { return a.ts + c.row * a.p + c.k * gm.tile; };
  // c's timestamps into ts slot ti if c has a valid record (its valid
  // bytes, in valid slot vi, have landed)
  auto stage_ts = [&](const Cursor& c, int vi, int ti) {
    const int len = len_of(c);
    if (any_set(vslot(vi), shift16(valid_at(c)), len, lane))
      stage(tslot(ti), ts_at(c), len * 8, lane);
  };

  stage(vslot(0), valid_at(cur), len_of(cur), lane);
  m3::cp_async_commit();
  m3::cp_async_wait<0>();
  __syncwarp();
  stage_ts(cur, 0, 0);
  if (nx1.row < a.s) stage(vslot(1), valid_at(nx1), len_of(nx1), lane);
  m3::cp_async_commit();

  int64_t total = 0;
  for (int vi = 0, ti = 0;; vi = vi == 2 ? 0 : vi + 1, ti ^= 1) {
    m3::cp_async_wait<0>();
    __syncwarp();  // cur's timestamps and nx1's valid bytes have landed for every lane
    const int v1 = vi == 2 ? 0 : vi + 1;
    if (nx1.row < a.s) stage_ts(nx1, v1, ti ^ 1);
    if (nx2.row < a.s) stage(vslot(v1 == 2 ? 0 : v1 + 1), valid_at(nx2), len_of(nx2), lane);
    m3::cp_async_commit();

    const int len = len_of(cur), p0 = cur.k * gm.tile;
    int64_t* cts = reinterpret_cast<int64_t*>(tslot(ti) + shift16(ts_at(cur)));
    const int n = compact(vslot(vi) + shift16(valid_at(cur)), cts, src, len, a.lo, a.hi, lane);
    if (cur.pass == 0) total += n;
    __syncwarp();  // compacted by every lane
    const bool last_tile = cur.k == gm.ntiles - 1;
    const int pass_end = gm.ntiles == 1 ? gm.passes : cur.pass + 1;
    const int64_t rb = cur.row * a.p;
    for (int pass = cur.pass; pass < pass_end; ++pass) {
      const int s0 = pass * gm.pass_steps;
      const int steps = t - s0 < gm.pass_steps ? t - s0 : gm.pass_steps;
      const int r0 = lane * gm.run;
      merge_run(cts, src, n, p0, grid + s0, r0, r0 + gm.run < steps ? r0 + gm.run : steps,
                a.lookback, cur.k == 0, pick);
      if (last_tile) {
        __syncwarp();  // every lane's picks
        write_values(a.bits + rb, a.pif + rb, a.mult + rb, a.values + cur.row * a.t + s0, pick,
                     steps, lane);
      }
      __syncwarp();  // the picks are read before the next pass or tile rewrites them
    }
    if (last_tile && (gm.ntiles == 1 || cur.pass == gm.passes - 1)) {
      if (lane == 0) a.counts[cur.row] = (int32_t)total;
      total = 0;
    }
    if (nx1.row >= a.s) break;
    cur = nx1;
    nx1 = nx2;
    nx2.next(gm, nw);
  }
}

using Kernel = void (*)(Args, Geom, Layout);

// How a launch of this shape runs: its geometry, its warps a block and
// shared memory a block, and whether the grid sits in shared memory.
struct Launch {
  Geom gm;
  Layout L;
  int warps;
  size_t smem;
  bool grid_smem;
  Kernel kernel;
};

cudaError_t plan_launch(int64_t s, int64_t p, int64_t t, int tile, int run, Launch* out) {
  if (s <= 0 || p <= 0 || p > 0x7fffffff || t < 0 || t > 0x7fffffff || tile < 0 ||
      tile > kTileMax || run < 0 || run > kRunMax)
    return cudaErrorInvalidValue;
  out->gm = geometry(p, t, tile, run, kLanes);
  out->L = layout(out->gm);
  out->grid_smem = t <= kGridSteps;
  out->kernel = out->grid_smem ? consolidate_grid_kernel<true> : consolidate_grid_kernel<false>;
  const int64_t fixed = out->grid_smem ? round16((int)t * 8) : 0;
  const int64_t w = ((int64_t)m3::kSmemMax - fixed) / out->L.bytes;
  if (w < 1) return cudaErrorInvalidValue;
  // few rows: no more warps a block than spreads the rows over every SM
  int dev = 0, sms = 1;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  const int64_t spread = (s + sms - 1) / sms;
  const int64_t cap = spread < kWarpsMax ? spread : kWarpsMax;
  out->warps = (int)(w < cap ? w : cap);
  out->smem = (size_t)(fixed + out->warps * out->L.bytes);
  return cudaSuccess;
}

}  // namespace

// Records tile records a warp stages at most (the CPU tests size their
// rows past it).
extern "C" int m3_consolidate_grid_tile_records() { return (int)kTileMax; }

// How a launch of [s, p] records onto t steps runs (tile and run as
// m3_consolidate_grid takes them): out[0] warps a block, out[1] the blocks
// the card holds at once (SMs x blocks per SM), out[2] shared memory a
// block (bytes), out[3] registers a thread, out[4] 1 where the grid sits in
// shared memory, out[5] records a tile, out[6] steps a lane takes a pass,
// out[7] blocks a launch of s rows starts. Returns a CUDA error code.
extern "C" int m3_consolidate_grid_shape(int64_t s, int64_t p, int64_t t, int tile, int run,
                                         int64_t* out) {
  Launch l;
  cudaError_t e = plan_launch(s, p, t, tile, run, &l);
  if (e != cudaSuccess) return (int)e;
  cudaFuncAttributes attr;
  if ((e = cudaFuncGetAttributes(&attr, l.kernel)) != cudaSuccess) return (int)e;
  int64_t resident = 0;
  if ((e = m3::resident_blocks(l.kernel, l.warps * kLanes, l.smem, &resident)) != cudaSuccess)
    return (int)e;
  const int64_t need = (s + l.warps - 1) / l.warps;
  out[0] = l.warps;
  out[1] = resident;
  out[2] = (int64_t)l.smem;
  out[3] = attr.numRegs;
  out[4] = l.grid_smem ? 1 : 0;
  out[5] = l.gm.tile;
  out[6] = l.gm.run;
  out[7] = need < resident ? need : resident;
  return 0;
}

// values [s, t] f64 and counts [s] int32 of records [s, p] (every pointer a
// device pointer, every array contiguous); s > 0, 0 < p < 2^31, t < 2^31. tile: the
// records a tile stages (0: the row, up to kTileMax); run: the steps a lane
// takes a pass (0: ceil(t / 32), up to kRunMax).
extern "C" int m3_consolidate_grid(const void* ts, const void* bits, const void* pif,
                                   const void* mult, const void* valid, int64_t s, int64_t p,
                                   int64_t lo, int64_t hi, const void* grid, int64_t t,
                                   int64_t lookback, void* values, void* counts, int tile,
                                   int run, void* stream) {
  Launch l;
  cudaError_t e = plan_launch(s, p, t, tile, run, &l);
  if (e != cudaSuccess) return (int)e;
  const Args a{(const int64_t*)ts, (const int64_t*)bits, (const uint8_t*)pif,
               (const uint8_t*)mult, (const uint8_t*)valid, s, p, lo, hi,
               (const int64_t*)grid, t, lookback, (double*)values, (int32_t*)counts};
  int64_t resident = 0;  // raises the kernel's shared memory limit to this launch's
  if ((e = m3::resident_blocks(l.kernel, l.warps * kLanes, l.smem, &resident)) != cudaSuccess)
    return (int)e;
  const int64_t need = (s + l.warps - 1) / l.warps;
  const int64_t blocks = need < resident ? need : resident;
  l.kernel<<<(unsigned)blocks, l.warps * kLanes, l.smem, (cudaStream_t)stream>>>(a, l.gm, l.L);
  return (int)cudaGetLastError();
}

#else

extern "C" int m3_consolidate_grid_tile_records() { return (int)kTileMax; }

// The kernel's walk, one row at a time: tiles of `tile` records (0: the
// kernel's), each compacted in order, then each pass's `lanes` runs of `run`
// steps (0: the kernel's run for `lanes` lanes) merged in turn, then the
// pass's values. Returns 1 for arguments the kernel does not take.
extern "C" int m3_consolidate_grid_host(const int64_t* ts, const int64_t* bits,
                                        const uint8_t* pif, const uint8_t* mult,
                                        const uint8_t* valid, int64_t s, int64_t p, int64_t lo,
                                        int64_t hi, const int64_t* grid, int64_t t,
                                        int64_t lookback, double* values, int32_t* counts,
                                        int tile, int lanes, int run) {
  if (s <= 0 || p <= 0 || p > 0x7fffffff || t < 0 || t > 0x7fffffff || tile < 0 ||
      tile > kTileMax || lanes <= 0 || lanes > 1024 || run < 0 || run > kRunMax)
    return 1;
  const Geom gm = geometry(p, t, tile, run, lanes);
  std::vector<int64_t> cts(gm.tile);
  std::vector<int16_t> src(gm.tile);
  std::vector<int32_t> pick(gm.pass_steps);
  for (int64_t row = 0; row < s; ++row) {
    int64_t total = 0;
    int n = 0;
    for (int pass = 0; pass < gm.passes; ++pass) {
      const int s0 = pass * gm.pass_steps;
      const int steps = t - s0 < gm.pass_steps ? (int)(t - s0) : gm.pass_steps;
      for (int k = 0; k < gm.ntiles; ++k) {
        const int p0 = k * gm.tile;
        const int p1 = p - p0 < gm.tile ? (int)p : p0 + gm.tile;
        if (pass == 0 || gm.ntiles > 1) {  // a row of one tile is compacted once
          n = 0;
          for (int j = p0; j < p1; ++j) {
            const int64_t r = row * p + j;
            if (valid[r] && ts[r] >= lo && ts[r] < hi) {
              cts[n] = ts[r];
              src[n++] = (int16_t)(j - p0);
            }
          }
          if (pass == 0) total += n;
        }
        for (int lane = 0; lane < lanes; ++lane) {
          const int r0 = lane * gm.run;
          merge_run(cts.data(), src.data(), n, p0, grid + s0, r0,
                    r0 + gm.run < steps ? r0 + gm.run : steps, lookback, k == 0, pick.data());
        }
      }
      for (int st = 0; st < steps; ++st) {
        const int32_t pk = pick[st];
        const int64_t r = row * p + pk;
        values[row * t + s0 + st] =
            pk >= 0 ? kept_value(bits[r], pif[r], mult[r]) : as_f64(kNaNBits);
      }
    }
    counts[row] = (int32_t)total;
  }
  return 0;
}

#endif
