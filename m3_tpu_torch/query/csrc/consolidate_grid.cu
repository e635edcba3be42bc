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
// Design: a block of 256 threads a row. The row's records are walked in
// tiles of up to kTileMax records: each round of 256 consecutive records is
// compacted (a warp ballot, then the block's eight warp counts) into shared
// memory as the tile's counted timestamps and their record indices, in
// order. Each thread holds kSteps steps of the grid in registers (1,024
// steps a pass) and binary-searches each tile's compacted timestamps for
// them; a later tile's pick replaces an earlier one's, as its records are
// later. A row whose records fit one tile is compacted once for all its
// passes. The kept steps then read their record's bits, point_is_float and
// mult, and the block writes its row of values (consecutive threads,
// consecutive steps). Bound: the bytes, each record's valid and ts read
// once (the picks' bits, point_is_float and mult once each at most), the
// grid once a block (from L2), values and counts written once. A simple
// design: a row's 256 threads search one row, and the search is not a merge.
//
// Without __CUDACC__ the same tile walk, compaction order and search compile
// as host C++ (m3_consolidate_grid_host, one row at a time with one thread,
// the tile size a parameter), so the CPU tests hold this source and its tiles
// against the twin.

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

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;          // grid steps a thread holds in a pass
constexpr int kTileMax = 8192;     // records a tile stages (96 KiB)

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

M3_HD bool counted(const Args& a, int64_t i) {
  if (!a.valid[i]) return false;
  const int64_t x = a.ts[i];
  return x >= a.lo && x < a.hi;
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

// 10^m for m in 0..6, the constants of ops/decode.py _POW10 (m clamped).
M3_HD double pow10(unsigned m) {
  switch (m) {
    case 0: return 1.0;
    case 1: return 10.0;
    case 2: return 100.0;
    case 3: return 1e3;
    case 4: return 1e4;
    case 5: return 1e5;
    default: return 1e6;
  }
}

M3_HD double as_f64(int64_t b) {
  double d;
  memcpy(&d, &b, sizeof d);
  return d;
}

// The value of step g of a row, given its pick (record index i, timestamp
// pts; i < 0 when no counted record is at or before g).
M3_HD double step_value(const Args& a, int64_t row, int i, int64_t pts, int64_t g) {
  const int64_t age = (int64_t)((uint64_t)g - (uint64_t)pts);
  if (i < 0 || !(age < a.lookback)) return as_f64(0x7ff8000000000000ll);
  const int64_t r = row * a.p + i;
  const int64_t b = a.bits[r];
  return a.pif[r] ? as_f64(b) : (double)b / pow10(a.mult[r]);
}

M3_HD int tile_records(int64_t p) {
  const int64_t rounded = (p + kThreads - 1) / kThreads * kThreads;
  return (int)(rounded < kTileMax ? (rounded > 0 ? rounded : kThreads) : kTileMax);
}

}  // namespace

#ifdef __CUDACC__

namespace {

// Compacts the counted records of [p0, p1) of the row into cts / csrc, in
// order; returns how many.
__device__ __forceinline__ int stage_tile(const Args& a, int64_t row, int64_t p0, int64_t p1,
                                          int64_t* cts, int32_t* csrc, int* wsum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int base = 0;
  for (int64_t r0 = p0; r0 < p1; r0 += kThreads) {
    const int64_t j = r0 + threadIdx.x;
    const bool f = j < p1 && counted(a, row * a.p + j);
    const unsigned m = __ballot_sync(0xffffffffu, f);
    if (lane == 0) wsum[warp] = __popc(m);
    __syncthreads();
    int off = 0, tot = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = wsum[w];
      off += w < warp ? c : 0;
      tot += c;
    }
    if (f) {
      const int pos = base + off + __popc(m & ((1u << lane) - 1u));
      cts[pos] = a.ts[row * a.p + j];
      csrc[pos] = (int32_t)(j - p0);
    }
    base += tot;
    __syncthreads();  // wsum is rewritten by the next round
  }
  return base;
}

__global__ void __launch_bounds__(kThreads) consolidate_grid_kernel(Args a, int tile) {
  extern __shared__ __align__(16) unsigned char smem[];
  int64_t* cts = reinterpret_cast<int64_t*>(smem);
  int32_t* csrc = reinterpret_cast<int32_t*>(cts + tile);
  int* wsum = reinterpret_cast<int*>(csrc + tile);
  __shared__ int n_staged;
  const bool one_tile = a.p <= tile;
  const int64_t per_pass = (int64_t)kThreads * kSteps;
  const int64_t passes = a.t > 0 ? (a.t + per_pass - 1) / per_pass : 1;
  for (int64_t row = blockIdx.x; row < a.s; row += gridDim.x) {
    int64_t total = 0;
    for (int64_t pass = 0; pass < passes; ++pass) {
      int64_t g[kSteps], pts[kSteps];
      int pick[kSteps];
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        const int64_t st = pass * per_pass + k * kThreads + threadIdx.x;
        g[k] = st < a.t ? a.grid[st] : 0;
        pick[k] = -1;
        pts[k] = 0;
      }
      for (int64_t p0 = 0; p0 < a.p; p0 += tile) {
        const int64_t p1 = p0 + tile < a.p ? p0 + tile : a.p;
        if (pass == 0 || !one_tile) {
          const int n = stage_tile(a, row, p0, p1, cts, csrc, wsum);
          if (pass == 0) total += n;
          if (threadIdx.x == 0) n_staged = n;
          __syncthreads();
        }
        const int n = n_staged;
#pragma unroll
        for (int k = 0; k < kSteps; ++k) {
          const int64_t st = pass * per_pass + k * kThreads + threadIdx.x;
          if (st >= a.t || n == 0) continue;
          const int u = upper(cts, n, g[k]);
          if (u > 0) {
            pick[k] = (int)(p0 + csrc[u - 1]);
            pts[k] = cts[u - 1];
          }
        }
        if (!one_tile) __syncthreads();  // the next tile is staged over this one
      }
#pragma unroll
      for (int k = 0; k < kSteps; ++k) {
        const int64_t st = pass * per_pass + k * kThreads + threadIdx.x;
        if (st < a.t) a.values[row * a.t + st] = step_value(a, row, pick[k], pts[k], g[k]);
      }
    }
    if (threadIdx.x == 0) a.counts[row] = (int32_t)total;
    __syncthreads();  // the next row restages the tile
  }
}

}  // namespace

// Records tile records a block stages at most (the CPU tests size their
// rows past it).
extern "C" int m3_consolidate_grid_tile_records() { return kTileMax; }

// values [s, t] f64 and counts [s] int32 of records [s, p] (every pointer a
// device pointer, every array contiguous); s > 0, 0 < p < 2^31.
extern "C" int m3_consolidate_grid(const void* ts, const void* bits, const void* pif,
                                   const void* mult, const void* valid, int64_t s, int64_t p,
                                   int64_t lo, int64_t hi, const void* grid, int64_t t,
                                   int64_t lookback, void* values, void* counts, void* stream) {
  if (s <= 0 || p <= 0 || p > 0x7fffffff || t < 0) return (int)cudaErrorInvalidValue;
  const Args a{(const int64_t*)ts, (const int64_t*)bits, (const uint8_t*)pif,
               (const uint8_t*)mult, (const uint8_t*)valid, s, p, lo, hi,
               (const int64_t*)grid, t, lookback, (double*)values, (int32_t*)counts};
  const int tile = tile_records(p);
  const size_t smem = (size_t)tile * 12 + kWarps * 4;
  int64_t resident = 0;  // raises the kernel's shared memory limit to this launch's
  cudaError_t e = m3::resident_blocks(consolidate_grid_kernel, kThreads, smem, &resident);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = s < 0x7fffffff ? s : 0x7fffffff;
  consolidate_grid_kernel<<<(unsigned)blocks, kThreads, smem, (cudaStream_t)stream>>>(a, tile);
  return (int)cudaGetLastError();
}

#else

extern "C" int m3_consolidate_grid_tile_records() { return kTileMax; }

// The kernel's walk, one row at a time: tiles of `tile` records (0: the
// kernel's choice for p), each compacted in order, then every step searched.
extern "C" int m3_consolidate_grid_host(const int64_t* ts, const int64_t* bits,
                                        const uint8_t* pif, const uint8_t* mult,
                                        const uint8_t* valid, int64_t s, int64_t p, int64_t lo,
                                        int64_t hi, const int64_t* grid, int64_t t,
                                        int64_t lookback, double* values, int32_t* counts,
                                        int tile) {
  if (s <= 0 || p <= 0 || p > 0x7fffffff || t < 0 || tile < 0) return 1;
  if (tile == 0) tile = tile_records(p);
  const Args a{ts, bits, pif, mult, valid, s, p, lo, hi, grid, t, lookback, values, counts};
  std::vector<int64_t> cts(tile);
  std::vector<int32_t> csrc(tile);
  std::vector<int> pick(t > 0 ? t : 1);
  std::vector<int64_t> pts(t > 0 ? t : 1);
  for (int64_t row = 0; row < s; ++row) {
    int64_t total = 0;
    for (int64_t st = 0; st < t; ++st) pick[st] = -1, pts[st] = 0;
    for (int64_t p0 = 0; p0 < p; p0 += tile) {
      const int64_t p1 = p0 + tile < p ? p0 + tile : p;
      int n = 0;
      for (int64_t j = p0; j < p1; ++j)
        if (counted(a, row * p + j)) {
          cts[n] = ts[row * p + j];
          csrc[n++] = (int32_t)(j - p0);
        }
      total += n;
      for (int64_t st = 0; st < t && n > 0; ++st) {
        const int u = upper(cts.data(), n, grid[st]);
        if (u > 0) {
          pick[st] = (int)(p0 + csrc[u - 1]);
          pts[st] = cts[u - 1];
        }
      }
    }
    for (int64_t st = 0; st < t; ++st)
      values[row * t + st] = step_value(a, row, pick[st], pts[st], grid[st]);
    counts[row] = (int32_t)total;
  }
  return 0;
}

#endif
