// Dense rollup reductions of the aggregator tier: kernel B-5a (the eight
// rollup fields of each group) and kernel B-5b (exact interpolated
// quantiles of each group). They replace the XLA programs of
// m3_tpu/aggregator/kernels.py:183 (aggregate_dense) and :224
// (dense_quantiles); neither is a Pallas kernel.
//
// Inputs. A flush densifies one storage policy's buffered datapoints into
// groups of one (metric, window) each (aggregator/kernels.py
// pack_dense_groups): vals f32 [G, P], torder i32 [G, P] (the within-window
// time order) and valid u8 [G, P], row-major, P the largest group's count.
//
// B-5a writes f32 [8, G]: sum, count, min, max, sum_sq, mean, stdev, last
// (the order of kernels.FIELDS), so that the flush reads all eight back in
// one copy. B-5b writes f32 [Q, G], one row per requested quantile.
//
// What the reference computes, on the CPU under XLA (probed on the JAX
// package; the port's twins, kernels.py, repeat it step for step):
// - f32 subnormals flush to a zero of the same sign, inputs and results
//   (XLA runs with FTZ and DAZ): min and max take flushed inputs.
// - A row sum (sum, sum_sq) over P <= 32 slots adds in slot order from +0.
//   Over P > 32 XLA rewrites the reduce into a tree: the row, padded by
//   floor(pad / 2) slots in front to a multiple of 32, is summed window by
//   window (32 slots, in slot order, from +0), and the ceil(P / 32) window
//   sums are reduced the same way until at most 32 are left.
// - XLA's CPU code contracts some multiply-adds into fused ones: the plain
//   row reduce of x * x (P <= 32) is acc = fma(x, x, acc), the windowed one
//   (P > 32) multiplies and adds apart; the stdev's numerator is
//   fma(c, sum_sq, -(sum * sum)); the quantile's interpolation is
//   fma(vhi - vlo, frac, vlo).
// - min and max are IEEE minimum and maximum: NaN propagates and -0 < +0.
// - Over P = 1 slot XLA drops the reduce: sum, min, max and last are the
//   slot's value as it is (-0 and subnormals kept).
// - last is the value at the greatest time order, the first slot on ties,
//   summed from +0 with zeros elsewhere: -0 and subnormals give +0. An
//   invalid slot has time order INT32_MIN and value +0, so where slot 0 is
//   invalid and every valid slot's time order is INT32_MIN, last is +0.
// - mean = sum / max(count, 1) (0 when count is 0); stdev as in
//   aggregation/common.go, 0 where count * (count - 1) is 0, with IEEE
//   division and square root. Empty rows: sum 0, min/max/last NaN.
// - A quantile q: rank = q * max(n - 1, 0) in f32, lo = floor(rank),
//   hi = min(lo + 1, max(n - 1, 0)), frac = rank - lo; vlo and vhi are the
//   values at sorted positions lo and hi of the row with its invalid slots
//   read as +inf (NaN sorts last), each summed from +0 like last; NaN where
//   n = 0. Two valid +inf picks give inf + (inf - inf) * frac = NaN.
// Build with -fmad=false (no other contraction than the explicit fmaf
// calls), with -ftz=true, and without fast math (IEEE division and sqrt).
//
// Design. A row is routed by the width P (the widest group's count: one
// timer batching 1,000 values widens every row of its shard to 1,000
// slots, most of them invalid) and by its valid count n.
// - P <= 8 (config 4's 6): a thread a row. A persistent grid walks tiles of
//   256 rows; a tile is one contiguous span of values (and time orders)
//   and one of flags, copied into shared memory in 16-byte cp.async chunks
//   while the block works on the tile before (two buffers). B-5a folds its
//   row in slot order; B-5b sorts the row's <= 8 order keys in registers
//   (a 19-exchange network, invalid slots as the key of +inf) and takes
//   ranks lo and hi by one select chain, each quantile's lo, hi and frac
//   for each n read from a table the block computes once.
// - P > 8: a warp takes 32 consecutive rows, and each lane reads its row's
//   flags in aligned 16-byte chunks (eight in flight) and lists the indices
//   of its first 32 valid slots in shared memory; only those slots' values
//   are read.
//   B-5b, n <= 8: the lane sorts its row's keys as above. 8 < n <= 32: the
//   warp takes such rows one at a time, each lane ranks one slot's key
//   against the others by shuffles, and the lanes at ranks lo and hi hand
//   their values over. The P - n invalid slots are never read: they count
//   as P - n keys of +inf. That is exact: a valid +inf ties with them and
//   valid NaNs sort after them, so the value at sorted position r is the
//   r-th non-NaN valid value if r < m (m their count), +inf if
//   r < m + P - n, NaN otherwise. n > 32: the warp puts the row on a work
//   list (atomicAdd), and a second launch on the same stream, a block a
//   listed row on the resident grid, reads the list's length from device
//   memory, copies the row's non-NaN valid keys into shared memory (~52K
//   fit) and selects each pick (a quantile's lo and hi) by radix, 8 bits a
//   pass: one pass over the keys counts every pick's 256-bin histogram,
//   and a warp a pick scans its bins (8 a lane, a shuffle scan). Rows with
//   more keys run the same passes on keys re-read from device memory.
//   B-5a, n <= 32: the lane folds its listed slots in slot order. n > 32
//   (so P > 32, a window tree): the warp takes the row, a lane a 32-slot
//   window, and the window sums go up the tree in order.
//   Both sums skip invalid slots (and windows without a valid slot). That
//   is exact under one rule: adding +0 changes a sum only when the sum is
//   -0 (valid values flushed to zero: -1.5e-38 + 1.4e-38), which turns +0.
//   So an accumulator of -0 turns +0 where it skipped a slot before its
//   next add or before its window's end. A level's last window ends at
//   its last item: XLA adds no padding behind it.
// Bound: bytes. B-5a reads 9 bytes a slot and writes 32 a group; B-5b reads
// 5 a slot and writes 4 a quantile and group (about 0.26 and 0.13 ms at
// [10,000,000, 6] and three quantiles at 3.35 TB/s); on wide rows, a flag
// a slot and the valid slots' values.
//
// Inputs: the tile route's staging and the wide routes' flag scans read
// whole aligned 16-byte chunks, so up to 15 bytes before a tensor's first
// byte and after its last. A chunk never crosses a page, so the reads
// cannot fault, and the bytes outside the tensor are masked off; a buffer
// whose allocator does not round sizes to 16 bytes would show them to
// compute-sanitizer memcheck (torch's caching allocator rounds blocks to
// 512 bytes). Edge chunks read a byte at a time made B-5b's tile route and
// both kernels' wide rows slower (a design check), so the loads stay whole.
//
// Without __CUDACC__ the same routes compile as host C++
// (m3_aggregate_dense_host, m3_dense_quantiles_host): the lanes of a warp
// run one after the other, so the CPU tests hold this source against the
// twins.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>

#include "../../csrc/launch.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __host__ __device__ __forceinline__
#else
#define M3_HD inline
#endif

namespace {

constexpr int kWindow = 32;        // XLA's tree-reduction window
constexpr int kMaxLevels = 8;      // window levels: 32^7 slots exceed any row
constexpr int kMaxQuantiles = 32;  // quantiles one launch computes
constexpr int kMaxPicks = 2 * kMaxQuantiles;
constexpr int kThreads = 256;      // a block of the tile and wide routes
constexpr int kThreadMaxP = 8;     // rows this narrow (or this few valid slots) a thread each
constexpr int kShort = 32;         // valid slots a row's list holds (a warp's lanes)
constexpr int kLongThreads = 1024;
constexpr int kScanChunks = 8;     // 16-byte flag chunks a thread has in flight
constexpr uint32_t kNanKey = 0xFFFFFFFFu;
constexpr uint32_t kInfKey = 0xFF800000u;  // order_key(+inf)

// The rows' window tree (the same for every row: it depends on P only).
struct Tree {
  int levels;               // window levels above the final sum (0: P <= 32)
  int lo[kMaxLevels];       // each level's front padding
  int64_t n[kMaxLevels + 1];  // each level's items; n[levels] <= 32 is the final sum's
};

struct Quantiles {
  int n;
  float q[kMaxQuantiles];
};

Tree make_tree(int64_t p) {
  Tree t;
  memset(&t, 0, sizeof t);
  int64_t n = p;
  while (n > kWindow && t.levels < kMaxLevels) {
    const int64_t m = (n + kWindow - 1) / kWindow;
    t.lo[t.levels] = (int)((m * kWindow - n) / 2);
    t.n[t.levels] = n;
    ++t.levels;
    n = m;
  }
  t.n[t.levels] = n;
  return t;
}

M3_HD uint32_t bits_of(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return u;
}

M3_HD float from_bits(uint32_t u) {
  float x;
  memcpy(&x, &u, sizeof x);
  return x;
}

M3_HD bool is_nan(float x) { return x != x; }

// A subnormal to the zero of its sign (NaN and the rest unchanged).
M3_HD float ftz(float x) { return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x; }

// An arithmetic operand or result flushed: the card's arithmetic flushes
// both itself under -ftz=true; the host build flushes them here.
M3_HD float ftz_op(float x) {
#ifdef __CUDA_ARCH__
  return x;
#else
  return ftz(x);
#endif
}

M3_HD float add(float a, float b) { return ftz_op(ftz_op(a) + ftz_op(b)); }
M3_HD float mul(float a, float b) { return ftz_op(ftz_op(a) * ftz_op(b)); }
M3_HD float fdiv(float a, float b) { return ftz_op(ftz_op(a) / ftz_op(b)); }
M3_HD float fma_(float a, float b, float c) {
  return ftz_op(fmaf(ftz_op(a), ftz_op(b), ftz_op(c)));
}

// A sum after it skipped +0 slots: -0 + +0 is +0, anything else unchanged.
M3_HD float skipped(float acc) { return bits_of(acc) == 0x80000000u ? 0.0f : acc; }

// a < b with -0 below +0 (neither NaN).
M3_HD bool below(float a, float b) {
  return a < b || (a == b && (bits_of(a) >> 31) && !(bits_of(b) >> 31));
}

// A value summed from +0 with zeros beside it: flushed, -0 to +0.
M3_HD float picked(float x) {
  const float y = ftz(x);
  return y == 0.0f ? 0.0f : y;
}

// count, min, max and last of a row's valid slots, in any order of slots:
// merge() of two parts is the fold of both (min and max over flushed
// values, -0 below +0; last the greatest time order, the lowest slot on
// ties).
struct Fields {
  int64_t c;
  float mn, mx;
  int nan;
  int32_t best;
  int64_t at;
  float last;

  // An invalid slot 0 is a candidate for last: time order INT32_MIN, +0.
  M3_HD void clear(bool slot0_invalid) {
    c = 0;
    mn = INFINITY;
    mx = -INFINITY;
    nan = 0;
    best = INT32_MIN;
    at = slot0_invalid ? 0 : INT64_MAX;
    last = 0.0f;
  }
  M3_HD void take_last(int64_t j, int32_t te, float x) {
    if (te > best || (te == best && j < at)) {
      best = te;
      at = j;
      last = x;
    }
  }
  M3_HD void take(int64_t j, int32_t te, float x) {
    ++c;
    const float y = ftz(x);  // a compare and a select do not flush
    if (is_nan(y)) {
      nan = 1;
    } else {
      if (below(y, mn)) mn = y;
      if (below(mx, y)) mx = y;
    }
    take_last(j, te, x);
  }
  M3_HD void merge(const Fields& o) {
    c += o.c;
    nan |= o.nan;
    if (below(o.mn, mn)) mn = o.mn;
    if (below(mx, o.mx)) mx = o.mx;
    take_last(o.at, o.best, o.last);
  }
};

// The eight fields into f[0..7] (kernels.FIELDS order) from a row's sums.
M3_HD void finish_fields(const Fields& fl, float s, float ss, bool one_slot, float* f) {
  const float cf = (float)fl.c;
  const float div = mul(cf, add(cf, -1.0f));
  const float num = fma_(cf, ss, -mul(s, s));
  const float var = fdiv(num, div == 0.0f ? 1.0f : div);
  float sd = sqrtf(var > 0.0f || is_nan(var) ? var : 0.0f);
  sd = ftz_op(sd);
  const bool empty = fl.c == 0;
  f[0] = empty ? 0.0f : s;
  f[1] = cf;
  f[2] = empty || fl.nan ? NAN : fl.mn;
  f[3] = empty || fl.nan ? NAN : fl.mx;
  f[4] = empty ? 0.0f : ss;
  f[5] = cf > 0.0f ? fdiv(s, cf > 1.0f ? cf : 1.0f) : 0.0f;
  f[6] = div == 0.0f ? 0.0f : sd;
  f[7] = empty ? NAN : one_slot ? fl.last : picked(fl.last);
}

// B-5a for one row of p <= kThreadMaxP slots (so no window tree), every
// slot in slot order.
M3_HD void fold_flat(const float* v, const int32_t* t, const uint8_t* ok, int p, float* f) {
  Fields fl;
  fl.clear(false);
  float s = 0.0f, ss = 0.0f;
  if (p == 1) {  // XLA drops a reduce over one slot: the slot's value as it is
    if (ok[0]) {
      fl.take(0, t[0], v[0]);
      s = v[0];
      fl.mn = fl.mx = v[0];
      fl.nan = 0;
    }
    ss = mul(s, s);
  } else {
#pragma unroll
    for (int j = 0; j < kThreadMaxP; ++j) {
      if (j < p) {
        const bool valid = ok[j] != 0;
        const float x = valid ? v[j] : 0.0f;
        if (valid) fl.take(j, t[j], x);
        else fl.take_last(j, INT32_MIN, 0.0f);
        s = add(s, x);
        ss = fma_(x, x, ss);
      }
    }
  }
  finish_fields(fl, s, ss, p == 1, f);
}

// One row's sum in the window tree, fed only the slots (and the windows)
// that hold a value, in slot order: push(l, i, x) adds item i of level l
// (a slot at level 0, a window sum above). An accumulator skips the items
// between its adds as +0 (skipped()), and a window closes when an item of
// a later window arrives or at finish().
struct TreeSum {
  float acc[kMaxLevels + 1];
  int64_t next[kMaxLevels + 1];  // the padded position after the last add
  int64_t win[kMaxLevels + 1];   // the open window, -1 for none

  M3_HD void clear(const Tree& t) {
    for (int l = 0; l <= t.levels; ++l) {
      acc[l] = 0.0f;
      next[l] = 0;
      win[l] = -1;
    }
  }
  // The open window of level l as an item of the next level. It ends at
  // its last item: the tree adds no padding behind a level's last item.
  M3_HD float closed(const Tree& t, int l) const {
    const int64_t end = t.lo[l] + t.n[l];
    return next[l] < (win[l] + 1) * kWindow && next[l] < end ? skipped(acc[l]) : acc[l];
  }
  M3_HD void push(const Tree& t, int l, int64_t i, float x) {
    for (;;) {
      if (l == t.levels) {
        if (next[l] < i) acc[l] = skipped(acc[l]);
        acc[l] = add(acc[l], x);
        next[l] = i + 1;
        return;
      }
      const int64_t q = i + t.lo[l], w = q / kWindow;
      bool carry = false;
      float cv = 0.0f;
      int64_t ci = 0;
      if (win[l] != w) {
        if (win[l] >= 0) {
          carry = true;
          cv = closed(t, l);
          ci = win[l];
        }
        win[l] = w;
        acc[l] = 0.0f;
        next[l] = w * kWindow;
      }
      if (next[l] < q) acc[l] = skipped(acc[l]);
      acc[l] = add(acc[l], x);
      next[l] = q + 1;
      if (!carry) return;
      // the window this item closed goes up a level (nothing above l
      // depends on level l's state)
      ++l;
      i = ci;
      x = cv;
    }
  }
  M3_HD float finish(const Tree& t) {
    for (int l = 0; l < t.levels; ++l) {
      if (win[l] >= 0) {
        const float v = closed(t, l);
        const int64_t w = win[l];
        win[l] = -1;
        push(t, l + 1, w, v);
      }
    }
    return next[t.levels] < t.n[t.levels] ? skipped(acc[t.levels]) : acc[t.levels];
  }
};

// One 32-slot window of level 0 (padded positions [32w, 32w + 32)): its
// valid slots into fl, their sum and sum of squares (each from +0, in slot
// order, skipping invalid slots) into *s and *ss. False if it has none.
M3_HD bool fold_window(const float* v, const int32_t* t, const uint8_t* ok, int64_t p, int64_t w,
                       int lo, Fields& fl, float* s, float* ss) {
  const int64_t s0 = w * kWindow - lo;
  uint32_t mask = 0;
#pragma unroll
  for (int k = 0; k < kWindow; ++k) {
    const int64_t j = s0 + k;
    if (j >= 0 && j < p && ok[j] != 0) mask |= 1u << k;
  }
  float acc = 0.0f, acc2 = 0.0f;
  int next = 0;
  for (int k0 = 0; k0 < kWindow; k0 += 16) {
    float xs[16];
    int32_t ts[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {  // 16 loads in flight before their fold
      if ((mask >> (k0 + k)) & 1u) {
        xs[k] = v[s0 + k0 + k];
        ts[k] = t[s0 + k0 + k];
      }
    }
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      if ((mask >> (k0 + k)) & 1u) {
        fl.take(s0 + k0 + k, ts[k], xs[k]);
        if (next < k0 + k) acc = skipped(acc);
        acc = add(acc, xs[k]);
        acc2 = add(acc2, mul(xs[k], xs[k]));
        next = k0 + k + 1;
      }
    }
  }
  *s = next < kWindow && s0 + next < p ? skipped(acc) : acc;  // no padding after slot p - 1
  *ss = acc2;  // a sum of squares is never -0
  return mask != 0;
}

// Bit i set where byte i of x is not 0.
M3_HD uint32_t nonzero4(uint32_t x) {
  uint32_t t = x | (x >> 4);
  t |= t >> 2;
  t |= t >> 1;
  return ((t & 0x01010101u) * 0x01020408u) >> 24;
}

// The valid flags of the 16-byte chunk at address c (16-aligned) whose
// words are w0..w3, as a mask of the bytes inside the row [a, e).
M3_HD uint32_t chunk_mask(uint32_t w0, uint32_t w1, uint32_t w2, uint32_t w3, uintptr_t c,
                          uintptr_t a, uintptr_t e) {
  uint32_t m = nonzero4(w0) | nonzero4(w1) << 4 | nonzero4(w2) << 8 | nonzero4(w3) << 12;
  if (c < a) m &= 0xFFFFu << (a - c);
  if (e < c + 16) m &= (1u << (e - c)) - 1u;
  return m;
}

M3_HD int lowest_bit(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __ffs(m) - 1;
#else
  return __builtin_ctz(m);
#endif
}

M3_HD int popcount(uint32_t m) {
#ifdef __CUDA_ARCH__
  return __popc(m);
#else
  return __builtin_popcount(m);
#endif
}

// The 16-byte chunk at c (16-aligned) of a row [a, e): on the card one
// load (the aligned chunk lies in the pages of the bytes it holds), on the
// host the bytes inside the row only.
M3_HD void load16(uintptr_t c, uintptr_t a, uintptr_t e, uint32_t* w) {
#ifdef __CUDA_ARCH__
  const uint4 x = *reinterpret_cast<const uint4*>(c);
  w[0] = x.x;
  w[1] = x.y;
  w[2] = x.z;
  w[3] = x.w;
#else
  for (int i = 0; i < 4; ++i) w[i] = 0;
  for (uintptr_t b = c < a ? a : c; b < c + 16 && b < e; ++b)
    w[(b - c) / 4] |= (uint32_t)*reinterpret_cast<const uint8_t*>(b) << (8 * ((b - c) % 4));
#endif
}

// One thread reads a row's flags [ok, ok + p) in aligned 16-byte chunks,
// kScanChunks in flight, and writes the indices of its first kShort valid slots to
// list[0], list[stride], ... in slot order. Returns the valid count n.
M3_HD int64_t scan_row(const uint8_t* ok, int64_t p, int32_t* list, int stride) {
  const uintptr_t a = (uintptr_t)ok, e = a + p;
  int64_t n = 0;
  for (uintptr_t base = a & ~(uintptr_t)15; base < e; base += 16 * kScanChunks) {
    uint32_t w[kScanChunks][4];
#pragma unroll
    for (int u = 0; u < kScanChunks; ++u)
      if (base + 16 * u < e) load16(base + 16 * u, a, e, w[u]);
#pragma unroll
    for (int u = 0; u < kScanChunks; ++u) {
      const uintptr_t c = base + 16 * u;
      if (c >= e) break;
      uint32_t m = chunk_mask(w[u][0], w[u][1], w[u][2], w[u][3], c, a, e);
      for (; m != 0 && n < kShort; m &= m - 1)
        list[n++ * stride] = (int32_t)(c + lowest_bit(m) - a);
      n += popcount(m);  // past the list: counted only
    }
  }
  return n;
}

// B-5a for one row of P > kThreadMaxP slots from its n <= kShort listed
// valid slots (list[k * stride]), in slot order, 8 loads in flight.
M3_HD void fold_listed(const float* v, const int32_t* t, const int32_t* list, int stride, int64_t n,
                       const Tree& tree, float* f) {
  Fields fl;
  fl.clear(n == 0 || list[0] != 0);
  TreeSum ts, tss;
  ts.clear(tree);
  tss.clear(tree);
  float ss = 0.0f;
  for (int k0 = 0; k0 < n; k0 += 8) {
    int32_t js[8], tt[8];
    float xs[8];
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k0 + k < n) {
        js[k] = list[(k0 + k) * stride];
        xs[k] = v[js[k]];
        tt[k] = t[js[k]];
      }
    }
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      if (k0 + k < n) {
        fl.take(js[k], tt[k], xs[k]);
        ts.push(tree, 0, js[k], xs[k]);
        if (tree.levels == 0) ss = fma_(xs[k], xs[k], ss);
        else tss.push(tree, 0, js[k], mul(xs[k], xs[k]));
      }
    }
  }
  const float s = ts.finish(tree);
  if (tree.levels > 0) ss = tss.finish(tree);
  finish_fields(fl, s, ss, false, f);
}

// The order-preserving key of a slot's value (-0 below +0, every NaN last).
M3_HD uint32_t order_key(float x) {
  if (is_nan(x)) return kNanKey;
  const uint32_t u = bits_of(x);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

M3_HD float key_value(uint32_t k) {
  if (k == kNanKey) return NAN;
  return from_bits((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

struct Pick {
  int64_t lo, hi;
  float frac;
};

M3_HD Pick quantile_pick(float q, float n) {
  float cm = add(n, -1.0f);
  if (!(cm > 0.0f)) cm = 0.0f;
  const float rank = mul(q, cm);
  const float lo = floorf(rank);
  const float hi = fminf(lo + 1.0f, cm);
  return {(int64_t)lo, (int64_t)hi, add(rank, -lo)};
}

M3_HD float quantile_value(float n, float vlo_sorted, float vhi_sorted, float frac) {
  if (!(n > 0.0f)) return NAN;
  const float vlo = picked(vlo_sorted);
  const float vhi = picked(vhi_sorted);
  return fma_(add(vhi, -vlo), frac, vlo);
}

// The value at sorted position r of a row whose m non-NaN valid values
// are followed by `gap` invalid slots (+inf) and then its valid NaNs;
// `v` is the r-th non-NaN valid value where r < m.
M3_HD float rank_value(int64_t r, int64_t m, int64_t gap, float v) {
  return r < m ? v : r < m + gap ? INFINITY : NAN;
}

// Sorts 8 keys ascending (Batcher's odd-even merge network).
M3_HD void cswap(uint32_t& a, uint32_t& b) {
  const uint32_t x = a < b ? a : b, y = a < b ? b : a;
  a = x;
  b = y;
}
M3_HD void sort8(uint32_t* k) {
  cswap(k[0], k[1]); cswap(k[2], k[3]); cswap(k[4], k[5]); cswap(k[6], k[7]);
  cswap(k[0], k[2]); cswap(k[1], k[3]); cswap(k[4], k[6]); cswap(k[5], k[7]);
  cswap(k[1], k[2]); cswap(k[5], k[6]);
  cswap(k[0], k[4]); cswap(k[1], k[5]); cswap(k[2], k[6]); cswap(k[3], k[7]);
  cswap(k[2], k[4]); cswap(k[3], k[5]);
  cswap(k[1], k[2]); cswap(k[3], k[4]); cswap(k[5], k[6]);
}

// Each quantile's pick at each valid count n <= kThreadMaxP (the same for
// every row of that count).
struct SmallPicks {
  int lo[kThreadMaxP + 1][kMaxQuantiles], hi[kThreadMaxP + 1][kMaxQuantiles];
  float frac[kThreadMaxP + 1][kMaxQuantiles];
};

M3_HD void fill_pick(const Quantiles& qs, int i, SmallPicks* sp) {
  const int n = i / qs.n, q = i % qs.n;
  const Pick pk = quantile_pick(qs.q[q], (float)n);
  sp->lo[n][q] = (int)pk.lo;
  sp->hi[n][q] = (int)pk.hi;
  sp->frac[n][q] = pk.frac;
}

// The sorted keys at ranks lo and hi (hi is lo or lo + 1) by one select
// chain (no register array indexed at run time).
M3_HD void select_pair(const uint32_t* k, int lo, int hi, uint32_t* klo, uint32_t* khi) {
  uint32_t a = k[0], b = k[1];
#pragma unroll
  for (int i = 1; i < 8; ++i) {
    a = lo == i ? k[i] : a;
    b = lo == i ? k[i < 7 ? i + 1 : 7] : b;
  }
  *klo = a;
  *khi = hi == lo ? a : b;
}

// B-5b for a row of at most 8 keys k (sorted in place; kNanKey past the
// row) and n valid slots: its nq quantiles to out[i * g]. With `gap` >= 0
// the keys are the n valid slots' and the P - n = gap invalid slots are
// rank_value's +inf; with gap < 0 every slot has its key (invalid: +inf).
M3_HD void quantiles_small(uint32_t* k, int n, int m, int64_t gap, const Quantiles& qs,
                           const SmallPicks& sp, int64_t g, float* out) {
  sort8(k);  // the keys past the row sort last and no rank below n reaches them
  for (int i = 0; i < qs.n; ++i) {
    const int lo = sp.lo[n][i], hi = sp.hi[n][i];
    uint32_t klo, khi;
    select_pair(k, lo, hi, &klo, &khi);
    float vlo = key_value(klo), vhi = key_value(khi);
    if (gap >= 0) {
      vlo = rank_value(lo, m, gap, vlo);
      vhi = rank_value(hi, m, gap, vhi);
    }
    out[i * g] = quantile_value((float)n, vlo, vhi, sp.frac[n][i]);
  }
}

// B-5b for one row of p <= kThreadMaxP slots.
M3_HD void quantiles_flat(const float* v, const uint8_t* ok, int p, const Quantiles& qs,
                          const SmallPicks& sp, int64_t g, float* out) {
  uint32_t k[8];
  int n = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool on = j < p && ok[j] != 0;
    n += on;
    k[j] = j >= p ? kNanKey : on ? order_key(v[j]) : kInfKey;
  }
  quantiles_small(k, n, 0, -1, qs, sp, g, out);
}

// B-5b for a row of P > kThreadMaxP slots from its n <= kThreadMaxP listed
// valid slots (list[k * stride]).
M3_HD void quantiles_listed(const float* v, const int32_t* list, int stride, int n, int64_t p,
                            const Quantiles& qs, const SmallPicks& sp, int64_t g, float* out) {
  uint32_t k[8];
  int m = 0;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    if (j < n) {
      const float x = v[list[j * stride]];
      k[j] = order_key(x);
      m += !is_nan(x);
    } else {
      k[j] = kNanKey;
    }
  }
  quantiles_small(k, n, m, p - n, qs, sp, g, out);
}

// The long rows' select: pick i of a row is quantile i / 2's rank lo (i
// even) or hi; each pick below m (the non-NaN valid count) selects its key
// 8 bits a pass, the prefix found so far in prefix[i] and its rank among
// the keys under that prefix in k[i] (a pick at m or above is rank_value's
// +inf or NaN and takes no part).
M3_HD int64_t pick_rank(const Quantiles& qs, int i, int64_t n) {
  const Pick pk = quantile_pick(qs.q[i / 2], (float)n);
  return i % 2 == 0 ? pk.lo : pk.hi;
}

// A lane's 8 bins [8 lane, 8 lane + 8) of a pick's histogram, e the count
// below them: where rank *k falls in them, the digit into *prefix and *k
// made relative to its bin.
M3_HD void resolve_digit(const uint32_t* bins, int lane, int64_t e, int shift, int64_t* k,
                         uint32_t* prefix) {
  for (int b = 0; b < 8; ++b) {
    if (*k < e + bins[b]) {
      *k -= e;
      *prefix |= (uint32_t)(8 * lane + b) << shift;
      return;
    }
    e += bins[b];
  }
}

// Quantile i of a long row from its picks' keys.
M3_HD float long_quantile(const Quantiles& qs, const uint32_t* prefix, int i, int64_t n, int64_t m,
                          int64_t p) {
  const Pick pk = quantile_pick(qs.q[i], (float)n);
  return quantile_value((float)n, rank_value(pk.lo, m, p - n, key_value(prefix[2 * i])),
                        rank_value(pk.hi, m, p - n, key_value(prefix[2 * i + 1])), pk.frac);
}

#ifdef __CUDACC__

constexpr unsigned kFull = 0xFFFFFFFFu;

// Bytes of a tile's span in shared memory: the 16-byte chunks over `bytes`
// (a multiple of 16) at any alignment.
__host__ __device__ constexpr int64_t span_bytes(int64_t bytes) { return bytes + 16; }

// Starts the copy of [src, src + bytes) into dst as the aligned 16-byte
// chunks that cover it (an aligned chunk that holds a byte of the tensor
// lies in its allocation's pages); the data starts at dst + (src & 15).
__device__ __forceinline__ void stage(uint8_t* dst, const void* src, int64_t bytes) {
  const uintptr_t a = (uintptr_t)src, lo = a & ~(uintptr_t)15;
  const uintptr_t hi = (a + bytes + 15) & ~(uintptr_t)15;
  for (uintptr_t c = lo + threadIdx.x * 16; c < hi; c += (uintptr_t)blockDim.x * 16)
    m3::cp_async16(dst + (c - lo), (const void*)c);
}

// Fields reduced across the warp (every lane gets the whole).
__device__ __forceinline__ void warp_merge(Fields& fl) {
#pragma unroll
  for (int d = 16; d >= 1; d >>= 1) {
    Fields o;
    o.c = __shfl_xor_sync(kFull, fl.c, d);
    o.mn = __shfl_xor_sync(kFull, fl.mn, d);
    o.mx = __shfl_xor_sync(kFull, fl.mx, d);
    o.nan = __shfl_xor_sync(kFull, fl.nan, d);
    o.best = __shfl_xor_sync(kFull, fl.best, d);
    o.at = __shfl_xor_sync(kFull, fl.at, d);
    o.last = __shfl_xor_sync(kFull, fl.last, d);
    fl.merge(o);
  }
}

// P = kP <= kThreadMaxP: a thread a row over tiles of kThreads rows
// staged in shared memory, two buffers. kQuantiles: B-5b (vals, valid),
// else B-5a (vals, torder, valid).
template <bool kQuantiles, int kP>
__global__ void __launch_bounds__(kThreads)
    tile_kernel(const float* __restrict__ vals, const int32_t* __restrict__ torder,
                const uint8_t* __restrict__ valid, int64_t g, Quantiles qs,
                float* __restrict__ out) {
  constexpr int p = kP;
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ SmallPicks picks;
  if (kQuantiles)
    for (int i = threadIdx.x; i < (kThreadMaxP + 1) * qs.n; i += blockDim.x)
      fill_pick(qs, i, &picks);
  const int64_t vb = span_bytes((int64_t)kThreads * p * 4), fb = span_bytes((int64_t)kThreads * p);
  const int64_t buf_bytes = (kQuantiles ? 1 : 2) * vb + fb;
  const int64_t tiles = (g + kThreads - 1) / kThreads;
  const int vo = (int)((uintptr_t)vals & 15), to = (int)((uintptr_t)torder & 15),
            fo = (int)((uintptr_t)valid & 15);
  auto issue = [&](int64_t tile, int b) {
    uint8_t* buf = smem + b * buf_bytes;
    const int64_t r0 = tile * kThreads;
    const int64_t rows = g - r0 < kThreads ? g - r0 : kThreads;
    stage(buf, vals + r0 * p, rows * p * 4);
    if (!kQuantiles) stage(buf + vb, torder + r0 * p, rows * p * 4);
    stage(buf + (kQuantiles ? 1 : 2) * vb, valid + r0 * p, rows * p);
    m3::cp_async_commit();
  };
  int b = 0;
  int64_t tile = blockIdx.x;
  if (tile < tiles) issue(tile, 0);
  for (; tile < tiles; tile += gridDim.x) {
    const int64_t next = tile + gridDim.x;
    if (next < tiles) {
      issue(next, b ^ 1);
      m3::cp_async_wait<1>();
    } else {
      m3::cp_async_wait<0>();
    }
    __syncthreads();
    const int64_t row = tile * kThreads + threadIdx.x;
    if (row < g) {
      const uint8_t* buf = smem + b * buf_bytes;
      const float* v = reinterpret_cast<const float*>(buf + vo) + (int64_t)threadIdx.x * p;
      const uint8_t* ok = buf + (kQuantiles ? 1 : 2) * vb + fo + (int64_t)threadIdx.x * p;
      if (kQuantiles) {
        quantiles_flat(v, ok, p, qs, picks, g, out + row);
      } else {
        const int32_t* t =
            reinterpret_cast<const int32_t*>(buf + vb + to) + (int64_t)threadIdx.x * p;
        float f[8];
        fold_flat(v, t, ok, p, f);
#pragma unroll
        for (int k = 0; k < 8; ++k) out[k * g + row] = f[k];
      }
    }
    __syncthreads();  // the buffer is refilled next
    b ^= 1;
  }
}

// B-5a, P > kThreadMaxP: a warp takes 32 consecutive rows, a lane a row
// for rows of at most kShort valid slots (its list in shared memory,
// [entry][lane]); the warp together, a lane a 32-slot window, for longer
// rows.
__global__ void __launch_bounds__(kThreads)
    aggregate_wide_kernel(const float* __restrict__ vals, const int32_t* __restrict__ torder,
                          const uint8_t* __restrict__ valid, int64_t g, int64_t p, Tree tree,
                          float* __restrict__ out) {
  __shared__ int32_t lists[kThreads / 32][kShort][32];
  const int lane = threadIdx.x & 31;
  int32_t* list = &lists[threadIdx.x / 32][0][lane];
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t r0 = ((int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * 32; r0 < g;
       r0 += warps * 32) {
    const int64_t row = r0 + lane;
    const int64_t n = row < g ? scan_row(valid + row * p, p, list, 32) : 0;
    if (row < g && n <= kShort) {
      float f[8];
      fold_listed(vals + row * p, torder + row * p, list, 32, n, tree, f);
#pragma unroll
      for (int k = 0; k < 8; ++k) out[k * g + row] = f[k];
    }
    for (unsigned longs = __ballot_sync(kFull, n > kShort); longs != 0; longs &= longs - 1) {
      const int64_t r = r0 + __ffs(longs) - 1;  // n > 32 valid slots, so P > 32
      const float* v = vals + r * p;
      const int32_t* t = torder + r * p;
      const uint8_t* ok = valid + r * p;
      Fields fl;
      fl.clear(ok[0] == 0);
      TreeSum ts, tss;
      ts.clear(tree);
      tss.clear(tree);
      for (int64_t w0 = 0; w0 < tree.n[1]; w0 += 32) {
        const int64_t w = w0 + lane;
        float ws = 0.0f, wss = 0.0f;
        const bool has = w < tree.n[1] && fold_window(v, t, ok, p, w, tree.lo[0], fl, &ws, &wss);
        for (unsigned real = __ballot_sync(kFull, has); real != 0; real &= real - 1) {
          const int i = __ffs(real) - 1;
          ts.push(tree, 1, w0 + i, __shfl_sync(kFull, ws, i));
          tss.push(tree, 1, w0 + i, __shfl_sync(kFull, wss, i));
        }
      }
      warp_merge(fl);
      float f[8];
      finish_fields(fl, ts.finish(tree), tss.finish(tree), false, f);
      float mine = f[0];
#pragma unroll
      for (int k = 1; k < 8; ++k) mine = lane == k ? f[k] : mine;
      if (lane < 8) out[lane * g + r] = mine;
    }
    __syncwarp();  // the lists are rewritten by the next rows
  }
}

// B-5b, P > kThreadMaxP: a warp takes 32 consecutive rows, a lane a row
// for rows of at most kThreadMaxP valid slots; the warp together, a row at
// a time, for rows of up to kShort; longer rows go onto the work list.
__global__ void __launch_bounds__(kThreads)
    quantiles_wide_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ valid,
                          int64_t g, int64_t p, Quantiles qs, unsigned long long* long_count,
                          int64_t* long_rows, float* __restrict__ out) {
  __shared__ int32_t lists[kThreads / 32][kShort][32];
  __shared__ SmallPicks picks;
  for (int i = threadIdx.x; i < (kThreadMaxP + 1) * qs.n; i += blockDim.x) fill_pick(qs, i, &picks);
  __syncthreads();
  const int lane = threadIdx.x & 31;
  int32_t(*warp_lists)[32] = lists[threadIdx.x / 32];
  int32_t* list = &warp_lists[0][lane];
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t r0 = ((int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32) * 32; r0 < g;
       r0 += warps * 32) {
    const int64_t row = r0 + lane;
    const int64_t n = row < g ? scan_row(valid + row * p, p, list, 32) : 0;
    if (row < g && n <= kThreadMaxP)
      quantiles_listed(vals + row * p, list, 32, (int)n, p, qs, picks, g, out + row);
    __syncwarp();  // every lane's list is written
    for (unsigned mids = __ballot_sync(kFull, n > kThreadMaxP && n <= kShort); mids != 0;
         mids &= mids - 1) {
      const int owner = __ffs(mids) - 1;
      const int64_t r = r0 + owner;
      const int nn = __shfl_sync(kFull, (int)n, owner);
      const bool have = lane < nn;
      const float x = have ? vals[r * p + warp_lists[lane][owner]] : 0.0f;
      const uint32_t key = have ? order_key(x) : kNanKey;
      const int m = __popc(__ballot_sync(kFull, have && !is_nan(x)));
      int rank = 0;
      for (int i = 0; i < nn; ++i) {
        const uint32_t ki = __shfl_sync(kFull, key, i);
        rank += (ki < key) || (ki == key && i < lane);
      }
      float mine = 0.0f;
      for (int i = 0; i < qs.n; ++i) {
        const Pick pk = quantile_pick(qs.q[i], (float)nn);
        const unsigned at_lo = __ballot_sync(kFull, have && rank == pk.lo);
        const unsigned at_hi = __ballot_sync(kFull, have && rank == pk.hi);
        const float xlo = __shfl_sync(kFull, x, at_lo ? __ffs(at_lo) - 1 : 0);
        const float xhi = __shfl_sync(kFull, x, at_hi ? __ffs(at_hi) - 1 : 0);
        const float v = quantile_value((float)nn, rank_value(pk.lo, m, p - nn, xlo),
                                       rank_value(pk.hi, m, p - nn, xhi), pk.frac);
        mine = lane == i ? v : mine;
      }
      if (lane < qs.n) out[lane * g + r] = mine;
    }
    const unsigned longs = __ballot_sync(kFull, n > kShort);
    if (lane == 0 && longs != 0) {
      unsigned long long at = atomicAdd(long_count, (unsigned long long)__popc(longs));
      for (unsigned l = longs; l != 0; l &= l - 1) long_rows[at++] = r0 + __ffs(l) - 1;
    }
    __syncwarp();  // the lists are rewritten by the next rows
  }
}

// B-5b's long rows: a block a listed row. Dynamic shared memory: a
// histogram of 256 bins for each of the 2 * qs.n picks, then up to `cap`
// keys.
__global__ void __launch_bounds__(kLongThreads)
    quantiles_long_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ valid,
                          int64_t g, int64_t p, Quantiles qs,
                          const unsigned long long* long_count, const int64_t* long_rows,
                          int64_t cap, float* __restrict__ out) {
  extern __shared__ __align__(16) uint32_t dyn[];
  const int picks = 2 * qs.n;
  uint32_t* hist = dyn;
  uint32_t* keys = dyn + picks * 256;
  __shared__ uint32_t prefix[kMaxPicks];
  __shared__ int64_t k[kMaxPicks];
  __shared__ unsigned long long count_n, count_m;
  const int lane = threadIdx.x & 31, warp = threadIdx.x / 32, warps = blockDim.x / 32;
  const unsigned long long rows = *long_count;
  for (unsigned long long li = blockIdx.x; li < rows; li += gridDim.x) {
    const int64_t row = long_rows[li];
    const float* v = vals + row * p;
    const uint8_t* ok = valid + row * p;
    for (int b = threadIdx.x; b < picks * 256; b += blockDim.x) hist[b] = 0;
    if (threadIdx.x == 0) count_n = count_m = 0;
    __syncthreads();
    for (int64_t j0 = 0; j0 < p; j0 += blockDim.x) {  // the valid values, read once
      const int64_t j = j0 + threadIdx.x;
      const bool on = j < p && ok[j] != 0;
      const float x = on ? v[j] : 0.0f;
      const bool keyed = on && !is_nan(x);
      const unsigned bn = __ballot_sync(kFull, on), bm = __ballot_sync(kFull, keyed);
      unsigned long long at = 0;
      if (lane == 0) {
        if (bn) atomicAdd(&count_n, (unsigned long long)__popc(bn));
        if (bm) at = atomicAdd(&count_m, (unsigned long long)__popc(bm));
      }
      at = __shfl_sync(kFull, at, 0) + __popc(bm & ((1u << lane) - 1u));
      if (keyed && at < (unsigned long long)cap) keys[at] = order_key(x);
    }
    __syncthreads();
    const int64_t n = (int64_t)count_n, m = (int64_t)count_m;
    if (threadIdx.x < picks) {
      k[threadIdx.x] = pick_rank(qs, threadIdx.x, n);
      prefix[threadIdx.x] = 0;
    }
    __syncthreads();
    for (int shift = 24; shift >= 0; shift -= 8) {
      // one pass over the keys counts every pick's histogram (a pick at m
      // or above, whose k stays >= m, counts nothing)
      const uint32_t mask = shift == 24 ? 0u : ~0u << (shift + 8);
      const int64_t nk = m <= cap ? m : p;
      for (int64_t j = threadIdx.x; j < nk; j += blockDim.x) {
        uint32_t key;
        if (m <= cap) {
          key = keys[j];
        } else {  // more keys than shared memory holds: read them again
          if (ok[j] == 0 || is_nan(v[j])) continue;
          key = order_key(v[j]);
        }
        for (int i = 0; i < picks; ++i)
          if (k[i] < m && (key & mask) == prefix[i])
            atomicAdd(&hist[i * 256 + ((key >> shift) & 255u)], 1u);
      }
      __syncthreads();
      for (int i = warp; i < picks; i += warps) {  // a warp a pick's 256 bins
        uint32_t* h = hist + i * 256 + 8 * lane;
        uint32_t bins[8];
        int64_t sum = 0;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          bins[b] = h[b];
          sum += bins[b];
          h[b] = 0;  // cleared for the next pass
        }
        int64_t incl = sum;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int64_t y = __shfl_up_sync(kFull, incl, d);
          if (lane >= d) incl += y;
        }
        int64_t ki = k[i];
        uint32_t pre = prefix[i];
        const bool hit = ki < m && incl - sum <= ki && ki < incl;  // one lane holds rank ki
        __syncwarp();  // every lane read them before they change
        if (hit) {
          resolve_digit(bins, lane, incl - sum, shift, &ki, &pre);
          k[i] = ki;
          prefix[i] = pre;
        }
      }
      __syncthreads();
    }
    if (threadIdx.x < qs.n)
      out[threadIdx.x * g + row] = long_quantile(qs, prefix, threadIdx.x, n, m, p);
    __syncthreads();  // prefix, k, hist and keys are reused by the next row
  }
}

// Grid of a persistent kernel: the resident blocks, at most `needed`.
template <class Kernel>
cudaError_t grid_for(Kernel kernel, int threads, size_t smem, int64_t needed, unsigned* out) {
  int64_t blocks = 0;
  const cudaError_t e = m3::resident_blocks(kernel, threads, smem, &blocks);
  if (e != cudaSuccess) return e;
  if (blocks > needed) blocks = needed;
  *out = (unsigned)(blocks > 0 ? blocks : 1);
  return cudaSuccess;
}

template <bool kQuantiles, int kP>
cudaError_t launch_tile(const float* vals, const int32_t* torder, const uint8_t* valid, int64_t g,
                        const Quantiles& qs, float* out, cudaStream_t stream) {
  const size_t smem = (size_t)(2 * ((kQuantiles ? 1 : 2) * span_bytes((int64_t)kThreads * kP * 4) +
                                    span_bytes((int64_t)kThreads * kP)));
  unsigned grid = 0;
  const cudaError_t e =
      grid_for(tile_kernel<kQuantiles, kP>, kThreads, smem, (g + kThreads - 1) / kThreads, &grid);
  if (e != cudaSuccess) return e;
  tile_kernel<kQuantiles, kP><<<grid, kThreads, smem, stream>>>(vals, torder, valid, g, qs, out);
  return cudaGetLastError();
}

// The tile route at each width P <= kThreadMaxP (the row's loops unrolled).
template <bool kQuantiles>
cudaError_t launch_tiles(const float* vals, const int32_t* torder, const uint8_t* valid, int64_t g,
                         int p, const Quantiles& qs, float* out, cudaStream_t stream) {
  switch (p) {
    case 1: return launch_tile<kQuantiles, 1>(vals, torder, valid, g, qs, out, stream);
    case 2: return launch_tile<kQuantiles, 2>(vals, torder, valid, g, qs, out, stream);
    case 3: return launch_tile<kQuantiles, 3>(vals, torder, valid, g, qs, out, stream);
    case 4: return launch_tile<kQuantiles, 4>(vals, torder, valid, g, qs, out, stream);
    case 5: return launch_tile<kQuantiles, 5>(vals, torder, valid, g, qs, out, stream);
    case 6: return launch_tile<kQuantiles, 6>(vals, torder, valid, g, qs, out, stream);
    case 7: return launch_tile<kQuantiles, 7>(vals, torder, valid, g, qs, out, stream);
    default: return launch_tile<kQuantiles, kThreadMaxP>(vals, torder, valid, g, qs, out, stream);
  }
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// B-5a: vals f32 [g, p], torder i32 [g, p], valid u8 [g, p] (contiguous, on
// the card) -> out f32 [8, g]. Rows of p <= 8 slots take the tile route,
// wider rows a warp each. Returns the CUDA error of the launch.
extern "C" int m3_aggregate_dense(const float* vals, const int32_t* torder, const uint8_t* valid,
                                  int64_t g, int64_t p, float* out, void* stream) {
  if (g <= 0 || p <= 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  if (p <= kThreadMaxP) {
    Quantiles none;
    none.n = 0;
    return (int)launch_tiles<false>(vals, torder, valid, g, (int)p, none, out, s);
  }
  unsigned grid = 0;
  const cudaError_t e = grid_for(aggregate_wide_kernel, kThreads, 0, (g + kThreads - 1) / kThreads,
                                 &grid);
  if (e != cudaSuccess) return (int)e;
  aggregate_wide_kernel<<<grid, kThreads, 0, s>>>(vals, torder, valid, g, p, make_tree(p), out);
  return (int)cudaGetLastError();
}

// B-5b: vals f32 [g, p], valid u8 [g, p] (contiguous, on the card), qs a
// host array of nq (1..32) quantiles -> out f32 [nq, g]. Rows of p <= 8
// slots take the tile route; wider rows a warp each, and for p > 32 the
// rows of more than 32 valid slots a block each in a second launch, through
// the work list in `scratch` (int64 [g + 1] on the card: the count, then
// the rows). Returns the CUDA error of a launch, or -1 for an nq out of
// range or a missing scratch.
extern "C" int m3_dense_quantiles(const float* vals, const uint8_t* valid, int64_t g, int64_t p,
                                  const float* qs, int nq, void* scratch, float* out,
                                  void* stream) {
  if (nq < 1 || nq > kMaxQuantiles) return -1;
  if (g <= 0 || p <= 0) return 0;
  Quantiles q;
  q.n = nq;
  for (int i = 0; i < nq; ++i) q.q[i] = qs[i];
  const cudaStream_t s = (cudaStream_t)stream;
  if (p <= kThreadMaxP) return (int)launch_tiles<true>(vals, nullptr, valid, g, (int)p, q, out, s);
  const bool lists = p > kShort;
  if (lists && scratch == nullptr) return -1;
  unsigned long long* count = (unsigned long long*)scratch;
  int64_t* rows = lists ? (int64_t*)scratch + 1 : nullptr;
  cudaError_t e;
  if (lists && (e = cudaMemsetAsync(count, 0, sizeof *count, s)) != cudaSuccess) return (int)e;
  unsigned grid = 0;
  if ((e = grid_for(quantiles_wide_kernel, kThreads, 0, (g + kThreads - 1) / kThreads, &grid)) !=
      cudaSuccess)
    return (int)e;
  quantiles_wide_kernel<<<grid, kThreads, 0, s>>>(vals, valid, g, p, q, count, rows, out);
  if ((e = cudaGetLastError()) != cudaSuccess || !lists) return (int)e;
  const size_t smem = m3::kSmemMax - 4096;  // the kernel's static arrays take < 1 KB
  const int64_t cap = (int64_t)(smem - (size_t)2 * nq * 256 * 4) / 4;
  if ((e = grid_for(quantiles_long_kernel, kLongThreads, smem, g, &grid)) != cudaSuccess)
    return (int)e;
  quantiles_long_kernel<<<grid, kLongThreads, smem, s>>>(vals, valid, g, p, q, count, rows, cap,
                                                        out);
  return (int)cudaGetLastError();
}

#else  // host C++ build of the same routes, a warp's lanes one after the other

extern "C" int m3_aggregate_dense_host(const float* vals, const int32_t* torder,
                                       const uint8_t* valid, int64_t g, int64_t p, float* out) {
  const Tree tree = make_tree(p);
  int32_t list[kShort];
  for (int64_t r = 0; r < g; ++r) {
    const float* v = vals + r * p;
    const int32_t* t = torder + r * p;
    const uint8_t* ok = valid + r * p;
    float f[8];
    if (p <= kThreadMaxP) {
      fold_flat(v, t, ok, (int)p, f);
    } else if (const int64_t n = scan_row(ok, p, list, 1); n <= kShort) {
      fold_listed(v, t, list, 1, n, tree, f);
    } else {  // the warp's lanes, a window each, in turn
      Fields fl;
      fl.clear(ok[0] == 0);
      TreeSum ts, tss;
      ts.clear(tree);
      tss.clear(tree);
      for (int64_t w = 0; w < tree.n[1]; ++w) {
        float ws, wss;
        if (fold_window(v, t, ok, p, w, tree.lo[0], fl, &ws, &wss)) {
          ts.push(tree, 1, w, ws);
          tss.push(tree, 1, w, wss);
        }
      }
      finish_fields(fl, ts.finish(tree), tss.finish(tree), false, f);
    }
    for (int k = 0; k < 8; ++k) out[k * g + r] = f[k];
  }
  return 0;
}

// Routes as in m3_dense_quantiles; `cap` is the long route's shared-memory
// key capacity (rows of more non-NaN valid keys select on keys read from
// the row each pass), 0 for the card's.
extern "C" int m3_dense_quantiles_host(const float* vals, const uint8_t* valid, int64_t g,
                                       int64_t p, const float* qs, int nq, int64_t cap,
                                       float* out) {
  if (nq < 1 || nq > kMaxQuantiles) return -1;
  Quantiles q;
  q.n = nq;
  for (int i = 0; i < nq; ++i) q.q[i] = qs[i];
  if (cap <= 0) cap = (int64_t)(m3::kSmemMax - 4096 - (size_t)2 * nq * 256 * 4) / 4;
  SmallPicks picks;
  for (int i = 0; i < (kThreadMaxP + 1) * nq; ++i) fill_pick(q, i, &picks);
  int32_t list[kShort];
  uint32_t* hist = new uint32_t[2 * kMaxQuantiles * 256]();
  uint32_t* keys = new uint32_t[cap];
  uint32_t prefix[kMaxPicks];
  int64_t k[kMaxPicks];
  for (int64_t row = 0; row < g; ++row) {
    const float* v = vals + row * p;
    const uint8_t* ok = valid + row * p;
    if (p <= kThreadMaxP) {
      quantiles_flat(v, ok, (int)p, q, picks, g, out + row);
      continue;
    }
    const int64_t n = scan_row(ok, p, list, 1);
    if (n <= kThreadMaxP) {
      quantiles_listed(v, list, 1, (int)n, p, q, picks, g, out + row);
      continue;
    }
    if (n <= kShort) {  // the warp's lanes' ranks, by the same comparisons
      uint32_t key[kShort];
      float x[kShort];
      int64_t m = 0;
      for (int i = 0; i < n; ++i) {
        x[i] = v[list[i]];
        key[i] = order_key(x[i]);
        m += !is_nan(x[i]);
      }
      for (int i = 0; i < nq; ++i) {
        const Pick pk = quantile_pick(q.q[i], (float)n);
        float xlo = 0.0f, xhi = 0.0f;
        for (int a = 0; a < n; ++a) {
          int64_t rank = 0;
          for (int b = 0; b < n; ++b) rank += (key[b] < key[a]) || (key[b] == key[a] && b < a);
          if (rank == pk.lo) xlo = x[a];
          if (rank == pk.hi) xhi = x[a];
        }
        out[i * g + row] = quantile_value((float)n, rank_value(pk.lo, m, p - n, xlo),
                                          rank_value(pk.hi, m, p - n, xhi), pk.frac);
      }
      continue;
    }
    int64_t m = 0;  // the long route
    for (int64_t j = 0; j < p; ++j) {
      if (ok[j] == 0 || is_nan(v[j])) continue;
      if (m < cap) keys[m] = order_key(v[j]);
      ++m;
    }
    for (int i = 0; i < 2 * nq; ++i) {
      k[i] = pick_rank(q, i, n);
      prefix[i] = 0;
    }
    for (int shift = 24; shift >= 0; shift -= 8) {
      const uint32_t mask = shift == 24 ? 0u : ~0u << (shift + 8);
      for (int64_t j = 0; j < (m <= cap ? m : p); ++j) {
        uint32_t key;
        if (m <= cap) {
          key = keys[j];
        } else {
          if (ok[j] == 0 || is_nan(v[j])) continue;
          key = order_key(v[j]);
        }
        for (int i = 0; i < 2 * nq; ++i)
          if (k[i] < m && (key & mask) == prefix[i]) ++hist[i * 256 + ((key >> shift) & 255u)];
      }
      for (int i = 0; i < 2 * nq; ++i) {  // the warp's scan of each pick, lane by lane
        uint32_t* h = hist + i * 256;
        for (int64_t lane = 0, e = 0; lane < 32 && k[i] < m; ++lane) {
          int64_t sum = 0;
          for (int b = 0; b < 8; ++b) sum += h[8 * lane + b];
          if (e <= k[i] && k[i] < e + sum) {
            resolve_digit(h + 8 * lane, (int)lane, e, shift, &k[i], &prefix[i]);
            break;
          }
          e += sum;
        }
        memset(h, 0, 256 * sizeof *h);
      }
    }
    for (int i = 0; i < nq; ++i) out[i * g + row] = long_quantile(q, prefix, i, n, m, p);
  }
  delete[] hist;
  delete[] keys;
  return 0;
}

#endif
