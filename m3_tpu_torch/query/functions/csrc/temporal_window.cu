// Windowed temporal functions over a range matrix (kernel B-7): deriv,
// predict_linear, holt_winters and quantile_over_time. Not a Pallas kernel:
// it replaces the XLA programs of m3_tpu/query/functions/temporal.py:419-461
// (_linreg_sums, deriv, predict_linear), :517-568 (holt_winters) and
// :571-602 (quantile_over_time), which gather [S, 128, W] windows
// (_gather_windows, :505) inside a lax.map over chunks of 128 steps and then
// reduce them, run a W-step lax.scan over them, or sort them.
//
// What it computes. Input f32 [S, T], NaN = missing; the window is W steps;
// output f32 [S, T - first]: output column o is input column first + o and
// covers input columns [first + o - W + 1, first + o], NaN before column 0
// (the engine keeps the columns from first = W - 1 on). Per function
// (parameters a-d, as the wrapper rounds them to f32):
// - deriv (a = step seconds) / predict_linear (a = step, b = seconds ahead):
//   the least-squares line through the window's valid samples, time measured
//   from the window's end (d_j = (j - (W-1)) * step for slot j): the sums n,
//   sum v, sum d, sum d^2, sum d*v over the slots in order, then
//   temporal.py:441-447's formula, NaN below two samples. predict_linear is
//   slope * b + intercept.
// - holt_winters (a = sf, b = 1 - sf, c = tf, d = 1 - tf): the W-step
//   recurrence of temporal.py:526-551 over the window's slots in order
//   (trend set on the second valid sample), NaN below two samples.
// - quantile_over_time (a = q, b = -1 for q < 0, +1 for q > 1, else 0): the
//   order statistics lo = floor(q (n-1)) and hi = min(lo + 1, n - 1) of the
//   window's n valid samples, vlo + (vhi - vlo) * frac; -inf / +inf for q
//   out of [0, 1] where the window holds a sample; NaN where it holds none.
//
// Bound. Bytes: the input read once and the kept columns written once.
// Operations: the fewest f32 adds, multiplies and divisions the parity
// contract (below) leaves, over the windows that compute a value (two
// samples or more; one for the quantile): the linear functions 3 a valid
// slot where the window's sums of d and d^2 are table folds (a fully valid
// window, or samples only at its end: sum v and sum d*v remain) and 7 in
// any other window, then deriv's slope 7 and predict_linear's slope,
// intercept and prediction 13 a window; holt_winters 8 a valid slot but 0
// on a window's first sample and 5 on its second (8n - 11); the quantile
// one comparison a value and 5 a window (the interpolation). At W = 361
// over [100,000, 1,080] (720 columns kept, 1.95e10 valid slots) that is
// 5.9e10 operations, 0.89 ms at 67 TFLOP/s. The build has no FMA
// contraction (-fmad=false), so adds and multiplies run at one a lane a
// cycle, half of that published rate: at most 50% of the operation bound
// is reachable.
//
// Design (the twin's order of arithmetic is the contract):
// - Only the kept columns: a launch covers output columns first .. T-1, and
//   stages only the input they read.
// - deriv, predict_linear, holt_winters (staged route): a block a row at a
//   time on a persistent grid. The row's slots are staged in shared memory,
//   0 where a sample is missing, with a flag array (1 / 0) and the validity
//   as a bitmask (one __ballot_sync per 32 slots) with each word's running
//   count, so a window's sample count, and whether its samples are its last
//   ones, are a few word reads. A thread takes kCols = 4 adjacent
//   columns and folds each in slot order; one 16-byte load of 4 slot values
//   serves all 4 (walk4), two rounds of 4 slots unrolled.
//   * Linear functions: sum v and sum d*v over the slots the group's windows
//     hold samples in (a missing slot adds +0 and d*0, which change no sum,
//     as in the twin: no sum is ever -0). Where every window of the group
//     holds its samples in one run at its end (or in every slot: a series
//     that starts inside the window), sum d and sum d^2 come from slot
//     tables built once a block: the fold of d_k .. d_{W-1} for each k, each
//     from +0 in slot order (d_j and d_j^2 by the twin's expressions), so
//     bit-equal to the twin's sums: 3 operations a slot. A group with any
//     other window folds those two sums too, d_j * flag and d_j^2 * flag
//     (d * 1 = d, d * 0 adds nothing): 7 a slot. n is the count.
//   * holt_winters: the tested step (hw_step) until every window of the
//     group has seen two samples, then the 4 recurrences interleaved to the
//     window's end: without a test where no window has a gap left, else
//     each step kept only where its slot's flag is set.
//   * A window without a sample (or one, for holt_winters) writes NaN.
// - quantile_over_time (staged route): a warp holds rows_per_warp rows in
//   shared memory and lays its lanes across them, lanes_per_row runs of
//   consecutive output columns a row: as many runs as a power of two that
//   keeps them at least W/2 columns (so no first window's O(W^2) insertion
//   outweighs its run's slides), and as many rows as fill 32 lanes within
//   kQuantWarpBytes. Where fewer rows fit, lanes stay idle rather than the
//   runs shrinking. Over 720 columns on an H100, W = 31: 32 lanes of 23
//   columns beat 16 of 45, 8 of 90 and 4 of 180; W = 361: 2 lanes of 360,
//   two rows a warp, beat runs of 23 (32 lanes, one row: 2.1x slower), 45,
//   90 and 180. Each of the warp's A = rows_per_warp *
//   lanes_per_row lanes keeps its window's valid samples sorted in shared
//   memory (value k of lane i at k * A + i: at A = 32 a warp's lanes never
//   share a bank), so idle lanes take no shared memory.
//   The first window is sorted in registers (a bitonic network, W <= 32) or
//   by insertion. A slide finds the leaving and the entering sample's places
//   by two binary searches side by side and moves the hole the leaving one
//   leaves to the entering one's place: one shift of the values between,
//   four a round with their loads ahead of their stores. Which of two equal
//   values (+0 and -0) leaves does not matter: the interpolation's result
//   does not depend on the sign of a zero it picks.
// - Rows too long for shared memory (device-memory route, also forced by
//   force_global): a block a row, read from device memory, a thread a column
//   walking its W slots (the quantile: a thread a run, windows in a device
//   scratch buffer the wrapper allocates).
//
// Parity. Every f32 step repeats the twin's operations in its order (the
// twin, temporal.py's _linreg_sums / holt_winters / quantile_over_time,
// folds the slots one at a time). Build with -fmad=false (no FMA
// contraction) and without fast math; subnormals are kept, as torch keeps
// them.
//
// Without __CUDACC__ the same per-column and per-run code compiles as host
// C++ (one row at a time, the groups and runs of a row in turn, the bitmask,
// tables and word counts built by the same functions), which the CPU tests
// hold against the PyTorch twin.

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "../../../csrc/launch.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __device__ __forceinline__
#define M3_HDX __host__ __device__ inline
#else
#include <cstring>
#include <vector>
#define M3_HD inline
#define M3_HDX inline
using std::max;
using std::min;
static inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
static inline int __popc(uint32_t x) { return __builtin_popcount(x); }
#endif

namespace {

// The lowest set bit's index of a nonzero word.
M3_HD int ctz32(uint32_t x) {
#ifdef __CUDACC__
  return __ffs(x) - 1;
#else
  return __builtin_ctz(x);
#endif
}

// Function ids, in the order of temporal_window.FUNCTIONS.
enum Fn { DERIV = 0, PREDICT_LINEAR = 1, HOLT_WINTERS = 2, QUANTILE = 3, NUM_FNS };

struct Params {
  float a, b, c, d;
};

constexpr int kCols = 4;               // output columns a thread of the per-column functions
static_assert(kCols % 4 == 0, "a group's first column starts a 16-byte load");
constexpr int kThreads = 256;          // a block of the per-column functions, at most
constexpr int kMaxThreads = 1024;      // a block of the device-memory route's quantile runs
constexpr int kTableMax = 1024;        // longest window with fold tables
constexpr int kQuantWarps = 4;         // warps a block of the staged quantile, at most
constexpr int64_t kQuantWarpBytes = 16384;  // shared memory a quantile warp aims at
constexpr int64_t kFallbackBlocks = 1024;   // grid of the device-memory route

M3_HD float qnan() { return __int_as_float(0x7fc00000); }
M3_HD float qinf() { return __int_as_float(0x7f800000); }

M3_HDX constexpr int64_t round4(int64_t n) { return (n + 3) / 4 * 4; }
M3_HDX constexpr int64_t round32(int64_t n) { return (n + 31) / 32 * 32; }

// Slot j's time from the window's end, as the twin computes it.
M3_HD float slot_d(int j, int w, float step) {
  const float w1 = (float)(w - 1);
  return ((float)j - w1) * step;
}

// ---------------------------------------------------------------------------
// The device-memory route: a thread a column, reading device memory.
// ---------------------------------------------------------------------------

// A row in device memory seen from output column 0: at(i) is input column
// lead + i, NaN before column 0.
struct Row {
  const float* p;
  int lead;
  M3_HD float at(int i) const { return lead + i < 0 ? qnan() : p[lead + i]; }
};

// The least-squares fit of output column t's window (slots t .. t+W-1).
M3_HD void linreg(const Row& row, int t, int w, float step, float& slope, float& icpt) {
  float n = 0.0f, sv = 0.0f, sd = 0.0f, sdd = 0.0f, sdv = 0.0f;
  for (int j = 0; j < w; ++j) {
    const float v = row.at(t + j);
    if (v != v) continue;
    const float d = slot_d(j, w, step);
    n = n + 1.0f;
    sv = sv + v;
    sd = sd + d;
    sdd = sdd + d * d;
    sdv = sdv + d * v;
  }
  const float nn = n > 1.0f ? n : 1.0f;
  const float cov = sdv - sd * sv / nn;
  const float var = sdd - sd * sd / nn;
  const float s = cov / (var == 0.0f ? 1.0f : var);
  const float ic = sv / nn - s * sd / nn;
  const bool good = n >= 2.0f;
  slope = good ? s : qnan();
  icpt = good ? ic : qnan();
}

// holt_winters' state over a window's valid samples: seen counts them up
// to 2 (the trend is set on the second).
struct HW {
  float prev, curr, trend;
  int seen;
};

M3_HD void hw_step(HW& h, float v, const Params& p) {
  if (h.seen == 0) {
    h.curr = v;
    h.seen = 1;
    return;
  }
  const float trend0 = h.seen >= 2 ? h.trend : v - h.curr;
  const float tn = h.seen == 1 ? trend0 : p.c * (h.curr - h.prev) + p.d * trend0;
  const float nc = p.a * v + p.b * (h.curr + tn);
  h.prev = h.curr;
  h.curr = nc;
  h.trend = tn;
  h.seen = 2;
}

// The step of a column that has seen two samples (hw_step's last case).
M3_HD void hw_steady(HW& h, float v, const Params& p) {
  const float tn = p.c * (h.curr - h.prev) + p.d * h.trend;
  const float nc = p.a * v + p.b * (h.curr + tn);
  h.prev = h.curr;
  h.curr = nc;
  h.trend = tn;
}

M3_HD float holt_winters(const Row& row, int t, int w, const Params& p) {
  HW h{0.0f, 0.0f, 0.0f, 0};
  for (int j = 0; j < w; ++j) {
    const float v = row.at(t + j);
    if (v == v) hw_step(h, v, p);
  }
  return h.seen >= 2 ? h.curr : qnan();
}

// One output column of the per-column functions.
template <int FN>
M3_HD float column(const Row& row, int t, int w, const Params& p) {
  if (FN == HOLT_WINTERS) return holt_winters(row, t, w, p);
  float slope, icpt;
  linreg(row, t, w, p.a, slope, icpt);
  return FN == DERIV ? slope : slope * p.b + icpt;
}

// ---------------------------------------------------------------------------
// quantile_over_time: a sorted window slid along a run of output columns.
// ---------------------------------------------------------------------------

// A staged row seen from output column 0: slot i is s[i].
struct Slots {
  const float* s;
  M3_HD float at(int i) const { return s[i]; }
};

// The sorted window: n values in ascending order, place i at a[i * stride]
// (W places).
struct QWin {
  float* a;
  int stride, n, top;  // top: the largest power of two <= W
  M3_HD float& at(int i) const { return a[i * stride]; }
  // the places of u and v: the number of values below each (two
  // branch-free binary searches side by side)
  M3_HD void find2(float u, float v, int& pu, int& pv) const {
    pu = pv = 0;
    for (int step = top; step > 0; step >>= 1) {
      const int iu = pu + step, iv = pv + step;
      if (iu <= n && at(iu - 1) < u) pu = iu;
      if (iv <= n && at(iv - 1) < v) pv = iv;
    }
  }
  // vo leaves (none when NaN; else one value equal to it is present) and vi
  // enters (none when NaN) with one shift: the hole vo leaves (or a new one
  // at the top) moves to vi's place, the values between it and there
  // moving by one. Four values move a round, their loads ahead of their
  // stores.
  M3_HD void slide(float vo, float vi) {
    const bool out = vo == vo, in = vi == vi;
    int p, q;
    find2(vo, vi, p, q);
    if (!out) p = n;
    const int t = !in ? n - (out ? 1 : 0) : q > p ? q - 1 : q;
    const int dir = t > p ? 1 : -1, len = t > p ? t - p : p - t;
    float* h = a + p * stride;
    const int d = dir * stride;
    int k = 0;
    for (; k + 4 <= len; k += 4) {
      const float x0 = h[d], x1 = h[2 * d], x2 = h[3 * d], x3 = h[4 * d];
      h[0] = x0;
      h[d] = x1;
      h[2 * d] = x2;
      h[3 * d] = x3;
      h += 4 * d;
    }
    for (; k < len; ++k, h += d) h[0] = h[d];
    if (in) h[0] = vi;
    n += (in ? 1 : 0) - (out ? 1 : 0);
  }
  M3_HD float emit(int w, const Params& p) const {
    if (n == 0) return qnan();
    if (p.b < 0.0f) return -qinf();
    if (p.b > 0.0f) return qinf();
    const float rank = p.a * (float)(n - 1);
    int lo = (int)floorf(rank);
    lo = max(0, min(lo, w - 1));
    const int hi = min(min(lo + 1, w - 1), n - 1);
    const float frac = rank - (float)lo;
    const float vlo = at(lo), vhi = at(hi);
    return vlo + (vhi - vlo) * frac;
  }
};

M3_HDX int pow2_floor(int w) {
  int c = 1;
  while (2 * c <= w) c <<= 1;
  return c;
}

// The first window of a run (W <= 32) sorted in registers: a bitonic
// network over 32 values, a missing sample as +inf (so after every sample;
// n counts the samples), then the n samples into the window. Equal values
// may trade places, and min/max may give either zero of -0 and +0: no
// output depends on a zero's sign.
template <class R>
M3_HD void sort32(const R& row, int t0, int w, QWin& q) {
  float v[32];
  int n = 0;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
    const float x = j < w ? row.at(t0 + j) : qnan();
    n += x == x ? 1 : 0;
    v[j] = x == x ? x : qinf();
  }
#pragma unroll
  for (int k = 2; k <= 32; k <<= 1)
#pragma unroll
    for (int h = k >> 1; h > 0; h >>= 1)
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int l = i ^ h;
        if (l > i) {
          const float lo = fminf(v[i], v[l]), hi = fmaxf(v[i], v[l]);
          v[i] = (i & k) == 0 ? lo : hi;
          v[l] = (i & k) == 0 ? hi : lo;
        }
      }
#pragma unroll
  for (int j = 0; j < 32; ++j)
    if (j < n) q.at(j) = v[j];
  q.n = n;
}

// Output columns [t0, t1) of one row: the first window sorted (in registers
// up to W = 32, else by insertion), then slid a column at a time. a: W
// places, stride apart.
template <class R>
M3_HD void quantile_run(const R& row, int t0, int t1, int w, const Params& p, float* a,
                        int stride, float* out) {
  QWin q{a, stride, 0, pow2_floor(w)};
  if (w <= 32) {
    sort32(row, t0, w, q);
  } else {
    for (int j = 0; j < w; ++j) q.slide(qnan(), row.at(t0 + j));
  }
  out[t0] = q.emit(w, p);
  for (int t = t0 + 1; t < t1; ++t) {
    q.slide(row.at(t - 1), row.at(t + w - 1));
    out[t] = q.emit(w, p);
  }
}

// ---------------------------------------------------------------------------
// The staged route of the per-column functions.
// ---------------------------------------------------------------------------

// A staged row: slot i is input column first - (W-1) + i (output column o's
// window is slots o .. o+W-1), v[i] its sample or 0, ok[i] 1 where it holds
// one and 0 where not, bit i of mask the same, pre[k] the samples in the
// words before word k.
struct Staged {
  const float* v;
  const float* ok;
  const uint32_t* mask;
  const int* pre;
  M3_HD int before(int i) const {
    return pre[i >> 5] + __popc(mask[i >> 5] & ((1u << (i & 31)) - 1u));
  }
  M3_HD int count(int lo, int hi) const { return before(hi) - before(lo); }
  // the first slot in [i, end) holding a sample (end when none)
  M3_HD int next(int i, int end) const {
    while (i < end) {
      const uint32_t bits = mask[i >> 5] & (~0u << (i & 31));
      if (bits) return min((i & ~31) + ctz32(bits), end);
      i = (i & ~31) + 32;
    }
    return end;
  }
};

// Slot tables: d_j, d_j^2 (round4(W) each), and where on (W <= kTableMax)
// suf[k] / suf2[k], the folds of d_k .. d_{W-1} (and of their squares),
// each from +0 in slot order.
struct Tables {
  float *d, *dd, *suf, *suf2;
  bool on;
};

// The staged route's shared memory, in 4-byte words.
struct Layout {
  int stage;   // staged slots, a multiple of 32 (values, then ok)
  int words;   // mask words (one past the staged slots, always 0)
  int mask;    // offset of the mask words; the word counts follow them
  int pre;
  int tabs;    // offset of the slot tables
  bool tables;
  int total;
};

M3_HDX Layout col_layout(int n_out, int w, int fn) {
  Layout l{};
  l.stage = (int)round32((int64_t)n_out + w + 2 * kCols + 4);
  l.words = l.stage / 32 + 1;
  l.mask = 2 * l.stage;
  l.pre = l.mask + (int)round4(l.words);
  l.tabs = l.pre + (int)round4(l.words);
  l.tables = fn != HOLT_WINTERS && w <= kTableMax;
  int64_t total = l.tabs;
  if (fn != HOLT_WINTERS) total += 2 * round4(w);
  if (l.tables) total += 2 * round4(w);
  l.total = total < 0x7fffffff ? (int)total : 0x7fffffff;
  return l;
}

M3_HD Tables tables_at(float* t, int w, bool on) {
  const int w4 = (int)round4(w);
  return {t, t + w4, t + 2 * w4, t + 3 * w4, on};
}

// Fills the tables, thread tid of nth.
M3_HD void build_tables(float* t, int w, float step, bool on, int tid, int nth) {
  const Tables tb = tables_at(t, w, on);
  for (int j = tid; j < round4(w); j += nth) {
    const float x = j < w ? slot_d(j, w, step) : 0.0f;
    tb.d[j] = x;
    tb.dd[j] = x * x;
  }
  if (!on) return;
  for (int k = tid; k < w; k += nth) {
    float s = 0.0f, s2 = 0.0f;
    for (int j = k; j < w; ++j) {
      const float x = slot_d(j, w, step);
      s = s + x;
      s2 = s2 + x * x;
    }
    tb.suf[k] = s;
    tb.suf2[k] = s2;
  }
}

struct F4 {
  float x, y, z, w;
};

// Four floats from a 16-byte aligned address.
M3_HD F4 ld4(const float* p) {
#ifdef __CUDACC__
  const float4 v = *reinterpret_cast<const float4*>(p);
  return {v.x, v.y, v.z, v.w};
#else
  return {p[0], p[1], p[2], p[3]};
#endif
}

// Walks slots [j, j1) of the group's kCols columns in order, j a multiple
// of 4: s (and, with OK, ok) are the staged values (flags) from the group's
// first column, 16-byte aligned; step(v, m, d, dd) takes one slot's values
// of the columns (v[c] for column c), their flags (with OK) and the slot's
// d_j and d_j^2 (with D). 16-byte loads of kCols + 4 values serve 4 slots of
// all the columns.
template <bool OK, bool D, class Step>
M3_HD void walk4(const float* s, const float* ok, const Tables& tb, int j, int j1, Step step) {
  constexpr int kV = kCols + 4;
  if (j + 4 <= j1) {
    float v[kV], m[kV];
#pragma unroll
    for (int q = 0; q < kCols; q += 4) {
      const F4 a = ld4(s + j + q), ao = OK ? ld4(ok + j + q) : a;
      v[q] = a.x, v[q + 1] = a.y, v[q + 2] = a.z, v[q + 3] = a.w;
      m[q] = ao.x, m[q + 1] = ao.y, m[q + 2] = ao.z, m[q + 3] = ao.w;
    }
#pragma unroll 2
    for (; j + 4 <= j1; j += 4) {
      const F4 b = ld4(s + j + kCols), bo = OK ? ld4(ok + j + kCols) : b;
      v[kCols] = b.x, v[kCols + 1] = b.y, v[kCols + 2] = b.z, v[kCols + 3] = b.w;
      m[kCols] = bo.x, m[kCols + 1] = bo.y, m[kCols + 2] = bo.z, m[kCols + 3] = bo.w;
      const F4 d4 = D ? ld4(tb.d + j) : b, dd4 = D && OK ? ld4(tb.dd + j) : b;
      const float dk[4] = {d4.x, d4.y, d4.z, d4.w}, ddk[4] = {dd4.x, dd4.y, dd4.z, dd4.w};
#pragma unroll
      for (int k = 0; k < 4; ++k) step(v + k, m + k, dk[k], ddk[k]);
#pragma unroll
      for (int q = 0; q < kCols; ++q) v[q] = v[q + 4], m[q] = m[q + 4];
    }
  }
  for (; j < j1; ++j) {
    float v[kCols], m[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) v[c] = s[j + c], m[c] = OK ? ok[j + c] : 0.0f;
    step(v, m, D ? tb.d[j] : 0.0f, D && OK ? tb.dd[j] : 0.0f);
  }
}

// deriv / predict_linear of output columns o .. o+kCols-1. Where every window of
// the group holds its samples in one run at its end, sum d and sum d^2 are
// table entries and the slots fold sum v and sum d*v (3 operations a
// slot); otherwise the slots also fold sum d and sum d^2 with each slot's
// flag (d*1 = d, d*0 adds nothing), 7 a slot.
template <int FN>
M3_HD void linear_group(const Staged& st, const Tables& tb, int o, int w, const Params& p,
                        float res[kCols]) {
  int cnt[kCols];
  float sd[kCols], sdd[kCols], sv[kCols], sdv[kCols];
  int lo = w;
  bool gaps = !tb.on;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int s0 = o + c;
    const int n = st.count(s0, s0 + w);
    cnt[c] = n;
    sd[c] = sdd[c] = sv[c] = sdv[c] = 0.0f;
    if (n == 0 || !tb.on) continue;
    if (st.count(s0 + w - n, s0 + w) == n) {  // the last n slots (or all)
      sd[c] = tb.suf[w - n];
      sdd[c] = tb.suf2[w - n];
      lo = min(lo, w - n);
    } else {
      gaps = true;
    }
  }
  const float *s = st.v + o, *ok = st.ok + o;
  if (gaps) {
#pragma unroll
    for (int c = 0; c < kCols; ++c) sd[c] = sdd[c] = 0.0f;
    walk4<true, true>(s, ok, tb, 0, w, [&](const float* v, const float* m, float dj, float ddj) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        sv[c] = sv[c] + v[c];
        sd[c] = sd[c] + dj * m[c];
        sdd[c] = sdd[c] + ddj * m[c];
        sdv[c] = sdv[c] + dj * v[c];
      }
    });
  } else if (lo < w) {
    walk4<false, true>(s, ok, tb, lo & ~3, w, [&](const float* v, const float*, float dj, float) {
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        sv[c] = sv[c] + v[c];
        sdv[c] = sdv[c] + dj * v[c];
      }
    });
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const float n = (float)cnt[c];
    const float nn = n > 1.0f ? n : 1.0f;
    const float cov = sdv[c] - sd[c] * sv[c] / nn;
    const float var = sdd[c] - sd[c] * sd[c] / nn;
    const float sl = cov / (var == 0.0f ? 1.0f : var);
    const float ic = sv[c] / nn - sl * sd[c] / nn;
    const bool good = n >= 2.0f;
    const float slope = good ? sl : qnan();
    const float icpt = good ? ic : qnan();
    res[c] = FN == DERIV ? slope : slope * p.b + icpt;
  }
}

// holt_winters of output columns o .. o+kCols-1: the tested step (hw_step) until
// every window of the group has seen two samples, then the 4 recurrences
// interleaved to the window's end, without a test where no window has a
// gap left, else each step kept only where its slot holds a sample.
M3_HD void holt_group(const Staged& st, const Tables& tb, int o, int w, const Params& p,
                      float res[kCols]) {
  bool on[kCols];
  int lo = w, steady = 0;
#pragma unroll
  for (int c = 0; c < kCols; ++c) {
    const int s0 = o + c;
    on[c] = st.count(s0, s0 + w) >= 2;
    if (!on[c]) continue;
    const int f1 = st.next(s0, s0 + w);
    lo = min(lo, f1 - s0);
    steady = max(steady, st.next(f1 + 1, s0 + w) - s0 + 1);
  }
  HW h[kCols];
#pragma unroll
  for (int c = 0; c < kCols; ++c) h[c] = {0.0f, 0.0f, 0.0f, 0};
  if (lo < w) {
    const int s4 = min((steady + 3) & ~3, w);
    const float* s = st.v + o;
    const float* ok = st.ok + o;
    for (int j = lo; j < s4; ++j)
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (on[c] && ok[j + c] != 0.0f) hw_step(h[c], s[j + c], p);
    bool gaps = false;
#pragma unroll
    for (int c = 0; c < kCols; ++c)
      gaps |= on[c] && st.count(o + c + s4, o + c + w) != w - s4;
    if (!gaps) {
      walk4<false, false>(s, ok, tb, s4, w, [&](const float* v, const float*, float, float) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) hw_steady(h[c], v[c], p);
      });
    } else {
      walk4<true, false>(s, ok, tb, s4, w, [&](const float* v, const float* m, float, float) {
#pragma unroll
        for (int c = 0; c < kCols; ++c) {
          const float tn = p.c * (h[c].curr - h[c].prev) + p.d * h[c].trend;
          const float nc = p.a * v[c] + p.b * (h[c].curr + tn);
          const bool take = m[c] != 0.0f;
          h[c].prev = take ? h[c].curr : h[c].prev;
          h[c].curr = take ? nc : h[c].curr;
          h[c].trend = take ? tn : h[c].trend;
        }
      });
    }
  }
#pragma unroll
  for (int c = 0; c < kCols; ++c) res[c] = on[c] ? h[c].curr : qnan();
}

template <int FN>
M3_HD void column_group(const Staged& st, const Tables& tb, int o, int w, const Params& p,
                        float res[kCols]) {
  if (FN == HOLT_WINTERS) holt_group(st, tb, o, w, p, res);
  else linear_group<FN>(st, tb, o, w, p, res);
}

// ---------------------------------------------------------------------------
// Plans.
// ---------------------------------------------------------------------------

// The staged quantile's layout.
struct QShape {
  int lanes;       // lanes a row
  int rows;        // rows a warp
  int run;         // output columns a lane
  int stage;       // staged slots a row
  int warp_words;  // shared memory a warp, in 4-byte words
  M3_HDX int active() const { return rows * lanes; }  // lanes with a run (<= 32)
};

QShape quantile_shape(int n_out, int w, int run) {
  QShape q{};
  const int min_run = (n_out + 31) / 32;
  int lanes;
  if (run > 0) {
    q.run = std::max(run, min_run);
    lanes = (n_out + q.run - 1) / q.run;
  } else {
    // the most runs of at least W/2 columns, a power of two
    lanes = 1;
    while (lanes < 32 && (int64_t)lanes * (w + 1) <= n_out) lanes *= 2;
    q.run = (n_out + lanes - 1) / lanes;
  }
  q.lanes = lanes;
  q.rows = std::max(1, 32 / lanes);
  q.stage = (int)round4((int64_t)n_out + w - 1);
  // a row's slots and its lanes' windows
  auto words = [&](int rows) { return (int64_t)rows * (q.stage + (int64_t)lanes * w); };
  while (q.rows > 1 && words(q.rows) * 4 > kQuantWarpBytes) q.rows /= 2;
  q.warp_words = (int)std::min<int64_t>(words(q.rows), 0x7fffffff);
  return q;
}

// How a launch is laid out.
struct Plan {
  int threads;        // a block
  int run;            // output columns a thread (the quantile's: a lane's run)
  bool staged;        // the row (and the windows) in shared memory
  int64_t smem;       // bytes of shared memory a block
  int64_t grid;       // blocks (before the persistent grid's cap)
  int64_t scratch;    // bytes of device scratch (the device-memory route's windows)
  bool tables;        // the linear functions' fold tables
  QShape q;
};

// run: the quantile's columns a thread (0: the kernel's choice).
// force_global: take the device-memory route whatever the row's length.
Plan make_plan(int64_t rows, int cols, int first, int w, int fn, int run, bool force_global) {
  Plan pl{};
  const int n_out = cols - first;
  if (!force_global) {
    if (fn == QUANTILE) {
      pl.q = quantile_shape(n_out, w, run);
      const int64_t warp_bytes = (int64_t)pl.q.warp_words * 4;
      const int warps = (int)std::min<int64_t>(kQuantWarps, (int64_t)m3::kSmemMax / warp_bytes);
      if (warps >= 1) {
        pl.staged = true;
        pl.threads = warps * 32;
        pl.run = pl.q.run;
        pl.smem = warps * warp_bytes;
        const int64_t groups = (rows + pl.q.rows - 1) / pl.q.rows;
        pl.grid = (groups + warps - 1) / warps;
      }
    } else {
      const Layout l = col_layout(n_out, w, fn);
      if ((int64_t)l.total * 4 <= (int64_t)m3::kSmemMax) {
        pl.staged = true;
        pl.threads = (int)std::min<int64_t>(kThreads, std::max<int64_t>(32, round32((n_out + kCols - 1) / kCols)));
        pl.run = kCols;
        pl.smem = (int64_t)l.total * 4;
        pl.tables = l.tables;
        pl.grid = rows;
      }
    }
  }
  if (!pl.staged) {
    if (fn == QUANTILE) {
      const int min_run = (n_out + kMaxThreads - 1) / kMaxThreads;
      pl.run = run > 0 ? std::max(run, min_run) : std::max(w, min_run);
      const int active = (n_out + pl.run - 1) / pl.run;
      pl.threads = std::min(kMaxThreads, (active + 31) / 32 * 32);
    } else {
      pl.run = 1;
      pl.threads = std::min(kThreads, (n_out + 31) / 32 * 32);
    }
    pl.grid = std::min<int64_t>(rows, kFallbackBlocks);
    pl.scratch = fn == QUANTILE ? pl.grid * pl.threads * w * 4 : 0;
  }
  pl.grid = std::min<int64_t>(pl.grid, 0x7fffffff);
  return pl;
}

bool valid_args(int cols, int first, int w, int fn) {
  return cols >= 0 && first >= 0 && first <= cols && w > 0 && fn >= 0 && fn < NUM_FNS;
}

#ifdef __CUDACC__
// The staged per-column kernel: a block a row at a time, persistent.
template <int FN>
__global__ void __launch_bounds__(kThreads)
    window_staged_kernel(const float* __restrict__ x, int64_t rows, int cols, int first, int w,
                         Params p, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int n_out = cols - first;
  const Layout l = col_layout(n_out, w, FN);
  uint32_t* mask = reinterpret_cast<uint32_t*>(smem + l.mask);
  int* pre = reinterpret_cast<int*>(smem + l.pre);
  const Tables tb = tables_at(smem + l.tabs, w, l.tables);
  if (FN != HOLT_WINTERS) build_tables(smem + l.tabs, w, p.a, l.tables, threadIdx.x, blockDim.x);
  if (threadIdx.x == 0) mask[l.words - 1] = 0u;
  const Staged st{smem, smem + l.stage, mask, pre};
  const int lead = first - (w - 1);
  const int lane = threadIdx.x & 31;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const float* xr = x + r * cols;
    __syncthreads();  // the previous row's readers (and the tables' writers) are done
    for (int i = threadIdx.x; i < l.stage; i += blockDim.x) {
      const int in = lead + i;
      const float v = in >= 0 && in < cols ? xr[in] : qnan();
      const bool ok = v == v;
      smem[i] = ok ? v : 0.0f;
      smem[l.stage + i] = ok ? 1.0f : 0.0f;
      const unsigned bits = __ballot_sync(0xffffffffu, ok);
      if (lane == 0) mask[i >> 5] = bits;
    }
    __syncthreads();
    if (threadIdx.x < 32) {  // each word's running count
      int carry = 0;
      for (int base = 0; base < l.words; base += 32) {
        const int k = base + lane;
        const int c = k < l.words ? __popc(mask[k]) : 0;
        int incl = c;
#pragma unroll
        for (int d = 1; d < 32; d <<= 1) {
          const int t = __shfl_up_sync(0xffffffffu, incl, d);
          if (lane >= d) incl += t;
        }
        if (k < l.words) pre[k] = carry + incl - c;
        carry += __shfl_sync(0xffffffffu, incl, 31);
      }
    }
    __syncthreads();
    float* orow = out + r * n_out;
    for (int g = threadIdx.x; g * kCols < n_out; g += blockDim.x) {
      const int o = g * kCols;
      float res[kCols];
      column_group<FN>(st, tb, o, w, p, res);
#pragma unroll
      for (int c = 0; c < kCols; ++c)
        if (o + c < n_out) orow[o + c] = res[c];
    }
  }
}

// The staged quantile: each warp its rows_per_warp rows at a time, persistent.
__global__ void __launch_bounds__(kQuantWarps * 32)
    quantile_staged_kernel(const float* __restrict__ x, int64_t rows, int cols, int first, int w,
                           Params p, QShape q, float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5, warps = blockDim.x >> 5;
  float* stage = smem + (int64_t)warp * q.warp_words;
  float* win = stage + (int64_t)q.rows * q.stage;
  const int n_out = cols - first, lead = first - (w - 1);
  const int g = lane / q.lanes, t0 = (lane % q.lanes) * q.run, stride = q.active();
  const int64_t groups = (rows + q.rows - 1) / q.rows;
  for (int64_t rg = (int64_t)blockIdx.x * warps + warp; rg < groups;
       rg += (int64_t)gridDim.x * warps) {
    __syncwarp();  // the previous rows' readers are done
    for (int k = 0; k < q.rows; ++k) {
      const int64_t r = rg * q.rows + k;
      const float* xr = x + r * cols;
      for (int i = lane; i < q.stage; i += 32) {
        const int in = lead + i;
        stage[k * q.stage + i] = r < rows && in >= 0 && in < cols ? xr[in] : qnan();
      }
    }
    __syncwarp();
    const int64_t r = rg * q.rows + g;
    if (g < q.rows && r < rows && t0 < n_out)
      quantile_run(Slots{stage + g * q.stage}, t0, min(t0 + q.run, n_out), w, p, win + lane,
                   stride, out + r * n_out);
  }
}

// The device-memory route: a block a row, read from device memory.
template <int FN>
__global__ void __launch_bounds__(kMaxThreads)
    window_global_kernel(const float* __restrict__ x, int64_t rows, int cols, int first, int w,
                         Params p, int run, float* __restrict__ out, float* __restrict__ scratch) {
  const int n_out = cols - first;
  float* win = scratch + (int64_t)blockIdx.x * blockDim.x * w;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const Row row{x + r * cols, first - (w - 1)};
    float* orow = out + r * n_out;
    if (FN == QUANTILE) {
      const int t0 = threadIdx.x * run;
      if (t0 < n_out)
        quantile_run(row, t0, min(t0 + run, n_out), w, p, win + threadIdx.x, blockDim.x, orow);
    } else {
      for (int t = threadIdx.x; t < n_out; t += blockDim.x) orow[t] = column<FN>(row, t, w, p);
    }
  }
}

// The staged kernel of fn, its grid capped at the blocks the card holds at
// once (the persistent grid); sets its shared memory limit.
template <int FN>
cudaError_t staged_grid(const Plan& pl, int64_t* grid) {
  int64_t resident = 0;
  cudaError_t e;
  if constexpr (FN == QUANTILE)
    e = m3::resident_blocks(quantile_staged_kernel, pl.threads, (size_t)pl.smem, &resident);
  else
    e = m3::resident_blocks(window_staged_kernel<FN>, pl.threads, (size_t)pl.smem, &resident);
  *grid = std::min(pl.grid, resident);
  return e;
}

cudaError_t staged_grid_fn(int fn, const Plan& pl, int64_t* grid) {
  switch (fn) {
    case DERIV: return staged_grid<DERIV>(pl, grid);
    case PREDICT_LINEAR: return staged_grid<PREDICT_LINEAR>(pl, grid);
    case HOLT_WINTERS: return staged_grid<HOLT_WINTERS>(pl, grid);
    default: return staged_grid<QUANTILE>(pl, grid);
  }
}

template <int FN>
int launch(const float* x, int64_t rows, int cols, int first, int w, const Params& p,
           const Plan& pl, float* out, float* scratch, cudaStream_t stream) {
  if (pl.staged) {
    int64_t grid = 0;
    const cudaError_t e = staged_grid<FN>(pl, &grid);
    if (e != cudaSuccess) return (int)e;
    if constexpr (FN == QUANTILE)
      quantile_staged_kernel<<<(unsigned)grid, pl.threads, (size_t)pl.smem, stream>>>(
          x, rows, cols, first, w, p, pl.q, out);
    else
      window_staged_kernel<FN><<<(unsigned)grid, pl.threads, (size_t)pl.smem, stream>>>(
          x, rows, cols, first, w, p, out);
  } else {
    window_global_kernel<FN><<<(unsigned)pl.grid, pl.threads, 0, stream>>>(
        x, rows, cols, first, w, p, pl.run, out, scratch);
  }
  return (int)cudaGetLastError();
}
#endif

}  // namespace

#ifdef __CUDACC__
// B-7 over f32 [rows, cols] x into f32 [rows, cols - first] out (output
// columns first .. cols-1) on `stream`. fn: the function id; a-d its
// parameters; run: the quantile's columns a thread (0: the kernel's);
// force_global: the device-memory route. scratch holds
// m3_temporal_window_scratch_bytes(...) bytes (may be null when that is 0).
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int m3_temporal_window(const float* x, int64_t rows, int cols, int window, int first,
                                  int fn, float a, float b, float c, float d, int run,
                                  int force_global, float* out, float* scratch,
                                  int64_t scratch_bytes, void* stream) {
  if (!valid_args(cols, first, window, fn) || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == first) return (int)cudaGetLastError();
  const Plan pl = make_plan(rows, cols, first, window, fn, run, force_global != 0);
  if (pl.scratch > scratch_bytes || (pl.scratch > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params p{a, b, c, d};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (fn) {
    case DERIV: return launch<DERIV>(x, rows, cols, first, window, p, pl, out, scratch, s);
    case PREDICT_LINEAR:
      return launch<PREDICT_LINEAR>(x, rows, cols, first, window, p, pl, out, scratch, s);
    case HOLT_WINTERS:
      return launch<HOLT_WINTERS>(x, rows, cols, first, window, p, pl, out, scratch, s);
    default: return launch<QUANTILE>(x, rows, cols, first, window, p, pl, out, scratch, s);
  }
}
#endif

// Bytes of device scratch m3_temporal_window needs at this shape (0 when the
// row fits in shared memory), or -1 for arguments it does not take.
extern "C" int64_t m3_temporal_window_scratch_bytes(int64_t rows, int cols, int window, int first,
                                                    int fn, int run, int force_global) {
  if (!valid_args(cols, first, window, fn) || rows < 0) return -1;
  if (rows == 0 || cols == first) return 0;
  return make_plan(rows, cols, first, window, fn, run, force_global != 0).scratch;
}

// The launch's layout, into out int64[9]: threads a block, output columns a
// thread (the quantile's run), staged (1) or not (0), shared memory bytes a
// block, blocks (the card's persistent grid in the card build), scratch
// bytes, the quantile's rows a warp and lanes a row (0 otherwise), fold
// tables (1) or not (0). Returns nonzero for a shape it does not launch.
extern "C" int m3_temporal_window_shape(int64_t rows, int cols, int window, int first, int fn,
                                        int run, int force_global, int64_t* out) {
  if (!valid_args(cols, first, window, fn) || rows <= 0 || cols == first) return 1;
  const Plan pl = make_plan(rows, cols, first, window, fn, run, force_global != 0);
  int64_t grid = pl.grid;
#ifdef __CUDACC__
  if (pl.staged && staged_grid_fn(fn, pl, &grid) != cudaSuccess) return 2;
#endif
  out[0] = pl.threads;
  out[1] = pl.run;
  out[2] = pl.staged ? 1 : 0;
  out[3] = pl.smem;
  out[4] = grid;
  out[5] = pl.scratch;
  out[6] = pl.staged && fn == QUANTILE ? pl.q.rows : 0;
  out[7] = pl.staged && fn == QUANTILE ? pl.q.lanes : 0;
  out[8] = pl.tables ? 1 : 0;
  return 0;
}

#ifndef __CUDACC__
// Host build of the same code, one row at a time: the staged route builds
// the row's slots, mask, word counts and tables as the kernel does and runs
// its groups (or the quantile's runs, each window in a buffer of its own,
// stride 1) in turn; the device-memory route runs its per-column code.
extern "C" int m3_temporal_window_host(const float* x, int64_t rows, int cols, int window,
                                       int first, int fn, float a, float b, float c, float d,
                                       int run, int force_global, float* out) {
  if (!valid_args(cols, first, window, fn) || rows < 0) return 1;
  if (rows == 0 || cols == first) return 0;
  const Plan pl = make_plan(rows, cols, first, window, fn, run, force_global != 0);
  const Params p{a, b, c, d};
  const int w = window, n_out = cols - first, lead = first - (w - 1);
  auto value = [&](int64_t r, int i) { return lead + i >= 0 && lead + i < cols ? x[r * cols + lead + i] : std::nanf(""); };
  if (!pl.staged) {
    std::vector<float> win((size_t)w);
    for (int64_t r = 0; r < rows; ++r) {
      const Row row{x + r * cols, lead};
      float* orow = out + r * n_out;
      for (int t = 0; t < n_out; ++t) {
        if (fn == QUANTILE) {
          if (t % pl.run == 0) quantile_run(row, t, min(t + pl.run, n_out), w, p, win.data(), 1, orow);
          continue;
        }
        switch (fn) {
          case DERIV: orow[t] = column<DERIV>(row, t, w, p); break;
          case PREDICT_LINEAR: orow[t] = column<PREDICT_LINEAR>(row, t, w, p); break;
          default: orow[t] = column<HOLT_WINTERS>(row, t, w, p); break;
        }
      }
    }
    return 0;
  }
  if (fn == QUANTILE) {
    std::vector<float> stage((size_t)pl.q.stage), win((size_t)w);
    for (int64_t r = 0; r < rows; ++r) {
      for (int i = 0; i < pl.q.stage; ++i) stage[i] = value(r, i);
      for (int l = 0; l < pl.q.lanes; ++l) {
        const int t0 = l * pl.q.run;
        if (t0 < n_out)
          quantile_run(Slots{stage.data()}, t0, min(t0 + pl.q.run, n_out), w, p, win.data(), 1,
                       out + r * n_out);
      }
    }
    return 0;
  }
  const Layout l = col_layout(n_out, w, fn);
  std::vector<float> smem((size_t)l.total + 4);
  float* sm = smem.data();
  uint32_t* mask = reinterpret_cast<uint32_t*>(sm + l.mask);
  int* pre = reinterpret_cast<int*>(sm + l.pre);
  if (fn != HOLT_WINTERS) build_tables(sm + l.tabs, w, p.a, l.tables, 0, 1);
  const Tables tb = tables_at(sm + l.tabs, w, l.tables);
  const Staged st{sm, sm + l.stage, mask, pre};
  for (int64_t r = 0; r < rows; ++r) {
    for (int k = 0; k < l.words; ++k) mask[k] = 0u;
    for (int i = 0; i < l.stage; ++i) {
      const float v = value(r, i);
      const bool ok = v == v;
      sm[i] = ok ? v : 0.0f;
      sm[l.stage + i] = ok ? 1.0f : 0.0f;
      if (ok) mask[i >> 5] |= 1u << (i & 31);
    }
    for (int k = 0, carry = 0; k < l.words; ++k) {
      pre[k] = carry;
      carry += __popc(mask[k]);
    }
    float* orow = out + r * n_out;
    for (int o = 0; o < n_out; o += kCols) {
      float res[kCols];
      switch (fn) {
        case DERIV: column_group<DERIV>(st, tb, o, w, p, res); break;
        case PREDICT_LINEAR: column_group<PREDICT_LINEAR>(st, tb, o, w, p, res); break;
        default: column_group<HOLT_WINTERS>(st, tb, o, w, p, res); break;
      }
      for (int k = 0; k < kCols && o + k < n_out; ++k) orow[o + k] = res[k];
    }
  }
  return 0;
}
#endif
