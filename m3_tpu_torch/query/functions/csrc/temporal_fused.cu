// Fused temporal functions over a range matrix (kernel B2): the CUDA port of
// the Pallas kernel m3_tpu/query/functions/temporal_fused.py:_fused_call (its
// inline `kernel`), which evaluates up to 15 FUSABLE temporal functions over
// one f32 [S, T] matrix in one pass, one f32 [S, T] output per function.
//
// What it computes. For output column t of a row, the window is the input
// columns [a, t], a = max(0, t - w + 1); NaN marks a missing sample. The
// functions and their NaN gates are those of
// m3_tpu/query/functions/temporal.py: sum/count/avg/min/max/last_over_time
// (NaN without a valid sample), stdvar/stddev_over_time (NaN below two; the
// row's nanmean is subtracted first, as the reference does), rate /
// increase / delta (two valid samples; counter corrections at resets, the
// zero-point clamp and extrapolation of rate.go), irate / idelta (the last
// two valid samples, both inside the window) and resets / changes (pairs of
// consecutive valid samples; NaN unless a valid sample follows the window's
// first slot).
//
// Bound. Memory: each input read once and each output written once, 4
// bytes each; per function f32[S, T] in + out (0.581 GB at S=100000, T=726:
// 0.173 ms at 3.35 TB/s). The arithmetic is a few f32 operations per
// element and log2(w) tree levels, far below the card's rate.
//
// Design, and what each choice is for:
// - One warp per row, persistent CTAs of kMaxWarps warps walking the rows
//   (row += gridDim.x * warps), two waves of them (kGridWaves). One CTA
//   per row, the earlier design, paid a block reduction and a
//   __syncthreads per row and left a third of its threads idle on the last
//   columns; a warp owns its row and synchronises with __syncwarp only.
// - Each warp double-buffers its rows in shared memory: the next row's
//   cp.async copies (4 bytes a lane, neighbouring lanes on neighbouring
//   addresses, so a warp's request is one contiguous 128-byte run whatever
//   the row's 4- or 8-byte alignment) are started before this row is
//   computed, so its load overlaps this row's work. Every pointer into
//   shared memory derives from the kernel's own `smem`, so the compiler
//   emits shared loads (LDS), not generic ones; rows too long for shared
//   memory run a second instantiation over a device scratch buffer.
// - The kernel is a template over the state groups a call needs (Group):
//   the wrapper's function ids pick one instantiation, so a one-function
//   call carries only its own state (avg_over_time: valid counts and one
//   windowed sum; rate: valid indices and the correction amounts) and
//   takes the row's nanmean only for stddev/stdvar. Each requested
//   function is written by its own loop (emit_fn), so the loop body is
//   that function's code alone and the compiler overlaps columns.
// - Counts and indices cost 1/32 of a row: one ballot per 32 columns gives
//   the chunk's valid bits, and the chunk's valid count, last valid index
//   and reset/change bits and counts are kept per chunk; the count, last
//   or first valid index and event count at any column follow from one
//   chunk word and a popcount / clz / ffs. Counts are exact, as the
//   reference's float sums of 0/1 values are below 2^24.
// - Windowed sums, min and max repeat the reference's doubling tree
//   (_win_reduce: acc_{m+1}[t] = op(acc_m[t - 2^m], acc_m[t]), the window
//   assembled from the levels of w's set bits, lowest first). For w <= 16
//   (kDirectMax; PromQL's [1m] at a 10 s step is 7) each column reduces
//   its own leaves in registers in that order (direct_reduce), with no
//   per-row arrays at all; longer windows run the tree over the row in
//   shared memory, in place and descending, O(T log w). The row and the
//   amounts have 32 fill words before column 0, so leaves need no bounds
//   test. Repeating the reference's order makes every function but
//   stddev/stdvar equal the twin bit for bit on the CPU; those two differ
//   only through the row's nanmean, summed here in another order than
//   torch.nanmean (5e-3 abs, TOLERANCE.md).
// - rate / increase / delta: _rate_impl's four divisions depend, apart
//   from the counter's zero-point clamp, only on the distances from the
//   column to the window's first and last valid samples. Each block fills
//   a table of those (Geo, up to 16 x 16 entries) with the formula's own
//   code, and a column multiplies its result by one entry. The exact
//   formula runs only where the distances fall outside the table or the
//   clamp may apply (surely_unclamped decides that from exact-enough
//   products, without dividing): a divergent branch that real windows
//   rarely take. The values are the formula's bit for bit.
// - Functions that locate the window's valid samples (rate, irate, last,
//   ...) gate on those indices, not on a count: two fewer chunk lookups.
// - Outputs: lane l writes columns l, l + 32, ..., so every store of a warp
//   is one contiguous run.
//
// Parity. Every f32 step repeats the reference's operations in its order.
// Build with -fmad=false (no FMA contraction) and without fast math;
// subnormals are kept, as torch keeps them.
//
// Without __CUDACC__ the same row code compiles as host C++ (one "lane",
// the warp primitives as sequential loops), which the CPU tests hold
// against the PyTorch twin.

#include <cmath>
#include <cstdint>
#include <type_traits>

#include "../../../csrc/launch.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __device__ __forceinline__
#define M3_HDX __host__ __device__ inline
#define M3_LANE ((int)(threadIdx.x & 31u))
#define M3_STEP 32
#define M3_SYNC() __syncwarp()
#else
#include <cstring>
#include <vector>
#define M3_HD inline
#define M3_HDX inline
#define M3_LANE 0
#define M3_STEP 1
#define M3_SYNC() ((void)0)
static inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
#endif

namespace {

// Function ids, in the order of temporal_fused.FUNCTIONS.
enum Fn {
  RATE = 0, IRATE, INCREASE, DELTA, IDELTA, RESETS, CHANGES, SUM_OT, COUNT_OT, AVG_OT,
  MIN_OT, MAX_OT, LAST_OT, STDDEV_OT, STDVAR_OT, NUM_FNS
};

constexpr int kMaxOuts = NUM_FNS;

struct Outs {
  float* p[kMaxOuts];
  int fn[kMaxOuts];
  int n;
};

// State groups: which per-row arrays and trees an instantiation builds.
enum Group {
  G_LV = 1,      // last valid index <= t
  G_NV = 2,      // first valid index >= t
  G_ERES = 4,    // prefix count of resets
  G_ECHG = 8,    // prefix count of changes
  G_SUM = 16,    // sum tree
  G_MIN = 32,    // min tree
  G_MAX = 64,    // max tree
  G_CORR = 128,  // counter-correction tree (rate, increase)
  G_STD = 256,   // nanmean, then sum and sum-of-squares trees about it
  G_ALL = 511
};

// The state groups each function needs (count is always built).
M3_HDX constexpr int fn_groups(int fn) {
  return fn == COUNT_OT ? 0
       : (fn == LAST_OT || fn == IRATE || fn == IDELTA) ? G_LV
       : fn == DELTA ? G_LV | G_NV
       : (fn == RATE || fn == INCREASE) ? G_LV | G_NV | G_CORR
       : fn == RESETS ? G_LV | G_NV | G_ERES
       : fn == CHANGES ? G_LV | G_NV | G_ECHG
       : (fn == SUM_OT || fn == AVG_OT) ? G_SUM
       : fn == MIN_OT ? G_MIN
       : fn == MAX_OT ? G_MAX
       : G_STD;
}

// The instantiations: one per single-function group set, and G_ALL for any
// other set of functions.
constexpr int kInstances[] = {
  0, G_LV, G_LV | G_NV, G_LV | G_NV | G_CORR, G_LV | G_NV | G_ERES, G_LV | G_NV | G_ECHG,
  G_SUM, G_MIN, G_MAX, G_STD, G_ALL
};

inline int select_groups(const int* fns, int nfn) {
  int g = 0;
  for (int i = 0; i < nfn; ++i) g |= fn_groups(fns[i]);
  for (int m : kInstances)
    if (m == g) return g;
  return G_ALL;
}

// Calls run(std::integral_constant<int, G>) for the instantiation g.
template <class Run>
int dispatch(int g, Run&& run) {
  using std::integral_constant;
  switch (g) {
    case 0: return run(integral_constant<int, 0>());
    case G_LV: return run(integral_constant<int, G_LV>());
    case G_LV | G_NV: return run(integral_constant<int, G_LV | G_NV>());
    case G_LV | G_NV | G_CORR: return run(integral_constant<int, G_LV | G_NV | G_CORR>());
    case G_LV | G_NV | G_ERES: return run(integral_constant<int, G_LV | G_NV | G_ERES>());
    case G_LV | G_NV | G_ECHG: return run(integral_constant<int, G_LV | G_NV | G_ECHG>());
    case G_SUM: return run(integral_constant<int, G_SUM>());
    case G_MIN: return run(integral_constant<int, G_MIN>());
    case G_MAX: return run(integral_constant<int, G_MAX>());
    case G_STD: return run(integral_constant<int, G_STD>());
    default: return run(integral_constant<int, G_ALL>());
  }
}

// Windows of at most kDirectMax steps are reduced per output column
// straight from the row (the reference's tree over at most 16 leaves, in
// registers); longer ones run the tree over whole rows in place.
constexpr int kDirectMax = 16;
constexpr int kPad = 32;  // words before column 0 of the row and of the float buffers
constexpr int kUnroll = 4;  // columns in flight in an output loop
static_assert(kDirectMax >= 0 && kDirectMax < 32, "direct windows use bits 0..4");

// Per-row arrays of an instantiation: float buffers of `cols` words (the
// tree's levels and results acc, V, V2; in direct mode only the correction
// amounts of rate/increase), then per-chunk words (chunks of 32 columns):
// the valid bits, the valid count and last valid index before the chunk,
// the first valid index after it, and the reset / change bits and counts
// before the chunk. Counts and indices at any column follow from a chunk's
// words and a popcount, so they take 1/32 of a row each.
template <int G>
struct Layout {
  static constexpr int chunk_words =
      3 + ((G & G_NV) ? 1 : 0) + ((G & G_ERES) ? 2 : 0) + ((G & G_ECHG) ? 2 : 0);
  static constexpr int tree_floats =
      ((G & (G_SUM | G_MIN | G_MAX | G_CORR | G_STD)) ? 2 : 0) + ((G & G_STD) ? 1 : 0);
  static constexpr int direct_floats = (G & G_CORR) ? 1 : 0;
  static M3_HDX int floats(int window) {
    return window <= kDirectMax ? direct_floats : tree_floats;
  }
  // words of one row's arrays (the row itself not included): each float
  // buffer kPad words before column 0, each chunk array one chunk before
  static M3_HDX int64_t words(int cols, int window) {
    return (int64_t)floats(window) * (cols + kPad) + (int64_t)chunk_words * ((cols + 31) / 32 + 1);
  }
};

// The stage at which a function's output is written: after the prefix
// passes (no tree), or after its tree.
enum Stage { S_NONE = 0, S_SUM, S_MIN, S_MAX, S_CORR, S_STD };

M3_HDX constexpr int stage_of(int fn) {
  switch (fn) {
    case SUM_OT: case AVG_OT: return S_SUM;
    case MIN_OT: return S_MIN;
    case MAX_OT: return S_MAX;
    case RATE: case INCREASE: return S_CORR;
    case STDDEV_OT: case STDVAR_OT: return S_STD;
    default: return S_NONE;
  }
}

M3_HD float qnan() { return __int_as_float(0x7FC00000); }
M3_HD float pos_inf() { return __int_as_float(0x7F800000); }

// _rate_impl's extrapolation at one column depends on the data only through
// dl = t - li and df = t - fi (the distances from the column to the
// window's last and first valid samples) and, for counters, through the
// zero-point clamp. A table of kGeoMax x kGeoMax entries, filled once per
// block by the same code, holds for each (dl, df) the factor that the
// unclamped extrapolation multiplies the result by, and what the clamp
// test needs: rate / increase / delta then cost one multiply (rate: and
// the division by the range) instead of four divisions.
constexpr int kGeoMax = 16;
struct alignas(16) Geo {
  float factor;    // extrap / max(sampled_interval, 1e-30), unclamped
  float interval;  // sampled_interval
  float to_start;  // duration_to_start, unclamped
  float may_clamp; // 0 where the zero-point clamp cannot apply
};

// Instantiations that may evaluate rate / increase / delta build the table.
M3_HDX constexpr bool uses_geo(int G) {
  return G == G_ALL || ((G & G_NV) && !(G & (G_ERES | G_ECHG)));
}
// The table's side K (entries K x K) and its first df: dl in [0, K), df in
// [df0, df0 + K). Windows of at most kGeoMax steps are covered whole.
M3_HDX int geo_side(int window) { return window < kGeoMax ? window : kGeoMax; }
M3_HDX int geo_df0(int window) { return window > kGeoMax ? window - kGeoMax : 0; }
template <int G>
M3_HDX int geo_words(int window) {
  return uses_geo(G) ? geo_side(window) * geo_side(window) * 4 : 0;
}

// One row and its arrays: per chunk j of 32 columns, vm[j] (valid bits),
// vb[j] / lb[j] (valid samples / last valid index before the chunk), na[j]
// (first valid index after it), rm/cm[j] (reset / change bits: a valid
// sample below / unequal to the previous valid one) and rb/cb[j] (those
// events before the chunk); -1 is "none". acc: tree levels or correction
// amounts; V, V2: the windowed results of the current stage. geo: the
// extrapolation table (uses_geo), side geo_k, first df geo_df0.
struct Row {
  const float* x;
  unsigned *vm, *rm, *cm;
  int *vb, *lb, *na, *rb, *cb;
  float *acc, *V, *V2;
  const Geo* geo;
  int cols, window, geo_k, geo_df0;
  float step, duration, base;
  bool direct;  // window <= kDirectMax: no tree arrays
};

#ifdef __CUDACC__
M3_HD int m3_popc(unsigned v) { return __popc(v); }
M3_HD int m3_clz(unsigned v) { return __clz((int)v); }
M3_HD int m3_ffs(unsigned v) { return __ffs((int)v); }
#else
inline int m3_popc(unsigned v) { return __builtin_popcount(v); }
inline int m3_clz(unsigned v) { return v ? __builtin_clz(v) : 32; }
inline int m3_ffs(unsigned v) { return __builtin_ffs((int)v); }
#endif

M3_HD unsigned le_mask(int b) { return (2u << b) - 1u; }  // bits 0..b

// Chunk -1 (columns -32 .. -1) holds no valid sample and no event, so the
// helpers take t >= -32 without a test.

// valid samples in [0, t]
M3_HD int count_to(const Row& R, int t) {
  const int j = t >> 5;
  return R.vb[j] + m3_popc(R.vm[j] & le_mask(t & 31));
}

// last valid index <= t, -1 none
M3_HD int last_valid(const Row& R, int t) {
  const int j = t >> 5;
  const unsigned m = R.vm[j] & le_mask(t & 31);
  return m ? (j << 5) + 31 - m3_clz(m) : R.lb[j];
}

// first valid index >= a (a >= 0), -1 none
M3_HD int first_valid(const Row& R, int a) {
  const int j = a >> 5;
  const unsigned m = R.vm[j] & ~((1u << (a & 31)) - 1u);
  return m ? (j << 5) + m3_ffs(m) - 1 : R.na[j];
}

// events (bits m, counts before each chunk b) in [0, t]
M3_HD int events_to(const unsigned* m, const int* b, int t) {
  const int j = t >> 5;
  return b[j] + m3_popc(m[j] & le_mask(t & 31));
}

struct OpAdd {
  M3_HD float operator()(float a, float b) const { return a + b; }
};
struct OpMin {
  M3_HD float operator()(float a, float b) const { return b < a ? b : a; }
};
struct OpMax {
  M3_HD float operator()(float a, float b) const { return b > a ? b : a; }
};

// The tree's leaves, by index i >= -kPad: the row and the amounts have
// kPad words before column 0, NaN and 0, so the fill needs no test.
struct LeafSum {
  const float* x;
  M3_HD float operator()(int i) const { return x[i] == x[i] ? x[i] : 0.0f; }
};
struct LeafMin {
  const float* x;
  M3_HD float operator()(int i) const { return x[i] == x[i] ? x[i] : pos_inf(); }
};
struct LeafMax {
  const float* x;
  M3_HD float operator()(int i) const { return x[i] == x[i] ? x[i] : -pos_inf(); }
};
struct LeafAmount {  // the correction amounts, stored
  const float* a;
  M3_HD float operator()(int i) const { return a[i]; }
};
struct LeafDev {  // x - base (std's baseline-shifted values), or its square
  const float* x;
  float base;
  bool square;
  M3_HD float operator()(int i) const {
    if (x[i] != x[i]) return 0.0f;
    const float xb = x[i] - base;
    return square ? xb * xb : xb;
  }
};

// The reference's tree over the 2^E leaves from s: op(earlier half, later
// half), recursively (acc_E[s + 2^E - 1]).
template <int E>
struct Block {
  template <class Leaf, class Op>
  M3_HD static float run(const Leaf& leaf, int s, Op op) {
    return op(Block<E - 1>::run(leaf, s, op), Block<E - 1>::run(leaf, s + (1 << (E - 1)), op));
  }
};
template <>
struct Block<0> {
  template <class Leaf, class Op>
  M3_HD static float run(const Leaf& leaf, int s, Op) { return leaf(s); }
};

// _win_reduce's result at column t for window <= kDirectMax, per column:
// the window is the blocks of w's set bits, lowest bit oldest, each a
// perfect tree, folded oldest first. Leaves before column 0 are the fill,
// and op(fill, fill) == fill, so this equals the reference's shifted-in
// fills bit for bit.
template <class Leaf, class Op>
M3_HD float direct_reduce(const Leaf& leaf, int t, int window, Op op) {
  int s = t - window + 1;
  float v = 0.0f;
  bool have = false;
  auto take = [&](float b, int size) {
    v = have ? op(v, b) : b;
    have = true;
    s += size;
  };
  if (window & 1) take(Block<0>::run(leaf, s, op), 1);
  if (window & 2) take(Block<1>::run(leaf, s, op), 2);
  if (window & 4) take(Block<2>::run(leaf, s, op), 4);
  if (window & 8) take(Block<3>::run(leaf, s, op), 8);
  if (window & 16) take(Block<4>::run(leaf, s, op), 16);
  return v;
}

// The windowed value `which` of column t: from the tree's result arrays,
// or reduced directly from the row.
enum Win { W_SUM, W_MIN, W_MAX, W_CORR, W_DEV, W_DEV2 };

// _rate_impl's window geometry at output column t, from the window's first
// (fi) and last (li) valid samples. Exact small integers: (float)li -
// (float)t is -(float)(t - li) for any t < 2^24, so it depends on t - li
// and t - fi only.
struct RateGeom {
  float interval, avg_between, to_start, to_end;
};

M3_HD RateGeom rate_geom(int li, int fi, int t, float step, float duration) {
  const float t_last = ((float)li - (float)t) * step;
  const float t_first = ((float)fi - (float)t) * step;
  const float range_start = -duration;
  RateGeom g;
  g.to_start = t_first - range_start;
  g.to_end = -t_last;
  g.interval = t_last - t_first;
  const float span = (float)(li - fi);
  g.avg_between = g.interval / (span > 1.0f ? span : 1.0f);
  return g;
}

// The factor _rate_impl multiplies the result by, given duration_to_start
M3_HD float rate_factor(const RateGeom& g, float to_start) {
  const float threshold = g.avg_between * 1.1f;
  float extrap = g.interval;
  extrap = extrap + (to_start < threshold ? to_start : g.avg_between / 2.0f);
  extrap = extrap + (g.to_end < threshold ? g.to_end : g.avg_between / 2.0f);
  return extrap / (g.interval > 1e-30f ? g.interval : 1e-30f);
}

// _rate_impl for output column t, from the window's first (fi) and last
// (li) valid samples and the counter correction
M3_HD float rate_like(int li, int fi, float last_v, float first_v, float corr, int t, float step,
                      float duration, bool is_rate, bool is_counter) {
  const RateGeom g = rate_geom(li, fi, t, step, duration);
  float duration_to_start = g.to_start;
  float result = last_v - first_v + corr;
  if (is_counter) {
    const float dur_to_zero = g.interval * (first_v / (result > 0.0f ? result : 1.0f));
    if (result > 0.0f && first_v >= 0.0f && dur_to_zero < duration_to_start)
      duration_to_start = dur_to_zero;
  }
  result = result * rate_factor(g, duration_to_start);
  if (is_rate) result = result / duration;
  return result;
}

// The table entry for (dl, df): rate_geom at li = T - dl, fi = T - df, t = T
// (any T < 2^24 gives the same bits)
M3_HD Geo geo_entry(int dl, int df, float step, float duration) {
  const int T = 1 << 20;
  const RateGeom g = rate_geom(T - dl, T - df, T, step, duration);
  // dur_to_zero = interval * (first_v / result) is >= 0 (or NaN) when the
  // clamp is asked about, so it cannot fall below a to_start <= 0
  const bool may_clamp = !(g.to_start <= 0.0f && g.interval >= 0.0f);
  return Geo{rate_factor(g, g.to_start), g.interval, g.to_start, may_clamp ? 1.0f : 0.0f};
}

// True where the zero-point clamp surely does not apply to a counter window
// with result > 0 and first_v >= 0, that is where dur_to_zero = interval *
// (first_v / result) is at least to_start: decided without the division, as
// interval * first_v >= to_start * result with a margin of 1e-3, where the
// three products and the quotient are normal f32 values (each within 2^-24
// of its exact value). Anything else takes the exact formula.
M3_HD bool surely_unclamped(float interval, float first_v, float result, float to_start) {
  const float b = to_start * result;
  return to_start >= 0x1p-126f && b >= 0x1p-100f && b <= 0x1p100f &&
         first_v >= result * 0x1p-100f && interval * first_v >= b * 1.001f;
}

// The counter correction attached to sample j: its previous valid sample's
// value if j is valid and lower (a reset), else 0
M3_HD float reset_amount(const Row& R, int j) {
  const int p = last_valid(R, j - 1);  // -1 (the fill, NaN) if none
  const float pv = R.x[p];
  return p >= 0 && R.x[j] < pv ? pv : 0.0f;
}

template <int W>
M3_HD float windowed(const Row& R, int t) {
  if (!R.direct) return W == W_DEV2 ? R.V2[t] : R.V[t];
  switch (W) {
    case W_SUM: return direct_reduce(LeafSum{R.x}, t, R.window, OpAdd());
    case W_MIN: return direct_reduce(LeafMin{R.x}, t, R.window, OpMin());
    case W_MAX: return direct_reduce(LeafMax{R.x}, t, R.window, OpMax());
    case W_CORR: return direct_reduce(LeafAmount{R.acc}, t, R.window, OpAdd());
    case W_DEV: return direct_reduce(LeafDev{R.x, R.base, false}, t, R.window, OpAdd());
    default: return direct_reduce(LeafDev{R.x, R.base, true}, t, R.window, OpAdd());
  }
}

// Output column t of function fn, from the arrays of its stage
// Every value is computed whatever the count, then gated: the loop body has
// no branch, so the compiler overlaps the columns of an unrolled loop. Any
// index of an empty window is -1 or lies in the fill before column 0, which
// every array has. Functions that find the window's valid samples gate on
// those indices instead of the count (the count is then never computed):
// a window [a, t] holds a valid sample iff last_valid(t) >= a, and two iff
// the first valid index >= a lies below the last valid index <= t.
template <int FN>
M3_HD float eval(const Row& R, int t) {
  const float nan = qnan();
  const int a = t - R.window + 1 > 0 ? t - R.window + 1 : 0;
  const int c = count_to(R, t) - count_to(R, a - 1);
  switch (FN) {
    case COUNT_OT: return c > 0 ? (float)c : nan;
    case SUM_OT: {
      const float s = windowed<W_SUM>(R, t);
      return c > 0 ? s : nan;
    }
    case AVG_OT: {
      const float s = windowed<W_SUM>(R, t) / (float)c;
      return c > 0 ? s : nan;
    }
    case MIN_OT: {
      const float m = windowed<W_MIN>(R, t);
      return c > 0 ? m : nan;
    }
    case MAX_OT: {
      const float m = windowed<W_MAX>(R, t);
      return c > 0 ? m : nan;
    }
    case LAST_OT: {
      const int li = last_valid(R, t);
      const float v = R.x[li];
      return li >= a ? v : nan;
    }
    case IRATE:
    case IDELTA: {
      // two valid samples in the window iff the second-to-last lies in it
      const int li = last_valid(R, t), si = last_valid(R, li - 1);
      float res = R.x[li] - R.x[si];
      if (FN == IRATE) {
        const float dt = (float)(li - si) * R.step;
        res = res / (dt > 1e-30f ? dt : 1e-30f);
      }
      return si >= a ? res : nan;
    }
    case RESETS:
    case CHANGES: {
      const unsigned* m = FN == RESETS ? R.rm : R.cm;
      const int* b = FN == RESETS ? R.rb : R.cb;
      // pairs after the window's first valid sample
      const int n = events_to(m, b, t) - events_to(m, b, first_valid(R, a));
      return c - (R.x[a] == R.x[a] ? 1 : 0) > 0 ? (float)n : nan;
    }
    case RATE:
    case INCREASE:
    case DELTA: {
      const int li = last_valid(R, t), fi = first_valid(R, a);
      const bool counter = FN != DELTA;
      float corr = 0.0f;
      if (counter) {
        // the correction attached to the first valid sample, whose partner
        // lies before the window (stored in direct mode)
        const float first_amount = R.direct ? R.acc[fi] : reset_amount(R, fi);
        corr = windowed<W_CORR>(R, t) - first_amount;
      }
      const float last_v = R.x[li], first_v = R.x[fi];
      const float result = last_v - first_v + corr;
      // the geometry from the table; outside it, or where the counter's
      // zero-point clamp may apply, the exact formula (a divergent, rare
      // branch)
      const int dl = t - li, j = t - fi - R.geo_df0;
      const bool in_table = (unsigned)dl < (unsigned)R.geo_k && (unsigned)j < (unsigned)R.geo_k;
      const Geo g = R.geo[in_table ? dl * R.geo_k + j : 0];
      bool exact = !in_table;
      if (counter && g.may_clamp != 0.0f && result > 0.0f && first_v >= 0.0f)
        exact = exact || !surely_unclamped(g.interval, first_v, result, g.to_start);
      const bool two = fi >= 0 && fi < li;  // two valid samples in [a, t]
      float v;
      if (two && exact) {
        v = rate_like(li, fi, last_v, first_v, corr, t, R.step, R.duration, FN == RATE, counter);
      } else {
        v = result * g.factor;
        if (FN == RATE) v = v / R.duration;
      }
      return two ? v : nan;
    }
    case STDDEV_OT:
    case STDVAR_OT: {
      const float cf = (float)c;
      const float mean = windowed<W_DEV>(R, t) / cf;
      float var = windowed<W_DEV2>(R, t) / cf - mean * mean;
      var = var > 0.0f ? var : (var == var ? 0.0f : var);
      if (FN == STDDEV_OT) var = sqrtf(var);
      return c >= 2 ? var : nan;
    }
    default: return nan;
  }
}

// Function FN's outputs for this row, if FN belongs to STAGE and the
// instantiation G builds its state: one loop per function, so the loop body
// is that function's code alone and independent columns overlap.
template <int G, int STAGE, int FN>
M3_HD void emit_fn(const Row& R, float* o) {
  constexpr bool needs_geo = FN == RATE || FN == INCREASE || FN == DELTA;
  if constexpr (stage_of(FN) == STAGE && (fn_groups(FN) & ~G) == 0 &&
                (!needs_geo || uses_geo(G))) {
#pragma unroll kUnroll
    for (int t = M3_LANE; t < R.cols; t += M3_STEP) o[t] = eval<FN>(R, t);
  }
}

// Writes every requested output of STAGE for this row.
template <int G, int STAGE>
M3_HD void emit(const Row& R, const Outs& outs, int64_t row) {
  for (int i = 0; i < outs.n; ++i) {
    float* o = outs.p[i] + row * R.cols;
    switch (outs.fn[i]) {
      case RATE: emit_fn<G, STAGE, RATE>(R, o); break;
      case IRATE: emit_fn<G, STAGE, IRATE>(R, o); break;
      case INCREASE: emit_fn<G, STAGE, INCREASE>(R, o); break;
      case DELTA: emit_fn<G, STAGE, DELTA>(R, o); break;
      case IDELTA: emit_fn<G, STAGE, IDELTA>(R, o); break;
      case RESETS: emit_fn<G, STAGE, RESETS>(R, o); break;
      case CHANGES: emit_fn<G, STAGE, CHANGES>(R, o); break;
      case SUM_OT: emit_fn<G, STAGE, SUM_OT>(R, o); break;
      case COUNT_OT: emit_fn<G, STAGE, COUNT_OT>(R, o); break;
      case AVG_OT: emit_fn<G, STAGE, AVG_OT>(R, o); break;
      case MIN_OT: emit_fn<G, STAGE, MIN_OT>(R, o); break;
      case MAX_OT: emit_fn<G, STAGE, MAX_OT>(R, o); break;
      case LAST_OT: emit_fn<G, STAGE, LAST_OT>(R, o); break;
      case STDDEV_OT: emit_fn<G, STAGE, STDDEV_OT>(R, o); break;
      default: emit_fn<G, STAGE, STDVAR_OT>(R, o); break;
    }
  }
  M3_SYNC();
}

// ---------------------------------------------------------------------------
// Prefix and suffix passes (warp ballots on the card, loops on the host)
// ---------------------------------------------------------------------------

// The per-chunk words in one ascending pass over the row (and for G_CORR
// the correction amounts into acc), and na in one descending pass over the
// chunks. Returns the row's valid count and (lane-
// partial on the card) the sum of its valid values.
template <int G>
M3_HD int prefix_pass(const Row& R, float& vsum) {
  const float* x = R.x;
  const int cols = R.cols;
  int cC = 0, cL = -1, cR = 0, cG = 0;
  for (int c0 = 0, j = 0; c0 < cols; c0 += 32, ++j) {
#ifdef __CUDACC__
    const int lane = M3_LANE;
    const int t = c0 + lane;
    const float v = t < cols ? x[t] : qnan();
    const bool valid = v == v;
    if ((G & G_STD) && valid) vsum = vsum + v;
    const unsigned bal = __ballot_sync(0xffffffffu, valid);
    unsigned res = 0, chg = 0;
    if (G & (G_ERES | G_ECHG | G_CORR)) {
      const unsigned mlt = bal & ((1u << lane) - 1u);
      const int prv = mlt ? c0 + 31 - m3_clz(mlt) : cL;
      const bool has = valid && prv >= 0;
      const float pv = prv >= 0 ? x[prv] : 0.0f;
      if (G & G_ERES) res = __ballot_sync(0xffffffffu, has && v < pv);
      if (G & G_ECHG) chg = __ballot_sync(0xffffffffu, has && v != pv);
      // the counter correction at t (reset_amount), the CORR tree's leaf
      if ((G & G_CORR) && t < cols) R.acc[t] = has && v < pv ? pv : 0.0f;
    }
    if (lane == 0) {
#else
    unsigned bal = 0, res = 0, chg = 0;
    int prv = cL;
    for (int b = 0; b < 32 && c0 + b < cols; ++b) {
      const float v = x[c0 + b];
      const bool reset = v == v && prv >= 0 && v < x[prv];
      if (G & G_CORR) R.acc[c0 + b] = reset ? x[prv] : 0.0f;
      if (v != v) continue;
      if (G & G_STD) vsum = vsum + v;
      bal |= 1u << b;
      if (reset) res |= 1u << b;
      if (prv >= 0 && v != x[prv]) chg |= 1u << b;
      prv = c0 + b;
    }
    {
#endif
      R.vm[j] = bal;
      R.vb[j] = cC;
      R.lb[j] = cL;
      if (G & G_ERES) { R.rm[j] = res; R.rb[j] = cR; }
      if (G & G_ECHG) { R.cm[j] = chg; R.cb[j] = cG; }
    }
    cC += m3_popc(bal);
    cL = bal ? c0 + 31 - m3_clz(bal) : cL;
    cR += m3_popc(res);
    cG += m3_popc(chg);
  }
  M3_SYNC();
  if (G & G_NV) {
    int cN = -1;
    for (int j = (cols - 1) >> 5; j >= 0; --j) {
      const unsigned m = R.vm[j];
      if (M3_LANE == 0) R.na[j] = cN;
      cN = m ? (j << 5) + m3_ffs(m) - 1 : cN;
    }
    M3_SYNC();
  }
  return cC;
}

// ---------------------------------------------------------------------------
// The reference's doubling tree (_win_reduce), in place
// ---------------------------------------------------------------------------

// dst[t] = op(t >= sh ? dst[t - sh] : fill, src[t]) for every t, in place:
// columns are taken in descending groups of kGroup chunks, every read of a
// group before any of its writes (a group never reads what a higher group
// wrote, since t - sh < t).
constexpr int kGroup = 8;

template <class Op>
M3_HD void shift_pass(float* dst, const float* src, int cols, int64_t sh, float fill, Op op) {
  const int lane = M3_LANE;
  const int top = ((cols - 1) / M3_STEP) * M3_STEP;
  for (int c0 = top; c0 >= 0; c0 -= kGroup * M3_STEP) {
    float r[kGroup];
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = c0 - u * M3_STEP + lane;
      if (t >= 0 && t < cols) r[u] = op(t >= sh ? dst[t - sh] : fill, src[t]);
    }
    M3_SYNC();
#pragma unroll
    for (int u = 0; u < kGroup; ++u) {
      const int t = c0 - u * M3_STEP + lane;
      if (t >= 0 && t < cols) dst[t] = r[u];
    }
  }
  M3_SYNC();
}

// acc holds the leaves (level 0); V receives the window's reduction,
// win(w)[t] = op(win(w - 2^e)[t - 2^e], acc_e[t]) for w's top bit e, built
// from w's set bits lowest first. acc is consumed.
template <class Op>
M3_HD void window_tree(float* acc, float* V, int cols, int window, float fill, Op op) {
  bool have = false;
  for (int64_t sh = 1; sh <= window; sh <<= 1) {
    if (window & sh) {
      if (!have) {
        for (int t = M3_LANE; t < cols; t += M3_STEP) V[t] = acc[t];
        M3_SYNC();
        have = true;
      } else {
        shift_pass(V, acc, cols, sh, fill, op);
      }
    }
    if (sh * 2 <= window) shift_pass(acc, acc, cols, sh, fill, op);
  }
}

// ---------------------------------------------------------------------------
// One row
// ---------------------------------------------------------------------------

template <int G>
M3_HD void process_row(Row& R, const Outs& outs, int64_t row) {
  const float* x = R.x;
  const int cols = R.cols;
  float vsum = 0.0f;
  const int vcnt = prefix_pass<G>(R, vsum);
  emit<G, S_NONE>(R, outs, row);
  if (G & G_SUM) {
    if (!R.direct) {
      for (int t = M3_LANE; t < cols; t += M3_STEP) R.acc[t] = LeafSum{x}(t);
      M3_SYNC();
      window_tree(R.acc, R.V, cols, R.window, 0.0f, OpAdd());
    }
    emit<G, S_SUM>(R, outs, row);
  }
  if (G & G_MIN) {
    if (!R.direct) {
      for (int t = M3_LANE; t < cols; t += M3_STEP) R.acc[t] = LeafMin{x}(t);
      M3_SYNC();
      window_tree(R.acc, R.V, cols, R.window, pos_inf(), OpMin());
    }
    emit<G, S_MIN>(R, outs, row);
  }
  if (G & G_MAX) {
    if (!R.direct) {
      for (int t = M3_LANE; t < cols; t += M3_STEP) R.acc[t] = LeafMax{x}(t);
      M3_SYNC();
      window_tree(R.acc, R.V, cols, R.window, -pos_inf(), OpMax());
    }
    emit<G, S_MAX>(R, outs, row);
  }
  if (G & G_CORR) {  // acc holds the amounts (prefix_pass) unless a tree above used it
    if (!R.direct && (G & (G_SUM | G_MIN | G_MAX))) {
      for (int t = M3_LANE; t < cols; t += M3_STEP) R.acc[t] = reset_amount(R, t);
      M3_SYNC();
    }
    if (!R.direct) window_tree(R.acc, R.V, cols, R.window, 0.0f, OpAdd());
    emit<G, S_CORR>(R, outs, row);
  }
  if (G & G_STD) {
    // the row's nanmean (the reference's per-series baseline)
#ifdef __CUDACC__
    for (int off = 16; off > 0; off >>= 1) vsum = vsum + __shfl_xor_sync(0xffffffffu, vsum, off);
#endif
    R.base = vcnt > 0 ? vsum / (float)vcnt : 0.0f;
    if (!R.direct) {
      for (int t = M3_LANE; t < cols; t += M3_STEP) R.acc[t] = LeafDev{x, R.base, false}(t);
      M3_SYNC();
      window_tree(R.acc, R.V, cols, R.window, 0.0f, OpAdd());
      for (int t = M3_LANE; t < cols; t += M3_STEP) R.acc[t] = LeafDev{x, R.base, true}(t);
      M3_SYNC();
      window_tree(R.acc, R.V2, cols, R.window, 0.0f, OpAdd());
    }
    emit<G, S_STD>(R, outs, row);
  }
}

// Points the row's arrays into `words` (Layout<G>::words(cols, window)
// words); R.cols and R.window are set.
template <int G>
M3_HD void bind_arrays(Row& R, float* words) {
  const int n = R.cols + kPad, nch = (R.cols + 31) / 32 + 1;
  R.direct = R.window <= kDirectMax;
  const int floats = Layout<G>::floats(R.window);
  R.acc = floats >= 1 ? words + kPad : nullptr;
  R.V = floats >= 2 ? words + n + kPad : nullptr;
  R.V2 = floats >= 3 ? words + 2 * n + kPad : nullptr;
  if (R.acc != nullptr)  // the amounts' zero fill before column 0
    for (int i = M3_LANE; i < kPad; i += M3_STEP) R.acc[i - kPad] = 0.0f;
  int* w = reinterpret_cast<int*>(words + (int64_t)floats * n) + 1;  // chunk -1 first
  R.vm = reinterpret_cast<unsigned*>(w);
  R.vb = w + nch;
  R.lb = w + 2 * nch;
  w += 3 * nch;
  R.na = R.rb = R.cb = nullptr;
  R.rm = R.cm = nullptr;
  if (G & G_NV) { R.na = w; w += nch; }
  if (G & G_ERES) { R.rm = reinterpret_cast<unsigned*>(w); R.rb = w + nch; w += 2 * nch; }
  if (G & G_ECHG) { R.cm = reinterpret_cast<unsigned*>(w); R.cb = w + nch; w += 2 * nch; }
  if (M3_LANE == 0) {  // chunk -1: no valid sample, no event
    R.vm[-1] = 0u;
    R.vb[-1] = 0;
    R.lb[-1] = -1;
    if (G & G_ERES) { R.rm[-1] = 0u; R.rb[-1] = 0; }
    if (G & G_ECHG) { R.cm[-1] = 0u; R.cb[-1] = 0; }
  }
  M3_SYNC();
}

// NaN in the kPad words before a row buffer: the leaves' fill.
M3_HD void pad_row(float* row) {
  for (int i = M3_LANE; i < kPad; i += M3_STEP) row[i - kPad] = qnan();
}

// Sets R's scalars and, for uses_geo(G), fills its extrapolation table at
// `geo` (geo_words<G>(window) words), entries tid, tid + nthreads, ...
// (the caller synchronises before the table is read).
template <int G>
M3_HD void init_row(Row& R, int cols, int window, float step, float duration, float* geo,
                    int tid, int nthreads) {
  R.cols = cols;
  R.window = window;
  R.step = step;
  R.duration = duration;
  R.geo = nullptr;
  R.geo_k = geo_side(window);
  R.geo_df0 = geo_df0(window);
  if constexpr (uses_geo(G)) {
    Geo* table = reinterpret_cast<Geo*>(geo);
    const int k = R.geo_k;
    for (int i = tid; i < k * k; i += nthreads)
      table[i] = geo_entry(i / k, R.geo_df0 + i % k, step, duration);
    R.geo = table;
  }
}

// Rows whose arrays do not fit in shared memory keep them in a device
// scratch buffer of at most this many bytes (the wrapper allocates it).
constexpr int64_t kScratchCap = 256ll << 20;

// Launch shape: warps per CTA, the dynamic shared memory (the
// extrapolation table, then in shared mode each warp's rows and arrays),
// and for long rows the scratch bytes and CTAs.
struct Plan {
  int warps;
  bool shared;        // each warp's rows and arrays in shared memory
  size_t smem;        // dynamic shared memory per CTA
  int64_t blocks;     // scratch mode: CTAs (each warp owns a scratch slot)
  int64_t scratch;    // scratch mode: bytes of device scratch needed
};

constexpr int kMaxWarps = 8;

// Persistent CTAs per CTA slot the card holds at once: two waves, so a CTA
// that finishes early leaves no SM idle while others still hold rows (one
// wave ran slower on the H100).
constexpr int64_t kGridWaves = 2;

template <int G>
Plan make_plan(int64_t rows, int cols, int window) {
  const int64_t words = Layout<G>::words(cols, window);
  const size_t per_warp = (size_t)(2 * ((int64_t)cols + kPad) + words) * 4;
  const size_t geo = (size_t)geo_words<G>(window) * 4;
  Plan p{kMaxWarps, true, 0, 0, 0};
  if (geo + per_warp <= m3::kSmemMax) {
    const int fit = (int)((m3::kSmemMax - geo) / per_warp);
    p.warps = fit < kMaxWarps ? fit : kMaxWarps;
    p.smem = geo + per_warp * p.warps;
    return p;
  }
  p.shared = false;
  p.smem = geo;
  const int64_t slot = ((int64_t)cols + kPad + words) * 4;
  int64_t warps = kScratchCap / slot;
  warps = warps < 1 ? 1 : (warps < rows ? warps : rows);
  p.blocks = (warps + kMaxWarps - 1) / kMaxWarps;
  p.scratch = p.blocks * kMaxWarps * slot;
  return p;
}

#ifdef __CUDACC__
M3_HD void load_row(float* dst, const float* src, int cols) {
  for (int t = M3_LANE; t < cols; t += 32) m3::cp_async4(dst + t, src + t);
}

// kShared: each warp's two row buffers and the instantiation's arrays in
// shared memory after the block's extrapolation table (every pointer of the
// row derives from `smem` in this function, so the compiler emits
// shared-memory loads, not generic ones). Otherwise (rows too long for
// shared memory) each warp keeps its arrays in its own slot of `scratch`
// and reads its rows in place.
template <int G, bool kShared>
__global__ void __launch_bounds__(kMaxWarps * 32)
temporal_fused_kernel(const float* __restrict__ x, int64_t rows, int cols, int window,
                      float step, float duration, Outs outs, float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  const int warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5;
  const int64_t words = Layout<G>::words(cols, window);
  const int64_t stride = (int64_t)gridDim.x * warps;
  int64_t r = (int64_t)blockIdx.x * warps + warp;
  Row R;
  init_row<G>(R, cols, window, step, duration, smem, threadIdx.x, blockDim.x);
  __syncthreads();  // the table is complete
  if constexpr (!kShared) {
    // this warp's slot: the row (kPad NaN words first), then its arrays
    float* row = scratch + r * ((int64_t)cols + kPad + words) + kPad;
    pad_row(row);
    bind_arrays<G>(R, row + cols);
    R.x = row;
    for (; r < rows; r += stride) {
      for (int t = M3_LANE; t < cols; t += 32) row[t] = x[r * cols + t];
      __syncwarp();
      process_row<G>(R, outs, r);
    }
  } else {
    const int64_t buf = (int64_t)cols + kPad;  // a row buffer and its pad
    float* mine = smem + geo_words<G>(window) + (size_t)warp * (2 * buf + words);
    pad_row(mine + kPad);
    pad_row(mine + buf + kPad);
    bind_arrays<G>(R, mine + 2 * buf);
    if (r < rows) load_row(mine + kPad, x + r * cols, cols);
    m3::cp_async_commit();
    for (int i = 0; r < rows; r += stride, ++i) {
      const int64_t next = r + stride;
      float* cur = mine + (i & 1) * buf + kPad;
      if (next < rows) load_row(mine + ((i + 1) & 1) * buf + kPad, x + next * cols, cols);
      m3::cp_async_commit();
      m3::cp_async_wait<1>();  // this row's copies (all but the newest group)
      __syncwarp();
      R.x = cur;
      process_row<G>(R, outs, r);  // ends in __syncwarp: the buffer is free
    }
  }
}

template <int G>
int launch(const float* x, int64_t rows, int cols, int window, float step, float duration,
           const Outs& o, float* scratch, int64_t scratch_bytes, cudaStream_t stream) {
  const Plan p = make_plan<G>(rows, cols, window);
  if (!p.shared) {
    if (scratch == nullptr || scratch_bytes < p.scratch) return (int)cudaErrorInvalidValue;
    temporal_fused_kernel<G, false><<<(unsigned)p.blocks, p.warps * 32, p.smem, stream>>>(
        x, rows, cols, window, step, duration, o, scratch);
    return (int)cudaGetLastError();
  }
  int64_t cap = 0;
  const cudaError_t e =
      m3::resident_blocks(temporal_fused_kernel<G, true>, p.warps * 32, p.smem, &cap);
  if (e != cudaSuccess) return (int)e;
  cap *= kGridWaves;
  const int64_t want = (rows + p.warps - 1) / p.warps;
  temporal_fused_kernel<G, true><<<(unsigned)(want < cap ? want : cap), p.warps * 32, p.smem,
                                   stream>>>(x, rows, cols, window, step, duration, o, nullptr);
  return (int)cudaGetLastError();
}
#endif

inline bool make_outs(float** outs, const int* fns, int nfn, Outs& o) {
  if (nfn <= 0 || nfn > kMaxOuts) return false;
  o.n = nfn;
  for (int i = 0; i < nfn; ++i) {
    if (fns[i] < 0 || fns[i] >= NUM_FNS) return false;
    o.p[i] = outs[i];
    o.fn[i] = fns[i];
  }
  return true;
}

}  // namespace

#ifdef __CUDACC__
// x f32[rows, cols] row-major; outs[i] f32[rows, cols] receives function
// fns[i] (ids of enum Fn), i < nfn. Rows whose arrays do not fit in shared
// memory need `scratch`, a device buffer of m3_temporal_fused_scratch_bytes
// bytes (else it may be null). Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for arguments it does not take).
extern "C" int m3_temporal_fused(const float* x, int64_t rows, int cols, int window,
                                 double step_seconds, float** outs, const int* fns, int nfn,
                                 float* scratch, int64_t scratch_bytes, void* stream) {
  Outs o;
  if (!make_outs(outs, fns, nfn, o) || window <= 0 || cols < 0) return (int)cudaErrorInvalidValue;
  if (rows <= 0 || cols == 0) return (int)cudaGetLastError();
  const float step = (float)step_seconds;
  const float duration = (float)((window - 1) * step_seconds);
  return dispatch(select_groups(fns, nfn), [&](auto g) {
    return launch<decltype(g)::value>(x, rows, cols, window, step, duration, o, scratch,
                                      scratch_bytes, (cudaStream_t)stream);
  });
}
#endif

// Bytes of device scratch m3_temporal_fused needs for these functions at
// this shape (0 when each warp's row fits in shared memory), or -1 for
// function ids it does not take.
extern "C" int64_t m3_temporal_fused_scratch_bytes(int64_t rows, int cols, int window,
                                                   const int* fns, int nfn) {
  Outs o;
  float* none[kMaxOuts] = {};
  if (!make_outs(none, fns, nfn, o) || cols < 0 || window <= 0) return -1;
  if (rows <= 0 || cols == 0) return 0;
  int64_t bytes = 0;
  dispatch(select_groups(fns, nfn), [&](auto g) {
    bytes = make_plan<decltype(g)::value>(rows, cols, window).scratch;
    return 0;
  });
  return bytes;
}

#ifndef __CUDACC__
// Host build of the same row code, one row at a time.
extern "C" int m3_temporal_fused_host(const float* x, int64_t rows, int cols, int window,
                                      double step_seconds, float** outs, const int* fns,
                                      int nfn) {
  Outs o;
  if (!make_outs(outs, fns, nfn, o) || window <= 0 || cols < 0) return 1;
  if (rows <= 0 || cols == 0) return 0;
  return dispatch(select_groups(fns, nfn), [&](auto g) {
    constexpr int G = decltype(g)::value;
    std::vector<float> words((size_t)(cols + kPad + Layout<G>::words(cols, window)));
    std::vector<Geo> geo((size_t)geo_words<G>(window) / 4 + 1);
    float* row = words.data() + kPad;
    pad_row(row);
    Row R;
    init_row<G>(R, cols, window, (float)step_seconds, (float)((window - 1) * step_seconds),
                reinterpret_cast<float*>(geo.data()), 0, 1);
    bind_arrays<G>(R, row + cols);
    R.x = row;
    for (int64_t r = 0; r < rows; ++r) {
      std::memcpy(row, x + r * cols, (size_t)cols * 4);
      process_row<G>(R, o, r);
    }
    return 0;
  });
}

// The instantiation the kernel runs for these functions (for the tests).
extern "C" int m3_temporal_fused_groups(const int* fns, int nfn) {
  return select_groups(fns, nfn);
}
#endif
