// Windowed temporal functions over a range matrix (kernel B-7): deriv,
// predict_linear, holt_winters and quantile_over_time. Not a Pallas kernel:
// it replaces the XLA programs of m3_tpu/query/functions/temporal.py:419-461
// (_linreg_sums, deriv, predict_linear), :517-568 (holt_winters) and
// :571-602 (quantile_over_time), which gather [S, 128, W] windows
// (_gather_windows, :505) inside a lax.map over chunks of 128 steps and then
// reduce them, run a W-step lax.scan over them, or sort them.
//
// What it computes. Input f32 [S, T], NaN = missing; the window is W steps;
// output f32 [S, T]: column t covers input columns [t - W + 1, t], with NaN
// before column 0. Per function (parameters a-d, as the wrapper rounds them
// to f32):
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
// Bound. Bytes: the input read once and the output written once, 8 bytes a
// column (0.58 GB at [100,000, 726]: 0.17 ms at 3.35 TB/s). Operations:
// linreg 6 f32 operations a valid slot, holt_winters 8, so a window of W
// slots costs ~W of them a column: at W = 361, 100,000 rows and 1,080
// columns 2.3e11 f32 operations, 3.5 ms at 67 TFLOP/s. So every function
// but quantile at small W is bound by its window's arithmetic, not by bytes.
// The quantile's sliding sorted window moves ~W values a column.
//
// Design (a first design that is right; the twin's order of arithmetic is
// the contract):
// - A block per row (rows too many for the grid are walked in a grid-stride
//   loop). The row is staged in shared memory behind W - 1 NaN slots, so a
//   window never tests its left edge; a row too long for shared memory is
//   read from device memory through the same accessor (Row::at), with the
//   window arrays in a device scratch buffer the wrapper allocates.
// - deriv, predict_linear, holt_winters: a thread per output column walks
//   its W slots in order (neighbouring threads read neighbouring words, so
//   shared memory serves a warp without bank conflicts) and keeps its sums
//   or the recurrence's state in registers. A slot without a sample adds
//   nothing, as the twin's adds of +-0 change no sum (no sum is ever -0).
// - quantile_over_time: a thread per run of consecutive output columns
//   (run >= W, so the first window's insertion sort, O(W^2) at worst, is
//   spread over at least W columns) keeps its window's valid samples sorted
//   in shared memory, interleaved across the block's threads (value k of
//   thread i at k * threads + i, no bank conflicts), and slides it: the
//   sample leaving is found by binary search and removed, the one entering
//   is inserted from the top, O(W) a column. Which of two equal values (+0
//   and -0) leaves does not matter: the interpolation's result does not
//   depend on the sign of a zero it picks.
//
// Parity. Every f32 step repeats the twin's operations in its order (the
// twin, temporal.py's _linreg_sums / holt_winters / quantile_over_time,
// folds the slots one at a time). Build with -fmad=false (no FMA
// contraction) and without fast math; subnormals are kept, as torch keeps
// them.
//
// Without __CUDACC__ the same per-column code compiles as host C++ (one row
// at a time, the runs of a row in turn), which the CPU tests hold against
// the PyTorch twin.

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
#endif

namespace {

// Function ids, in the order of temporal_window.FUNCTIONS.
enum Fn { DERIV = 0, PREDICT_LINEAR = 1, HOLT_WINTERS = 2, QUANTILE = 3, NUM_FNS };

struct Params {
  float a, b, c, d;
};

constexpr int kThreads = 256;          // a block of the per-column functions
constexpr int kMaxThreads = 1024;      // a block of quantile runs, at most
constexpr int64_t kFallbackBlocks = 1024;  // grid of the device-memory route

M3_HD float qnan() { return __int_as_float(0x7fc00000); }
M3_HD float qinf() { return __int_as_float(0x7f800000); }

// A row with W - 1 NaN slots before column 0: at(i) is column i - (W - 1).
// Staged: p is the padded row in shared memory and pad is 0; otherwise p is
// the row in device memory and pad is W - 1.
struct Row {
  const float* p;
  int pad;
  M3_HD float at(int i) const { return i < pad ? qnan() : p[i - pad]; }
};

// The least-squares fit of the window ending at column t (slots t .. t+W-1
// of the padded row).
M3_HD void linreg(const Row& row, int t, int w, float step, float& slope, float& icpt) {
  float n = 0.0f, sv = 0.0f, sd = 0.0f, sdd = 0.0f, sdv = 0.0f;
  const float w1 = (float)(w - 1);
  for (int j = 0; j < w; ++j) {
    const float v = row.at(t + j);
    if (v != v) continue;
    const float d = ((float)j - w1) * step;
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

M3_HD float holt_winters(const Row& row, int t, int w, const Params& p) {
  bool found1 = false, found2 = false;
  float prev = 0.0f, curr = 0.0f, trend = 0.0f;
  int idx = 0;  // valid samples seen
  for (int j = 0; j < w; ++j) {
    const float v = row.at(t + j);
    if (v != v) continue;
    if (!found1) {
      curr = v;
      found1 = true;
      idx = 1;
      continue;
    }
    const float trend0 = found2 ? trend : v - curr;
    const float tn = idx == 1 ? trend0 : p.c * (curr - prev) + p.d * trend0;
    const float nc = p.a * v + p.b * (curr + tn);
    prev = curr;
    curr = nc;
    trend = tn;
    ++idx;
    found2 = true;
  }
  return found2 ? curr : qnan();
}

// The sorted window: n values a[0], a[stride], ... in ascending order.
M3_HD void q_insert(float* a, int stride, int& n, float v) {
  int i = n;
  while (i > 0) {
    const float u = a[(i - 1) * stride];
    if (!(u > v)) break;
    a[i * stride] = u;
    --i;
  }
  a[i * stride] = v;
  ++n;
}

// Removes one value equal to v (present in the window).
M3_HD void q_remove(float* a, int stride, int& n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid * stride] < v) lo = mid + 1;
    else hi = mid;
  }
  for (int i = lo; i + 1 < n; ++i) a[i * stride] = a[(i + 1) * stride];
  --n;
}

M3_HD float q_emit(const float* a, int stride, int n, int w, const Params& p) {
  if (n == 0) return qnan();
  if (p.b < 0.0f) return -qinf();
  if (p.b > 0.0f) return qinf();
  const float rank = p.a * (float)(n - 1);
  int lo = (int)floorf(rank);
  lo = max(0, min(lo, w - 1));
  const int hi = min(min(lo + 1, w - 1), n - 1);
  const float frac = rank - (float)lo;
  const float vlo = a[lo * stride], vhi = a[hi * stride];
  return vlo + (vhi - vlo) * frac;
}

// Output columns [t0, t1) of one row: the first window sorted by insertion,
// then slid a column at a time.
M3_HD void quantile_run(const Row& row, int t0, int t1, int w, const Params& p, float* a,
                        int stride, float* out) {
  int n = 0;
  for (int j = 0; j < w; ++j) {
    const float v = row.at(t0 + j);
    if (v == v) q_insert(a, stride, n, v);
  }
  out[t0] = q_emit(a, stride, n, w, p);
  for (int t = t0 + 1; t < t1; ++t) {
    const float vo = row.at(t - 1);
    if (vo == vo) q_remove(a, stride, n, vo);
    const float vi = row.at(t + w - 1);
    if (vi == vi) q_insert(a, stride, n, vi);
    out[t] = q_emit(a, stride, n, w, p);
  }
}

// One output column of the per-column functions.
template <int FN>
M3_HD float column(const Row& row, int t, int w, const Params& p) {
  if (FN == HOLT_WINTERS) return holt_winters(row, t, w, p);
  float slope, icpt;
  linreg(row, t, w, p.a, slope, icpt);
  return FN == DERIV ? slope : slope * p.b + icpt;
}

// How a launch is laid out.
struct Plan {
  int threads;      // a block
  int run;          // quantile: output columns a thread
  bool staged;      // the row (and the windows) in shared memory
  int64_t smem;     // bytes of shared memory a block
  int64_t grid;     // blocks
  int64_t scratch;  // bytes of device scratch (the device-memory route's windows)
};

M3_HDX constexpr int64_t round4(int64_t n) { return (n + 3) / 4 * 4; }

// run: quantile's columns a thread (0: the kernel's choice, at least W).
// force_global: take the device-memory route whatever the row's length.
Plan make_plan(int64_t rows, int cols, int w, int fn, int run, bool force_global) {
  Plan pl{};
  if (fn == QUANTILE) {
    const int min_run = (cols + kMaxThreads - 1) / kMaxThreads;
    pl.run = run > 0 ? std::max(run, min_run) : std::max(w, min_run);
    const int active = (cols + pl.run - 1) / pl.run;
    pl.threads = std::min(kMaxThreads, (active + 31) / 32 * 32);
  } else {
    pl.run = 1;
    pl.threads = std::min(kThreads, (cols + 31) / 32 * 32);
  }
  const int64_t win = fn == QUANTILE ? (int64_t)pl.threads * w : 0;
  const int64_t staged = (round4((int64_t)w - 1 + cols) + win) * 4;
  pl.staged = !force_global && staged <= (int64_t)m3::kSmemMax;
  if (pl.staged) {
    pl.smem = staged;
    pl.grid = std::min<int64_t>(rows, 0x7fffffff);
    pl.scratch = 0;
  } else {
    pl.smem = 0;
    pl.grid = std::min<int64_t>(rows, kFallbackBlocks);
    pl.scratch = pl.grid * win * 4;
  }
  return pl;
}

bool valid_args(int cols, int w, int fn) { return cols >= 0 && w > 0 && fn >= 0 && fn < NUM_FNS; }

#ifdef __CUDACC__
template <int FN, bool STAGED>
__global__ void __launch_bounds__(kMaxThreads)
    temporal_window_kernel(const float* __restrict__ x, int64_t rows, int cols, int w, Params p,
                           int run, float* __restrict__ out, float* __restrict__ scratch) {
  extern __shared__ __align__(16) float smem[];
  const int pad = w - 1;
  float* win = STAGED ? smem + round4((int64_t)pad + cols)
                      : scratch + (int64_t)blockIdx.x * blockDim.x * w;
  for (int64_t r = blockIdx.x; r < rows; r += gridDim.x) {
    const float* xr = x + r * cols;
    float* orow = out + r * cols;
    Row row;
    if (STAGED) {
      __syncthreads();  // the previous row's readers are done
      for (int i = threadIdx.x; i < pad + cols; i += blockDim.x)
        smem[i] = i < pad ? qnan() : xr[i - pad];
      __syncthreads();
      row = {smem, 0};
    } else {
      row = {xr, pad};
    }
    if (FN == QUANTILE) {
      const int t0 = threadIdx.x * run;
      if (t0 < cols) quantile_run(row, t0, min(t0 + run, cols), w, p, win + threadIdx.x, blockDim.x, orow);
    } else {
      for (int t = threadIdx.x; t < cols; t += blockDim.x) orow[t] = column<FN>(row, t, w, p);
    }
  }
}

template <int FN, bool STAGED>
int launch(const float* x, int64_t rows, int cols, int w, const Params& p, const Plan& pl,
           float* out, float* scratch, cudaStream_t stream) {
  auto kernel = temporal_window_kernel<FN, STAGED>;
  int64_t resident = 0;
  // sets the kernel's dynamic shared memory limit (above 48 KB)
  cudaError_t e = m3::resident_blocks(kernel, pl.threads, (size_t)pl.smem, &resident);
  if (e != cudaSuccess) return (int)e;
  kernel<<<(unsigned)pl.grid, pl.threads, (size_t)pl.smem, stream>>>(x, rows, cols, w, p, pl.run,
                                                                     out, scratch);
  return (int)cudaGetLastError();
}

template <int FN>
int launch_fn(const float* x, int64_t rows, int cols, int w, const Params& p, const Plan& pl,
              float* out, float* scratch, cudaStream_t stream) {
  return pl.staged ? launch<FN, true>(x, rows, cols, w, p, pl, out, scratch, stream)
                   : launch<FN, false>(x, rows, cols, w, p, pl, out, scratch, stream);
}
#endif

}  // namespace

#ifdef __CUDACC__
// B-7 over f32 [rows, cols] x into f32 [rows, cols] out on `stream`. fn: the
// function id; a-d its parameters; run: quantile's columns a thread (0: the
// kernel's); force_global: the device-memory route. scratch holds
// m3_temporal_window_scratch_bytes(...) bytes (may be null when that is 0).
// Returns the CUDA error of the launch (0 when it was accepted).
extern "C" int m3_temporal_window(const float* x, int64_t rows, int cols, int window, int fn,
                                  float a, float b, float c, float d, int run, int force_global,
                                  float* out, float* scratch, int64_t scratch_bytes,
                                  void* stream) {
  if (!valid_args(cols, window, fn) || rows < 0) return (int)cudaErrorInvalidValue;
  if (rows == 0 || cols == 0) return (int)cudaGetLastError();
  const Plan pl = make_plan(rows, cols, window, fn, run, force_global != 0);
  if (pl.scratch > scratch_bytes || (pl.scratch > 0 && scratch == nullptr))
    return (int)cudaErrorInvalidValue;
  const Params p{a, b, c, d};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (fn) {
    case DERIV: return launch_fn<DERIV>(x, rows, cols, window, p, pl, out, scratch, s);
    case PREDICT_LINEAR: return launch_fn<PREDICT_LINEAR>(x, rows, cols, window, p, pl, out, scratch, s);
    case HOLT_WINTERS: return launch_fn<HOLT_WINTERS>(x, rows, cols, window, p, pl, out, scratch, s);
    default: return launch_fn<QUANTILE>(x, rows, cols, window, p, pl, out, scratch, s);
  }
}
#endif

// Bytes of device scratch m3_temporal_window needs at this shape (0 when the
// row fits in shared memory), or -1 for arguments it does not take.
extern "C" int64_t m3_temporal_window_scratch_bytes(int64_t rows, int cols, int window, int fn,
                                                    int run, int force_global) {
  if (!valid_args(cols, window, fn) || rows < 0) return -1;
  if (rows == 0 || cols == 0) return 0;
  return make_plan(rows, cols, window, fn, run, force_global != 0).scratch;
}

// The launch's layout, into out int64[6]: threads a block, quantile's run,
// staged (1) or not (0), shared memory bytes a block, blocks, scratch bytes.
extern "C" int m3_temporal_window_shape(int64_t rows, int cols, int window, int fn, int run,
                                        int force_global, int64_t* out) {
  if (!valid_args(cols, window, fn) || rows <= 0 || cols == 0) return 1;
  const Plan pl = make_plan(rows, cols, window, fn, run, force_global != 0);
  out[0] = pl.threads;
  out[1] = pl.run;
  out[2] = pl.staged ? 1 : 0;
  out[3] = pl.smem;
  out[4] = pl.grid;
  out[5] = pl.scratch;
  return 0;
}

#ifndef __CUDACC__
// Host build of the same column code, one row at a time: the padded row in
// a buffer, a quantile run's window in a buffer of its own (stride 1).
extern "C" int m3_temporal_window_host(const float* x, int64_t rows, int cols, int window,
                                       int fn, float a, float b, float c, float d, int run,
                                       float* out) {
  if (!valid_args(cols, window, fn) || rows < 0) return 1;
  if (rows == 0 || cols == 0) return 0;
  const Plan pl = make_plan(rows, cols, window, fn, run, false);
  const Params p{a, b, c, d};
  const int pad = window - 1;
  std::vector<float> buf((size_t)pad + cols), win((size_t)window);
  const Row row{buf.data(), 0};
  for (int64_t r = 0; r < rows; ++r) {
    for (int i = 0; i < pad + cols; ++i) buf[i] = i < pad ? qnan() : x[r * cols + i - pad];
    float* orow = out + r * cols;
    if (fn == QUANTILE) {
      for (int t0 = 0; t0 < cols; t0 += pl.run)
        quantile_run(row, t0, min(t0 + pl.run, cols), window, p, win.data(), 1, orow);
      continue;
    }
    for (int t = 0; t < cols; ++t) {
      switch (fn) {
        case DERIV: orow[t] = column<DERIV>(row, t, window, p); break;
        case PREDICT_LINEAR: orow[t] = column<PREDICT_LINEAR>(row, t, window, p); break;
        default: orow[t] = column<HOLT_WINTERS>(row, t, window, p); break;
      }
    }
  }
  return 0;
}
#endif
