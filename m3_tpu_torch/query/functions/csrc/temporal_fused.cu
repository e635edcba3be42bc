// Fused temporal functions over a range matrix: the CUDA port of the Pallas
// kernel m3_tpu/query/functions/temporal_fused.py:_fused_call (its inline
// `kernel`), which evaluates up to 15 FUSABLE temporal functions over one
// f32 [S, T] matrix in one pass, one f32 [S, T] output per function.
//
// What it computes. For output column t of a row, the window is the input
// columns [max(0, t - w + 1), t]; NaN marks a missing sample. The functions
// and their NaN gates are those of m3_tpu/query/functions/temporal.py:
// sum/count/avg/min/max/last_over_time (NaN without a valid sample),
// stdvar/stddev_over_time (NaN below two; the row's nanmean is subtracted
// first, as the reference does, so the f32 sums do not cancel), rate /
// increase / delta (two distinct valid samples; counter corrections at
// resets, the zero-point clamp and extrapolation of rate.go), irate /
// idelta (the last two valid samples, both inside the window) and resets /
// changes (pairs of consecutive valid samples; NaN unless a valid sample
// follows the window's first slot).
//
// Design. One CTA per row. The row is staged in shared memory (T f32) and
// its nanmean taken by a block reduction; then each thread owns output
// columns t = tid, tid + blockDim, ... and scans its window once, in order,
// keeping the running sums, min/max, first/last/second-last valid sample,
// the counter correction and the reset/change counts. Consecutive valid
// samples inside the window are exactly the pairs whose event the
// reference counts (it excludes the event of the window's first valid
// sample, whose partner lies before the window), so no row-wide prev-valid
// arrays are needed. The scan is O(T * w) per row; w is a few steps in
// PromQL's common case. Every requested function is written from the same
// scan, so a multi-function call reads the row once.
//
// Bound. Memory: each input read once and each output written once,
// 4 bytes each; per function f32[S, T] in + out (0.581 GB at S=100000,
// T=726: 0.173 ms at 3.35 TB/s).
//
// Parity. The reference computes windowed sums with a doubling tree; this
// scan sums left to right, so sums differ by rounding (1e-4 abs + rel, and
// 5e-3 abs for stdvar/stddev, whose E[x^2] - mean^2 form amplifies it; see
// TOLERANCE.md). Counts, indices and NaN gates are exact. Every other step
// repeats the reference's f32 operations in its order. Build with
// -fmad=false (no FMA contraction) and without fast math; subnormals are
// kept, as torch keeps them.
//
// Without __CUDACC__ the per-column code compiles as host C++, which the
// CPU tests hold against the PyTorch twin.

#include <cmath>
#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __device__ __forceinline__
#else
#include <cstring>
#define M3_HD inline
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

M3_HD float qnan() { return __int_as_float(0x7FC00000); }
M3_HD float pos_inf() { return __int_as_float(0x7F800000); }

// One window [a, t] of a row, scanned left to right.
struct Window {
  float s, sb, ssb, mn, mx;  // sum, sum and sum of squares about the baseline
  int c;                     // valid samples
  int first_i, last_i, second_i;
  float first_v, last_v, second_v;
  float corr;                // counter correction: sum of prev at resets
  int nres, nchg;            // resets / changes among consecutive valid pairs
  bool valid_a;              // the window's first slot holds a valid sample

  M3_HD void scan(const float* x, int a, int t, float base) {
    s = 0.0f; sb = 0.0f; ssb = 0.0f;
    mn = pos_inf(); mx = -pos_inf();
    c = 0; first_i = -1; last_i = -1; second_i = -1;
    first_v = 0.0f; last_v = 0.0f; second_v = 0.0f;
    corr = 0.0f; nres = 0; nchg = 0;
    valid_a = x[a] == x[a];
    for (int j = a; j <= t; ++j) {
      const float v = x[j];
      if (v != v) continue;
      s = s + v;
      const float xb = v - base;
      sb = sb + xb;
      ssb = ssb + xb * xb;
      mn = v < mn ? v : mn;
      mx = v > mx ? v : mx;
      if (last_i >= 0) {
        if (v < last_v) { corr = corr + last_v; ++nres; }
        if (v != last_v) ++nchg;
      } else {
        first_i = j;
        first_v = v;
      }
      second_i = last_i;
      second_v = last_v;
      last_i = j;
      last_v = v;
      ++c;
    }
  }
};

// _rate_impl for output column t
M3_HD float rate_like(const Window& W, int t, float step, float duration, bool is_rate,
                      bool is_counter) {
  if (W.c < 2) return qnan();  // has_two: two distinct valid samples
  const float t_last = ((float)W.last_i - (float)t) * step;
  const float t_first = ((float)W.first_i - (float)t) * step;
  const float range_start = -duration;
  float duration_to_start = t_first - range_start;
  const float duration_to_end = -t_last;
  const float sampled_interval = t_last - t_first;
  const float span = (float)(W.last_i - W.first_i);
  const float avg_between = sampled_interval / (span > 1.0f ? span : 1.0f);
  float result = W.last_v - W.first_v + (is_counter ? W.corr : 0.0f);
  if (is_counter) {
    const float dur_to_zero = sampled_interval * (W.first_v / (result > 0.0f ? result : 1.0f));
    if (result > 0.0f && W.first_v >= 0.0f && dur_to_zero < duration_to_start)
      duration_to_start = dur_to_zero;
  }
  const float threshold = avg_between * 1.1f;
  float extrap = sampled_interval;
  extrap = extrap + (duration_to_start < threshold ? duration_to_start : avg_between / 2.0f);
  extrap = extrap + (duration_to_end < threshold ? duration_to_end : avg_between / 2.0f);
  result = result * (extrap / (sampled_interval > 1e-30f ? sampled_interval : 1e-30f));
  if (is_rate) result = result / duration;
  return result;
}

M3_HD float stdvar(const Window& W) {
  if (W.c < 2) return qnan();
  const float cf = (float)W.c;
  const float mean = W.sb / cf;
  const float var = W.ssb / cf - mean * mean;
  return var > 0.0f ? var : (var == var ? 0.0f : var);
}

M3_HD float eval(int fn, const Window& W, int t, float step, float duration) {
  const float nan = qnan();
  switch (fn) {
    case RATE: return rate_like(W, t, step, duration, true, true);
    case INCREASE: return rate_like(W, t, step, duration, false, true);
    case DELTA: return rate_like(W, t, step, duration, false, false);
    case IRATE:
    case IDELTA: {
      if (W.c < 2) return nan;  // the second-to-last valid sample lies in the window
      const float res = W.last_v - W.second_v;
      if (fn == IDELTA) return res;
      const float dt = (float)(W.last_i - W.second_i) * step;
      return res / (dt > 1e-30f ? dt : 1e-30f);
    }
    case RESETS: return W.c - (W.valid_a ? 1 : 0) > 0 ? (float)W.nres : nan;
    case CHANGES: return W.c - (W.valid_a ? 1 : 0) > 0 ? (float)W.nchg : nan;
    case SUM_OT: return W.c > 0 ? W.s : nan;
    case COUNT_OT: return W.c > 0 ? (float)W.c : nan;
    case AVG_OT: return W.c > 0 ? W.s / (float)W.c : nan;
    case MIN_OT: return W.c > 0 ? W.mn : nan;
    case MAX_OT: return W.c > 0 ? W.mx : nan;
    case LAST_OT: return W.last_i >= 0 ? W.last_v : nan;
    case STDDEV_OT: return sqrtf(stdvar(W));
    case STDVAR_OT: return stdvar(W);
    default: return nan;
  }
}

// All requested outputs of column t of one row (x is the row).
M3_HD void column(const float* x, int64_t row, int cols, int window, float step, float duration,
                  float base, const Outs& outs, int t) {
  const int a = t - window + 1 > 0 ? t - window + 1 : 0;
  Window W;
  W.scan(x, a, t, base);
  for (int i = 0; i < outs.n; ++i)
    outs.p[i][row * cols + t] = eval(outs.fn[i], W, t, step, duration);
}

#ifdef __CUDACC__
constexpr int kThreads = 128;

__global__ void __launch_bounds__(kThreads)
temporal_fused_kernel(const float* __restrict__ x, int cols, int window, float step,
                      float duration, Outs outs) {
  extern __shared__ float row[];
  __shared__ float red_s[kThreads / 32];
  __shared__ int red_c[kThreads / 32];
  const int64_t r = blockIdx.x;
  const float* src = x + r * cols;
  float s = 0.0f;
  int c = 0;
  for (int j = threadIdx.x; j < cols; j += kThreads) {
    const float v = src[j];
    row[j] = v;
    if (v == v) {
      s = s + v;
      ++c;
    }
  }
  // the row's nanmean (the stdvar baseline): warp shuffles, then one warp
  for (int off = 16; off > 0; off >>= 1) {
    s = s + __shfl_down_sync(0xffffffffu, s, off);
    c += __shfl_down_sync(0xffffffffu, c, off);
  }
  if ((threadIdx.x & 31) == 0) {
    red_s[threadIdx.x >> 5] = s;
    red_c[threadIdx.x >> 5] = c;
  }
  __syncthreads();
  float total = 0.0f;
  int count = 0;
  for (int i = 0; i < kThreads / 32; ++i) {
    total = total + red_s[i];
    count += red_c[i];
  }
  const float base = count > 0 ? total / (float)count : 0.0f;
  for (int t = threadIdx.x; t < cols; t += kThreads)
    column(row, r, cols, window, step, duration, base, outs, t);
}
#endif

}  // namespace

#ifdef __CUDACC__
// x f32[rows, cols] row-major; outs[i] f32[rows, cols] receives function
// fns[i] (ids of enum Fn), i < nfn. Returns cudaGetLastError() after the
// launch (cudaErrorInvalidValue for arguments it does not take).
extern "C" int m3_temporal_fused(const float* x, int64_t rows, int cols, int window,
                                 double step_seconds, float** outs, const int* fns, int nfn,
                                 void* stream) {
  if (nfn <= 0 || nfn > kMaxOuts || window <= 0 || cols < 0) return (int)cudaErrorInvalidValue;
  Outs o;
  o.n = nfn;
  for (int i = 0; i < nfn; ++i) {
    if (fns[i] < 0 || fns[i] >= NUM_FNS) return (int)cudaErrorInvalidValue;
    o.p[i] = outs[i];
    o.fn[i] = fns[i];
  }
  const size_t smem = (size_t)cols * sizeof(float);
  if (smem > 232448) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    const cudaError_t e = cudaFuncSetAttribute(
        temporal_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (rows > 0 && cols > 0) {
    temporal_fused_kernel<<<(unsigned)rows, kThreads, smem, (cudaStream_t)stream>>>(
        x, cols, window, (float)step_seconds, (float)((window - 1) * step_seconds), o);
  }
  return (int)cudaGetLastError();
}
#else
// Host build of the same per-column code; the baseline is summed left to
// right.
extern "C" int m3_temporal_fused_host(const float* x, int64_t rows, int cols, int window,
                                      double step_seconds, float** outs, const int* fns,
                                      int nfn) {
  if (nfn <= 0 || nfn > kMaxOuts || window <= 0 || cols < 0) return 1;
  Outs o;
  o.n = nfn;
  for (int i = 0; i < nfn; ++i) {
    if (fns[i] < 0 || fns[i] >= NUM_FNS) return 1;
    o.p[i] = outs[i];
    o.fn[i] = fns[i];
  }
  const float step = (float)step_seconds;
  const float duration = (float)((window - 1) * step_seconds);
  for (int64_t r = 0; r < rows; ++r) {
    const float* row = x + r * cols;
    float s = 0.0f;
    int c = 0;
    for (int j = 0; j < cols; ++j) {
      if (row[j] == row[j]) {
        s = s + row[j];
        ++c;
      }
    }
    const float base = c > 0 ? s / (float)c : 0.0f;
    for (int t = 0; t < cols; ++t) column(row, r, cols, window, step, duration, base, o, t);
  }
  return 0;
}
#endif
