// Deterministic grouped reductions (kernel K3): the seven grouped ops of
// query/functions/aggregation.py (sum, count, avg, min, max, stdvar, stddev)
// over a tag grouping. It replaces, on the card, the port's index_add_ /
// index_reduce_ reductions, whose CUDA atomics add in the order they arrive,
// so that two runs of one query could differ in the last bits. The reference
// is m3_tpu/query/functions/aggregation.py:95-160 (jax.ops.segment_sum /
// segment_min / segment_max; XLA code, not a Pallas kernel).
//
// What it computes. values f32 [S, T] (row-major), pad_index i32 [G, M]: row
// g lists group g's series in ascending order, then -1. Output f32 [G, T]:
// per (group, column) the f32 left fold over the group's members in that
// order, which is the order the CPU twin (index_add_ on the CPU) and the
// reference (XLA's scatter on the CPU) add in, so the three agree bit for
// bit:
// - sum and count skip NaN (add 0); sum is NaN where count is 0;
// - avg = sum / max(count, 1), NaN where count is 0;
// - min / max read NaN as +inf / -inf; a zero result is -0 if a member is
//   -0 (min) and +0 if a member is +0 (max), as XLA's min and max order
//   -0 below +0; NaN where count is 0;
// - stdvar: the two-pass population variance, mean = sum / max(count, 1),
//   then the fold of (x - mean) * (x - mean) over the non-NaN members over
//   max(count, 1); stddev its correctly rounded square root.
// - f32 subnormals flush to a zero of the same sign, every input and every
//   arithmetic result, as XLA flushes them on the CPU and the TPU: min/max's
//   candidates explicitly (a compare and a select do not flush under
//   -ftz=true, and min/max keep the selected input), the sums' operands and
//   results by the card's -ftz=true arithmetic, and explicitly in the host
//   build (ftz_op).
// Build with -fmad=false, so that (x - mean) * (x - mean) and its sum stay
// separate f32 operations, with -ftz=true, and without fast math (IEEE
// division and sqrt).
//
// Design. One thread per (group, column); a block is 128 consecutive
// columns of one group (grid.x groups, grid.y column blocks), so a warp
// reads 32 consecutive floats of each member's row: one 128-byte request a
// member. The block stages the group's member list in shared memory, 1024
// at a time, and each thread issues 64 members' loads before it folds them
// in order, so that a thread has 64 loads in flight while the sum stays
// sequential: with G x T threads only (7,200 at 10 groups x 720 steps),
// loads in flight are what the time depends on (8 in flight ran several
// times slower on an H100), not the block size. Bound: each value
// read once (twice for stdvar) and each output written once.
//
// Without __CUDACC__ the same fold compiles as host C++ (m3_grouped_reduce_host),
// so the CPU tests hold this source against the twin.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __host__ __device__ __forceinline__
#else
#define M3_HD inline
#endif

namespace {

enum Op { kSum = 0, kCount, kAvg, kMin, kMax, kStdvar, kStddev, kNumOps };

constexpr int kThreads = 128;
constexpr int kStage = 1024;
constexpr int kUnroll = 64;

// The fold's state for one (group, column).
struct Acc {
  float s = 0.0f, c = 0.0f, m = 0.0f, ss = 0.0f, mean = 0.0f;
};

M3_HD bool is_nan(float x) { return x != x; }

// A subnormal to the zero of its sign (NaN and the rest unchanged).
M3_HD float ftz(float x) { return fabsf(x) < FLT_MIN ? copysignf(0.0f, x) : x; }

// An arithmetic operand or result flushed: the card's add, multiply and
// divide flush both themselves under -ftz=true (an explicit flush there
// costs registers and lengthens each fold's chain of dependent adds); the
// host build flushes them here.
M3_HD float ftz_op(float x) {
#ifdef __CUDA_ARCH__
  return x;
#else
  return ftz(x);
#endif
}

M3_HD bool sign_bit(float x) {
  uint32_t u;
  memcpy(&u, &x, sizeof u);
  return (u >> 31) != 0;
}

M3_HD void init(Acc& a, int op) {
  a.s = 0.0f;
  a.c = 0.0f;
  a.ss = 0.0f;
  a.m = op == kMin ? INFINITY : -INFINITY;
}

// Pass 1 (sum, count, min, max) or pass 2 (the squared deviations), one
// member at a time, in order.
M3_HD void fold(Acc& a, float x, int op, int pass) {
  x = ftz_op(x);
  const bool nan = is_nan(x);
  if (pass == 2) {
    const float d = ftz_op(x - a.mean);
    a.ss = ftz_op(a.ss + (nan ? 0.0f : ftz_op(d * d)));
    return;
  }
  a.c += nan ? 0.0f : 1.0f;
  if (op == kMin) {
    const float y = nan ? INFINITY : ftz(x);
    if (y < a.m || (y == 0.0f && a.m == 0.0f && sign_bit(y))) a.m = y;
  } else if (op == kMax) {
    const float y = nan ? -INFINITY : ftz(x);
    if (y > a.m || (y == 0.0f && a.m == 0.0f && !sign_bit(y))) a.m = y;
  } else {
    a.s = ftz_op(a.s + (nan ? 0.0f : x));
  }
}

M3_HD float finish_pass1(Acc& a, int op) {
  // for stdvar: the mean of pass 2 (NaN where count is 0, unused then)
  a.mean = a.c > 0.0f ? ftz_op(a.s / fmaxf(a.c, 1.0f)) : NAN;
  switch (op) {
    case kSum: return a.c > 0.0f ? a.s : NAN;
    case kCount: return a.c;
    case kAvg: return a.mean;
    default: return a.c > 0.0f ? a.m : NAN;  // kMin, kMax
  }
}

M3_HD float finish_pass2(const Acc& a, int op) {
  if (!(a.c > 0.0f)) return NAN;
  const float var = ftz_op(a.ss / fmaxf(a.c, 1.0f));
#ifdef __CUDA_ARCH__
  return op == kStddev ? __fsqrt_rn(var) : var;
#else
  return op == kStddev ? std::sqrt(var) : var;
#endif
}

}  // namespace

#ifdef __CUDACC__

namespace {

// One pass over group g's members for this thread's column t.
__device__ __forceinline__ void walk(Acc& a, const float* __restrict__ values, int64_t cols,
                                     int64_t t, bool live, const int32_t* __restrict__ members,
                                     int64_t m, int op, int pass, int32_t* idx, int* first_neg) {
  for (int64_t base = 0; base < m; base += kStage) {
    const int n = (int)(m - base < kStage ? m - base : kStage);
    __syncthreads();  // the previous stage is read by every thread
    if (threadIdx.x == 0) *first_neg = n;
    __syncthreads();
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int32_t r = members[base + j];
      idx[j] = r;
      if (r < 0) atomicMin(first_neg, j);
    }
    __syncthreads();
    const int nv = *first_neg;  // members end at the first -1
    if (live) {
      int j = 0;
      for (; j + kUnroll <= nv; j += kUnroll) {
        float x[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) x[u] = values[(int64_t)idx[j + u] * cols + t];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) fold(a, x[u], op, pass);
      }
      for (; j < nv; ++j) fold(a, values[(int64_t)idx[j] * cols + t], op, pass);
    }
    if (nv < n) return;  // uniform over the block
  }
}

__global__ void __launch_bounds__(kThreads)
    grouped_reduce_kernel(const float* __restrict__ values, int64_t cols,
                          const int32_t* __restrict__ pad_index, int64_t m, int op,
                          float* __restrict__ out) {
  __shared__ int32_t idx[kStage];
  __shared__ int first_neg;
  const int64_t g = blockIdx.x;
  const int64_t t = (int64_t)blockIdx.y * kThreads + threadIdx.x;
  const bool live = t < cols;
  const int32_t* members = pad_index + g * m;
  Acc a;
  init(a, op);
  walk(a, values, cols, t, live, members, m, op, 1, idx, &first_neg);
  float r = finish_pass1(a, op);
  if (op == kStdvar || op == kStddev) {
    walk(a, values, cols, t, live, members, m, op, 2, idx, &first_neg);
    r = finish_pass2(a, op);
  }
  if (live) out[g * cols + t] = r;
}

}  // namespace

// out[G, T] for op 0..6 (sum, count, avg, min, max, stdvar, stddev); every
// pointer a device pointer, values [S, T] and pad_index [G, M] contiguous.
extern "C" int m3_grouped_reduce(const void* values, int64_t cols, const void* pad_index,
                                 int64_t groups, int64_t m, int op, void* out, void* stream) {
  if (op < 0 || op >= kNumOps || m < 1) return (int)cudaErrorInvalidValue;
  if (groups <= 0 || cols <= 0) return 0;
  const int64_t col_blocks = (cols + kThreads - 1) / kThreads;
  if (groups > 0x7fffffff || col_blocks > 65535) return (int)cudaErrorInvalidValue;
  grouped_reduce_kernel<<<dim3((unsigned)groups, (unsigned)col_blocks), kThreads, 0,
                          (cudaStream_t)stream>>>((const float*)values, cols,
                                                  (const int32_t*)pad_index, m, op, (float*)out);
  return (int)cudaGetLastError();
}

#else  // host C++ build of the same fold, for the CPU tests

extern "C" int m3_grouped_reduce_host(const float* values, int64_t cols, const int32_t* pad_index,
                                      int64_t groups, int64_t m, int op, float* out) {
  if (op < 0 || op >= kNumOps || m < 1) return 1;
  for (int64_t g = 0; g < groups; ++g) {
    const int32_t* members = pad_index + g * m;
    int64_t nv = 0;
    while (nv < m && members[nv] >= 0) ++nv;
    for (int64_t t = 0; t < cols; ++t) {
      Acc a;
      init(a, op);
      for (int64_t j = 0; j < nv; ++j) fold(a, values[(int64_t)members[j] * cols + t], op, 1);
      float r = finish_pass1(a, op);
      if (op == kStdvar || op == kStddev) {
        for (int64_t j = 0; j < nv; ++j) fold(a, values[(int64_t)members[j] * cols + t], op, 2);
        r = finish_pass2(a, op);
      }
      out[g * cols + t] = r;
    }
  }
  return 0;
}

#endif
