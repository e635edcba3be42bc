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
// Design. A block takes WC consecutive columns of one group (WC 8, 16 or 32,
// a template parameter); block b is column block b % ceil(T / WC) of group
// b / ceil(T / WC), so a group's blocks run side by side. The entry picks
// the widest WC whose G x ceil(T / WC) blocks reach the card's SM count, and
// WC = 8 otherwise: one group of 720 columns runs 90 blocks, ten groups 230.
// Warp 0 folds: its lane c < WC owns column c0 + c and folds the group's
// members in row order with the fold above. Warps 1-7 copy, by cp.async:
// each batch's member list into an index ring kStages batches ahead, then,
// reading the rows from there, each member's WC floats (one to four 32-byte
// sectors of its row) into a ring of kStages batches of kBatch members in
// dynamic shared memory: 1,024 members deep at WC 8 and 16 (32 and 64 KB),
// 512 at WC 32 (64 KB). A copy is 16 bytes where the row stride and the
// base are 16-byte aligned, else 4. One __syncthreads a batch: batch i is
// folded while batches i + 1 .. i + kStages - 1 are in flight, so loads in
// flight are bounded by the ring, not by a thread's registers, and no copy
// waits on the load of its row index. A group's members end at its first
// -1: a producer that reads one notes its position (atomicMin in shared
// memory), which the fold reads behind the barrier of its batch. Stdvar
// and stddev walk the rings again for pass 2. On one group the fold is what
// is left: one warp issues its ~7 instructions a member at well under one a
// cycle (~14 cycles a member on an H100, where the chain of adds needs 4).
// Bound: the larger of the bytes (each value read once, twice for stdvar,
// each output written once) over the memory rate, and the fold's chain of M
// dependent adds (M the largest group, ~4 cycles an add) over the SM clock.
//
// Without __CUDACC__ the same batch walk and fold compile as host C++
// (m3_grouped_reduce_host): the ring's batches
// are copied and folded in turn, one column after another, so the CPU tests
// hold this source, its column blocks and its ring, against the twin.

#include <cfloat>
#include <cmath>
#include <cstdint>
#include <cstring>

#include "../../../csrc/launch.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __host__ __device__ __forceinline__
#else
#include <vector>
#define M3_HD inline
#endif

namespace {

enum Op { kSum = 0, kCount, kAvg, kMin, kMax, kStdvar, kStddev, kNumOps };

constexpr int kThreads = 256;  // warp 0 folds, warps 1-7 copy
constexpr int kProducers = kThreads - 32;
constexpr int kStages = 4;     // batches in the ring
constexpr int kUnroll = 8;     // ring reads issued before their folds

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

// Members a batch of the ring holds at width WC, and the ring's size.
template <int WC>
struct Ring {
  static_assert(WC == 8 || WC == 16 || WC == 32, "WC is 8, 16 or 32");
  static constexpr int kBatch = WC == 32 ? 128 : 256;
  static constexpr int kFloats = kStages * kBatch * WC;
  static constexpr size_t kBytes = kFloats * sizeof(float);
  // log2 of a member's copies: WC / 4 of 16 bytes, or WC of 4
  static constexpr int kShift16 = WC == 8 ? 1 : (WC == 16 ? 2 : 3);
  static constexpr int kShift4 = kShift16 + 2;
};

// The widest WC whose blocks reach `sms`, else 8.
M3_HD int pick_width(int64_t groups, int64_t cols, int64_t sms) {
  for (int wc = 32; wc > 8; wc /= 2)
    if (groups * ((cols + wc - 1) / wc) >= sms) return wc;
  return 8;
}

// Members of batch b that the fold takes: those before the first -1
// (first_neg; m while none was seen) and before m.
M3_HD int batch_count(int64_t first_neg, int64_t b, int64_t m, int batch) {
  int64_t end = (b + 1) * batch;
  if (end > first_neg) end = first_neg;
  if (end > m) end = m;
  const int64_t n = end - b * batch;
  return n < 0 ? 0 : (int)n;
}

M3_HD void copy16(float* dst, const float* src) {
#ifdef __CUDA_ARCH__
  m3::cp_async16(dst, src);
#else
  memcpy(dst, src, 16);
#endif
}

template <class T>
M3_HD void copy4(T* dst, const T* src) {
  static_assert(sizeof(T) == 4, "a 4-byte copy");
#ifdef __CUDA_ARCH__
  m3::cp_async4(dst, src);
#else
  *dst = *src;
#endif
}

M3_HD void note_end(long long* first_neg, long long at) {
#ifdef __CUDA_ARCH__
  atomicMin(first_neg, at);
#else
  if (at < *first_neg) *first_neg = at;
#endif
}

// A batch's member list is copied into an index ring in shared memory
// kStages batches ahead of its rows, so that a row's copy never waits on
// the load of its index: kIdxSlots slots of kBatch ints. The copies of
// batch b's list: positions q0, q0 + dq, ... below m.
constexpr int kIdxSlots = kStages + 1;

template <int WC>
M3_HD void issue_members(const int32_t* members, int64_t m, int64_t b, int32_t* idx, int q0,
                         int dq) {
  constexpr int B = Ring<WC>::kBatch;
  for (int mm = q0; mm < B && b * B + mm < m; mm += dq)
    copy4(idx + (b % kIdxSlots) * B + mm, members + b * B + mm);
}

// The producers' copies of batch b's rows into `slot` ([kBatch, WC]
// floats), their indices read from the batch's index slot: copies q0,
// q0 + dq, ..., copy q being part q % P of member q / P (P = WC / 4 copies
// of 16 bytes, or WC of 4). A -1 is noted in first_neg and not copied; nor
// is a row past `rows` or a part past the last column.
template <int WC>
M3_HD void issue_batch(const float* values, int64_t rows, int64_t cols, int64_t c0,
                       const int32_t* idx, int64_t m, int64_t b, float* slot, bool vec16, int q0,
                       int dq, long long* first_neg) {
  constexpr int B = Ring<WC>::kBatch;
  const int shift = vec16 ? Ring<WC>::kShift16 : Ring<WC>::kShift4;
  const int width = vec16 ? 4 : 1;
  const int32_t* list = idx + (b % kIdxSlots) * B;
  for (int q = q0; q < (B << shift); q += dq) {
    const int mm = q >> shift, part = q & ((1 << shift) - 1);
    const int64_t at = b * B + mm;
    if (at >= m) break;
    const int32_t r = list[mm];
    if (r < 0) {
      if (part == 0) note_end(first_neg, at);
      continue;
    }
    const int64_t col = c0 + part * width;
    if (r >= rows || col >= cols) continue;
    const float* src = values + (int64_t)r * cols + col;
    float* dst = slot + mm * WC + part * width;
    if (vec16) copy16(dst, src);
    else copy4(dst, src);
  }
}

// Fold the first n members of a ring slot into one column's state, in
// order; `col` is the slot's first float of that column. The next kUnroll
// members are read while the present ones fold, so the fold does not wait
// on its reads.
template <int WC, int PASS>
M3_HD void fold_batch(Acc& a, const float* col, int n, int op) {
  constexpr int pass = PASS;
  int k = 0;
  if (n >= kUnroll) {
    float x[kUnroll];
    for (int u = 0; u < kUnroll; ++u) x[u] = col[u * WC];
    for (; k + 2 * kUnroll <= n; k += kUnroll) {
      float y[kUnroll];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int u = 0; u < kUnroll; ++u) y[u] = col[(k + kUnroll + u) * WC];
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
      for (int u = 0; u < kUnroll; ++u) {
        fold(a, x[u], op, pass);
        x[u] = y[u];
      }
    }
#ifdef __CUDA_ARCH__
#pragma unroll
#endif
    for (int u = 0; u < kUnroll; ++u) fold(a, x[u], op, pass);
    k += kUnroll;
  }
  for (; k < n; ++k) fold(a, col[k * WC], op, pass);
}

// 16-byte copies need 16-byte aligned rows and base.
M3_HD bool rows_aligned16(const float* values, int64_t cols) {
  return cols % 4 == 0 && (reinterpret_cast<uintptr_t>(values) & 15) == 0;
}

}  // namespace

#ifdef __CUDACC__

namespace {

// One pass over the group's first m members through the ring; returns the
// members folded (those before the first -1). Step k copies batch k's rows
// and batch k + kStages's member list; the steps run kStages - 1 batches
// ahead of the fold, one __syncthreads apart.
template <int WC, int OP, int PASS>
__device__ __forceinline__ int64_t walk(Acc& a, const float* __restrict__ values, int64_t rows,
                                        int64_t cols, int64_t c0,
                                        const int32_t* __restrict__ members, int64_t m,
                                        bool vec16, float* ring, int32_t* idx,
                                        long long* first_neg, bool live, int lane) {
  constexpr int B = Ring<WC>::kBatch;
  const int64_t nb = (m + B - 1) / B;
  const bool producer = threadIdx.x >= 32;
  const int q0 = threadIdx.x - 32;
  auto step = [&](int64_t k) {
    if (producer) {
      if (k < nb)
        issue_batch<WC>(values, rows, cols, c0, idx, m, k, ring + (k % kStages) * B * WC, vec16,
                        q0, kProducers, first_neg);
      if (k + kStages < nb) issue_members<WC>(members, m, k + kStages, idx, q0, kProducers);
    }
    m3::cp_async_commit();
  };
  if (producer)
    for (int k = 0; k < kStages && k < nb; ++k) issue_members<WC>(members, m, k, idx, q0, kProducers);
  m3::cp_async_commit();
  m3::cp_async_wait<0>();
  __syncthreads();  // the first kStages member lists are staged
  for (int k = 0; k < kStages - 1; ++k) {
    step(k);
    __syncthreads();  // batch k's list is read before its slot is copied over
  }
  int64_t done = 0;
  for (int64_t b = 0; b < nb; ++b) {
    m3::cp_async_wait<kStages - 2>();  // this thread's copies of batch b (and of a later list)
    __syncthreads();  // everyone's; ring slot (b - 1) % kStages is free
    // a -1 noted during this step lies in batch b + kStages - 1, so every
    // thread reads the same count
    const int n = batch_count(*(volatile long long*)first_neg, b, m, B);
    step(b + kStages - 1);
    if (live) fold_batch<WC, PASS>(a, ring + (b % kStages) * B * WC + lane, n, OP);
    done = b * B + n;
    if (n < B) break;  // the first -1 or the last member: uniform over the block
  }
  m3::cp_async_wait<0>();
  __syncthreads();  // the rings are free for the next pass
  return done;
}

template <int WC, int OP>
__global__ void __launch_bounds__(kThreads)
    grouped_reduce_kernel(const float* __restrict__ values, int64_t rows, int64_t cols,
                          const int32_t* __restrict__ pad_index, int64_t m, int vec16,
                          float* __restrict__ out) {
  extern __shared__ __align__(16) float ring[];
  __shared__ int32_t idx[kIdxSlots * Ring<WC>::kBatch];
  __shared__ long long first_neg;
  const int64_t ncb = (cols + WC - 1) / WC;
  const int64_t g = blockIdx.x / ncb;
  const int64_t c0 = ((int64_t)blockIdx.x - g * ncb) * WC;
  const int lane = threadIdx.x & 31;
  const bool live = threadIdx.x < WC && c0 + lane < cols;
  const int32_t* members = pad_index + g * m;
  if (threadIdx.x == 0) first_neg = m;
  __syncthreads();
  Acc a;
  init(a, OP);
  const int64_t nv = walk<WC, OP, 1>(a, values, rows, cols, c0, members, m, vec16, ring, idx,
                                     &first_neg, live, lane);
  float r = finish_pass1(a, OP);
  if (OP == kStdvar || OP == kStddev) {
    walk<WC, OP, 2>(a, values, rows, cols, c0, members, nv, vec16, ring, idx, &first_neg, live,
                    lane);
    r = finish_pass2(a, OP);
  }
  if (live) out[g * cols + c0 + lane] = r;
}

template <int WC, int OP>
cudaError_t launch_op(const float* values, int64_t rows, int64_t cols, const int32_t* pad_index,
                      int64_t groups, int64_t m, float* out, cudaStream_t stream) {
  const auto kernel = grouped_reduce_kernel<WC, OP>;
  int64_t resident = 0;  // raises the kernel's shared memory limit to the ring's size
  const cudaError_t e = m3::resident_blocks(kernel, kThreads, Ring<WC>::kBytes, &resident);
  if (e != cudaSuccess) return e;
  const int64_t blocks = groups * ((cols + WC - 1) / WC);
  kernel<<<(unsigned)blocks, kThreads, Ring<WC>::kBytes, stream>>>(
      values, rows, cols, pad_index, m, rows_aligned16(values, cols) ? 1 : 0, out);
  return cudaGetLastError();
}

template <int WC>
cudaError_t launch_width(const float* values, int64_t rows, int64_t cols,
                         const int32_t* pad_index, int64_t groups, int64_t m, int op, float* out,
                         cudaStream_t stream) {
  switch (op) {
    case kSum: return launch_op<WC, kSum>(values, rows, cols, pad_index, groups, m, out, stream);
    case kCount: return launch_op<WC, kCount>(values, rows, cols, pad_index, groups, m, out, stream);
    case kAvg: return launch_op<WC, kAvg>(values, rows, cols, pad_index, groups, m, out, stream);
    case kMin: return launch_op<WC, kMin>(values, rows, cols, pad_index, groups, m, out, stream);
    case kMax: return launch_op<WC, kMax>(values, rows, cols, pad_index, groups, m, out, stream);
    case kStdvar:
      return launch_op<WC, kStdvar>(values, rows, cols, pad_index, groups, m, out, stream);
    default:
      return launch_op<WC, kStddev>(values, rows, cols, pad_index, groups, m, out, stream);
  }
}

cudaError_t sm_count(int64_t* out) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = sms;
  return e;
}

}  // namespace

// The column-block width (8, 16 or 32) the entry picks for G groups of T
// columns on the current card; 0 if the card cannot be asked.
extern "C" int m3_grouped_reduce_width(int64_t groups, int64_t cols) {
  int64_t sms = 0;
  if (sm_count(&sms) != cudaSuccess) return 0;
  return pick_width(groups, cols, sms);
}

// out[G, T] for op 0..6 (sum, count, avg, min, max, stdvar, stddev); every
// pointer a device pointer, values [rows, T] and pad_index [G, M]
// contiguous. wc: the column-block width, 8, 16 or 32, or 0 to pick it by
// shape (m3_grouped_reduce_width).
extern "C" int m3_grouped_reduce(const void* values, int64_t rows, int64_t cols,
                                 const void* pad_index, int64_t groups, int64_t m, int op, int wc,
                                 void* out, void* stream) {
  if (op < 0 || op >= kNumOps || m < 1 || rows < 0) return (int)cudaErrorInvalidValue;
  if (wc != 0 && wc != 8 && wc != 16 && wc != 32) return (int)cudaErrorInvalidValue;
  if (groups <= 0 || cols <= 0) return 0;
  if (wc == 0) {
    int64_t sms = 0;
    const cudaError_t e = sm_count(&sms);
    if (e != cudaSuccess) return (int)e;
    wc = pick_width(groups, cols, sms);
  }
  if (groups > 0x7fffffff / ((cols + wc - 1) / wc)) return (int)cudaErrorInvalidValue;
  const float* v = (const float*)values;
  const int32_t* pad = (const int32_t*)pad_index;
  float* o = (float*)out;
  const cudaStream_t s = (cudaStream_t)stream;
  const cudaError_t e =
      wc == 32 ? launch_width<32>(v, rows, cols, pad, groups, m, op, o, s)
      : wc == 16 ? launch_width<16>(v, rows, cols, pad, groups, m, op, o, s)
                 : launch_width<8>(v, rows, cols, pad, groups, m, op, o, s);
  return (int)e;
}

#else  // host C++ build of the same batch walk and fold, for the CPU tests

namespace {

// The block of (g, c0), sequentially: each step copies a batch's rows and a
// later batch's member list, kStages - 1 batches ahead of the fold, as on
// the card; then each of the block's columns folds the batch in turn.
template <int WC>
int64_t host_walk(Acc* acc, int live, int op, int pass, const float* values, int64_t rows,
                  int64_t cols, int64_t c0, const int32_t* members, int64_t m, bool vec16,
                  float* ring, int32_t* idx, long long* first_neg) {
  constexpr int B = Ring<WC>::kBatch;
  const int64_t nb = (m + B - 1) / B;
  auto step = [&](int64_t k) {
    if (k < nb)
      issue_batch<WC>(values, rows, cols, c0, idx, m, k, ring + (k % kStages) * B * WC, vec16, 0,
                      1, first_neg);
    if (k + kStages < nb) issue_members<WC>(members, m, k + kStages, idx, 0, 1);
  };
  for (int k = 0; k < kStages && k < nb; ++k) issue_members<WC>(members, m, k, idx, 0, 1);
  for (int k = 0; k < kStages - 1; ++k) step(k);
  int64_t done = 0;
  for (int64_t b = 0; b < nb; ++b) {
    const int n = batch_count(*first_neg, b, m, B);
    step(b + kStages - 1);
    for (int c = 0; c < live; ++c) {
      const float* col = ring + (b % kStages) * B * WC + c;
      if (pass == 1) fold_batch<WC, 1>(acc[c], col, n, op);
      else fold_batch<WC, 2>(acc[c], col, n, op);
    }
    done = b * B + n;
    if (n < B) break;
  }
  return done;
}

template <int WC>
void host_reduce(const float* values, int64_t rows, int64_t cols, const int32_t* pad_index,
                 int64_t groups, int64_t m, int op, float* out) {
  std::vector<float> ring(Ring<WC>::kFloats);
  std::vector<int32_t> idx(kIdxSlots * Ring<WC>::kBatch);
  const bool vec16 = rows_aligned16(values, cols);
  for (int64_t g = 0; g < groups; ++g) {
    for (int64_t c0 = 0; c0 < cols; c0 += WC) {
      const int live = (int)(cols - c0 < WC ? cols - c0 : WC);
      long long first_neg = m;
      Acc acc[WC];
      for (int c = 0; c < live; ++c) init(acc[c], op);
      const int32_t* members = pad_index + g * m;
      const int64_t nv = host_walk<WC>(acc, live, op, 1, values, rows, cols, c0, members, m,
                                       vec16, ring.data(), idx.data(), &first_neg);
      for (int c = 0; c < live; ++c) {
        float r = finish_pass1(acc[c], op);
        out[g * cols + c0 + c] = r;
      }
      if (op == kStdvar || op == kStddev) {
        host_walk<WC>(acc, live, op, 2, values, rows, cols, c0, members, nv, vec16, ring.data(),
                      idx.data(), &first_neg);
        for (int c = 0; c < live; ++c) out[g * cols + c0 + c] = finish_pass2(acc[c], op);
      }
    }
  }
}

}  // namespace

// wc: the column-block width, 8, 16 or 32, or 0 for the one an H100 (132
// SMs) would pick for this shape; rows unchecked.
extern "C" int m3_grouped_reduce_host(const float* values, int64_t cols, const int32_t* pad_index,
                                      int64_t groups, int64_t m, int op, int wc, float* out) {
  if (op < 0 || op >= kNumOps || m < 1) return 1;
  const int64_t rows = INT64_MAX;
  if (wc == 0) wc = pick_width(groups, cols, 132);
  if (wc == 32) host_reduce<32>(values, rows, cols, pad_index, groups, m, op, out);
  else if (wc == 16) host_reduce<16>(values, rows, cols, pad_index, groups, m, op, out);
  else if (wc == 8) host_reduce<8>(values, rows, cols, pad_index, groups, m, op, out);
  else return 1;
  return 0;
}

#endif
