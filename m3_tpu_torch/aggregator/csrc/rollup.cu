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
//   summed from +0 with zeros elsewhere: -0 and subnormals give +0.
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
// Design. B-5a: a thread a row folds its P slots in slot order (the sum
// order is sequential, so a row cannot be split across threads without
// changing its bits), with the window tree kept as one accumulator a level
// for P > 32. B-5b: rows of P <= 32 slots lie in segments of W lanes (W the
// power of two >= P), 32 / W rows a warp; each lane ranks its slot by the
// (key, slot) order against the segment's others by shuffles, and the
// lanes holding ranks lo and hi hand their values over by ballot and
// shuffle: no sort. Rows of P > 32 slots take a block each: a radix select
// over the order-preserving u32 key, 8 bits a pass (a shared-memory
// histogram), per distinct rank, reading the row from device memory, so any
// P the packer yields runs, rows longer than shared memory included.
// Bound: bytes. B-5a reads 9 bytes a slot and writes 32 a group; B-5b reads
// 5 a slot and writes 4 a quantile and group (about 0.26 and 0.13 ms at
// [10,000,000, 6] and three quantiles at 3.35 TB/s).
//
// Without __CUDACC__ the same folds, ranks and selects compile as host C++
// (m3_aggregate_dense_host, m3_dense_quantiles_host), so the CPU tests hold
// this source against the twins.

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
constexpr int kThreads = 256;
constexpr uint32_t kNanKey = 0xFFFFFFFFu;

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

// a < b with -0 below +0 (neither NaN).
M3_HD bool below(float a, float b) {
  return a < b || (a == b && (bits_of(a) >> 31) && !(bits_of(b) >> 31));
}

// A value summed from +0 with zeros beside it: flushed, -0 to +0.
M3_HD float picked(float x) {
  const float y = ftz(x);
  return y == 0.0f ? 0.0f : y;
}

// One row's sum in the window tree: an accumulator a level.
struct TreeSum {
  float acc[kMaxLevels + 1];
  int64_t pos[kMaxLevels + 1];

  M3_HD void clear(const Tree& t) {
    for (int l = 0; l <= t.levels; ++l) {
      acc[l] = 0.0f;
      pos[l] = 0;
    }
  }
  M3_HD void push(const Tree& t, float x) {
    int l = 0;
    for (;;) {
      acc[l] = add(acc[l], x);
      const int64_t i = pos[l]++;
      if (l == t.levels) return;
      if ((i + t.lo[l]) % kWindow != kWindow - 1 && i != t.n[l] - 1) return;
      x = acc[l];
      acc[l] = 0.0f;
      ++l;
    }
  }
};

// B-5a for one row: the eight fields into f[0..7] (kernels.FIELDS order).
M3_HD void fold_row(const float* v, const int32_t* t, const uint8_t* ok, int64_t p,
                    const Tree& tree, float* f) {
  int64_t c = 0;
  float s = 0.0f, ss = 0.0f;
  float mn = INFINITY, mx = -INFINITY;
  bool nan = false;
  int32_t best = 0;
  float last = 0.0f;
  if (p == 1) {  // XLA drops a reduce over one slot: the slot's value as it is
    c = ok[0] != 0;
    last = s = c ? v[0] : 0.0f;
    ss = mul(s, s);
    if (c) mn = mx = v[0];
  }
  TreeSum ts, tss;
  if (tree.levels > 0) {
    ts.clear(tree);
    tss.clear(tree);
  }
  for (int64_t j = 0; j < p && p > 1; ++j) {
    const bool valid = ok[j] != 0;
    const float x = valid ? v[j] : 0.0f;
    const int32_t te = valid ? t[j] : INT32_MIN;
    if (j == 0 || te > best) {
      best = te;
      last = x;
    }
    if (valid) {
      ++c;
      const float y = ftz(x);  // a compare and a select do not flush
      if (is_nan(y)) {
        nan = true;
      } else {
        if (below(y, mn)) mn = y;
        if (below(mx, y)) mx = y;
      }
    }
    if (tree.levels == 0) {
      s = add(s, x);
      ss = fma_(x, x, ss);
    } else {
      ts.push(tree, x);
      tss.push(tree, mul(x, x));
    }
  }
  if (tree.levels > 0) {
    s = ts.acc[tree.levels];
    ss = tss.acc[tree.levels];
  }
  const float cf = (float)c;
  const float div = mul(cf, add(cf, -1.0f));
  const float num = fma_(cf, ss, -mul(s, s));
  const float var = fdiv(num, div == 0.0f ? 1.0f : div);
  float sd = sqrtf(var > 0.0f || is_nan(var) ? var : 0.0f);
  sd = ftz_op(sd);
  const bool empty = c == 0;
  f[0] = empty ? 0.0f : s;
  f[1] = cf;
  f[2] = empty || nan ? NAN : mn;
  f[3] = empty || nan ? NAN : mx;
  f[4] = empty ? 0.0f : ss;
  f[5] = cf > 0.0f ? fdiv(s, cf > 1.0f ? cf : 1.0f) : 0.0f;
  f[6] = div == 0.0f ? 0.0f : sd;
  f[7] = empty ? NAN : p == 1 ? last : picked(last);
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

// A slot as the reference's sort sees it: invalid slots are +inf.
M3_HD float slot_value(const float* v, const uint8_t* ok, int64_t j) {
  return ok[j] ? v[j] : INFINITY;
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

// After a radix pass's histogram: the digit whose bin holds rank *k among
// the slots still in play, and *k made relative to that bin.
M3_HD uint32_t select_digit(const uint32_t* hist, int64_t* k) {
  int64_t acc = 0;
  for (uint32_t b = 0; b < 256; ++b) {
    if (acc + hist[b] > *k) {
      *k -= acc;
      return b;
    }
    acc += hist[b];
  }
  return 255;  // not reached: k < the slots in play
}

#ifdef __CUDACC__

__global__ void __launch_bounds__(kThreads)
    aggregate_dense_kernel(const float* __restrict__ vals, const int32_t* __restrict__ torder,
                           const uint8_t* __restrict__ valid, int64_t g, int64_t p, Tree tree,
                           float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * blockDim.x;
  for (int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x; r < g; r += stride) {
    float f[8];
    fold_row(vals + r * p, torder + r * p, valid + r * p, p, tree, f);
#pragma unroll
    for (int k = 0; k < 8; ++k) out[k * g + r] = f[k];
  }
}

// P <= 32: segments of W lanes, one row each.
template <int W>
__global__ void __launch_bounds__(kThreads)
    quantiles_warp_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ valid,
                          int64_t g, int p, Quantiles qs, float* __restrict__ out) {
  constexpr int kRows = 32 / W;
  constexpr uint32_t kSegMask = W == 32 ? 0xFFFFFFFFu : (1u << W) - 1u;
  const int lane = threadIdx.x & 31;
  const int seg = lane / W, j = lane % W;
  const int64_t warps = (int64_t)gridDim.x * (kThreads / 32);
  for (int64_t w = (int64_t)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
       w * kRows < g; w += warps) {
    const int64_t row = w * kRows + seg;
    const bool live = row < g && j < p;
    const bool ok = live && valid[row * p + j] != 0;
    const float x = ok ? vals[row * p + j] : INFINITY;
    const uint32_t key = live ? order_key(x) : kNanKey;
    const int shift = seg * W;
    const float n = (float)__popc((__ballot_sync(0xFFFFFFFFu, ok) >> shift) & kSegMask);
    int rank = 0;
#pragma unroll
    for (int m = 0; m < W; ++m) {
      const uint32_t km = __shfl_sync(0xFFFFFFFFu, key, m, W);
      rank += (km < key) || (km == key && m < j);
    }
    for (int i = 0; i < qs.n; ++i) {
      const Pick pk = quantile_pick(qs.q[i], n);
      const uint32_t at_lo = (__ballot_sync(0xFFFFFFFFu, rank == pk.lo) >> shift) & kSegMask;
      const uint32_t at_hi = (__ballot_sync(0xFFFFFFFFu, rank == pk.hi) >> shift) & kSegMask;
      const float vlo = __shfl_sync(0xFFFFFFFFu, x, shift + __ffs(at_lo) - 1);
      const float vhi = __shfl_sync(0xFFFFFFFFu, x, shift + __ffs(at_hi) - 1);
      if (j == 0 && row < g) out[i * g + row] = quantile_value(n, vlo, vhi, pk.frac);
    }
  }
}

// Any P: a block a row, a radix select per distinct rank.
__global__ void __launch_bounds__(kThreads)
    quantiles_block_kernel(const float* __restrict__ vals, const uint8_t* __restrict__ valid,
                           int64_t g, int64_t p, Quantiles qs, float* __restrict__ out) {
  __shared__ uint32_t hist[256];
  __shared__ unsigned long long count;
  __shared__ uint32_t sel_prefix;
  __shared__ long long sel_k;
  for (int64_t row = blockIdx.x; row < g; row += gridDim.x) {
    const float* v = vals + row * p;
    const uint8_t* ok = valid + row * p;
    if (threadIdx.x == 0) count = 0;
    __syncthreads();
    unsigned long long mine = 0;
    for (int64_t j = threadIdx.x; j < p; j += kThreads) mine += ok[j] != 0;
    atomicAdd(&count, mine);
    __syncthreads();
    const float n = (float)count;
    int64_t cached_rank[2] = {-1, -1};
    uint32_t cached_key[2] = {0, 0};
    for (int i = 0; i < qs.n; ++i) {
      const Pick pk = quantile_pick(qs.q[i], n);
      uint32_t keys[2];
      for (int h = 0; h < 2; ++h) {
        const int64_t want = h == 0 ? pk.lo : pk.hi;
        if (want == cached_rank[0]) { keys[h] = cached_key[0]; continue; }
        if (want == cached_rank[1]) { keys[h] = cached_key[1]; continue; }
        uint32_t prefix = 0, mask = 0;
        if (threadIdx.x == 0) sel_k = want;
        for (int shift = 24; shift >= 0; shift -= 8) {
          for (int b = threadIdx.x; b < 256; b += kThreads) hist[b] = 0;
          __syncthreads();
          for (int64_t j = threadIdx.x; j < p; j += kThreads) {
            const uint32_t k = order_key(slot_value(v, ok, j));
            if ((k & mask) == prefix) atomicAdd(&hist[(k >> shift) & 255u], 1u);
          }
          __syncthreads();
          if (threadIdx.x == 0) {
            int64_t k = sel_k;
            sel_prefix = prefix | (select_digit(hist, &k) << shift);
            sel_k = k;
          }
          __syncthreads();
          prefix = sel_prefix;
          mask |= 0xFFu << shift;
        }
        keys[h] = prefix;
        cached_rank[1] = cached_rank[0];
        cached_key[1] = cached_key[0];
        cached_rank[0] = want;
        cached_key[0] = prefix;
      }
      if (threadIdx.x == 0)
        out[i * g + row] = quantile_value(n, key_value(keys[0]), key_value(keys[1]), pk.frac);
    }
    __syncthreads();
  }
}

template <int W>
cudaError_t launch_warp(const float* vals, const uint8_t* valid, int64_t g, int p,
                        const Quantiles& qs, float* out, cudaStream_t stream) {
  const int64_t rows_per_block = (kThreads / 32) * (32 / W);
  int64_t blocks = (g + rows_per_block - 1) / rows_per_block;
  if (blocks > (1 << 30)) blocks = 1 << 30;
  quantiles_warp_kernel<W><<<(unsigned)blocks, kThreads, 0, stream>>>(vals, valid, g, p, qs, out);
  return cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace

#ifdef __CUDACC__

// B-5a: vals f32 [g, p], torder i32 [g, p], valid u8 [g, p] (contiguous, on
// the card) -> out f32 [8, g]. Returns the CUDA error of the launch.
extern "C" int m3_aggregate_dense(const float* vals, const int32_t* torder, const uint8_t* valid,
                                  int64_t g, int64_t p, float* out, void* stream) {
  if (g <= 0 || p <= 0) return 0;
  int64_t blocks = (g + kThreads - 1) / kThreads;
  if (blocks > (1 << 30)) blocks = 1 << 30;
  aggregate_dense_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      vals, torder, valid, g, p, make_tree(p), out);
  return (int)cudaGetLastError();
}

// B-5b: vals f32 [g, p], valid u8 [g, p] (contiguous, on the card), qs a
// host array of nq (1..32) quantiles -> out f32 [nq, g]. Rows of p <= 32
// slots take the warp route, longer rows the block route. Returns the CUDA
// error of the launch, or -1 for an nq out of range.
extern "C" int m3_dense_quantiles(const float* vals, const uint8_t* valid, int64_t g, int64_t p,
                                  const float* qs, int nq, float* out, void* stream) {
  if (nq < 1 || nq > kMaxQuantiles) return -1;
  if (g <= 0 || p <= 0) return 0;
  Quantiles q;
  q.n = nq;
  for (int i = 0; i < nq; ++i) q.q[i] = qs[i];
  const cudaStream_t s = (cudaStream_t)stream;
  if (p <= 32) {
    const int ip = (int)p;
    if (ip <= 1) return (int)launch_warp<1>(vals, valid, g, ip, q, out, s);
    if (ip <= 2) return (int)launch_warp<2>(vals, valid, g, ip, q, out, s);
    if (ip <= 4) return (int)launch_warp<4>(vals, valid, g, ip, q, out, s);
    if (ip <= 8) return (int)launch_warp<8>(vals, valid, g, ip, q, out, s);
    if (ip <= 16) return (int)launch_warp<16>(vals, valid, g, ip, q, out, s);
    return (int)launch_warp<32>(vals, valid, g, ip, q, out, s);
  }
  int64_t blocks = 0;
  cudaError_t e = m3::resident_blocks(quantiles_block_kernel, kThreads, 0, &blocks);
  if (e != cudaSuccess) return (int)e;
  if (blocks > g) blocks = g;
  quantiles_block_kernel<<<(unsigned)blocks, kThreads, 0, s>>>(vals, valid, g, p, q, out);
  return (int)cudaGetLastError();
}

#else  // host C++ build of the same folds, ranks and selects, for the CPU tests

extern "C" int m3_aggregate_dense_host(const float* vals, const int32_t* torder,
                                       const uint8_t* valid, int64_t g, int64_t p, float* out) {
  const Tree tree = make_tree(p);
  for (int64_t r = 0; r < g; ++r) {
    float f[8];
    fold_row(vals + r * p, torder + r * p, valid + r * p, p, tree, f);
    for (int k = 0; k < 8; ++k) out[k * g + r] = f[k];
  }
  return 0;
}

// Routes as in m3_dense_quantiles: the warp route ranks each slot against
// its segment's others lane by lane; the block route runs the radix select.
extern "C" int m3_dense_quantiles_host(const float* vals, const uint8_t* valid, int64_t g,
                                       int64_t p, const float* qs, int nq, float* out) {
  if (nq < 1 || nq > kMaxQuantiles) return -1;
  uint32_t hist[256];
  for (int64_t row = 0; row < g; ++row) {
    const float* v = vals + row * p;
    const uint8_t* ok = valid + row * p;
    int64_t c = 0;
    for (int64_t j = 0; j < p; ++j) c += ok[j] != 0;
    const float n = (float)c;
    for (int i = 0; i < nq; ++i) {
      const Pick pk = quantile_pick(qs[i], n);
      float picks[2];
      for (int h = 0; h < 2; ++h) {
        const int64_t want = h == 0 ? pk.lo : pk.hi;
        if (p <= 32) {
          picks[h] = NAN;
          for (int64_t j = 0; j < p; ++j) {
            const uint32_t key = order_key(slot_value(v, ok, j));
            int64_t rank = 0;
            for (int64_t m = 0; m < p; ++m) {
              const uint32_t km = order_key(slot_value(v, ok, m));
              rank += (km < key) || (km == key && m < j);
            }
            if (rank == want) picks[h] = slot_value(v, ok, j);
          }
        } else {
          uint32_t prefix = 0, mask = 0;
          int64_t k = want;
          for (int shift = 24; shift >= 0; shift -= 8) {
            memset(hist, 0, sizeof hist);
            for (int64_t j = 0; j < p; ++j) {
              const uint32_t key = order_key(slot_value(v, ok, j));
              if ((key & mask) == prefix) ++hist[(key >> shift) & 255u];
            }
            prefix |= select_digit(hist, &k) << shift;
            mask |= 0xFFu << shift;
          }
          picks[h] = key_value(prefix);
        }
      }
      out[i * g + row] = quantile_value(n, picks[0], picks[1], pk.frac);
    }
  }
  return 0;
}

#endif
