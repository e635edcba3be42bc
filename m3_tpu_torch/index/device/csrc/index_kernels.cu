// Device kernels of the inverted index's device tier: K1, the batched term
// lookup, and K2, the postings union into a packed doc bitmap. They replace
// the XLA programs of m3_tpu/index/device/kernels.py: K1 match_terms_traced
// (:133), K2 bitmap_from_terms_traced (:236) and bitmap_from_term_range_traced
// (:251) over _mask_to_bitmap (:269).
//
// Term keys. A segment's terms are sorted per field and keyed as their bytes
// zero-padded to k words, read as big-endian u32 words, with the byte length
// as the tiebreak. (words, length) orders exactly like the raw bytes, NUL
// extensions included (kernels.py host_key_lt is the host copy of the
// compare). Keys, lengths, postings and bitmaps are int32 tensors on the
// PyTorch side, read here as their u32 bit patterns.
//
// K1: one thread per query row b. A lower-bound binary search of q_keys[b]
// over [lo[b], hi[b]) of the key matrix; the result is the global index of
// the first key >= the query when that key equals the query (all words and
// the length), else -1; a row with q_len < 0 (a value wider than the keys)
// gives -1. The reference runs a fixed bit_length(n_terms) iterations of a
// clamped search over a power-of-two padded batch; the lower bound of a
// sorted range is unique, so this loop (while lo < hi) gives the same index
// on every row that exists. Bound: log2(n) key reads of k words a row, a
// few KB a call, so a launch costs its latency.
//
// K2: the bitmap has one bit a doc, bit j of word w is doc 32w + j, and the
// bits past n_docs stay 0. The reference builds a difference array and a
// cumsum over the whole field's postings slab, O(field postings) even for
// one term. Here the entry zeroes the words (cudaMemsetAsync on the stream)
// and a kernel sets the bits of the selected postings only, with atomicOr:
// - a list of terms: blockIdx.x is the listed term (-1 skipped), and the
//   blocks of grid.y stride over that term's [start, end);
// - a range of terms [lo, hi): its postings are the one contiguous run
//   [post_idx[lo].start, post_idx[hi - 1].end) of post_data (terms append
//   field by field and term by term), which a 1-D grid strides over.
// OR is idempotent and commutative, so the words are the same in every run
// and equal the reference's. Each warp reads 32 consecutive postings; a
// term's postings ascend, so runs of lanes share a word: a segmented OR
// over the warp (shuffles, runs of equal words) leaves one atomicOr a run,
// issued by the run's first lane. Bound: 4 bytes a posting read and the
// words written once.
//
// Without __CUDACC__ the same row and warp code compiles as host C++: the
// *_host entries walk query rows one by one and postings in 32-lane groups,
// with the segmented OR over an array, so the CPU tests hold this source
// against the plain PyTorch twins of index/device/kernels.py.

#include <cstdint>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __host__ __device__ __forceinline__
#else
#include <cstring>
#define M3_HD inline
#endif

namespace {

constexpr int kThreads = 256;

// a < b in the (words, length) order.
M3_HD bool key_lt(const uint32_t* a, int32_t a_len, const uint32_t* b, int32_t b_len, int k) {
  for (int i = 0; i < k; ++i)
    if (a[i] != b[i]) return a[i] < b[i];
  return a_len < b_len;
}

// K1 for one query row. Bounds outside [0, n] are clamped to it (they do
// not occur: the store hands each row its field's range).
M3_HD int32_t match_row(const uint32_t* keys, const int32_t* lens, int64_t n, int k, int32_t lo,
                        int32_t hi, const uint32_t* q, int32_t q_len) {
  if (q_len < 0) return -1;
  if (lo < 0) lo = 0;
  if (hi > n) hi = (int32_t)n;
  const int32_t end = hi;
  while (lo < hi) {
    const int32_t mid = lo + ((hi - lo) >> 1);
    if (key_lt(keys + (int64_t)mid * k, lens[mid], q, q_len, k))
      lo = mid + 1;
    else
      hi = mid;
  }
  if (lo >= end || lens[lo] != q_len) return -1;
  const uint32_t* a = keys + (int64_t)lo * k;
  for (int i = 0; i < k; ++i)
    if (a[i] != q[i]) return -1;
  return lo;
}

// The word and bit a posting sets; word -1 for a doc past the bitmap (it
// does not occur: postings hold the segment's own doc ordinals).
M3_HD void posting_bit(int32_t doc, int64_t n_words, int32_t* word, uint32_t* bit) {
  const uint32_t d = (uint32_t)doc;
  if ((int64_t)d < n_words * 32) {
    *word = (int32_t)(d >> 5);
    *bit = 1u << (d & 31);
  } else {
    *word = -1;
    *bit = 0;
  }
}

}  // namespace

#ifdef __CUDACC__

namespace {

__global__ void match_terms_kernel(const uint32_t* __restrict__ keys,
                                   const int32_t* __restrict__ lens, int64_t n, int k,
                                   const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                                   const uint32_t* __restrict__ q_keys,
                                   const int32_t* __restrict__ q_lens, int64_t rows,
                                   int32_t* __restrict__ out) {
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  out[r] = match_row(keys, lens, n, k, lo[r], hi[r], q_keys + r * k, q_lens[r]);
}

// Sets the bits of post_data[s, e) with one atomicOr per run of lanes that
// share a word. `warp` and `n_warps` number the warps striding over the run;
// the loop is uniform over a warp, so the shuffles see all 32 lanes.
__device__ __forceinline__ void or_span(const int32_t* __restrict__ post_data, int64_t s,
                                        int64_t e, int64_t warp, int64_t n_warps,
                                        int64_t n_words, uint32_t* __restrict__ words) {
  const int lane = threadIdx.x & 31;
  for (int64_t i0 = s + warp * 32; i0 < e; i0 += n_warps * 32) {
    const int64_t i = i0 + lane;
    int32_t word = -1;
    uint32_t bit = 0;
    if (i < e) posting_bit(post_data[i], n_words, &word, &bit);
    // segmented OR: after the steps, a lane holds the OR of its run from
    // itself to the run's end
    uint32_t acc = bit;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const uint32_t o = __shfl_down_sync(0xffffffffu, acc, off);
      const int32_t ow = __shfl_down_sync(0xffffffffu, word, off);
      if (lane + off < 32 && ow == word) acc |= o;
    }
    const int32_t prev = __shfl_up_sync(0xffffffffu, word, 1);
    if (word >= 0 && (lane == 0 || prev != word)) atomicOr(words + word, acc);
  }
}

__global__ void bitmap_terms_kernel(const int32_t* __restrict__ post_idx,
                                    const int32_t* __restrict__ post_data, int64_t n_terms,
                                    const int32_t* __restrict__ gis, int64_t n_words,
                                    uint32_t* __restrict__ words) {
  const int32_t gi = gis[blockIdx.x];
  if (gi < 0 || gi >= n_terms) return;
  const int64_t warps_per_block = blockDim.x >> 5;
  const int64_t warp = (int64_t)blockIdx.y * warps_per_block + (threadIdx.x >> 5);
  or_span(post_data, post_idx[2 * (int64_t)gi], post_idx[2 * (int64_t)gi + 1], warp,
          (int64_t)gridDim.y * warps_per_block, n_words, words);
}

__global__ void bitmap_range_kernel(const int32_t* __restrict__ post_data, int64_t s, int64_t e,
                                    int64_t n_words, uint32_t* __restrict__ words) {
  const int64_t warps_per_block = blockDim.x >> 5;
  const int64_t warp = (int64_t)blockIdx.x * warps_per_block + (threadIdx.x >> 5);
  or_span(post_data, s, e, warp, (int64_t)gridDim.x * warps_per_block, n_words, words);
}

int launch_error() { return (int)cudaGetLastError(); }

}  // namespace

// K1: out[b] for b < rows. keys [n, k], lens [n], lo/hi/q_lens [rows],
// q_keys [rows, k], all device pointers.
extern "C" int m3_index_match_terms(const void* keys, const void* lens, int64_t n, int k,
                                    const void* lo, const void* hi, const void* q_keys,
                                    const void* q_lens, int64_t rows, void* out, void* stream) {
  if (rows <= 0) return 0;
  if (k <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows + kThreads - 1) / kThreads;
  match_terms_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, (const int32_t*)lens, n, k, (const int32_t*)lo,
      (const int32_t*)hi, (const uint32_t*)q_keys, (const int32_t*)q_lens, rows, (int32_t*)out);
  return launch_error();
}

// K2 over a list of n_gis global term indices (-1 skipped); `chunks` blocks
// stride over each term's postings (the wrapper sizes it from the longest).
extern "C" int m3_index_bitmap_terms(const void* post_idx, const void* post_data, int64_t n_terms,
                                     const void* gis, int64_t n_gis, int chunks, void* words,
                                     int64_t n_words, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_words > 0) {
    const cudaError_t e = cudaMemsetAsync(words, 0, (size_t)n_words * 4, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (n_gis <= 0 || n_words <= 0) return 0;
  // a grid.y past 65535 is left for the launch to refuse (a launch error)
  if (n_gis > 0x7fffffff || chunks < 1) return (int)cudaErrorInvalidValue;
  bitmap_terms_kernel<<<dim3((unsigned)n_gis, (unsigned)chunks), kThreads, 0, st>>>(
      (const int32_t*)post_idx, (const int32_t*)post_data, n_terms, (const int32_t*)gis, n_words,
      (uint32_t*)words);
  return launch_error();
}

// K2 over the contiguous postings run post_data[start, end).
extern "C" int m3_index_bitmap_range(const void* post_data, int64_t start, int64_t end,
                                     void* words, int64_t n_words, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_words > 0) {
    const cudaError_t e = cudaMemsetAsync(words, 0, (size_t)n_words * 4, st);
    if (e != cudaSuccess) return (int)e;
  }
  if (end <= start || n_words <= 0) return 0;
  // about 8 postings a thread
  int64_t blocks = (end - start + kThreads * 8 - 1) / (kThreads * 8);
  if (blocks > 0x7fffffff) blocks = 0x7fffffff;
  bitmap_range_kernel<<<(unsigned)blocks, kThreads, 0, st>>>((const int32_t*)post_data, start, end,
                                                             n_words, (uint32_t*)words);
  return launch_error();
}

#else  // host C++ build of the same code, for the CPU tests

namespace {

// or_span over 32-lane groups, with the segmented OR over an array.
void or_span_host(const int32_t* post_data, int64_t s, int64_t e, int64_t n_words,
                  uint32_t* words) {
  for (int64_t i0 = s; i0 < e; i0 += 32) {
    int32_t word[32];
    uint32_t acc[32];
    for (int lane = 0; lane < 32; ++lane) {
      word[lane] = -1;
      acc[lane] = 0;
      if (i0 + lane < e) posting_bit(post_data[i0 + lane], n_words, &word[lane], &acc[lane]);
    }
    for (int off = 1; off < 32; off <<= 1) {
      uint32_t next[32];
      for (int lane = 0; lane < 32; ++lane) {
        next[lane] = acc[lane];
        if (lane + off < 32 && word[lane + off] == word[lane]) next[lane] |= acc[lane + off];
      }
      std::memcpy(acc, next, sizeof acc);
    }
    for (int lane = 0; lane < 32; ++lane)
      if (word[lane] >= 0 && (lane == 0 || word[lane - 1] != word[lane]))
        words[word[lane]] |= acc[lane];
  }
}

}  // namespace

extern "C" int m3_index_match_terms_host(const void* keys, const void* lens, int64_t n, int k,
                                         const void* lo, const void* hi, const void* q_keys,
                                         const void* q_lens, int64_t rows, void* out) {
  if (rows > 0 && (k <= 0 || n < 0)) return 1;
  for (int64_t r = 0; r < rows; ++r)
    ((int32_t*)out)[r] = match_row((const uint32_t*)keys, (const int32_t*)lens, n, k,
                                   ((const int32_t*)lo)[r], ((const int32_t*)hi)[r],
                                   (const uint32_t*)q_keys + r * k, ((const int32_t*)q_lens)[r]);
  return 0;
}

extern "C" int m3_index_bitmap_terms_host(const void* post_idx, const void* post_data,
                                          int64_t n_terms, const void* gis, int64_t n_gis,
                                          void* words, int64_t n_words) {
  if (n_words > 0) std::memset(words, 0, (size_t)n_words * 4);
  const int32_t* idx = (const int32_t*)post_idx;
  for (int64_t b = 0; b < n_gis; ++b) {
    const int32_t gi = ((const int32_t*)gis)[b];
    if (gi < 0 || gi >= n_terms) continue;
    or_span_host((const int32_t*)post_data, idx[2 * (int64_t)gi], idx[2 * (int64_t)gi + 1],
                 n_words, (uint32_t*)words);
  }
  return 0;
}

extern "C" int m3_index_bitmap_range_host(const void* post_data, int64_t start, int64_t end,
                                          void* words, int64_t n_words) {
  if (n_words > 0) std::memset(words, 0, (size_t)n_words * 4);
  or_span_host((const int32_t*)post_data, start, end, n_words, (uint32_t*)words);
  return 0;
}

#endif
