// Device kernels of the inverted index's device tier: K1, the batched term
// lookup, and K2, the postings union into packed doc bitmaps. They replace
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
// K1: one warp per query row b. A lower-bound search of q_keys[b] over
// [lo[b], hi[b]) of the key matrix, 33 ways a round: each lane compares one
// of 32 pivots that cut the range into 33 parts, and the ballot's count of
// pivots below the query picks the part that holds the bound; a range of 32
// keys or fewer is compared key by key in one last round. 110,352 keys take
// 4 rounds of one dependent read each, where a binary search takes 17. The
// result is the global index of the first key >= the query when that key
// equals the query (all words and the length), else -1; a row with q_len < 0
// (a value wider than the keys) gives -1. The reference runs a fixed
// bit_length(n_terms) iterations of a clamped binary search; the lower bound
// of a sorted range is unique, so both give the same index on every row.
// Bound: log2(n) key reads of k words a row, a few KB a call: a launch costs
// its latency, which the warp search cuts to 4 dependent reads.
//
// K2: a list of spans (out_row, start, end) of post_data, the reference's
// _mask_to_bitmap contract (a term list is its terms' post_idx rows, a field
// or prefix range one run), ORed into bitmap rows [n_rows, n_words]: one bit
// a doc, bit j of word w is doc 32w + j, and the bits past n_docs stay 0.
// The reference builds a difference array and a cumsum over the whole
// field's postings slab, O(field postings) even for one term. Here one
// launch sets the bits of the listed postings only, with atomicOr, after one
// cudaMemsetAsync of the rows (the zeroing cannot be folded into the kernel:
// the blocks of a launch run in no order and share words, so every word must
// be zero before any block ORs into it). The work is counted in quads, the
// 16-byte-aligned groups of 4 postings a span touches: the entry lays the
// spans out on the host with the prefix sum of their quads (int64) and hands
// them over in one piece, one copy into device scratch; block b takes quads
// [b Q, (b + 1) Q) whichever spans they belong to. A lane loads its 2
// consecutive quads first (a 16-byte load where the quad lies inside its
// span, scalar loads at a span's head and tail), ORs its 8 postings into
// runs of one (row, word) key, sends the runs between its first and last to
// the bitmap, and the warp's segmented OR over the lanes' first and last runs
// leaves one atomicOr a run that crosses lanes. Keys hold the row, so two
// spans of different rows never merge. OR is idempotent and commutative, so
// the words are the same in every run and equal the reference's. Bound: 4
// bytes a posting read and the words written once.
//
// Without __CUDACC__ the same row and lane code compiles as host C++: the
// *_host entries run K1's rounds lane by lane and K2's tiles lane by lane,
// with the warp's ballot and segmented OR over arrays, so the CPU tests hold
// this source against the plain PyTorch twins of index/device/kernels.py.

#include <cstdint>
#include <vector>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __host__ __device__ __forceinline__
#define M3_UNROLL _Pragma("unroll")
#else
#include <cstring>
#define M3_HD inline
#define M3_UNROLL
#endif

namespace {

constexpr int kLanes = 32;
constexpr int kK1Threads = 256;
constexpr int kQuadsPerLane = 2;  // K2: quads a lane loads before its ORs
constexpr int kLaneDocs = 4 * kQuadsPerLane;
constexpr int64_t kTileQuads = kLanes * kQuadsPerLane;  // K2: quads a warp takes

// a < b in the (words, length) order.
M3_HD bool key_lt(const uint32_t* a, int32_t a_len, const uint32_t* b, int32_t b_len, int k) {
  for (int i = 0; i < k; ++i)
    if (a[i] != b[i]) return a[i] < b[i];
  return a_len < b_len;
}

// ---------- K1 ----------

// The key lane l compares in a round over [lo, hi): the key lo + l when the
// range fits a warp (lanes past it compare nothing), else the (l+1)-th of 32
// pivots that cut it into 33 parts (pivots ascend strictly, all in
// (lo, hi)).
M3_HD int32_t probe(int32_t lo, int32_t hi, int lane) {
  const int64_t len = (int64_t)hi - lo;
  if (len <= kLanes) return lo + lane;
  return lo + (int32_t)((lane + 1) * len / (kLanes + 1));
}

// Narrows [lo, hi) to the part that holds the lower bound, given the count
// c of compared keys below the query (keys ascend, so they are lanes 0 to
// c - 1). A range that fits a warp closes on its bound.
M3_HD void narrow(int32_t* lo, int32_t* hi, int c) {
  const int32_t a = *lo, b = *hi;
  if ((int64_t)b - a <= kLanes) {
    *lo = *hi = a + c;
    return;
  }
  if (c > 0) *lo = probe(a, b, c - 1) + 1;
  if (c < kLanes) *hi = probe(a, b, c);
}

// Whether lane l's key of the round is below the query.
M3_HD bool probe_lt(const uint32_t* keys, const int32_t* lens, int k, int32_t lo, int32_t hi,
                    int lane, const uint32_t* q, int32_t q_len) {
  if (lane >= (int64_t)hi - lo) return false;
  const int32_t p = probe(lo, hi, lane);
  return key_lt(keys + (int64_t)p * k, lens[p], q, q_len, k);
}

// A row's bounds clamped to [0, n] (rows outside do not occur: the store
// hands each row its field's range); false when the row cannot match.
M3_HD bool row_bounds(int64_t n, int32_t q_len, int32_t* lo, int32_t* hi) {
  if (q_len < 0) return false;
  if (*lo < 0) *lo = 0;
  if (*hi > n) *hi = (int32_t)n;
  return true;
}

// K1's answer for a row whose lower bound is `at`: the index when that key
// equals the query, else -1.
M3_HD int32_t match_at(const uint32_t* keys, const int32_t* lens, int k, int32_t at, int32_t end,
                       const uint32_t* q, int32_t q_len) {
  if (at >= end || lens[at] != q_len) return -1;
  const uint32_t* a = keys + (int64_t)at * k;
  for (int i = 0; i < k; ++i)
    if (a[i] != q[i]) return -1;
  return at;
}

// ---------- K2 ----------

// The spans as the host lays them out in one int64 buffer: the prefix sum of
// the spans' quads (n + 1 entries, prefix[n] the total), then each span's
// bitmap row, start and end in post_data.
struct Spans {
  const int64_t* prefix;
  const int64_t* row;
  const int64_t* start;
  const int64_t* end;
  int64_t n;
};

M3_HD Spans spans_of(const int64_t* buf, int64_t n) {
  return Spans{buf, buf + n + 1, buf + 2 * n + 1, buf + 3 * n + 1, n};
}

// Lays out n spans (int64 [n, 3]: row, start, end) as Spans reads them, with
// quads counted from `shift` postings before post_data, into buf (4n + 1
// entries); returns the total quads, or -1 when a span lies outside the
// n_rows rows or the n_post postings. An empty span has no quad.
inline int64_t lay_out_spans(const int64_t* spans, int64_t n, int shift, int64_t n_rows,
                             int64_t n_post, int64_t* buf) {
  buf[0] = 0;
  for (int64_t i = 0; i < n; ++i) {
    const int64_t row = spans[3 * i], st = spans[3 * i + 1], en = spans[3 * i + 2];
    if (row < 0 || row >= n_rows || st < 0 || en > n_post) return -1;
    const int64_t quads = en > st ? ((en + shift + 3) >> 2) - ((st + shift) >> 2) : 0;
    buf[i + 1] = buf[i] + quads;
    buf[n + 1 + i] = row;
    buf[2 * n + 1 + i] = st;
    buf[3 * n + 1 + i] = en;
  }
  return buf[n];
}

// The span that holds quad g: the last i with prefix[i] <= g (an empty
// span shares its prefix with the next, which is taken).
M3_HD int64_t span_of(const Spans& s, int64_t g) {
  int64_t lo = 0, hi = s.n;
  while (hi - lo > 1) {
    const int64_t mid = lo + ((hi - lo) >> 1);
    if (s.prefix[mid] <= g)
      lo = mid;
    else
      hi = mid;
  }
  return lo;
}

M3_HD void or_word(uint32_t* words, int32_t key, uint32_t bits) {
#ifdef __CUDA_ARCH__
  atomicOr(words + key, bits);
#else
  words[key] |= bits;
#endif
}

// A lane's postings: for each of its kLaneDocs postings, the key of the word
// it sets (row * n_words + doc / 32, or -1 for none) and its bit. Quads are
// counted from the 16-byte boundary below post_data, which lies `shift`
// postings before it; every load comes before the first key is made.
M3_HD void lane_postings(const int32_t* post_data, const Spans& s, int shift, int64_t total,
                         int64_t g0, int64_t n_words, int32_t* key, uint32_t* bit) {
  int32_t doc[kLaneDocs];
  int64_t row[kQuadsPerLane];
  bool in[kLaneDocs];
  int64_t i = g0 < total ? span_of(s, g0) : 0;
M3_UNROLL
  for (int u = 0; u < kQuadsPerLane; ++u) {
    const int64_t g = g0 + u;
    row[u] = -1;
M3_UNROLL
    for (int j = 0; j < 4; ++j) {
      in[4 * u + j] = false;
      doc[4 * u + j] = 0;
    }
    if (g >= total) continue;
    while (s.prefix[i + 1] <= g) ++i;
    const int64_t st = s.start[i], en = s.end[i];
    const int64_t d0 = (((st + shift) >> 2) + (g - s.prefix[i])) * 4 - shift;
    row[u] = s.row[i];
#ifdef __CUDA_ARCH__
    if (d0 >= st && d0 + 4 <= en) {
      const int4 v = __ldg(reinterpret_cast<const int4*>(post_data + d0));
      doc[4 * u] = v.x;
      doc[4 * u + 1] = v.y;
      doc[4 * u + 2] = v.z;
      doc[4 * u + 3] = v.w;
M3_UNROLL
      for (int j = 0; j < 4; ++j) in[4 * u + j] = true;
      continue;
    }
#endif
M3_UNROLL
    for (int j = 0; j < 4; ++j) {
      in[4 * u + j] = d0 + j >= st && d0 + j < en;
      if (in[4 * u + j]) doc[4 * u + j] = post_data[d0 + j];
    }
  }
M3_UNROLL
  for (int j = 0; j < kLaneDocs; ++j) {
    key[j] = -1;
    bit[j] = 0;
    const uint32_t d = (uint32_t)doc[j];
    // a doc past the bitmap does not occur: postings hold the segment's
    // own doc ordinals
    if (in[j] && (int64_t)d < n_words * 32) {
      key[j] = (int32_t)(row[j / 4] * n_words + (d >> 5));
      bit[j] = 1u << (d & 31);
    }
  }
}

// A lane's postings ORed into runs of one key: the first and last runs are
// kept for the warp's merge (the same run when there is one), the runs
// between them are ORed into the bitmap here.
struct Runs {
  int32_t kf, kl;  // keys of the first and last run, -1 for a lane with none
  uint32_t af, al;
  bool single;
};

M3_HD Runs lane_runs(const int32_t* key, const uint32_t* bit, uint32_t* words) {
  Runs r{-1, -1, 0, 0, true};
  int runs = 0;
M3_UNROLL
  for (int j = 0; j < kLaneDocs; ++j) {
    if (key[j] < 0) continue;
    if (runs > 0 && key[j] == r.kl) {
      r.al |= bit[j];
      continue;
    }
    if (runs == 1) {
      r.kf = r.kl;
      r.af = r.al;
    } else if (runs > 1) {
      or_word(words, r.kl, r.al);
    }
    r.kl = key[j];
    r.al = bit[j];
    ++runs;
  }
  r.single = runs <= 1;
  if (r.single) {
    r.kf = r.kl;
    r.af = r.al;
  }
  return r;
}

// The warp's merge for one lane, given its neighbours' keys (prev_kl: the
// last run of the lane before, -1 for lane 0; next_kf: the first run of the
// lane after, -1 for lane 31) and g_next, the OR of the first runs of equal
// key from the next lane on (a segmented OR over the lanes). A run that
// continues the lane before is that lane's to send.
M3_HD void lane_merge(const Runs& r, int32_t prev_kl, int32_t next_kf, uint32_t g_next,
                      uint32_t* words) {
  if (!r.single && r.kf != prev_kl) or_word(words, r.kf, r.af);
  if (r.kl >= 0 && (!r.single || r.kf != prev_kl))
    or_word(words, r.kl, r.al | (next_kf == r.kl ? g_next : 0u));
}

}  // namespace

#ifdef __CUDACC__

namespace {

__global__ void match_terms_kernel(const uint32_t* __restrict__ keys,
                                   const int32_t* __restrict__ lens, int64_t n, int k,
                                   const int32_t* __restrict__ lo_, const int32_t* __restrict__ hi_,
                                   const uint32_t* __restrict__ q_keys,
                                   const int32_t* __restrict__ q_lens, int64_t rows,
                                   int32_t* __restrict__ out) {
  const int64_t r = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / kLanes;
  const int lane = threadIdx.x & (kLanes - 1);
  if (r >= rows) return;  // the whole warp
  const int32_t q_len = q_lens[r];
  int32_t lo = lo_[r], hi = hi_[r];
  if (!row_bounds(n, q_len, &lo, &hi)) {
    if (lane == 0) out[r] = -1;
    return;
  }
  const int32_t end = hi;
  const uint32_t* q = q_keys + r * k;
  while (lo < hi) {  // lo and hi are alike in every lane
    const bool lt = probe_lt(keys, lens, k, lo, hi, lane, q, q_len);
    narrow(&lo, &hi, __popc(__ballot_sync(0xffffffffu, lt)));
  }
  if (lane == 0) out[r] = match_at(keys, lens, k, lo, end, q, q_len);
}

// span_buf: the spans laid out as Spans reads them.
__global__ void bitmap_spans_kernel(const int32_t* __restrict__ post_data,
                                    const int64_t* __restrict__ span_buf, int64_t n_spans,
                                    int shift, int64_t total, int64_t n_words,
                                    uint32_t* __restrict__ words) {
  const int lane = threadIdx.x & (kLanes - 1);
  const int64_t tile = (int64_t)blockIdx.x * (blockDim.x / kLanes) + threadIdx.x / kLanes;
  if (tile * kTileQuads >= total) return;  // the whole warp
  const Spans s = spans_of(span_buf, n_spans);
  int32_t key[kLaneDocs];
  uint32_t bit[kLaneDocs];
  lane_postings(post_data, s, shift, total, tile * kTileQuads + lane * kQuadsPerLane, n_words,
                key, bit);
  const Runs r = lane_runs(key, bit, words);
  // segmented OR of the first runs, from each lane over the lanes after it
  // with an equal first key: g ORs only bits of one word
  uint32_t g = r.af;
M3_UNROLL
  for (int off = 1; off < kLanes; off <<= 1) {
    const uint32_t o = __shfl_down_sync(0xffffffffu, g, off);
    const int32_t ok = __shfl_down_sync(0xffffffffu, r.kf, off);
    if (lane + off < kLanes && ok == r.kf) g |= o;
  }
  const int32_t prev_kl = __shfl_up_sync(0xffffffffu, r.kl, 1);
  const int32_t next_kf = __shfl_down_sync(0xffffffffu, r.kf, 1);
  const uint32_t g_next = __shfl_down_sync(0xffffffffu, g, 1);
  lane_merge(r, lane == 0 ? -1 : prev_kl, lane == kLanes - 1 ? -1 : next_kf, g_next, words);
}

__global__ void launch_floor_kernel() {}

int launch_error() { return (int)cudaGetLastError(); }

}  // namespace

// K1: out[b] for b < rows. keys [n, k], lens [n], lo/hi/q_lens [rows],
// q_keys [rows, k], all device pointers.
extern "C" int m3_index_match_terms(const void* keys, const void* lens, int64_t n, int k,
                                    const void* lo, const void* hi, const void* q_keys,
                                    const void* q_lens, int64_t rows, void* out, void* stream) {
  if (rows <= 0) return 0;
  if (k <= 0 || n < 0 || n > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows * kLanes + kK1Threads - 1) / kK1Threads;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  match_terms_kernel<<<(unsigned)blocks, kK1Threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)keys, (const int32_t*)lens, n, k, (const int32_t*)lo,
      (const int32_t*)hi, (const uint32_t*)q_keys, (const int32_t*)q_lens, rows, (int32_t*)out);
  return launch_error();
}

// K2 over n_spans host spans (int64 [n_spans, 3]: row, start, end) of
// post_data (n_post postings, the first `shift` postings past a 16-byte
// boundary): words [n_rows, n_words] are zeroed, then ORed into. The laid-out
// spans go up in one copy into `scratch` (device, 4 n_spans + 1 int64,
// 16-byte aligned). `threads` a block, a multiple of 32 (a count the
// card does not take is left for the launch to refuse). Returns -1 when no
// span holds a posting (the words are zeroed, no kernel launched), -2 when a
// span lies outside its rows or the postings (nothing done).
extern "C" int m3_index_bitmap_spans(const void* post_data, int64_t n_post, const void* spans,
                                     int64_t n_spans, int shift, int threads, void* scratch,
                                     void* words, int64_t n_rows, int64_t n_words, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  if (n_rows < 0 || n_words < 0 || n_rows * n_words > 0x7fffffff || n_spans < 0 || shift < 0 ||
      shift > 3 || threads < kLanes || threads % kLanes)
    return (int)cudaErrorInvalidValue;
  std::vector<int64_t> laid(4 * n_spans + 1);
  const int64_t total =
      lay_out_spans((const int64_t*)spans, n_spans, shift, n_rows, n_post, laid.data());
  if (total < 0) return -2;
  cudaError_t e = cudaSuccess;
  if (n_rows * n_words > 0) e = cudaMemsetAsync(words, 0, (size_t)(n_rows * n_words) * 4, st);
  if (e != cudaSuccess) return (int)e;
  if (total == 0 || n_rows * n_words == 0) return -1;
  // from pageable memory: staged by the CUDA runtime before the call returns
  e = cudaMemcpyAsync(scratch, laid.data(), laid.size() * sizeof(int64_t), cudaMemcpyHostToDevice,
                      st);
  if (e != cudaSuccess) return (int)e;
  const int64_t per_block = (threads / kLanes) * kTileQuads;
  const int64_t blocks = (total + per_block - 1) / per_block;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  bitmap_spans_kernel<<<(unsigned)blocks, threads, 0, st>>>((const int32_t*)post_data,
                                                            (const int64_t*)scratch, n_spans, shift,
                                                            total, n_words, (uint32_t*)words);
  return launch_error();
}

// An empty kernel: what one launch through this route costs the card.
extern "C" int m3_launch_floor(void* stream) {
  launch_floor_kernel<<<1, kLanes, 0, (cudaStream_t)stream>>>();
  return launch_error();
}

#else  // host C++ build of the same code, for the CPU tests

extern "C" int m3_index_match_terms_host(const void* keys, const void* lens, int64_t n, int k,
                                         const void* lo_, const void* hi_, const void* q_keys,
                                         const void* q_lens, int64_t rows, void* out) {
  if (rows > 0 && (k <= 0 || n < 0 || n > 0x7fffffff)) return 1;
  const uint32_t* kk = (const uint32_t*)keys;
  const int32_t* ll = (const int32_t*)lens;
  for (int64_t r = 0; r < rows; ++r) {
    const int32_t q_len = ((const int32_t*)q_lens)[r];
    const uint32_t* q = (const uint32_t*)q_keys + r * k;
    int32_t lo = ((const int32_t*)lo_)[r], hi = ((const int32_t*)hi_)[r];
    int32_t res = -1;
    if (row_bounds(n, q_len, &lo, &hi)) {
      const int32_t end = hi;
      while (lo < hi) {  // one round: the lanes' compares, then the ballot's count
        int c = 0;
        for (int lane = 0; lane < kLanes; ++lane)
          c += probe_lt(kk, ll, k, lo, hi, lane, q, q_len);
        narrow(&lo, &hi, c);
      }
      res = match_at(kk, ll, k, lo, end, q, q_len);
    }
    ((int32_t*)out)[r] = res;
  }
  return 0;
}

extern "C" int m3_index_bitmap_spans_host(const void* post_data, int64_t n_post,
                                          const void* spans, int64_t n_spans, int shift,
                                          void* words, int64_t n_rows, int64_t n_words) {
  if (n_rows < 0 || n_words < 0 || n_rows * n_words > 0x7fffffff || n_spans < 0 || shift < 0 ||
      shift > 3)
    return 1;
  std::vector<int64_t> buf(4 * n_spans + 1);
  const int64_t total =
      lay_out_spans((const int64_t*)spans, n_spans, shift, n_rows, n_post, buf.data());
  if (total < 0) return -2;
  uint32_t* w = (uint32_t*)words;
  if (n_rows * n_words > 0) std::memset(w, 0, (size_t)(n_rows * n_words) * 4);
  if (total == 0 || n_rows * n_words == 0) return -1;
  const Spans s = spans_of(buf.data(), n_spans);
  for (int64_t t0 = 0; t0 < total; t0 += kTileQuads) {  // one warp's tile
    Runs r[kLanes];
    for (int lane = 0; lane < kLanes; ++lane) {
      int32_t key[kLaneDocs];
      uint32_t bit[kLaneDocs];
      lane_postings((const int32_t*)post_data, s, shift, total, t0 + lane * kQuadsPerLane,
                    n_words, key, bit);
      r[lane] = lane_runs(key, bit, w);
    }
    uint32_t g[kLanes];
    for (int lane = 0; lane < kLanes; ++lane) g[lane] = r[lane].af;
    for (int off = 1; off < kLanes; off <<= 1) {
      uint32_t next[kLanes];
      for (int lane = 0; lane < kLanes; ++lane) {
        next[lane] = g[lane];
        if (lane + off < kLanes && r[lane + off].kf == r[lane].kf) next[lane] |= g[lane + off];
      }
      std::memcpy(g, next, sizeof g);
    }
    for (int lane = 0; lane < kLanes; ++lane)
      lane_merge(r[lane], lane == 0 ? -1 : r[lane - 1].kl,
                 lane == kLanes - 1 ? -1 : r[lane + 1].kf, lane == kLanes - 1 ? 0 : g[lane + 1],
                 w);
  }
  return 0;
}

#endif
