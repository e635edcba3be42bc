// Batched M3TSZ encode: kernel B-4. It replaces the XLA program of
// m3_tpu/ops/encode.py:153 (_build_kernel, driven by :365 encode_lanes); it
// is not a Pallas kernel.
//
// Inputs (ops/encode.py encode_inputs), M lanes, T records a lane at most:
// t0 int64 [M] (each lane's first time, nanos), counts int32 [M] (records,
// >= 1), float_lane uint8 [M], dod int32 [T, M] (delta-of-delta in seconds,
// 0 at record 0) and vbits int64 [T, M] (the value as an integer on an INT
// lane, its IEEE-754 bits on a FLOAT lane), record-major.
//
// Outputs, bit for bit those of the reference: words [M, W] (the big-endian
// u32 words of each lane's stream, MSB first, zero past its end), total_bits
// [M] (EOS included), and chunk_offs and chunk_sigs [C, M], C = ceil(T / k):
// the bit offset and the int tracker's significant bits before records 0,
// k, 2k, ...; rows at or past a lane's record count hold the offset before
// its EOS and the tracker's last state.
//
// What a record emits (the reference's eight slots, in order):
// - record 0: the first time, 64 bits;
// - the delta-of-delta: opcode '0' for 0, '10' + 7 bits for [-64, 63],
//   '110' + 9 bits for [-256, 255], '1110' + 12 bits for [-2048, 2047],
//   '1111' + 32 bits else;
// - an INT lane (d = v0 at record 0, prev - cur after; |d| < 2^31):
//   record 0 writes control '0', a header of 9 bits ('11', 6 bits of
//   sig - 1, '0') where sig > 0, else '00', and the sign bit (1 where
//   v0 >= 0) with sig bits of |v0|; a repeat (d == 0) writes '01'; a record
//   whose tracker state changed writes '000', the header of its new width
//   and the value; any other writes '1' and the value (sign bit: 1 where
//   d < 0). The width is the tracker's state after the record
//   (IntSigBitsTracker: raise at once; fall to the largest recent sig only
//   after 5 records at least 3 bits lower);
// - a FLOAT lane: record 0 writes '1' and the 64 bits; a repeat writes
//   '01'; an XOR x whose leading and trailing zeros cover the previous
//   nonzero XOR's writes '110' and the bits between the previous XOR's
//   zeros, else '111', 6 bits of leading zeros, 6 of meaningful bits - 1,
//   and the meaningful bits;
// - then EOS: 0x400 in 11 bits.
// C++ shifts by the width or more are undefined where XLA's give 0, and
// clz/ctz of 0 are 64 in the reference: each such place is written out.
//
// Bound: bytes -- the records read once, the [M, W] rows written once,
// zeros included (at [ingest]'s 100,000 x 720, W 4,096: 1.64 GB of the 2.53
// GB moved), and the chunk tables. The first design (a thread a lane walking
// its records) reached 22% of it: a memset zeroed the rows first, each
// thread stored its row a word at a time 16 KB from its neighbours' rows,
// and a warp ran int and float lanes both. This one:
// - A warp a lane, a lane of the warp a record: the warp takes its lane's
//   records kLanes at a time (a step), so a warp runs one kind's code.
// - Each lane reads its record of the next step while this one is encoded
//   (a step ahead). A block is kWarps neighbouring lanes, so the lines of
//   the record-major planes a warp reads are mostly in L1 for its
//   neighbours. Staging [32 records x lanes] tiles in shared memory for the
//   block (cp.async, a barrier a step) measured slower at every block size:
//   the barrier holds each warp to the block's slowest step.
// - A step: each record's slots from shuffles of its neighbour's value
//   (prev bits / prev int), a ballot of the nonzero XORs for the previous
//   nonzero XOR's zero counts before each record (a forward fill), the
//   tracker's states by rounds over the step (a prefix max of the active
//   sigs and ballots of the lows and mids give every state up to the first
//   fall; a round ends at each fall), each record's bit length, and its
//   offset by a shuffle prefix sum. Each record ORs its bits into the
//   warp's ring of kRing words in shared memory (atomics: records share
//   their edge words).
// - Stores: the words that a step completed leave the ring as coalesced
//   warp stores, in whole 32-byte sectors (the rest wait a step); after the
//   EOS the warp stores its last words and zeroes the rest of its row with
//   16-byte stores. No memset: each word of the rows is written once.
// What holds it now is its instructions (a few hundred a step: shuffle
// scans, the slots' selects, the ring's atomics), not the record reads.
// The host build runs the same steps (the same per-record helpers, the
// ring and the stores), a warp's lanes one after the other in each phase.
//
// No float arithmetic touches the values, only their bits: -fmad=false as
// the common flags have it, no -ftz needed.

#include <cstddef>
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

constexpr int kLanes = 32;  // records a step: a warp's lanes
constexpr int kWarps = 4;   // encode lanes a block, a warp each
constexpr int kThreads = kWarps * kLanes;
constexpr int kMinBlocks = 1024 / kThreads;  // blocks an SM holds at 64 registers a thread
constexpr int kAlign = 8;   // words: rows leave the ring in whole 32-byte sectors
constexpr int kRing = 128;  // words of a warp's ring
constexpr int64_t kMaxWords = 1 << 26;  // a row's bit offsets fit in int32
constexpr uint32_t kEos = 0x400;
constexpr int kEosBits = 11;
constexpr int kSigDiffThreshold = 3;
constexpr int kSigRepeatThreshold = 5;
constexpr int kRec0Bits = 130;  // the widest records: a float lane's first,
constexpr int kRecBits = 115;   // and a later float record with a new window
// A step starts with at most kAlign words in the ring (kAlign - 1 complete
// and the partial one) and adds the words its records touch past them.
static_assert(kRing >= kAlign + (31 + kRec0Bits + (kLanes - 1) * kRecBits - 1) / 32,
              "a step's words overflow the ring");
static_assert((kRing & (kRing - 1)) == 0, "the ring's size is a power of two");

M3_HD int clz64(uint64_t x) {
#ifdef __CUDA_ARCH__
  return __clzll((long long)x);  // 64 for 0
#else
  return x == 0 ? 64 : __builtin_clzll(x);
#endif
}

M3_HD int ctz64(uint64_t x) {
#ifdef __CUDA_ARCH__
  return x == 0 ? 64 : __ffsll((long long)x) - 1;  // __ffsll(0) is 0
#else
  return x == 0 ? 64 : __builtin_ctzll(x);
#endif
}

M3_HD int clz32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __clz((int)x);  // 32 for 0
#else
  return x == 0 ? 32 : __builtin_clz(x);
#endif
}

M3_HD int popc32(uint32_t x) {
#ifdef __CUDA_ARCH__
  return __popc(x);
#else
  return __builtin_popcount(x);
#endif
}

// The lowest lane of a mask (32 for none), and the highest below `lane`
// (-1 for none).
M3_HD int lowest(uint32_t m) { return m == 0 ? 32 : 31 - clz32(m & (0u - m)); }
M3_HD int highest_below(uint32_t m, int lane) {
  const uint32_t b = m & ((1u << lane) - 1u);
  return b == 0 ? -1 : 31 - clz32(b);
}
// Lanes 0 .. lane.
M3_HD uint32_t lanes_upto(int lane) { return lane >= 31 ? ~0u : (2u << lane) - 1u; }

// The delta-of-delta's opcode and value as one field: its bits, its width
// (selects, no branch: a warp's records take every width).
M3_HD int dod_field(int32_t dd, uint64_t* bits) {
  const uint64_t u = (uint32_t)dd;
  const bool b7 = dd >= -64 && dd <= 63, b9 = dd >= -256 && dd <= 255;
  const bool b12 = dd >= -2048 && dd <= 2047;
  *bits = dd == 0 ? 0
          : b7    ? (2ull << 7) | (u & 0x7f)
          : b9    ? (6ull << 9) | (u & 0x1ff)
          : b12   ? (14ull << 12) | (u & 0xfff)
                  : (15ull << 32) | u;
  return dd == 0 ? 1 : b7 ? 9 : b9 ? 12 : b12 ? 16 : 36;
}

// A record's value: a head (control and header, <= 15 bits) and a payload
// (<= 64 bits).
struct Value {
  uint32_t head;
  int hlen;
  uint64_t pay;
  int plen;
};

// A 64-bit word's leading zeros and trailing zeros (64 each for 0), packed
// as lz | tz << 8.
M3_HD int zeros(uint64_t x) { return clz64(x) | ctz64(x) << 8; }

// A FLOAT record's value from its bits, its XOR with the previous value's
// (x, its zeros xz) and the previous nonzero XOR's zeros (pz; record 0's
// bits' before record 1). The payload is x shifted past the previous XOR's
// trailing zeros where x's zeros cover its (contained: that XOR is not 0
// then, so pt <= 63), else past its own (x != 0, so ct <= 63).
M3_HD Value float_value(bool first, uint64_t vb, uint64_t x, int xz, int pz) {
  const int cl = xz & 0xff, ct = xz >> 8, pl = pz & 0xff, pt = pz >> 8;
  const bool contained = cl >= pl && ct >= pt;
  const uint64_t pay = x >> ((contained ? pt : ct) & 63);
  const int nm = 64 - cl - ct;
  if (first) return {1u, 1, vb, 64};
  if (x == 0) return {1u, 2, 0, 0};  // a repeat: '01'
  if (contained) return {6u, 3, pay, 64 - pl - pt};
  return {(7u << 12) | (uint32_t)(cl << 6) | (uint32_t)(nm - 1), 15, pay, nm};
}

// |d| as the reference takes it, in 32 bits (no signed overflow).
M3_HD uint32_t magnitude(int64_t d) { return (uint32_t)(d < 0 ? 0 - (uint64_t)d : (uint64_t)d); }

// An INT record's value from d (v0 at record 0) and the tracker's state
// before and after it.
M3_HD Value int_value(bool first, int64_t raw, int64_t d, int nsb, int nsa) {
  const uint32_t absval = magnitude(d);
  if (first) {  // '0', the header of sig (or '00'), the sign (1 where v0 >= 0), sig bits
    const int sig = 32 - clz32(absval);
    const uint32_t head = sig > 0 ? 0x180u | ((uint32_t)(sig - 1) << 1) : 0u;
    return {head, sig > 0 ? 10 : 3, ((uint64_t)(raw >= 0 ? 1 : 0) << sig) | absval, 1 + sig};
  }
  if (d == 0) return {1u, 2, 0, 0};  // a repeat: '01'
  const uint64_t pay = ((uint64_t)(d < 0 ? 1 : 0) << nsa) | absval;
  if (nsa != nsb) return {0x180u | ((uint32_t)(nsa - 1) << 1), 12, pay, 1 + nsa};
  return {1u, 1, pay, 1 + nsa};
}

// A record's bits: the first time (record 0), the dod field, the value.
M3_HD int record_bits(bool first, int dlen, const Value& v) {
  return (first ? 64 : 0) + dlen + v.hlen + v.plen;
}

// The dod field, the head and the payload of a record, right-aligned in
// (*hi, *lo): dlen + hlen + plen <= 115 bits. Each field holds no bit above
// its width.
M3_HD void record_fields(uint64_t dbits, const Value& v, uint64_t* hi, uint64_t* lo) {
  const uint64_t a = (dbits << v.hlen) | v.head;  // <= 51 bits
  *lo = v.plen == 0 ? a : v.plen == 64 ? v.pay : (a << v.plen) | v.pay;
  *hi = v.plen == 0 ? 0 : v.plen == 64 ? a : a >> (64 - v.plen);
}

// The int tracker (IntSigBitsTracker): significant bits, the largest sig of
// the current run of lows, the run's length.
struct Tracker {
  int ns, ch, nl;
};

enum { kInactive = 0, kRaise = 1, kLow = 2, kMid = 3 };

// What an active record does to the tracker whose state before it is pm.
M3_HD int classify(bool act, int sig, int pm) {
  if (!act) return kInactive;
  if (sig > pm) return kRaise;  // raise at once, the run untouched
  if (pm - sig >= kSigDiffThreshold) return kLow;
  return kMid;  // the run ends
}

// The lows of the run that lane `upto` ends (lanes after the last mid at or
// below it); *carried where no mid is at or below it, so that the run goes
// on from the tracker's state at the round's start.
M3_HD uint32_t run_lows(uint32_t lows, uint32_t mids, int upto, bool* carried) {
  const uint32_t m = mids & lanes_upto(upto);
  *carried = m == 0;
  const uint32_t r = lows & lanes_upto(upto);
  return m == 0 ? r : r & ~lanes_upto(31 - clz32(m));
}

M3_HD int run_length(uint32_t run, bool carried, const Tracker& t) {
  return popc32(run) + (carried ? t.nl : 0);
}

// ORs v into *w where `cond`: on the card a shared-memory reduction under
// a predicate, no branch.
M3_HD void or_word(uint32_t* w, uint32_t v, bool cond) {
#ifdef __CUDA_ARCH__
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %2, 0;\n @p red.shared.or.b32 [%0], %1;\n}\n" ::"r"(
          (unsigned)__cvta_generic_to_shared(w)),
      "r"(v), "r"((int)cond)
      : "memory");
#else
  if (cond) *w |= v;
#endif
}

// ORs n bits (1 <= n <= 128, right-aligned in hi:lo) into a warp's ring
// at bit `at` of the row, MSB first, where `live`: word i of the row is
// ring[i % kRing]. They touch at most 5 words; records share their edge
// words.
M3_HD void or_bits(uint32_t* ring, int at, uint64_t hi, uint64_t lo, int n, bool live) {
  const int end = at + n, last = (end - 1) >> 5;
  const int s = (32 - (end & 31)) & 31;  // zero bits after the last one in its word
  const uint64_t x0 = lo << s;
  const uint64_t x1 = s == 0 ? hi : (hi << s) | (lo >> (64 - s));
  const uint32_t x2 = s == 0 ? 0u : (uint32_t)(hi >> (64 - s));
  const int words = last - (at >> 5);  // touched, less one
  or_word(&ring[last & (kRing - 1)], (uint32_t)x0, live);
  or_word(&ring[(last - 1) & (kRing - 1)], (uint32_t)(x0 >> 32), live && words >= 1);
  or_word(&ring[(last - 2) & (kRing - 1)], (uint32_t)x1, live && words >= 2);
  or_word(&ring[(last - 3) & (kRing - 1)], (uint32_t)(x1 >> 32), live && words >= 3);
  or_word(&ring[(last - 4) & (kRing - 1)], x2, live && words >= 4);
}

// A record into the ring from bit `at` where `live`: the first time (record
// 0), then its fields.
M3_HD void emit_record(uint32_t* ring, int at, bool first, const int64_t* t0, uint64_t dbits,
                       int dlen, const Value& v, bool live) {
  if (first) or_bits(ring, at, 0, (uint64_t)*t0, 64, live);
  uint64_t hi, lo;
  record_fields(dbits, v, &hi, &lo);
  or_bits(ring, at + (first ? 64 : 0), hi, lo, dlen + v.hlen + v.plen, live);
}

// The records of a step (from record j0) that start a chunk, as a lane
// mask, from the next such record *next (advanced past the step).
M3_HD uint32_t chunk_starts(int* next, int j0, int n, int k) {
  uint32_t starts = 0;
  for (; *next < j0 + kLanes && *next < n; *next += k) starts |= 1u << (*next - j0);
  return starts;
}

// The row's words below `end` that leave the ring now: up to a 32-byte
// boundary of the words array (`lead` the row's first word on one).
M3_HD int flush_end(int lead, int end) {
  return end < lead ? 0 : lead + ((end - lead) & ~(kAlign - 1));
}

// The first word at or after `from` of a row on a 16-byte boundary (or W).
M3_HD int vector_start(const uint32_t* row, int from, int W) {
  const int a = from + (int)((4 - ((uintptr_t)(row + from) >> 2)) & 3);
  return a < W ? a : W;
}

#ifdef __CUDACC__

constexpr unsigned kFull = 0xffffffffu;

template <class V>
__device__ __forceinline__ V scan_sum(V v, int lane) {
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const V u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v += u;
  }
  return v;
}

__device__ __forceinline__ int scan_max(int v, int lane) {
#pragma unroll
  for (int d = 1; d < kLanes; d <<= 1) {
    const int u = __shfl_up_sync(kFull, v, d);
    if (lane >= d) v = max(v, u);
  }
  return v;
}

// The tracker's state before (*nsb) and after (*nsa) this lane's record
// over a step, and the tracker after the step. Each round runs from lane
// `st`: a prefix max of the active sigs is every state until the first
// fall; the lows' run lengths (ballots of the lows and the mids) find that
// fall, which ends the round with the tracker at its run's largest sig.
__device__ __forceinline__ void tracker_step(bool act, int sig, int lane, Tracker* t, int* nsb,
                                             int* nsa) {
  int st = 0;
  for (;;) {
    const bool in = lane >= st;
    const int incl = scan_max(act && in ? sig : 0, lane);
    int excl = __shfl_up_sync(kFull, incl, 1);
    if (lane == 0) excl = 0;
    const int pm = max(t->ns, excl);
    const int cls = classify(act && in, sig, pm);
    const uint32_t lows = __ballot_sync(kFull, cls == kLow);
    const uint32_t mids = __ballot_sync(kFull, cls == kMid);
    bool carried;
    const uint32_t run = run_lows(lows, mids, lane, &carried);
    const bool falls_here = cls == kLow && run_length(run, carried, *t) >= kSigRepeatThreshold;
    const int f = lowest(__ballot_sync(kFull, falls_here));
    if (in && lane < f) {
      *nsb = pm;
      *nsa = max(t->ns, incl);
    }
    const uint32_t rl = run_lows(lows, mids, f < 32 ? f : 31, &carried);
    int ch = __reduce_max_sync(kFull, (rl >> lane) & 1u ? sig : 0);
    if (carried && t->nl > 0) ch = max(ch, t->ch);
    if (f == 32) {
      const int nl = run_length(rl, carried, *t);
      *t = {max(t->ns, __shfl_sync(kFull, incl, 31)), ch, nl};
      return;
    }
    if (lane == f) {
      *nsb = pm;
      *nsa = ch;
    }
    *t = {ch, ch, 0};  // the fall: the run's largest sig, the run ends
    st = f + 1;
    if (st == kLanes) return;
  }
}

struct Args {
  const int64_t* t0;
  const int32_t* counts;
  const uint8_t* float_lane;
  const int32_t* dod;
  const int64_t* vbits;
  int64_t M;
  int k;
  int64_t W, C;
  uint32_t* words;
  int32_t* total_bits;
  int32_t* chunk_offs;
  int32_t* chunk_sigs;
};

__global__ void __launch_bounds__(kThreads, kMinBlocks) encode_kernel(const Args a) {
  __shared__ uint32_t s_ring[kWarps][kRing];
  const int warp = threadIdx.x / kLanes, lane = threadIdx.x % kLanes;
  const int64_t m = (int64_t)blockIdx.x * kWarps + warp;
  if (m >= a.M) return;
  const int n = a.counts[m];
  const bool is_float = a.float_lane[m] != 0;
  uint32_t* ring = s_ring[warp];
  for (int i = lane; i < kRing; i += kLanes) ring[i] = 0;
  const int W = (int)a.W;
  uint32_t* row = a.words + m * a.W;
  const int lead = (int)((kAlign - (m * a.W) % kAlign) % kAlign);  // its first word on 32 bytes
  int bitpos = 0, flushed = 0;      // the row's bits so far, its words stored
  int next_chunk = 0, chunks = 0;  // the next record that starts a chunk, chunks so far
  Tracker tr{0, 0, 0};
  uint64_t prev = 0;  // the previous value (its bits on a FLOAT lane)
  int pz = zeros(0);  // the previous nonzero XOR's zeros
  // this lane's record of each step, read a step ahead (the lanes of a block
  // read neighbouring words of the planes' rows at about the same time)
  const int32_t* g_dod = a.dod + (int64_t)lane * a.M + m;
  const int64_t* g_vb = a.vbits + (int64_t)lane * a.M + m;
  const int64_t stride = (int64_t)kLanes * a.M;
  int32_t next_dd = 0;
  int64_t next_raw = 0;
  if (lane < n) {
    next_dd = __ldg(g_dod);
    next_raw = __ldg(g_vb);
  }
  __syncwarp();
  for (int s = 0; s * kLanes < n; ++s) {
    const int j = s * kLanes + lane;
    const bool valid = j < n, first = j == 0;
    const int32_t dd = next_dd;
    const uint64_t raw = (uint64_t)next_raw;
    if (j + kLanes < n) {
      next_dd = __ldg(g_dod + (s + 1) * stride);
      next_raw = __ldg(g_vb + (s + 1) * stride);
    }
    uint64_t dbits;
    const int dlen = dod_field(dd, &dbits);
    uint64_t pv = __shfl_up_sync(kFull, raw, 1);
    if (lane == 0) pv = prev;
    prev = __shfl_sync(kFull, raw, kLanes - 1);
    Value v;
    int nsb = 0;
    if (is_float) {
      const uint64_t x = first ? raw : raw ^ pv;  // record 0 seeds the previous XOR
      const int xz = zeros(x);
      const uint32_t nz = __ballot_sync(kFull, valid && x != 0);
      const int src = highest_below(nz, lane);
      const int fill = __shfl_sync(kFull, xz, src < 0 ? 0 : src);
      v = float_value(first, raw, x, xz, src < 0 ? pz : fill);
      const int last = __shfl_sync(kFull, xz, nz ? 31 - __clz(nz) : 0);
      if (nz) pz = last;
    } else {
      const int64_t d = first ? (int64_t)raw : (int64_t)pv - (int64_t)raw;
      int nsa = 0;
      tracker_step(valid && d != 0, 32 - clz32(magnitude(d)), lane, &tr, &nsb, &nsa);
      v = int_value(first, (int64_t)raw, d, nsb, nsa);
    }
    const int len = valid ? record_bits(first, dlen, v) : 0;
    const int incl = scan_sum(len, lane);
    const int at = bitpos + incl - len;
    emit_record(ring, at, first, a.t0 + m, dbits, dlen, v, valid);
    const uint32_t starts = chunk_starts(&next_chunk, s * kLanes, n, a.k);
    if ((starts >> lane) & 1u) {
      const int64_t c = chunks + popc32(starts & ((1u << lane) - 1u));  // j / k
      a.chunk_offs[c * a.M + m] = at;
      a.chunk_sigs[c * a.M + m] = nsb;
    }
    chunks += popc32(starts);
    bitpos += __shfl_sync(kFull, incl, kLanes - 1);
    __syncwarp();
    const int fe = flush_end(lead, bitpos >> 5);
    for (int i = flushed + lane; i < fe; i += kLanes) {
      row[i] = ring[i & (kRing - 1)];
      ring[i & (kRing - 1)] = 0;
    }
    if (fe > flushed) flushed = fe;
    __syncwarp();
  }

  // the chunk rows past the last record, the EOS, the last words, zeros
  for (int64_t c = chunks + lane; c < a.C; c += kLanes) {
    a.chunk_offs[c * a.M + m] = bitpos;
    a.chunk_sigs[c * a.M + m] = tr.ns;
  }
  or_bits(ring, bitpos, 0, kEos, kEosBits, lane == 0);
  if (lane == 0) a.total_bits[m] = bitpos + kEosBits;
  __syncwarp();
  const int used = (bitpos + kEosBits + 31) >> 5;
  for (int i = flushed + lane; i < used; i += kLanes) row[i] = ring[i & (kRing - 1)];
  const int va = vector_start(row, used, W), nv = (W - va) >> 2;
  if (used + lane < va) row[used + lane] = 0;
  uint4* vz = reinterpret_cast<uint4*>(row + va);
  for (int q = lane; q < nv; q += kLanes) vz[q] = make_uint4(0u, 0u, 0u, 0u);
  for (int i = va + nv * 4 + lane; i < W; i += kLanes) row[i] = 0;
}

#endif

}  // namespace

#ifdef __CUDACC__

// How a launch over M lanes runs: out[0] warps a block (lanes a block),
// out[1] blocks the launch starts, out[2] the blocks the card holds at once
// (SMs x blocks per SM), out[3] shared memory a block (bytes), out[4]
// registers a thread, out[5] local memory a thread (bytes: spills). Returns
// a CUDA error code.
extern "C" int m3_encode_shape(int64_t M, int64_t* out) {
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, encode_kernel);
  if (e != cudaSuccess) return (int)e;
  int64_t resident = 0;
  if ((e = m3::resident_blocks(encode_kernel, kThreads, 0, &resident)) != cudaSuccess)
    return (int)e;
  out[0] = kWarps;
  out[1] = (M + kWarps - 1) / kWarps;
  out[2] = resident;
  out[3] = (int64_t)attr.sharedSizeBytes;
  out[4] = attr.numRegs;
  out[5] = (int64_t)attr.localSizeBytes;
  return 0;
}

// B-4: the planes above (contiguous, on the card), M lanes, T records, k
// records a chunk, W words a row, C = ceil(T / k) chunk rows -> words
// (int32 [M, W]), total_bits (int32 [M]), chunk_offs and chunk_sigs
// (int32 [C, M]). Every output word is written by the kernel (no memset).
// Returns the CUDA error of the launch, or -1 for arguments out of range.
extern "C" int m3_encode_lanes(const int64_t* t0, const int32_t* counts, const uint8_t* float_lane,
                               const int32_t* dod, const int64_t* vbits, int64_t M, int64_t T,
                               int k, int64_t W, int64_t C, int32_t* words, int32_t* total_bits,
                               int32_t* chunk_offs, int32_t* chunk_sigs, void* stream) {
  if (M < 0 || T < 1 || k < 1 || W < 1 || W > kMaxWords || C != (T + k - 1) / k) return -1;
  if (M == 0) return 0;
  const Args a{t0, counts, float_lane, dod, vbits, M, k, W, C, (uint32_t*)words, total_bits,
               chunk_offs, chunk_sigs};
  const unsigned grid = (unsigned)((M + kWarps - 1) / kWarps);
  encode_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

#else  // host C++ build: the kernel's steps, a warp's lanes one after the other

namespace {

// The tracker over a step, as tracker_step runs it: each round's prefix
// max, ballots and reductions over the 32 lanes in turn.
void tracker_step_host(const bool* act, const int* sig, Tracker* t, int* nsb, int* nsa) {
  int st = 0;
  for (;;) {
    int incl[kLanes], pm[kLanes], cls[kLanes];
    int run_max = 0;
    uint32_t lows = 0, mids = 0, falls = 0;
    for (int l = 0; l < kLanes; ++l) {
      const int v = act[l] && l >= st ? sig[l] : 0;
      incl[l] = l == 0 ? v : (v > incl[l - 1] ? v : incl[l - 1]);
      const int excl = l == 0 ? 0 : incl[l - 1];
      pm[l] = t->ns > excl ? t->ns : excl;
      cls[l] = classify(act[l] && l >= st, sig[l], pm[l]);
      lows |= (uint32_t)(cls[l] == kLow) << l;
      mids |= (uint32_t)(cls[l] == kMid) << l;
    }
    bool carried;
    for (int l = 0; l < kLanes; ++l) {
      const uint32_t run = run_lows(lows, mids, l, &carried);
      if (cls[l] == kLow && run_length(run, carried, *t) >= kSigRepeatThreshold) falls |= 1u << l;
    }
    const int f = lowest(falls);
    for (int l = st; l < f; ++l) {
      nsb[l] = pm[l];
      nsa[l] = t->ns > incl[l] ? t->ns : incl[l];
    }
    const uint32_t rl = run_lows(lows, mids, f < 32 ? f : 31, &carried);
    for (int l = 0; l < kLanes; ++l)
      if ((rl >> l) & 1u && sig[l] > run_max) run_max = sig[l];
    if (carried && t->nl > 0 && t->ch > run_max) run_max = t->ch;
    if (f == 32) {
      const int nl = run_length(rl, carried, *t);
      *t = {t->ns > incl[kLanes - 1] ? t->ns : incl[kLanes - 1], run_max, nl};
      return;
    }
    nsb[f] = pm[f];
    nsa[f] = run_max;
    *t = {run_max, run_max, 0};
    st = f + 1;
    if (st == kLanes) return;
  }
}

void encode_lane_host(int64_t m, const int64_t* t0, const int32_t* counts,
                      const uint8_t* float_lane, const int32_t* dod, const int64_t* vbits,
                      int64_t M, int k, int64_t W, int64_t C, uint32_t* words,
                      int32_t* total_bits, int32_t* chunk_offs, int32_t* chunk_sigs) {
  const int n = counts[m];
  const bool is_float = float_lane[m] != 0;
  uint32_t* row = words + m * W;
  const int lead = (int)((kAlign - (m * W) % kAlign) % kAlign);
  uint32_t ring[kRing] = {};
  int bitpos = 0, flushed = 0;
  int next_chunk = 0, chunks = 0;
  Tracker tr{0, 0, 0};
  uint64_t prev = 0;
  int pz = zeros(0);
  for (int s = 0; s * kLanes < n; ++s) {
    bool valid[kLanes], act[kLanes];
    uint64_t raw[kLanes], x[kLanes], dbits[kLanes];
    int64_t d[kLanes];
    int dlen[kLanes], sig[kLanes], nsb[kLanes] = {}, nsa[kLanes] = {}, len[kLanes];
    Value v[kLanes];
    uint32_t nz = 0;
    for (int l = 0; l < kLanes; ++l) {
      const int64_t j = (int64_t)s * kLanes + l;
      valid[l] = j < n;
      raw[l] = valid[l] ? (uint64_t)vbits[j * M + m] : 0;
      dlen[l] = dod_field(valid[l] ? dod[j * M + m] : 0, &dbits[l]);
      const uint64_t pv = l == 0 ? prev : raw[l - 1];
      const bool first = j == 0;
      x[l] = first ? raw[l] : raw[l] ^ pv;
      nz |= (uint32_t)(valid[l] && x[l] != 0) << l;
      d[l] = first ? (int64_t)raw[l] : (int64_t)pv - (int64_t)raw[l];
      sig[l] = 32 - clz32(magnitude(d[l]));
      act[l] = valid[l] && d[l] != 0;
    }
    if (is_float) {
      for (int l = 0; l < kLanes; ++l) {
        const int src = highest_below(nz, l);
        v[l] = float_value(s == 0 && l == 0, raw[l], x[l], zeros(x[l]),
                           src < 0 ? pz : zeros(x[src]));
      }
      if (nz) pz = zeros(x[31 - clz32(nz)]);
    } else {
      tracker_step_host(act, sig, &tr, nsb, nsa);
      for (int l = 0; l < kLanes; ++l)
        v[l] = int_value(s == 0 && l == 0, (int64_t)raw[l], d[l], nsb[l], nsa[l]);
    }
    prev = raw[kLanes - 1];
    const uint32_t starts = chunk_starts(&next_chunk, s * kLanes, n, k);
    int at = bitpos;
    for (int l = 0; l < kLanes; ++l) {
      const int64_t j = (int64_t)s * kLanes + l;
      len[l] = valid[l] ? record_bits(j == 0, dlen[l], v[l]) : 0;
      emit_record(ring, at, j == 0, t0 + m, dbits[l], dlen[l], v[l], valid[l]);
      if ((starts >> l) & 1u) {
        const int64_t c = chunks + popc32(starts & ((1u << l) - 1u));
        chunk_offs[c * M + m] = at;
        chunk_sigs[c * M + m] = nsb[l];
      }
      at += len[l];
    }
    chunks += popc32(starts);
    bitpos = at;
    const int fe = flush_end(lead, bitpos >> 5);
    for (int i = flushed; i < fe; ++i) {
      row[i] = ring[i & (kRing - 1)];
      ring[i & (kRing - 1)] = 0;
    }
    if (fe > flushed) flushed = fe;
  }
  for (int64_t c = chunks; c < C; ++c) {
    chunk_offs[c * M + m] = bitpos;
    chunk_sigs[c * M + m] = tr.ns;
  }
  or_bits(ring, bitpos, 0, kEos, kEosBits, true);
  total_bits[m] = bitpos + kEosBits;
  const int used = (bitpos + kEosBits + 31) >> 5;
  for (int i = flushed; i < used; ++i) row[i] = ring[i & (kRing - 1)];
  const int va = vector_start(row, used, (int)W), nv = ((int)W - va) >> 2;
  for (int i = used; i < va; ++i) row[i] = 0;
  std::memset(row + va, 0, (size_t)nv * 16);
  for (int i = va + nv * 4; i < W; ++i) row[i] = 0;
}

}  // namespace

extern "C" int m3_encode_lanes_host(const int64_t* t0, const int32_t* counts,
                                    const uint8_t* float_lane, const int32_t* dod,
                                    const int64_t* vbits, int64_t M, int64_t T, int k, int64_t W,
                                    int64_t C, int32_t* words, int32_t* total_bits,
                                    int32_t* chunk_offs, int32_t* chunk_sigs) {
  if (M < 0 || T < 1 || k < 1 || W < 1 || W > kMaxWords || C != (T + k - 1) / k) return -1;
  for (int64_t m = 0; m < M; ++m)
    encode_lane_host(m, t0, counts, float_lane, dod, vbits, M, k, W, C, (uint32_t*)words,
                     total_bits, chunk_offs, chunk_sigs);
  return 0;
}

#endif
