// M3TSZ chunk-lane decode + fold: the CUDA port of the Pallas kernel
// m3_tpu/ops/fused.py:lane_aggregates_packed (_pallas_kernel_packed and its
// three bodies _run_lane_tile, _run_lane_tile_fast, _run_lane_tile_fast_float).
//
// What it computes. Each lane is one chunk of at most k M3TSZ records. It
// starts from the decoder state of its side table (17 u32 planes), decodes
// its records from its own CW-word window (delta-of-delta timestamps, then
// int-mode sig/mult values or Gorilla XOR floats) and folds every value into
// f32 sum/min/max/last, an i32 count and an err flag. Only those leave.
//
// Bound. Memory: per lane the work needs the window words its chunk's bits
// occupy (ceil((rel_pos + span) / 32), at most CW), the state planes its
// tile's body reads (general 17, int-fast 5: REL NBITS IV_LO SIG MULT,
// float-fast 6: REL NBITS PFB PXR), one flag per tile, and 21 bytes of
// aggregates written; the decode itself is integer work in registers. At
// the main path's shape (31.5M lanes, CW=24, 7,424 int-fast and 256 general
// tiles, 15.1 words per lane) that is 3.24 GB: windows 1.90, planes 0.68,
// outputs 0.66; 0.97 ms at 3.35 TB/s (chip_smoke.py needed_bytes).
//
// Design. One thread per lane, looping over the k records with the state
// in registers as native 64-bit integers (the TPU's (hi, lo) u32 pairs
// are gone). The 4-word fetch is four word loads and a funnel shift; it
// replaces the TPU's barrel select over window columns (chunked.py
// _fetch4_select), which existed only because TPU gathers are slow. Words
// past CW read as zero, and word indices wrap with the barrel's mask
// exactly as the reference's do. The body is chosen per TILE (rows x 128
// lanes) by tile_flags, never per lane: the general and int-fast bodies
// convert int values differently, so the choice shows in the output.
//
// Loads (lane_aggregates_slab_kernel). A thread that fetches every word
// straight from device memory makes eight scattered 4-byte loads per record
// (a fetch for the timestamp, another for the value), whose 32 lanes touch
// up to 32 lines once their bit cursors drift apart, with nothing
// overlapping them. Instead:
// - A block walks 128-lane slabs. A slab's [CW, 128] window words are CW
//   contiguous 512-byte runs of [CW, Npad]; cp.async copies them, 16 bytes
//   a thread, into shared memory. A block loads its slab, then decodes it,
//   and the other blocks on its SM overlap its loads. A ring of two or
//   three stages that loads ahead ran slower on the H100: it fits fewer
//   blocks on an SM.
// - A lane reads word w at s[w * 128 + lane]: bank lane % 32 for every w,
//   so no bank conflicts however far the cursors drift. The fetch clamps
//   its first word index to CW and four zero rows follow the CW window
//   rows, so "past CW reads 0" is a plain load and a stage holds CW + 4
//   rows (28 at CW=24), not the barrel's mask + 4 (35).
// - One fetch per fast record: the value's bits are the timestamp fetch
//   shifted by the timestamp's width (follow, run_fast_int), unless the
//   barrel would wrap between the two or too few bits remain, when a
//   second fetch reads exactly what the reference reads.
// - The int-fast body, 97% of the main path's tiles, parses a sig/mult
//   header only on a to-int record, looks 10^-mult up only when mult
//   changes, and folds with min/max that skip the NaN test (its values are
//   never NaN; the bits are those of the NaN-aware fold). The timestamp
//   width and the fold are selects, not branches: the lanes of a warp
//   decode different records, so a branch on the data diverges.
// - State planes are read once per lane straight from [17, Npad]
//   (neighbouring lanes on neighbouring words): staging them bought
//   nothing and cost shared memory, that is blocks per SM.
// What it found (PERF.md): the number of stages, and so of blocks per SM,
// changed the time little, so the decode is not waiting on loads; it is
// bound by its own integer work (the int-fast record loop, some of it on
// rare paths), far from the bytes bound.
// The kernel takes Npad and the tile as multiples of 128 and windows and
// planes aligned to 16 bytes, which is all that pack_lanes and the resident
// assembly give; other shapes are refused (cudaErrorInvalidValue).
//
// Parity with the reference, bit for bit:
// - f32 values come from the reference's formulas (f64_bits_to_f32, to_f32,
//   _mult_reciprocal), not from native casts: f64_bits_to_f32 is not
//   correctly rounded, and to_f32 sends small negative ints to wrong values
//   (-3 -> 0.0). Both are copied as written.
// - Build with -fmad=false: nvcc would otherwise contract a*b+c into FMAs
//   that round differently. Never --use_fast_math.
// - Build with -ftz=true: XLA flushes f32 subnormals to zero on the CPU and
//   the TPU alike, so the reference's exp==0 branch and tiny sums give +-0.
// - min/max propagate NaN as jnp.minimum/jnp.maximum do (fminf/fmaxf drop
//   it), and of +0/-0 min takes -0 and max +0. Initial values are
//   +inf/-inf/NaN for min/max/last.
// - Markers: EOS ends a lane; annotations and unsupported time units set
//   err; a time-unit marker switches the unit and reads a 64-bit dod.
//
// Kernel R, the second entry (m3_decode_records), writes records instead of
// folding them: the general body's per-record timestamp, raw value bits,
// point_is_float, mult and valid, plus err per lane. It replaces XLA code,
// not a Pallas kernel: m3_tpu/ops/chunked.py:460 decode_chunked_lanes. Bound:
// memory, as B1's: the lanes' window words and 17 planes read, 19 bytes per
// record and 1 per lane written. Its records leave through shared memory so
// that the stores to device memory are coalesced (see decode_records_kernel).
//
// B3, the third entry (m3_lane_aggregates_fields), is the port of the Pallas
// kernel m3_tpu/ops/fused.py:lane_aggregates_pallas (_pallas_kernel): the
// same decode and fold with the general body on every lane, over the
// per-field layout (lane-major windows [n, CW], 17 separate field arrays),
// which is what chunked_device_args and the resident lane assembly give.
// Bound: memory, as B1's general tiles: per lane its chunk's window words,
// 15 u32 fields + 2 bool fields, 21 output bytes. Its trouble is the load: a
// thread per lane reading its own row strides CW*4 bytes across a warp, so
// the block stages its rows, one contiguous range, through shared memory
// with coalesced loads (see lane_aggregates_fields_kernel).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// -ftz=true -shared (ops/_build.py). Without __CUDACC__ the same per-lane
// code compiles as host C++ (with FTZ/DAZ set), which the CPU tests use to
// hold this file's arithmetic against the PyTorch twin.

#include <cstdint>

#include "../../csrc/launch.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __device__ __forceinline__
#define M3_HDX __host__ __device__ inline
#define M3_LOAD(p) __ldg(p)
#else
#include <cstring>
#include <vector>
#include <xmmintrin.h>
#define M3_HD inline
#define M3_HDX inline
#define M3_LOAD(p) (*(p))
static inline uint32_t __funnelshift_l(uint32_t lo, uint32_t hi, unsigned s) {
  s &= 31;
  return s ? (hi << s) | (lo >> (32 - s)) : hi;
}
static inline float __int_as_float(int x) { float f; std::memcpy(&f, &x, 4); return f; }
static inline int __float_as_int(float f) { int x; std::memcpy(&x, &f, 4); return x; }
static inline int __clzll(long long x) { return __builtin_clzll((unsigned long long)x); }
static inline int __ffsll(long long x) { return __builtin_ffsll(x); }
#endif

namespace {

enum Plane {
  REL = 0, NBITS, FIRST, PT_HI, PT_LO, PD_HI, PD_LO, PFB_HI, PFB_LO,
  PXR_HI, PXR_LO, IV_HI, IV_LO, TU, SIG, MULT, ISF
};

// Four window words aligned to the cursor, as two 64-bit halves: a = w0:w1,
// b = w2:w3. The low bits of w3 past the shift are zero, as in the reference.
struct Window {
  uint64_t a, b;
};

// 64 bits at bit `start` of the 128-bit window (zeros past its end).
M3_HD uint64_t get64(const Window& w, int start) {
  if (start == 0) return w.a;
  if (start < 64) return (w.a << start) | (w.b >> (64 - start));
  if (start == 64) return w.b;
  if (start < 128) return w.b << (start - 64);
  return 0;
}

// n bits at `start`, right-aligned. n outside [1, 64] gives 0, as the
// reference's shift by 64 or more does.
M3_HD uint64_t bits(const Window& w, int start, int n) {
  if ((unsigned)(n - 1) >= 64u) return 0;
  return get64(w, start) >> (64 - n);
}

M3_HD uint64_t shl64(uint64_t x, int s) { return s >= 64 ? 0 : x << s; }
M3_HD int clz64(uint64_t x) { return x ? __clzll((long long)x) : 64; }
M3_HD int ctz64(uint64_t x) { return x ? __ffsll((long long)x) - 1 : 64; }
M3_HD int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
M3_HD int min_i(int a, int b) { return a < b ? a : b; }
#ifdef __CUDACC__
M3_HD int clz32(uint32_t x) { return __clz((int)x); }
#else
inline int clz32(uint32_t x) { return x ? __builtin_clz(x) : 32; }
#endif

// The four window words at bit rel + pos of a lane, aligned to that bit.
// Word indices wrap with the reference's barrel mask; words past CW read as
// zero (Lane::word).
template <class Lane>
M3_HD Window fetch_window(const Lane& L, int pos) {
  const int p = L.rel + pos;
  const int widx = (p >> 5) & L.mask;
  const uint32_t w0 = L.word(widx), w1 = L.word(widx + 1);
  const uint32_t w2 = L.word(widx + 2), w3 = L.word(widx + 3);
  const unsigned r = (unsigned)p & 31u;
  const uint32_t s0 = __funnelshift_l(w1, w0, r);
  const uint32_t s1 = __funnelshift_l(w2, w1, r);
  const uint32_t s2 = __funnelshift_l(w3, w2, r);
  const uint32_t s3 = w3 << r;
  return {((uint64_t)s0 << 32) | s1, ((uint64_t)s2 << 32) | s3};
}

// A lane of the packed layout (B1, R): word-major windows [CW, Npad] and
// state planes [17, Npad].
struct LaneRef {
  const uint32_t* win;  // this lane's word 0 in the [CW, Npad] window array
  const uint32_t* planes;  // this lane's plane 0 in the [17, Npad] array
  int64_t npad;
  int cw, mask, rel;

  M3_HD uint32_t plane(int p) const { return M3_LOAD(planes + (int64_t)p * npad); }
  M3_HD uint32_t word(int i) const { return i < cw ? M3_LOAD(win + (int64_t)i * npad) : 0u; }
  M3_HD uint64_t pair(int p_hi) const {
    return ((uint64_t)plane(p_hi) << 32) | plane(p_hi + 1);
  }

  M3_HD Window fetch(int pos) const { return fetch_window(*this, pos); }
};

// A lane of a B1 slab: the slab's CW window rows of 128 words staged in
// shared memory (then up to four zero rows, stage_rows), this lane at
// column `col`, and its state planes read in place from the [17, Npad]
// array (once per lane, neighbouring lanes on neighbouring words). A warp
// reads word w of its 32 lanes from one row, 32 consecutive words: one bank
// each, however far the lanes' bit cursors have drifted apart.
constexpr int kSlab = 128;

struct SlabLane {
  const uint32_t* win;     // this lane's word 0 in the slab's [CW, 128] rows
  const uint32_t* planes;  // this lane's plane 0 in the [17, Npad] array
  int64_t npad;
  int cw, mask, rel;

  M3_HD uint32_t plane(int p) const { return M3_LOAD(planes + (int64_t)p * npad); }
  M3_HD uint64_t pair(int p_hi) const {
    return ((uint64_t)plane(p_hi) << 32) | plane(p_hi + 1);
  }

  // fetch_window with the first word index clamped to cw: a fetch from a
  // word at or past CW reads four zero words either way, and the stage
  // needs zero rows only up to cw + 3 (not the barrel's mask + 3)
  M3_HD Window fetch(int pos) const {
    const int p = rel + pos;
    const int widx = min_i((p >> 5) & mask, cw);
    const uint32_t* w = win + widx * kSlab;
    const uint32_t w0 = w[0], w1 = w[kSlab], w2 = w[2 * kSlab], w3 = w[3 * kSlab];
    const unsigned r = (unsigned)p & 31u;
    const uint32_t s0 = __funnelshift_l(w1, w0, r);
    const uint32_t s1 = __funnelshift_l(w2, w1, r);
    const uint32_t s2 = __funnelshift_l(w3, w2, r);
    const uint32_t s3 = w3 << r;
    return {((uint64_t)s0 << 32) | s1, ((uint64_t)s2 << 32) | s3};
  }
};

// The 17 state fields of the per-field layout (B3), one array each, indexed
// by the Plane enum; FIRST and ISF are bool (u8) arrays, the rest u32.
struct FieldPlanes {
  const uint32_t* p[17];
  const uint8_t* first;
  const uint8_t* isf;
};

// A lane of the per-field layout (B3): its CW window words in one row (a
// row of shared memory on the card) and its fields at index `lane`.
struct FieldLane {
  const uint32_t* row;
  FieldPlanes f;  // by value: p is a constant at every inlined call, so
                  // only the pointers the walk reads stay in registers
  int64_t lane;
  int cw, mask, rel;

  M3_HD uint32_t plane(int p) const {
    if (p == FIRST) return M3_LOAD(f.first + lane);
    if (p == ISF) return M3_LOAD(f.isf + lane);
    return M3_LOAD(f.p[p] + lane);
  }
  M3_HD uint32_t word(int i) const { return i < cw ? row[i] : 0u; }
  M3_HD uint64_t pair(int p_hi) const {
    return ((uint64_t)plane(p_hi) << 32) | plane(p_hi + 1);
  }

  M3_HD Window fetch(int pos) const { return fetch_window(*this, pos); }
};

// The host's array of the 17 field pointers, in Plane order, as a struct
// passed to the kernel by value.
inline FieldPlanes make_field_planes(const void* const* fields) {
  FieldPlanes f;
  for (int i = 0; i < 17; ++i) f.p[i] = static_cast<const uint32_t*>(fields[i]);
  f.first = static_cast<const uint8_t*>(fields[FIRST]);
  f.isf = static_cast<const uint8_t*>(fields[ISF]);
  return f;
}

// ---------------------------------------------------------------------------
// f32 conversions: the reference's formulas (m3_tpu/ops/u64.py, decode.py)
// ---------------------------------------------------------------------------

M3_HD float u32_to_f32(uint32_t x) {
  return (float)(int)(x >> 16) * 65536.0f + (float)(int)(x & 0xFFFFu);
}

M3_HD float to_f32(uint64_t v) {
  return (float)(int32_t)(uint32_t)(v >> 32) * 4294967296.0f + u32_to_f32((uint32_t)v);
}

M3_HD float pow2f(int e) { return __int_as_float((e + 127) << 23); }

M3_HD float f64_bits_to_f32(uint64_t v) {
  const uint32_t hi = (uint32_t)(v >> 32), lo = (uint32_t)v;
  const float sign = (hi >> 31) ? -1.0f : 1.0f;
  const int exp = (int)((hi >> 20) & 0x7FFu);
  const float mant = (float)(int)(hi & 0xFFFFFu) * 4294967296.0f + u32_to_f32(lo);
  const float frac = mant * 0x1p-52f;
  const int e = clampi(exp - 1023, -149, 128);
  const int e1 = clampi(e, -126, 127);
  float mag = (1.0f + frac) * pow2f(e1) * pow2f(e - e1);
  if (exp == 0) mag = frac * pow2f(-126);
  if (exp == 0x7FF) mag = mant == 0.0f ? __int_as_float(0x7F800000) : __int_as_float(0x7FC00000);
  return sign * mag;
}

// 10^-mult as the reference's correctly rounded f32 constants; 1 outside [1, 6]
M3_HD float mult_rcp(int mult) {
  switch (mult) {
    case 1: return __int_as_float(0x3DCCCCCD);
    case 2: return __int_as_float(0x3C23D70A);
    case 3: return __int_as_float(0x3A83126F);
    case 4: return __int_as_float(0x38D1B717);
    case 5: return __int_as_float(0x3727C5AC);
    case 6: return __int_as_float(0x358637BD);
    default: return 1.0f;
  }
}

// ---------------------------------------------------------------------------
// Aggregates
// ---------------------------------------------------------------------------

M3_HD float min_nan(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7FC00000);
  if (a < b) return a;
  if (b < a) return b;
  return __int_as_float(__float_as_int(a) | __float_as_int(b));
}

M3_HD float max_nan(float a, float b) {
  if (a != a || b != b) return __int_as_float(0x7FC00000);
  if (a > b) return a;
  if (b > a) return b;
  return __int_as_float(__float_as_int(a) & __float_as_int(b));
}

struct Acc {
  float sum, mn, mx, last;
  int32_t cnt;

  M3_HD void init() {
    sum = 0.0f;
    cnt = 0;
    mn = __int_as_float(0x7F800000);
    mx = __int_as_float((int)0xFF800000);
    last = __int_as_float(0x7FC00000);
  }
  M3_HD void fold(bool valid, float v) {
    sum = sum + (valid ? v : 0.0f);
    cnt += valid ? 1 : 0;
    mn = min_nan(mn, valid ? v : __int_as_float(0x7F800000));
    mx = max_nan(mx, valid ? v : __int_as_float((int)0xFF800000));
    if (valid) last = v;
  }
  // fold() for values that are never NaN (the int-fast body's): min and
  // max without the NaN test, the same bits otherwise (equal values merge
  // their bits, so -0 is below +0), every operand computed first so that
  // the compiler selects instead of branching
  M3_HD void fold_num(bool valid, float v) {
    sum = sum + (valid ? v : 0.0f);
    cnt += valid ? 1 : 0;
    const float lo = valid ? v : __int_as_float(0x7F800000);
    const float hi = valid ? v : __int_as_float((int)0xFF800000);
    const float mn_eq = __int_as_float(__float_as_int(mn) | __float_as_int(lo));
    const float mx_eq = __int_as_float(__float_as_int(mx) & __float_as_int(hi));
    const float mn_keep = mn < lo ? mn : mn_eq;
    const float mx_keep = mx > hi ? mx : mx_eq;
    mn = lo < mn ? lo : mn_keep;
    mx = hi > mx ? hi : mx_keep;
    last = valid ? v : last;
  }
};

// ---------------------------------------------------------------------------
// Record decode (m3_tpu/ops/decode.py)
// ---------------------------------------------------------------------------

struct State {
  int pos;
  bool done, err, is_float;
  int time_unit, mult, sig;
  uint64_t prev_time, prev_delta, prev_float_bits, prev_xor, int_val;
};

M3_HD uint64_t unit_nanos(int tu) {
  switch (tu) {
    case 1: return 1000000000ull;
    case 2: return 1000000ull;
    case 3: return 1000ull;
    case 4: return 1ull;
    default: return 0ull;
  }
}

// _decode_timestamp
template <class Lane>
M3_HD void decode_timestamp(const Lane& L, int nb, State& st, bool first, uint64_t nt) {
  const int pos = first ? st.pos + 64 : st.pos;
  const uint64_t prev_time0 = first ? nt : st.prev_time;
  const Window ws = L.fetch(pos);
  const bool in_range = pos + 11 <= nb;
  const uint32_t peek = (uint32_t)bits(ws, 0, 11);
  const bool is_marker = in_range && (peek >> 2) == 0x100u;
  const uint32_t mv = peek & 3u;
  const bool eos = is_marker && mv == 0;
  const bool ann = is_marker && mv == 1;
  const bool tu_marker = is_marker && mv == 2;

  const int new_unit = (int)bits(ws, 11, 8);
  const bool tu_supported = new_unit >= 1 && new_unit <= 4;
  const bool tu_changed = tu_marker && tu_supported && new_unit != st.time_unit;
  const int time_unit = (tu_marker && tu_supported) ? new_unit : st.time_unit;
  const int dod_off = tu_marker ? 19 : 0;

  const uint32_t head16 = (uint32_t)bits(ws, dod_off, 16);
  const uint32_t b0 = (head16 >> 15) & 1u, b1 = (head16 >> 14) & 1u;
  const uint32_t b2 = (head16 >> 13) & 1u, b3 = (head16 >> 12) & 1u;
  const bool zero_dod = b0 == 0;
  const bool sel7 = b0 == 1 && b1 == 0;
  const bool sel9 = b0 == 1 && b1 == 1 && b2 == 0;
  const bool sel12 = b0 == 1 && b1 == 1 && b2 == 1 && b3 == 0;
  const int default_bits = (time_unit == 1 || time_unit == 2) ? 32 : 64;
  const int nbits = sel7 ? 7 : (sel9 ? 9 : (sel12 ? 12 : default_bits));
  const int opbits = sel7 ? 2 : (sel9 ? 3 : 4);
  uint64_t dod_norm;
  if (sel7) {
    dod_norm = (uint64_t)(int64_t)((int32_t)(((head16 >> 7) & 0x7Fu) ^ 0x40u) - 0x40);
  } else if (sel9) {
    dod_norm = (uint64_t)(int64_t)((int32_t)(((head16 >> 4) & 0x1FFu) ^ 0x100u) - 0x100);
  } else if (sel12) {
    dod_norm = (uint64_t)(int64_t)((int32_t)((head16 & 0xFFFu) ^ 0x800u) - 0x800);
  } else if (default_bits == 32) {
    dod_norm = (uint64_t)(int64_t)(int32_t)(uint32_t)bits(ws, dod_off + 4, 32);
  } else {
    dod_norm = bits(ws, dod_off + 4, 64);
  }
  const uint64_t dod_bucket = dod_norm * unit_nanos(time_unit);
  const int bucket_consumed = zero_dod ? 1 : opbits + nbits;

  uint64_t dod = tu_changed ? bits(ws, 19, 64) : dod_bucket;
  if (zero_dod && !tu_changed) dod = 0;
  const int consumed = dod_off + (tu_changed ? 64 : bucket_consumed);

  const bool unit_ok = time_unit >= 1 && time_unit <= 4;
  const bool err_now = (ann || !unit_ok || (tu_marker && !tu_supported)) && !st.done && !eos;
  uint64_t prev_delta = st.prev_delta + dod;
  const uint64_t prev_time = prev_time0 + prev_delta;
  if (tu_changed) prev_delta = 0;

  const bool active = !st.done && !st.err && !eos && !err_now;
  if (active) {
    st.pos = pos + consumed;
    st.prev_time = prev_time;
    st.prev_delta = prev_delta;
    st.time_unit = time_unit;
  }
  st.done = st.done || eos;
  st.err = st.err || err_now;
}

// _read_int_header12: sig/mult update header from its 12 head bits
M3_HD void int_header12(uint32_t hb, int sig, int mult, int& new_sig, int& new_mult,
                        int& consumed, bool& mult_invalid) {
  const bool upd = ((hb >> 11) & 1u) == 1;
  const bool zero_sig = ((hb >> 10) & 1u) == 0;
  const int sig_m1 = (int)((hb >> 4) & 0x3Fu);
  new_sig = upd ? (zero_sig ? 0 : sig_m1 + 1) : sig;
  const int sig_consumed = upd ? (zero_sig ? 2 : 8) : 1;
  const bool is1 = !upd;
  const bool is2 = upd && zero_sig;
  const uint32_t b_mult_upd = is1 ? (hb >> 10) & 1u : (is2 ? (hb >> 9) & 1u : (hb >> 3) & 1u);
  const int mult_v = (int)(is1 ? (hb >> 7) & 7u : (is2 ? (hb >> 6) & 7u : hb & 7u));
  const bool mupd = b_mult_upd == 1;
  new_mult = mupd ? mult_v : mult;
  consumed = sig_consumed + (mupd ? 4 : 1);
  mult_invalid = mupd && mult_v > 6;
}

// _read_xor: Gorilla XOR float record at bit `off`
M3_HD void read_xor(const Window& ws, int off, uint64_t prev_bits, uint64_t prev_xor,
                    uint64_t& new_bits, uint64_t& new_xor, int& consumed) {
  const uint32_t c0 = (uint32_t)bits(ws, off, 1);
  const uint32_t c1 = (uint32_t)bits(ws, off + 1, 1);
  uint64_t x;
  if (c0 == 0) {
    x = 0;
    consumed = 1;
  } else if (c1 == 0) {  // contained: reuse the previous leading/trailing window
    const int lead = prev_xor ? clz64(prev_xor) : 64;
    const int trail = prev_xor ? ctz64(prev_xor) : 0;
    const int nm = clampi(64 - lead - trail, 0, 64);
    x = shl64(bits(ws, off + 2, nm), trail);
    consumed = 2 + nm;
  } else {  // uncontained: 6-bit lead, 6-bit (nm - 1), nm bits
    const int lead = (int)bits(ws, off + 2, 6);
    const int nm = (int)bits(ws, off + 8, 6) + 1;
    const int trail = clampi(64 - lead - nm, 0, 64);
    x = shl64(bits(ws, off + 14, nm), trail);
    consumed = 14 + nm;
  }
  new_bits = prev_bits ^ x;
  new_xor = x;
}

// _decode_value with int_optimized: one value record
template <class Lane>
M3_HD void decode_value(const Lane& L, State& st, bool first) {
  const int pos = st.pos;
  const Window ws = L.fetch(pos);
  const uint32_t head3 = (uint32_t)bits(ws, 0, 3);
  const bool first_is_float = ((head3 >> 2) & 1u) == 1;
  const bool upd = ((head3 >> 2) & 1u) == 0;
  const bool repeat = upd && ((head3 >> 1) & 1u) == 1;
  const bool to_float = upd && !repeat && (head3 & 1u) == 1;
  const bool to_int = upd && !repeat && (head3 & 1u) == 0;
  const bool stay = !upd;

  const bool sel_first_float = first && first_is_float;
  const bool sel_first_int = first && !first_is_float;
  const bool sel_to_float = !first && to_float;
  const bool sel_to_int = !first && to_int;
  const bool sel_stay_float = !first && stay && st.is_float;
  const bool sel_stay_int = !first && stay && !st.is_float;

  const uint64_t full = bits(ws, first ? 1 : 3, 64);
  const bool takes_header = sel_first_int || sel_to_int;
  int h_sig, h_mult, h_consumed;
  bool h_mult_bad;
  int_header12((uint32_t)bits(ws, first ? 1 : 3, 12), st.sig, st.mult, h_sig, h_mult,
               h_consumed, h_mult_bad);
  const int diff_off = first ? 1 + h_consumed : (to_int ? 3 + h_consumed : 1);
  const int diff_sig = takes_header ? h_sig : st.sig;
  const uint64_t diff_base = first ? 0 : st.int_val;
  const uint64_t diff = bits(ws, diff_off + 1, diff_sig);
  const uint64_t d_int_val = diff_base + (bits(ws, diff_off, 1) == 1 ? diff : (uint64_t)0 - diff);
  const int d_consumed = 1 + diff_sig;
  uint64_t x_bits, x_xor;
  int x_consumed;
  read_xor(ws, 1, st.prev_float_bits, st.prev_xor, x_bits, x_xor, x_consumed);

  const int first_consumed = first_is_float ? 65 : 1 + h_consumed + d_consumed;
  const int next_consumed =
      repeat ? 2
             : (to_float ? 3 + 64
                         : (to_int ? 3 + h_consumed + d_consumed
                                   : (st.is_float ? 1 + x_consumed : 1 + d_consumed)));
  const int consumed = first ? first_consumed : next_consumed;

  const bool new_is_float =
      (sel_first_float || sel_to_float) || (!(sel_first_int || sel_to_int) && st.is_float);
  const bool takes_full = sel_first_float || sel_to_float;
  uint64_t new_float_bits = takes_full ? full : st.prev_float_bits;
  if (sel_stay_float) new_float_bits = x_bits;
  uint64_t new_xor = takes_full ? full : st.prev_xor;
  if (sel_stay_float) new_xor = x_xor;
  const bool takes_diff = sel_first_int || sel_to_int || sel_stay_int;
  const bool err_now = takes_header && h_mult_bad;

  const bool active = !st.done && !st.err && !err_now;
  st.err = st.err || (err_now && !st.done);
  if (active) {
    st.pos = pos + consumed;
    st.prev_float_bits = new_float_bits;
    st.prev_xor = new_xor;
    if (takes_diff) st.int_val = d_int_val;
    if (takes_header) {
      st.sig = h_sig;
      st.mult = h_mult;
    }
    st.is_float = new_is_float;
  }
}

// _ts_consumed_fast: width of a marker-free {s, ms} timestamp record. The
// leading ones of its 4-bit head (0..4) pick 1, 9, 12, 16 or 36 bits, here
// a byte of one constant: no branch, so lanes whose widths differ do not
// diverge.
M3_HD int ts_consumed_fast(const Window& ws) {
  const uint32_t h = (uint32_t)(ws.a >> 60);
  const int ones = clz32(~(h << 28));  // the low 28 bits are set: at most 4
  return (int)((0x24100C0901ull >> (8 * ones)) & 0xFFu);
}

// ---------------------------------------------------------------------------
// The three bodies
// ---------------------------------------------------------------------------

// The general body's record walk (_run_lane_tile with int_optimized, and
// chunked.py decode_chunked_lanes' step): emit(idx, valid, state) after each
// record. Returns the lane's err flag.
template <class Lane, class Emit>
M3_HD bool walk_general(const Lane& L, int k, Emit&& emit) {
  const int num_bits = (int32_t)L.plane(NBITS);
  State st;
  st.pos = 0;
  st.done = num_bits <= L.rel;
  st.err = false;
  st.prev_time = L.pair(PT_HI);
  st.prev_delta = L.pair(PD_HI);
  st.time_unit = (int32_t)L.plane(TU);
  st.prev_float_bits = L.pair(PFB_HI);
  st.prev_xor = L.pair(PXR_HI);
  st.int_val = L.pair(IV_HI);
  st.mult = (int32_t)L.plane(MULT);
  st.sig = (int32_t)L.plane(SIG);
  st.is_float = L.plane(ISF) != 0;
  const bool first_chunk = L.plane(FIRST) != 0;
  const int nb = num_bits - L.rel;
  const uint64_t nt = bits(L.fetch(0), 0, 64);
  for (int idx = 0; idx < k; ++idx) {
    const bool first = first_chunk && idx == 0;
    const bool was_active = !st.done && !st.err;
    decode_timestamp(L, nb, st, first, nt);
    const bool ts_active = !st.done && !st.err;
    decode_value(L, st, first);
    emit(idx, was_active && ts_active && !st.done && !st.err, st);
  }
  return st.err;
}

// _run_lane_tile (int_optimized)
template <class Lane>
M3_HD bool run_general(const Lane& L, int k, Acc& acc) {
  return walk_general(L, k, [&](int, bool valid, const State& st) {
    const float v = st.is_float ? f64_bits_to_f32(st.prev_float_bits)
                                : to_f32(st.int_val) * mult_rcp(st.mult);
    acc.fold(valid, v);
  });
}

// The window at bit pos + c, given w = fetch(pos): w shifted left by c bits
// when that holds the first `need` bits exactly as a fetch at pos + c would
// (no barrel wrap, and need bits left of w's 128 - r valid ones), else a
// second fetch. The fast bodies read a timestamp and then its value from
// one fetch this way.
template <class Lane>
M3_HD Window follow(const Lane& L, const Window& w, int pos, int c, int need) {
  const int p = L.rel + pos;
  if (((p + c) >> 5) <= L.mask && 128 - (p & 31) - c >= need) return {get64(w, c), get64(w, c + 64)};
  return L.fetch(pos + c);
}

// Bits of a fast value record's window that its decode reads: int-fast
// reads a 12-bit header at 3 and 33 bits at r <= 15 (48 bits, always inside
// the 128 - r - c >= 61 valid bits of w shifted by a timestamp of c <= 36);
// float-fast reads an XOR record at 1 (at most 2 + 12 + 64 bits).
constexpr int kFloatValueBits = 79;

// _run_lane_tile_fast: int-mode, marker-free, int32-safe chunks. One fetch
// per record: the value's first 64 bits are the timestamp's window shifted
// by the timestamp's width (c in {1, 9, 12, 16, 36}), unless the barrel
// wraps between the two; the sig/mult header is parsed only on a to-int
// record, and 10^-mult is looked up only when mult changes.
template <class Lane>
M3_HD void run_fast_int(const Lane& L, int k, Acc& acc) {
  const bool active = (int32_t)L.plane(NBITS) > L.rel;
  int pos = 0;
  int32_t iv = (int32_t)L.plane(IV_LO);
  int sig = (int32_t)L.plane(SIG), mult = (int32_t)L.plane(MULT);
  float rcp = mult_rcp(mult);
  for (int idx = 0; idx < k; ++idx) {
    const Window wt = L.fetch(pos);
    const int ts = ts_consumed_fast(wt);
    const uint64_t va = ((L.rel + pos + ts) >> 5) <= L.mask
                            ? (wt.a << ts) | (wt.b >> (64 - ts))
                            : L.fetch(pos + ts).a;
    pos += ts;
    const uint32_t head2 = (uint32_t)(va >> 62);
    const bool repeat = head2 == 1;  // update + repeat
    const bool to_int = head2 == 0;  // update, no repeat (float excluded)
    int h_sig = sig, h_mult = mult, h_consumed = 0;
    if (to_int) {
      bool unused;
      int_header12((uint32_t)(va >> 49) & 0xFFFu, sig, mult, h_sig, h_mult, h_consumed, unused);
    }
    // sign + <= 31-bit diff from the first two words; r in [1, 15], never 0
    const unsigned r = to_int ? 3u + (unsigned)h_consumed : 1u;
    const uint32_t w0 = (uint32_t)(va >> 32), w1 = (uint32_t)va;
    const uint32_t hi32 = (w0 << r) | (w1 >> (32u - r));
    const uint32_t bit32 = (w1 << r) >> 31;
    const uint32_t body = (hi32 << 1) | bit32;
    const int n = to_int ? h_sig : sig;
    const uint32_t diff = (n == 0 || n > 32) ? 0u : body >> (32 - n);
    const uint32_t delta = (hi32 >> 31) == 1 ? diff : 0u - diff;
    if (!repeat) iv = (int32_t)((uint32_t)iv + delta);
    pos += repeat ? 2 : (to_int ? 3 + h_consumed + 1 + h_sig : 2 + sig);
    if (to_int) {
      sig = h_sig;
      if (h_mult != mult) rcp = mult_rcp(h_mult);
      mult = h_mult;
    }
    acc.fold_num(active, (float)iv * rcp);
  }
}

// _run_lane_tile_fast_float: float-mode XOR / repeat records only
template <class Lane>
M3_HD void run_fast_float(const Lane& L, int k, Acc& acc) {
  const bool active = (int32_t)L.plane(NBITS) > L.rel;
  int pos = 0;
  uint64_t pfb = L.pair(PFB_HI), pxr = L.pair(PXR_HI);
  for (int idx = 0; idx < k; ++idx) {
    const Window wt = L.fetch(pos);
    const int ts = ts_consumed_fast(wt);
    const Window ws = follow(L, wt, pos, ts, kFloatValueBits);
    pos += ts;
    const bool repeat = bits(ws, 0, 1) == 0;
    uint64_t nb, nx;
    int consumed;
    read_xor(ws, 1, pfb, pxr, nb, nx, consumed);
    if (!repeat) {
      pfb = nb;
      pxr = nx;
    }
    pos += repeat ? 2 : 1 + consumed;
    acc.fold(active, f64_bits_to_f32(pfb));
  }
}

M3_HD LaneRef lane_ref(const uint32_t* windows, const uint32_t* lanes, int64_t npad, int cw,
                       int mask, int64_t lane) {
  LaneRef L;
  L.win = windows + lane;
  L.planes = lanes + lane;
  L.npad = npad;
  L.cw = cw;
  L.mask = mask;
  L.rel = (int32_t)L.plane(REL);
  return L;
}

// out_f [4, n] (sum, min, max, last), out_cnt [n], out_err [n]
M3_HD void store_lane(const Acc& acc, bool err, int64_t lane, int64_t n, float* out_f,
                      int32_t* out_cnt, uint8_t* out_err) {
  out_f[lane] = acc.sum;
  out_f[n + lane] = acc.mn;
  out_f[2 * n + lane] = acc.mx;
  out_f[3 * n + lane] = acc.last;
  out_cnt[lane] = acc.cnt;
  out_err[lane] = err ? 1 : 0;
}

// B3: one lane of the per-field layout, general body only (_pallas_kernel
// runs _run_lane_tile on every tile). `row` holds the lane's CW words.
M3_HD void decode_field_lane(const uint32_t* row, const FieldPlanes& f, int64_t n, int cw,
                             int mask, int k, int64_t lane, float* out_f, int32_t* out_cnt,
                             uint8_t* out_err) {
  FieldLane L;
  L.row = row;
  L.f = f;
  L.lane = lane;
  L.cw = cw;
  L.mask = mask;
  L.rel = (int32_t)L.plane(REL);
  Acc acc;
  acc.init();
  const bool err = run_general(L, k, acc);
  store_lane(acc, err, lane, n, out_f, out_cnt, out_err);
}

// One lane with the body its tile's flag picks; outputs at `lane` of arrays
// of length n.
template <class Lane>
M3_HD void decode_body(const Lane& L, int flag, int k, int64_t lane, int64_t n, float* out_f,
                       int32_t* out_cnt, uint8_t* out_err) {
  Acc acc;
  acc.init();
  bool err = false;
  if (flag == 1) {
    run_fast_int(L, k, acc);
  } else if (flag == 2) {
    run_fast_float(L, k, acc);
  } else {
    err = run_general(L, k, acc);
  }
  store_lane(acc, err, lane, n, out_f, out_cnt, out_err);
}

M3_HD SlabLane slab_lane(const uint32_t* s_win, const uint32_t* lanes, int64_t npad,
                         int64_t lane, int col, int cw, int mask) {
  SlabLane L;
  L.win = s_win + col;
  L.planes = lanes + lane;
  L.npad = npad;
  L.cw = cw;
  L.mask = mask;
  L.rel = (int32_t)L.plane(REL);
  return L;
}

// Rows of a slab stage: the CW window rows, then zero rows up to the last
// row a fetch reads, min(cw, mask) + 3.
M3_HDX int stage_rows(int cw, int mask) {
  const int rows = (mask < cw ? mask : cw) + 4;
  return rows > cw ? rows : cw;
}

// Bytes of shared memory of one slab stage.
inline size_t stage_bytes(int cw, int mask) { return (size_t)stage_rows(cw, mask) * kSlab * 4; }

// Whether B1 takes this shape: 128-lane slabs that tile Npad and never
// straddle two tiles, and a stage that fits a block's shared memory.
inline bool slab_shape_ok(int64_t npad, int64_t tile_lanes, int cw, int mask) {
  return npad % kSlab == 0 && tile_lanes > 0 && tile_lanes % kSlab == 0 && cw > 0 &&
         stage_bytes(cw, mask) <= m3::kSmemMax;
}

#ifdef __CUDACC__
// B1: a block walks 128-lane slabs (slab += gridDim.x). Each slab's CW
// window rows are 512-byte runs of the [CW, Npad] array; cp.async copies
// them, 16 bytes a thread, into the block's stage, and the block then
// decodes the slab from there while the other blocks on its SM load
// theirs. The body is chosen per slab (tile_lanes is a multiple of 128).
__global__ void __launch_bounds__(kSlab)
lane_aggregates_slab_kernel(const uint32_t* __restrict__ windows,
                            const uint32_t* __restrict__ lanes,
                            const int32_t* __restrict__ tile_flags, int64_t npad, int cw,
                            int mask, int k, int64_t tile_lanes, float* __restrict__ out_f,
                            int32_t* __restrict__ out_cnt, uint8_t* __restrict__ out_err) {
  extern __shared__ __align__(16) uint32_t s_stage[];
  const int stage_words = stage_rows(cw, mask) * kSlab;
  const int64_t nslab = npad / kSlab;
  const int tid = threadIdx.x;
  // the zero rows after the window rows (copies never write them)
  for (int j = cw * kSlab + tid; j < stage_words; j += kSlab) s_stage[j] = 0u;
  for (int64_t slab = blockIdx.x; slab < nslab; slab += gridDim.x) {
    const int64_t col = slab * kSlab;
    for (int j = tid; j < cw * 32; j += kSlab) {
      const int row = j >> 5, q = (j & 31) * 4;
      m3::cp_async16(s_stage + row * kSlab + q, windows + row * npad + col + q);
    }
    m3::cp_async_commit();
    m3::cp_async_wait<0>();
    __syncthreads();  // every thread's copies have landed
    decode_body(slab_lane(s_stage, lanes, npad, col + tid, tid, cw, mask),
                __ldg(tile_flags + col / tile_lanes), k, col + tid, npad, out_f, out_cnt,
                out_err);
    __syncthreads();  // the stage is read before it is refilled
  }
}

// Kernel R: the general body's records, one thread per lane. Each thread
// stages its k records in shared memory (row stride k|1, odd, so 64-bit
// stores and loads are free of bank conflicts); then the block writes its
// lanes' records out as one contiguous range of the lane-major [n, k]
// arrays, so the stores to device memory are coalesced.
constexpr int kRecThreads = 64;
constexpr int kRecBytes = 8 + 8 + 1 + 1 + 1;  // ts, bits, pif, mult, valid

__global__ void __launch_bounds__(kRecThreads)
decode_records_kernel(const uint32_t* __restrict__ windows, const uint32_t* __restrict__ lanes,
                      int64_t npad, int64_t n, int cw, int mask, int k,
                      int64_t* __restrict__ out_ts, int64_t* __restrict__ out_bits,
                      uint8_t* __restrict__ out_pif, uint8_t* __restrict__ out_mult,
                      uint8_t* __restrict__ out_valid, uint8_t* __restrict__ out_err) {
  extern __shared__ int64_t smem[];
  const int ks = k | 1;
  int64_t* s_ts = smem;
  int64_t* s_bits = s_ts + kRecThreads * ks;
  uint8_t* s_pif = reinterpret_cast<uint8_t*>(s_bits + kRecThreads * ks);
  uint8_t* s_mult = s_pif + kRecThreads * ks;
  uint8_t* s_valid = s_mult + kRecThreads * ks;
  const int t = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * kRecThreads;
  if (base + t < n) {
    const LaneRef L = lane_ref(windows, lanes, npad, cw, mask, base + t);
    const bool err = walk_general(L, k, [&](int idx, bool valid, const State& st) {
      const int i = t * ks + idx;
      s_ts[i] = (int64_t)st.prev_time;
      s_bits[i] = (int64_t)(st.is_float ? st.prev_float_bits : st.int_val);
      s_pif[i] = st.is_float ? 1 : 0;
      s_mult[i] = (uint8_t)st.mult;
      s_valid[i] = valid ? 1 : 0;
    });
    out_err[base + t] = err ? 1 : 0;
  }
  __syncthreads();
  const int64_t here = n - base < kRecThreads ? n - base : kRecThreads;
  const int total = (int)here * k;
  const int64_t o = base * k;
  for (int i = t; i < total; i += kRecThreads) {
    const int j = (i / k) * ks + i % k;
    out_ts[o + i] = s_ts[j];
    out_bits[o + i] = s_bits[j];
    out_pif[o + i] = s_pif[j];
    out_mult[o + i] = s_mult[j];
    out_valid[o + i] = s_valid[j];
  }
}

// B3: the per-field layout, one thread per lane. A block's lanes are
// consecutive rows of the lane-major [n, CW] windows, so its windows are
// one contiguous range: the block loads it with coalesced loads into
// shared memory, one row per lane at an odd stride (cw|1), so the fetches
// of a warp, at row t plus one word index, fall in distinct banks. The 17
// state fields are per-lane arrays, read coalesced once per lane.
constexpr int kFieldThreads = 128;

__global__ void __launch_bounds__(kFieldThreads)
lane_aggregates_fields_kernel(const uint32_t* __restrict__ windows, const FieldPlanes f,
                              int64_t n, int cw, int mask, int k, float* __restrict__ out_f,
                              int32_t* __restrict__ out_cnt, uint8_t* __restrict__ out_err) {
  extern __shared__ uint32_t s_rows[];
  const int stride = cw | 1;
  const int64_t base = (int64_t)blockIdx.x * kFieldThreads;
  const int here = n - base < kFieldThreads ? (int)(n - base) : kFieldThreads;
  const uint32_t* src = windows + base * cw;
  const int total = here * cw;
  for (int i = threadIdx.x; i < total; i += kFieldThreads) {
    s_rows[(i / cw) * stride + i % cw] = __ldg(src + i);
  }
  __syncthreads();
  if ((int)threadIdx.x < here) {
    decode_field_lane(s_rows + threadIdx.x * stride, f, n, cw, mask, k, base + threadIdx.x,
                      out_f, out_cnt, out_err);
  }
}
#else
// One lane's records straight into the lane-major [n, k] outputs.
void decode_lane_records(const uint32_t* windows, const uint32_t* lanes, int64_t npad, int cw,
                         int mask, int k, int64_t lane, int64_t* out_ts, int64_t* out_bits,
                         uint8_t* out_pif, uint8_t* out_mult, uint8_t* out_valid,
                         uint8_t* out_err) {
  const LaneRef L = lane_ref(windows, lanes, npad, cw, mask, lane);
  const bool err = walk_general(L, k, [&](int idx, bool valid, const State& st) {
    const int64_t i = lane * k + idx;
    out_ts[i] = (int64_t)st.prev_time;
    out_bits[i] = (int64_t)(st.is_float ? st.prev_float_bits : st.int_val);
    out_pif[i] = st.is_float ? 1 : 0;
    out_mult[i] = (uint8_t)st.mult;
    out_valid[i] = valid ? 1 : 0;
  });
  out_err[lane] = err ? 1 : 0;
}
#endif

}  // namespace

#ifdef __CUDACC__
// windows u32[cw, npad], lanes u32[17, npad], tile_flags i32[npad / tile_lanes];
// out_f f32[4, npad] (sum, min, max, last), out_cnt i32[npad], out_err u8[npad].
// Npad and tile_lanes are multiples of 128, windows and lanes 16-byte
// aligned. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for a shape or alignment it does not take).
extern "C" int m3_lane_aggregates(const uint32_t* windows, const uint32_t* lanes,
                                  const int32_t* tile_flags, int64_t npad, int cw, int mask,
                                  int k, int64_t tile_lanes, float* out_f, int32_t* out_cnt,
                                  uint8_t* out_err, void* stream) {
  const bool aligned = (((uintptr_t)windows | (uintptr_t)lanes) & 15u) == 0;
  if (!slab_shape_ok(npad, tile_lanes, cw, mask) || !aligned) return (int)cudaErrorInvalidValue;
  if (npad > 0) {
    const size_t smem = stage_bytes(cw, mask);
    int64_t cap = 0;
    const cudaError_t e = m3::resident_blocks(lane_aggregates_slab_kernel, kSlab, smem, &cap);
    if (e != cudaSuccess) return (int)e;
    const int64_t nslab = npad / kSlab;
    lane_aggregates_slab_kernel<<<(unsigned)(nslab < cap ? nslab : cap), kSlab, smem,
                                  (cudaStream_t)stream>>>(
        windows, lanes, tile_flags, npad, cw, mask, k, tile_lanes, out_f, out_cnt, out_err);
  }
  return (int)cudaGetLastError();
}

// Kernel R. windows u32[cw, npad], lanes u32[17, npad] as for
// m3_lane_aggregates; the first n lanes are decoded with the general body.
// Outputs, lane-major [n, k]: out_ts i64 (prev_time after each record),
// out_bits i64 (f64 bits if the point is float, else the int value),
// out_pif / out_mult / out_valid u8; out_err u8[n]. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue if k needs
// more shared memory than a block has).
extern "C" int m3_decode_records(const uint32_t* windows, const uint32_t* lanes, int64_t npad,
                                 int64_t n, int cw, int mask, int k, int64_t* out_ts,
                                 int64_t* out_bits, uint8_t* out_pif, uint8_t* out_mult,
                                 uint8_t* out_valid, uint8_t* out_err, void* stream) {
  const size_t smem = (size_t)kRecThreads * (size_t)(k | 1) * kRecBytes;
  if (k <= 0 || smem > m3::kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_records_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    const int64_t blocks = (n + kRecThreads - 1) / kRecThreads;
    decode_records_kernel<<<(unsigned)blocks, kRecThreads, smem, (cudaStream_t)stream>>>(
        windows, lanes, npad, n, cw, mask, k, out_ts, out_bits, out_pif, out_mult, out_valid,
        out_err);
  }
  return (int)cudaGetLastError();
}

// B3. windows u32[n, cw] lane-major; fields: a host array of 17 device
// pointers in Plane order (rel_pos ... is_float), each an [n] array, u32
// but for first and is_float (bool as u8). Outputs as m3_lane_aggregates',
// over n lanes. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue if a block's window rows exceed shared memory).
extern "C" int m3_lane_aggregates_fields(const uint32_t* windows, const void* const* fields,
                                         int64_t n, int cw, int mask, int k, float* out_f,
                                         int32_t* out_cnt, uint8_t* out_err, void* stream) {
  const size_t smem = (size_t)kFieldThreads * (size_t)(cw | 1) * 4;
  if (cw <= 0 || k <= 0 || smem > m3::kSmemMax) return (int)cudaErrorInvalidValue;
  if (smem > 49152) {
    const cudaError_t e = cudaFuncSetAttribute(
        lane_aggregates_fields_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  if (n > 0) {
    const int64_t blocks = (n + kFieldThreads - 1) / kFieldThreads;
    lane_aggregates_fields_kernel<<<(unsigned)blocks, kFieldThreads, smem,
                                    (cudaStream_t)stream>>>(
        windows, make_field_planes(fields), n, cw, mask, k, out_f, out_cnt, out_err);
  }
  return (int)cudaGetLastError();
}
#else
// Host build of the same per-lane code, with subnormals flushed as -ftz=true
// flushes them on the card, and lanes decoded as the card decodes them: each
// 128-lane slab's window rows copied into a stage and read through
// SlabLane. Returns 1 for a shape the kernel does not take.
extern "C" int m3_lane_aggregates_host(const uint32_t* windows, const uint32_t* lanes,
                                       const int32_t* tile_flags, int64_t npad, int cw,
                                       int mask, int k, int64_t tile_lanes, float* out_f,
                                       int32_t* out_cnt, uint8_t* out_err) {
  if (!slab_shape_ok(npad, tile_lanes, cw, mask)) return 1;
  const unsigned csr = _mm_getcsr();
  _mm_setcsr(csr | 0x8040u);  // FTZ | DAZ
  std::vector<uint32_t> st((size_t)stage_rows(cw, mask) * kSlab, 0u);
  for (int64_t col = 0; col < npad; col += kSlab) {
    for (int w = 0; w < cw; ++w)
      std::memcpy(&st[(size_t)w * kSlab], windows + w * npad + col, kSlab * 4);
    const int flag = tile_flags[col / tile_lanes];
    for (int t = 0; t < kSlab; ++t)
      decode_body(slab_lane(st.data(), lanes, npad, col + t, t, cw, mask), flag, k, col + t,
                  npad, out_f, out_cnt, out_err);
  }
  _mm_setcsr(csr);
  return 0;
}

// Host build of kernel R (no f32 arithmetic, so no FTZ setting needed).
extern "C" int m3_decode_records_host(const uint32_t* windows, const uint32_t* lanes, int64_t npad,
                                      int64_t n, int cw, int mask, int k, int64_t* out_ts,
                                      int64_t* out_bits, uint8_t* out_pif, uint8_t* out_mult,
                                      uint8_t* out_valid, uint8_t* out_err) {
  for (int64_t lane = 0; lane < n; ++lane) {
    decode_lane_records(windows, lanes, npad, cw, mask, k, lane, out_ts, out_bits, out_pif,
                        out_mult, out_valid, out_err);
  }
  return 0;
}

// Host build of B3, each lane's window row read in place.
extern "C" int m3_lane_aggregates_fields_host(const uint32_t* windows, const void* const* fields,
                                              int64_t n, int cw, int mask, int k, float* out_f,
                                              int32_t* out_cnt, uint8_t* out_err) {
  const FieldPlanes f = make_field_planes(fields);
  const unsigned csr = _mm_getcsr();
  _mm_setcsr(csr | 0x8040u);  // FTZ | DAZ
  for (int64_t lane = 0; lane < n; ++lane) {
    decode_field_lane(windows + lane * cw, f, n, cw, mask, k, lane, out_f, out_cnt, out_err);
  }
  _mm_setcsr(csr);
  return 0;
}
#endif
