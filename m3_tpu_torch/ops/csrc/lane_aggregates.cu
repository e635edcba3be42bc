// M3TSZ chunk-lane decode: the CUDA port of the Pallas kernels
// m3_tpu/ops/fused.py:lane_aggregates_packed (B1) and lane_aggregates_pallas
// (B3), and of the XLA scans m3_tpu/ops/chunked.py:460 decode_chunked_lanes
// (kernel R) and m3_tpu/ops/decode.py:542 decode_batched (kernel B-6, the
// whole-stream decode: a warp's 32 series walked with R's votes, their
// records staged and stored as whole sectors, their words read through a
// ring in shared memory; its note is at decode_batched_kernel below).
//
// What it computes. Each lane is one chunk of at most k M3TSZ records. It
// starts from the decoder state of its side table (17 u32 planes), decodes
// its records from its own CW-word window (delta-of-delta timestamps, then
// int-mode sig/mult values or Gorilla XOR floats) and either folds every
// value into f32 sum/min/max/last, an i32 count and an err flag (B1, B3) or
// writes every record out (R).
//
// Bound. Memory: per lane the work needs the window words its chunk's bits
// occupy (ceil((rel_pos + span) / 32), at most CW), the state planes its
// body reads (general 17, int-fast 5: REL NBITS IV_LO SIG MULT, float-fast
// 6: REL NBITS PFB PXR), one flag per tile (B1), and its outputs: 21 bytes
// of aggregates (B1, B3), or 19 bytes a record and 1 a lane (R). At B1's
// main path (31.5M lanes, CW=24, 7,424 int-fast and 256 general tiles, 15.1
// words per lane) that is 3.24 GB, 0.97 ms at 3.35 TB/s (chip_smoke.py
// needed_bytes). The decode itself is integer work in registers, and that
// work, not the loads, is what the card spends its time on (PERF.md).
//
// Design, common to the three entries:
// - One thread per lane, looping over the k records with the state in
//   registers as native 64-bit integers (the TPU's (hi, lo) u32 pairs are
//   gone). A fetch is four words and a funnel shift (the TPU's barrel select
//   over window columns, chunked.py _fetch4_select, existed only because TPU
//   gathers are slow); word indices wrap with the reference's barrel mask.
// - A block walks 128-lane slabs on a persistent grid, staging each slab's
//   windows in shared memory by cp.async; the other blocks on its SM
//   overlap their loads with its decode. (A ring of stages that loads ahead
//   ran slower on the H100: it fits fewer blocks on an SM.)
// - State planes are read once per lane straight from device memory.
//
// The general body's record walk (walk_general), shared by R, B3 and B1's
// general tiles, was rebuilt for this card (PERF.md). It is bound by
// the instructions it issues per record, so:
// - Each 32-lane warp takes warp-uniform decisions by vote (group_any): the
//   timestamp decode drops the marker logic when no active lane is at a
//   marker or has an unsupported time unit; the value decode is specialised
//   to int mode or float mode when every active lane is past its first
//   record and in that mode (first and is_float are then constants), skips
//   the int header and diff when no lane takes them and read_xor when no lane
//   stays in float mode; the fold converts to f32 only the kinds of value
//   that some valid lane has. What is computed is selected exactly as
//   before, so the result cannot change. A warp whose lanes are in both
//   modes past their first record stops voting on its value records for the
//   rest of the chunk (the mode-agnostic decode is right for any lane).
// - Bit extraction (get64, bits, read_xor, the timestamp head) is shifts and
//   selects, with no branch on a data-dependent bit offset; every offset the
//   walk reads at is below 64, so get64 is two 64-bit shifts.
// - A compile-time switch (kTime): R keeps the timestamps; the folds drop the
//   64-bit dod * unit_nanos, the time carry and the first-time fetch, and
//   keep the consumed width, the markers (EOS, annotation, time-unit change)
//   and err bit for bit.
// - 10^-mult comes from a table in shared memory: one load, however the
//   lanes' mults differ.
// - The value record is fetched anew after its timestamp: deriving it from
//   the timestamp's window (follow, as the fast bodies do) shifts 128 bits
//   by a variable width, which cost more than four loads from shared memory.
// The host build walks each group of 32 lanes in step and takes the same
// decisions over the group, so the CPU tests reach every path.
//
// B1 (m3_lane_aggregates): packed layout, word-major windows [CW, Npad] and
// state planes [17, Npad]. A slab's [CW, 128] words are CW 512-byte runs,
// copied 16 bytes a thread into a stage where word w of lane t sits at
// s[w * 128 + t]: a warp reading one word of each of its lanes hits 32
// distinct banks however far the lanes' bit cursors have drifted apart.
// Words past CW read as zero: the fetch clamps its first word index to CW,
// and zero rows follow the CW window rows (stage_rows). The body is chosen
// per TILE (rows x 128 lanes) by tile_flags, never per lane: the general and
// int-fast bodies convert int values differently, so the choice shows in
// the output. The int-fast body, 97% of the main path's tiles, reads one
// fetch per record, parses a sig/mult header only on a to-int record, looks
// 10^-mult up only when mult changes, and folds with selects. It takes Npad
// and the tile as multiples of 128 and windows and planes aligned to 16
// bytes; other shapes are refused (cudaErrorInvalidValue).
//
// Kernel R (m3_decode_records) writes the general body's records instead of
// folding them: per record the timestamp, raw value bits, point_is_float,
// mult and valid, plus err per lane, lane-major [n, k]. Its input is B1's
// packed layout and stage, at any lane count (a query's gathered lanes are
// ragged): full slabs come in by 16-byte cp.async when Npad is a multiple of
// 4, the tail slab (and every slab otherwise) word by word, zero-filled.
// Records leave through a per-warp stage of kRecGroup records a lane (odd
// stride, free of bank conflicts), which the warp flushes as runs of whole
// sectors of the lane-major outputs. Stored straight to device memory, the
// same records take several times as long on the H100 (chip_smoke.py
// [query] times both).
//
// B3 (m3_lane_aggregates_fields): the general body on every lane over the
// per-field layout (lane-major windows [N, CW], 17 separate field arrays),
// which chunked_device_args and the resident lane assembly give. A slab's
// rows are one contiguous range: consecutive threads cp.async consecutive
// words into 128 rows at an odd stride (CW words and four zero words, so a
// fetch needs no bounds test), so the copies are coalesced and their
// writes, like the warp's fetches at one word index, fall in distinct
// banks. A word-major stage (as B1's) needs the rows transposed
// through a second buffer, which halved the blocks per SM at wide windows
// and ran slower on mixed int/float lanes.
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
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -O3 -fmad=false
// -ftz=true -shared (ops/_build.py). Without __CUDACC__ the same code
// compiles as host C++ (with FTZ/DAZ set), which the CPU tests use to hold
// this file's arithmetic, staging and warp decisions against the PyTorch
// twins.

#include <cstdint>

#include "../../csrc/launch.cuh"

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __device__ __forceinline__
#define M3_HDX __host__ __device__ inline
#define M3_LOAD(p) __ldg(p)
#else
#include <algorithm>
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

// Lanes of a slab, a block's threads.
constexpr int kSlab = 128;
// Lanes that take one decision together: a warp on the card, a group of
// lanes walked in step on the host.
constexpr int kGroup = 32;

// Four window words aligned to the cursor, as two 64-bit halves: a = w0:w1,
// b = w2:w3. The low bits of w3 past the shift are zero, as in the reference.
struct Window {
  uint64_t a, b;
};

// 64 bits at bit `start` of the 128-bit window, for 0 <= start < 64 (every
// offset the record decode reads at): two shifts, no branch on the offset.
M3_HD uint64_t get64(const Window& w, int start) {
  return (w.a << start) | ((w.b >> 1) >> (63 - start));
}

// 64 bits at bit `start` >= 0, zeros past the window's end.
M3_HD uint64_t get64_any(const Window& w, int start) {
  if (start >= 128) return 0ull;
  return start >= 64 ? w.b << (start - 64) : get64(w, start);
}

// n bits at `start`, right-aligned. n outside [1, 64] gives 0, as the
// reference's shift by 64 or more does.
M3_HD uint64_t bits(const Window& w, int start, int n) {
  const uint64_t v = get64(w, start) >> ((64 - n) & 63);
  return (unsigned)(n - 1) < 64u ? v : 0ull;
}

M3_HD uint64_t shl64(uint64_t x, int s) { return s >= 64 ? 0 : x << (s & 63); }
M3_HD int clz64(uint64_t x) { return x ? __clzll((long long)x) : 64; }
M3_HD int ctz64(uint64_t x) { return x ? __ffsll((long long)x) - 1 : 64; }
M3_HD int clampi(int x, int lo, int hi) { return x < lo ? lo : (x > hi ? hi : x); }
M3_HD int min_i(int a, int b) { return a < b ? a : b; }
#ifdef __CUDACC__
M3_HD int clz32(uint32_t x) { return __clz((int)x); }
#else
inline int clz32(uint32_t x) { return x ? __builtin_clz(x) : 32; }
#endif

// Whether any lane of the group holds p: a warp vote on the card (where a
// group is one thread of a warp whose 32 threads all walk together), an OR
// over the G lanes walked in step on the host.
template <int G>
M3_HD bool group_any(const bool* p) {
#ifdef __CUDA_ARCH__
  static_assert(G == 1, "on the card a thread walks one lane and the warp votes");
  return __any_sync(0xffffffffu, p[0]) != 0;
#else
  bool any = false;
  for (int i = 0; i < G; ++i) any = any || p[i];
  return any;
#endif
}

// Whether every lane of the group holds p.
template <int G>
M3_HD bool group_all(const bool* p) {
  bool q[G];
  for (int i = 0; i < G; ++i) q[i] = !p[i];
  return !group_any<G>(q);
}

// ---------------------------------------------------------------------------
// Lanes: a slab's window words in shared memory (a staged copy on the host),
// and where the lane's state planes come from
// ---------------------------------------------------------------------------

// The window part of a lane: its CW window words staged in shared memory,
// word w at win[w * kStride], then (at least) four zero words. B1's and R's
// word-major slab stage has kStride = 128 (stage_rows), B3's lane rows
// kStride = 1 (fields_row_stride).
template <int kStride>
struct StagedWin {
  const uint32_t* win;  // this lane's word 0
  int cw, mask, rel;

  // The four window words at bit rel + pos, aligned to that bit. The first
  // word index wraps with the barrel's mask and is clamped to cw: a fetch
  // from a word at or past CW reads four zero words either way, and the
  // stage needs zero words only up to cw + 3 (not the barrel's mask + 3).
  M3_HD Window fetch(int pos) const {
    const int p = rel + pos;
    const int widx = min_i((p >> 5) & mask, cw);
    const uint32_t* w = win + widx * kStride;
    const uint32_t w0 = w[0], w1 = w[kStride], w2 = w[2 * kStride], w3 = w[3 * kStride];
    const unsigned r = (unsigned)p & 31u;
    const uint32_t s0 = __funnelshift_l(w1, w0, r);
    const uint32_t s1 = __funnelshift_l(w2, w1, r);
    const uint32_t s2 = __funnelshift_l(w3, w2, r);
    const uint32_t s3 = w3 << r;
    return {((uint64_t)s0 << 32) | s1, ((uint64_t)s2 << 32) | s3};
  }
};

// A lane of the packed layout (B1, R): planes [17, Npad], this lane's plane
// 0 at `planes`. A lane past the last (R's tail slab) is not `live` and
// reads zero planes: zero bits, so it is done before its first record.
struct SlabLane : StagedWin<kSlab> {
  const uint32_t* planes;
  int64_t npad;
  bool live;

  M3_HD uint32_t plane(int p) const { return live ? M3_LOAD(planes + (int64_t)p * npad) : 0u; }
  M3_HD uint64_t pair(int p_hi) const {
    return ((uint64_t)plane(p_hi) << 32) | plane(p_hi + 1);
  }
};

// The 17 state fields of the per-field layout (B3), one array each, indexed
// by the Plane enum; FIRST and ISF are bool (u8) arrays, the rest u32.
struct FieldPlanes {
  const uint32_t* p[17];
  const uint8_t* first;
  const uint8_t* isf;
};

// A lane of the per-field layout (B3): its fields at index `lane`.
struct FieldLane : StagedWin<1> {
  FieldPlanes f;  // by value: p is a constant at every inlined call, so
                  // only the pointers the walk reads stay in registers
  int64_t lane;
  bool live;

  M3_HD uint32_t plane(int p) const {
    if (!live) return 0u;
    if (p == FIRST) return M3_LOAD(f.first + lane);
    if (p == ISF) return M3_LOAD(f.isf + lane);
    return M3_LOAD(f.p[p] + lane);
  }
  M3_HD uint64_t pair(int p_hi) const {
    return ((uint64_t)plane(p_hi) << 32) | plane(p_hi + 1);
  }
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

M3_HD SlabLane slab_lane(const uint32_t* s_win, const uint32_t* lanes, int64_t npad,
                         int64_t lane, int col, int cw, int mask, bool live) {
  SlabLane L;
  L.win = s_win + col;
  L.planes = lanes + (live ? lane : 0);
  L.npad = npad;
  L.cw = cw;
  L.mask = mask;
  L.live = live;
  L.rel = (int32_t)L.plane(REL);
  return L;
}

M3_HD FieldLane field_lane(const uint32_t* row, const FieldPlanes& f, int64_t lane, int cw,
                           int mask, bool live) {
  FieldLane L;
  L.win = row;
  L.f = f;
  L.lane = live ? lane : 0;
  L.cw = cw;
  L.mask = mask;
  L.live = live;
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

// 10^-mult as the reference's correctly rounded f32 constants; 1 outside
// [1, 6]
M3_HD float mult_rcp(int mult) {
  const int bits = mult == 1 ? 0x3DCCCCCD
                 : mult == 2 ? 0x3C23D70A
                 : mult == 3 ? 0x3A83126F
                 : mult == 4 ? 0x38D1B717
                 : mult == 5 ? 0x3727C5AC
                 : mult == 6 ? 0x358637BD
                             : 0x3F800000;
  return __int_as_float(bits);
}

// ---------------------------------------------------------------------------
// Aggregates
// ---------------------------------------------------------------------------

// jnp.minimum / jnp.maximum: NaN if either is NaN; of equal values min
// takes the sign bit and max drops it. Selects, not branches.
M3_HD float min_nan(float a, float b) {
  const float eq = __int_as_float(__float_as_int(a) | __float_as_int(b));
  const float m = a < b ? a : (b < a ? b : eq);
  return (a != a || b != b) ? __int_as_float(0x7FC00000) : m;
}

M3_HD float max_nan(float a, float b) {
  const float eq = __int_as_float(__float_as_int(a) & __float_as_int(b));
  const float m = a > b ? a : (b > a ? b : eq);
  return (a != a || b != b) ? __int_as_float(0x7FC00000) : m;
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
    last = valid ? v : last;
  }
  // fold() for values that are never NaN (the int-fast body's): min and
  // max without the NaN test, the same bits otherwise
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
  return tu == 1 ? 1000000000ull : tu == 2 ? 1000000ull : tu == 3 ? 1000ull : tu == 4 ? 1ull : 0ull;
}

M3_HD int64_t sext(uint32_t x, int width) {
  const uint32_t sign = 1u << (width - 1);
  return (int64_t)((int32_t)(x ^ sign) - (int32_t)sign);
}

// The window at bit pos + c, given w = fetch(pos): w shifted left by c bits
// when that holds the first `need` bits exactly as a fetch at pos + c would
// (no barrel wrap, and need bits left of w's 128 - r valid ones), else a
// second fetch. (The general walk fetches its value records anew: shifting
// a 128-bit window by a variable width costs more than four loads from
// shared memory.)
template <class Lane>
M3_HD Window follow(const Lane& L, const Window& w, int pos, int c, int need) {
  const int p = L.rel + pos;
  if (((p + c) >> 5) <= L.mask && 128 - (p & 31) - c >= need)
    return {get64_any(w, c), get64_any(w, c + 64)};
  return L.fetch(pos + c);
}

// Whether a timestamp record at pos (its window ws) is a marker (EOS,
// annotation, time unit) inside the lane's bits.
M3_HD bool ts_marker(const Window& ws, int pos, int nb) {
  return pos + 11 <= nb && (uint32_t)(ws.a >> 55) == 0x100u;
}

// _decode_timestamp of the record at pos (its window ws). kTime: keep
// prev_time / prev_delta (R); without it only the width, the markers, the
// time unit and err are kept (the folds read nothing else). kPlain: every
// lane of the group is inactive or at a record that is not a marker, with a
// supported time unit (the common case), so the marker logic drops out.
template <bool kTime, bool kPlain>
M3_HD void decode_timestamp(const Window& ws, int pos, int nb, State& st, bool first,
                            uint64_t nt) {
  const uint32_t top = (uint32_t)(ws.a >> 32);
  const uint32_t peek = top >> 21;  // 11 bits
  const bool is_marker = !kPlain && ts_marker(ws, pos, nb);
  const uint32_t mv = peek & 3u;
  const bool eos = is_marker && mv == 0;
  const bool ann = is_marker && mv == 1;
  const bool tu_marker = is_marker && mv == 2;

  const int new_unit = (int)((top >> 13) & 0xFFu);
  const bool tu_supported = new_unit >= 1 && new_unit <= 4;
  const bool tu_changed = tu_marker && tu_supported && new_unit != st.time_unit;
  const int time_unit = (tu_marker && tu_supported) ? new_unit : st.time_unit;
  const int dod_off = tu_marker ? 19 : 0;

  // the dod's 16 head bits; the leading ones of its first 4 (0..4) pick a
  // zero dod, 7, 9 or 12 bits, or the unit's default width
  const uint32_t head16 = tu_marker ? (uint32_t)(ws.a >> 29) & 0xFFFFu : top >> 16;
  const int ones = clz32(~((head16 >> 12) << 28));
  const int default_bits = (time_unit == 1 || time_unit == 2) ? 32 : 64;
  const int bucket_consumed =
      ones < 4 ? (int)((0x100C0901u >> ((8 * ones) & 31)) & 0xFFu) : 4 + default_bits;
  const int consumed = dod_off + (tu_changed ? 64 : bucket_consumed);

  const bool unit_ok = kPlain || (time_unit >= 1 && time_unit <= 4);
  const bool err_now = (ann || !unit_ok || (tu_marker && !tu_supported)) && !st.done && !eos;
  const bool active = !st.done && !st.err && !eos && !err_now;

  if (kTime) {
    const uint64_t wide = get64(ws, dod_off + 4);
    const int64_t dod_default =
        default_bits == 32 ? (int64_t)(int32_t)(uint32_t)(wide >> 32) : (int64_t)wide;
    const int64_t dod_norm = ones == 1   ? sext((head16 >> 7) & 0x7Fu, 7)
                             : ones == 2 ? sext((head16 >> 4) & 0x1FFu, 9)
                             : ones == 3 ? sext(head16 & 0xFFFu, 12)
                                         : dod_default;
    const uint64_t dod_bucket = ones == 0 ? 0ull : (uint64_t)dod_norm * unit_nanos(time_unit);
    const uint64_t dod = tu_changed ? get64(ws, 19) : dod_bucket;
    const uint64_t prev_delta = st.prev_delta + dod;
    const uint64_t prev_time = (first ? nt : st.prev_time) + prev_delta;
    if (active) {
      st.prev_time = prev_time;
      st.prev_delta = tu_changed ? 0ull : prev_delta;
    }
  }
  if (active) {
    st.pos = pos + consumed;
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

// _read_xor: Gorilla XOR float record at bit `off`. Both the contained
// (reuse the previous leading/trailing window) and the uncontained (6-bit
// lead, 6-bit nm - 1) forms are computed and selected; one extraction.
M3_HD void read_xor(const Window& ws, int off, uint64_t prev_bits, uint64_t prev_xor,
                    uint64_t& new_bits, uint64_t& new_xor, int& consumed) {
  const uint64_t g = get64(ws, off);
  const bool c0 = (g >> 63) != 0;
  const bool c1 = ((g >> 62) & 1u) != 0;
  const int lead_c = clz64(prev_xor);
  const int trail_c = prev_xor ? ctz64(prev_xor) : 0;
  const int nm_c = clampi(64 - lead_c - trail_c, 0, 64);
  const int lead_u = (int)((g >> 56) & 63u);
  const int nm_u = (int)((g >> 50) & 63u) + 1;
  const int trail_u = clampi(64 - lead_u - nm_u, 0, 64);
  const int nm = c1 ? nm_u : nm_c;
  const int trail = c1 ? trail_u : trail_c;
  const int head = c1 ? 14 : 2;
  const uint64_t x = c0 ? shl64(bits(ws, off + head, nm), trail) : 0ull;
  consumed = c0 ? head + nm : 1;
  new_bits = prev_bits ^ x;
  new_xor = x;
}

// Which lanes a value decode serves: any (kAny), or, when every active lane
// of the group is past its first record and in int mode (kInt) or in float
// mode (kFloat), those alone: `first` and is_float are then constants.
enum Mode { kAny, kInt, kFloat };

// The parts of _decode_value that an active lane's record needs: the int
// header + diff (a first int value, a to-int record, an int record that
// stays) and read_xor (a float record that stays).
template <int kMode>
M3_HD void value_needs(const Window& ws, const State& st, bool first_lane, bool& need_int,
                       bool& need_xor) {
  const bool first = kMode == kAny && first_lane;
  const bool is_float = kMode == kAny ? st.is_float : kMode == kFloat;
  const uint32_t head3 = (uint32_t)(ws.a >> 61);
  const bool active = !st.done && !st.err;
  const bool stay = (head3 >> 2) != 0;
  const bool to_int = !stay && (head3 & 3u) == 0;
  need_int = active && (first ? !stay : (to_int || (stay && !is_float)));
  need_xor = active && !first && stay && is_float;
}

// _decode_value with int_optimized: one value record at the window ws.
// do_int / do_xor: whether any lane of the group needs the int header and
// diff, or read_xor (value_needs); a lane never reads a part it skips.
template <int kMode>
M3_HD void decode_value(const Window& ws, State& st, bool first_lane, bool do_int, bool do_xor) {
  const bool first = kMode == kAny && first_lane;
  const bool is_float = kMode == kAny ? st.is_float : kMode == kFloat;
  const uint32_t head3 = (uint32_t)(ws.a >> 61);
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
  const bool sel_stay_float = !first && stay && is_float;
  const bool sel_stay_int = !first && stay && !is_float;

  const int off = first ? 1 : 3;
  const uint64_t full = get64(ws, off);
  const bool takes_header = sel_first_int || sel_to_int;
  int h_sig = st.sig, h_mult = st.mult, h_consumed = 0;
  bool h_mult_bad = false;
  uint64_t d_int_val = st.int_val;
  int d_consumed = 0;
  if (do_int) {
    int_header12((uint32_t)(full >> 52), st.sig, st.mult, h_sig, h_mult, h_consumed, h_mult_bad);
    const int diff_off = first ? 1 + h_consumed : (to_int ? 3 + h_consumed : 1);
    const int diff_sig = takes_header ? h_sig : st.sig;
    const uint64_t diff_base = first ? 0 : st.int_val;
    const bool sign = ((ws.a << diff_off) >> 63) != 0;  // diff_off <= 15
    const uint64_t diff = bits(ws, diff_off + 1, diff_sig);
    d_int_val = diff_base + (sign ? diff : (uint64_t)0 - diff);
    d_consumed = 1 + diff_sig;
  }
  uint64_t x_bits = st.prev_float_bits, x_xor = st.prev_xor;
  int x_consumed = 0;
  if (do_xor) read_xor(ws, 1, st.prev_float_bits, st.prev_xor, x_bits, x_xor, x_consumed);

  const int first_consumed = first_is_float ? 65 : 1 + h_consumed + d_consumed;
  const int next_consumed =
      repeat ? 2
             : (to_float ? 3 + 64
                         : (to_int ? 3 + h_consumed + d_consumed
                                   : (is_float ? 1 + x_consumed : 1 + d_consumed)));
  const int consumed = first ? first_consumed : next_consumed;

  const bool new_is_float =
      (sel_first_float || sel_to_float) || (!(sel_first_int || sel_to_int) && is_float);
  const bool takes_full = sel_first_float || sel_to_float;
  const uint64_t new_float_bits =
      sel_stay_float ? x_bits : (takes_full ? full : st.prev_float_bits);
  const uint64_t new_xor = sel_stay_float ? x_xor : (takes_full ? full : st.prev_xor);
  const bool takes_diff = sel_first_int || sel_to_int || sel_stay_int;
  const bool err_now = takes_header && h_mult_bad;

  const bool active = !st.done && !st.err && !err_now;
  st.err = st.err || (err_now && !st.done);
  if (active) {
    st.pos = st.pos + consumed;
    st.prev_float_bits = new_float_bits;
    st.prev_xor = new_xor;
    st.int_val = takes_diff ? d_int_val : st.int_val;
    st.sig = takes_header ? h_sig : st.sig;
    st.mult = takes_header ? h_mult : st.mult;
    st.is_float = new_is_float;
  }
}

// The general body's record walk (_run_lane_tile with int_optimized, and
// chunked.py decode_chunked_lanes' step) over a group of G lanes walked in
// step: G = 1 on the card (the warp is the group), kGroup on the host.
// emit(idx, valid[G], state[G]) after each record; err[G] at the end.
template <bool kTime, int G, class Lane, class Emit>
M3_HD void walk_general(const Lane* L, int k, bool* err, Emit&& emit) {
  State st[G];
  bool first_chunk[G];
  int nb[G];
  uint64_t nt[G];
  for (int i = 0; i < G; ++i) {
    const Lane& l = L[i];
    const int num_bits = (int32_t)l.plane(NBITS);
    State& s = st[i];
    s.pos = 0;
    s.done = num_bits <= l.rel;
    s.err = false;
    s.prev_time = kTime ? l.pair(PT_HI) : 0ull;
    s.prev_delta = kTime ? l.pair(PD_HI) : 0ull;
    s.time_unit = (int32_t)l.plane(TU);
    s.prev_float_bits = l.pair(PFB_HI);
    s.prev_xor = l.pair(PXR_HI);
    s.int_val = l.pair(IV_HI);
    s.mult = (int32_t)l.plane(MULT);
    s.sig = (int32_t)l.plane(SIG);
    s.is_float = l.plane(ISF) != 0;
    first_chunk[i] = l.plane(FIRST) != 0;
    nb[i] = num_bits - l.rel;
    nt[i] = kTime ? l.fetch(0).a : 0ull;
  }
  // whether the group has met a record with both int and float lanes: from
  // then on its value records take the mode-agnostic decode (kAny, every
  // part computed), which is right for any lane, without the votes
  bool mixed = false;
  for (int idx = 0; idx < k; ++idx) {
    Window ws[G];
    int pos[G];
    bool was[G], plain[G], ts_ok[G], need_int[G], need_xor[G], in_int[G], in_float[G];
    bool valid[G];
    for (int i = 0; i < G; ++i) {
      const bool first = first_chunk[i] && idx == 0;
      was[i] = !st[i].done && !st[i].err;
      pos[i] = first ? st[i].pos + 64 : st[i].pos;
      ws[i] = L[i].fetch(pos[i]);
      plain[i] = !was[i] || (!ts_marker(ws[i], pos[i], nb[i]) && st[i].time_unit >= 1 &&
                             st[i].time_unit <= 4);
    }
    const bool all_plain = group_all<G>(plain);
    for (int i = 0; i < G; ++i) {
      const bool first = first_chunk[i] && idx == 0;
      if (all_plain) decode_timestamp<kTime, true>(ws[i], pos[i], nb[i], st[i], first, nt[i]);
      else decode_timestamp<kTime, false>(ws[i], pos[i], nb[i], st[i], first, nt[i]);
      ts_ok[i] = !st[i].done && !st[i].err;
      // an inactive lane's value decode is inactive too: its window is unused
      ws[i] = L[i].fetch(st[i].pos);
      in_int[i] = !ts_ok[i] || (!first && !st[i].is_float);
      in_float[i] = !ts_ok[i] || (!first && st[i].is_float);
    }
    const bool all_int = !mixed && group_all<G>(in_int);
    const bool all_float = !mixed && !all_int && group_all<G>(in_float);
    if (all_int) {
      for (int i = 0; i < G; ++i) value_needs<kInt>(ws[i], st[i], false, need_int[i], need_xor[i]);
      const bool do_int = group_any<G>(need_int);
      for (int i = 0; i < G; ++i) decode_value<kInt>(ws[i], st[i], false, do_int, false);
    } else if (all_float) {
      for (int i = 0; i < G; ++i)
        value_needs<kFloat>(ws[i], st[i], false, need_int[i], need_xor[i]);
      const bool do_int = group_any<G>(need_int), do_xor = group_any<G>(need_xor);
      for (int i = 0; i < G; ++i) decode_value<kFloat>(ws[i], st[i], false, do_int, do_xor);
    } else if (mixed) {
      for (int i = 0; i < G; ++i) decode_value<kAny>(ws[i], st[i], false, true, true);
    } else {
      for (int i = 0; i < G; ++i)
        value_needs<kAny>(ws[i], st[i], first_chunk[i] && idx == 0, need_int[i], need_xor[i]);
      const bool do_int = group_any<G>(need_int), do_xor = group_any<G>(need_xor);
      for (int i = 0; i < G; ++i)
        decode_value<kAny>(ws[i], st[i], first_chunk[i] && idx == 0, do_int, do_xor);
      // int and float lanes past their first record: the group stays mixed
      // for the rest of its records, as a rule, so it stops voting
      mixed = idx > 0;
    }
    for (int i = 0; i < G; ++i) valid[i] = was[i] && ts_ok[i] && !st[i].done && !st[i].err;
    emit(idx, valid, st);
  }
  for (int i = 0; i < G; ++i) err[i] = st[i].err;
}

// 10^-mult (mult_rcp) looked up in a table of 8 (1 outside [1, 6]): on the
// card a table in shared memory, one load whatever the lanes' mults.
struct RcpTable {
  const float* t;
  M3_HD float operator()(int mult) const { return t[(unsigned)mult < 8u ? mult : 0]; }
};
M3_HD void fill_rcp_table(float* t, int i) {
  if (i < 8) t[i] = mult_rcp(i);
}

// A record's f32 value as the general body folds it; each conversion only
// if some valid lane of the group needs it (do_f, do_i)
template <class Rcp>
M3_HD float value_f32(const State& st, bool do_f, bool do_i, const Rcp& rcp) {
  const float vf = do_f ? f64_bits_to_f32(st.prev_float_bits) : 0.0f;
  const float vi = do_i ? to_f32(st.int_val) * rcp(st.mult) : 0.0f;
  return st.is_float ? vf : vi;
}

// _run_lane_tile (int_optimized) over a group of G lanes
template <int G, class Lane, class Rcp>
M3_HD void run_general(const Lane* L, int k, Acc* acc, bool* err, const Rcp& rcp) {
  walk_general<false, G>(L, k, err, [&](int, const bool* valid, const State* st) {
    bool need_f[G], need_i[G];
    for (int i = 0; i < G; ++i) {
      need_f[i] = valid[i] && st[i].is_float;
      need_i[i] = valid[i] && !st[i].is_float;
    }
    const bool do_f = group_any<G>(need_f), do_i = group_any<G>(need_i);
    for (int i = 0; i < G; ++i) acc[i].fold(valid[i], value_f32(st[i], do_f, do_i, rcp));
  });
}

// ---------------------------------------------------------------------------
// Whole streams (kernel B-6): m3_tpu/ops/decode.py decode_batched
// ---------------------------------------------------------------------------

// B-6's geometry (its note is at decode_batched_kernel). A warp walks 32
// series, a lane each. Every kB6Group records the warp stores its lanes'
// runs of ts, bits and values_f32 from its record stage, every
// kB6FlagGroup records the runs of the three u8 planes; each lane reads its
// stream through a ring of its next kB6Ring words.
constexpr int kB6Group = 16;
constexpr int kB6FlagGroup = 32;  // a multiple of kB6Group
constexpr int kB6Ring = 32;       // a power of two
constexpr int kB6Warps = 4;
constexpr int kB6Threads = kB6Warps * kGroup;
// A lane's row of the ts and bits stages, in records: odd, so that a warp's
// 64-bit stores of one record fall in distinct banks.
constexpr int kB6Stride = kB6Group + 1;
// Bytes of a lane's row of the flag stage: whole words, an odd number of them.
constexpr int kB6FlagStride = kB6FlagGroup + 4;
// Bytes of a warp's part of the block's shared memory: the ring, the ts and
// bits stages, the flag stage.
constexpr size_t kB6WarpBytes =
    (size_t)kGroup * (kB6Ring * 4 + kB6Stride * 16 + kB6FlagStride);
static_assert((kB6Ring & (kB6Ring - 1)) == 0, "the ring wraps by a mask");
static_assert(kB6FlagGroup % kB6Group == 0 && kB6FlagGroup % 16 == 0, "flag runs");
static_assert(kB6WarpBytes % 16 == 0, "each warp's part stays 16-byte aligned");

// A warp's part of the block's shared memory.
struct B6Stage {
  uint32_t* ring;  // word k of lane l's ring at ring[(k % kB6Ring) * kGroup + l]
  uint64_t* ts;    // record r of lane l at ts[l * kB6Stride + r % kB6Group]
  uint64_t* bits;  // likewise
  uint8_t* flags;  // record r of lane l at flags[l * kB6FlagStride + r % kB6FlagGroup]:
                   // point_is_float | valid << 1 | mult << 2
};

M3_HD B6Stage b6_stage(uint8_t* base) {
  B6Stage sg;
  sg.ring = reinterpret_cast<uint32_t*>(base);
  sg.ts = reinterpret_cast<uint64_t*>(base + kGroup * kB6Ring * 4);
  sg.bits = sg.ts + kGroup * kB6Stride;
  sg.flags = reinterpret_cast<uint8_t*>(sg.bits + kGroup * kB6Stride);
  return sg;
}

#ifndef __CUDACC__
// Fetches the host build served from the row, past the ring (the tests read
// it through m3_decode_batched_host_far_fetches).
int64_t b6_far_fetches = 0;
#endif

// A series of the whole-stream decode: its row of W stream words in device
// memory, and its ring, which holds the row's words [lo, lo + kB6Ring)
// (those below W) in shared memory. A fetch clips each of its four word
// indices to W - 1, as the reference's _fetch4 does, so a fetch past the
// end repeats the last word (BatchedSegments pads two zero words, so its
// rows end in zeros). It reads the ring when the four words are in it, and
// the row otherwise (a record wider than what the ring holds ahead of the
// cursor): the same words either way.
struct StreamLane {
  const uint32_t* row;
  int64_t w;
  int last;        // the last word index a fetch reads: W - 1
  int lo;          // the ring's first word
  uint32_t* ring;  // this lane's word 0 of its warp's ring

  M3_HD Window fetch(int pos) const {
    const int i0 = min_i(pos >> 5, last), i1 = min_i(i0 + 1, last);
    const int i2 = min_i(i0 + 2, last), i3 = min_i(i0 + 3, last);
    uint32_t w0, w1, w2, w3;
    // i0 >= lo: a fetch never reads below the cursor of the last refill
    if (i3 < lo + kB6Ring) {
      w0 = ring[(i0 & (kB6Ring - 1)) * kGroup];
      w1 = ring[(i1 & (kB6Ring - 1)) * kGroup];
      w2 = ring[(i2 & (kB6Ring - 1)) * kGroup];
      w3 = ring[(i3 & (kB6Ring - 1)) * kGroup];
    } else {
#ifndef __CUDACC__
      ++b6_far_fetches;
#endif
      w0 = M3_LOAD(row + i0);
      w1 = M3_LOAD(row + i1);
      w2 = M3_LOAD(row + i2);
      w3 = M3_LOAD(row + i3);
    }
    const unsigned r = (unsigned)pos & 31u;
    const uint32_t s0 = __funnelshift_l(w1, w0, r);
    const uint32_t s1 = __funnelshift_l(w2, w1, r);
    const uint32_t s2 = __funnelshift_l(w3, w2, r);
    const uint32_t s3 = w3 << r;
    return {((uint64_t)s0 << 32) | s1, ((uint64_t)s2 << 32) | s3};
  }

  // Moves the ring to start at the word of bit `pos` (clipped to W - 1),
  // the lowest a later fetch reads: the words it held from there on stay in
  // their slots, the rest up to kB6Ring words are copied from the row (on
  // the card by cp.async, waited for here; the lane's own slots only).
  M3_HD void refill(int pos) {
    const int nlo = min_i(pos >> 5, last);
    const int from = nlo > lo + kB6Ring ? nlo : lo + kB6Ring;
    const int to = (int64_t)nlo + kB6Ring < w ? nlo + kB6Ring : (int)w;
    for (int k = from; k < to; ++k) {
#ifdef __CUDA_ARCH__
      m3::cp_async4(ring + (k & (kB6Ring - 1)) * kGroup, row + k);
#else
      ring[(k & (kB6Ring - 1)) * kGroup] = row[k];
#endif
    }
#ifdef __CUDA_ARCH__
    m3::cp_async_commit();
    m3::cp_async_wait<0>();
#endif
    lo = nlo;
  }
};

// Series `row` of the [S, W] words (row 0 for a lane past the last series:
// it walks as a done lane) with its ring filled from word 0.
M3_HD StreamLane stream_lane(const uint32_t* words, int64_t w, int64_t row, uint32_t* ring) {
  StreamLane L;
  L.row = words + row * w;
  L.w = w;
  L.last = w - 1 < 0x7FFFFFFF ? (int)(w - 1) : 0x7FFFFFFF;
  L.lo = -kB6Ring;
  L.ring = ring;
  L.refill(0);
  return L;
}

// _decode_value with int_optimized=False (decode.py:431-444): the first
// record is a 64-bit float, every later one an XOR record; every point is
// float, whatever the lane's state.
M3_HD void decode_value_float(const Window& ws, State& st, bool first) {
  uint64_t x_bits, x_xor;
  int x_consumed;
  read_xor(ws, 0, st.prev_float_bits, st.prev_xor, x_bits, x_xor, x_consumed);
  if (!st.done && !st.err) {
    st.pos += first ? 64 : x_consumed;
    st.prev_float_bits = first ? ws.a : x_bits;
    st.prev_xor = first ? ws.a : x_xor;
  }
  st.is_float = true;
}

// decode_batched's step loop over a group of G series walked in step (G = 1
// on the card, where the warp is the group; kGroup on the host): t records
// from bit 0, each R's timestamp step (with the markers) and R's value step
// (kIntOpt) or the float-only one, with walk_general's votes: the timestamp
// drops the marker logic when no active lane is at a marker or has an
// unsupported unit; the value step is specialised to int or float mode when
// every active lane is past record 0 and in that mode, and skips the int
// header and diff or read_xor when no lane takes them. The votes are taken
// anew at every record (a warp whose lanes are in both modes now is not
// taken to stay so for the rest of a long stream). What is computed is
// selected exactly as before, so the records cannot change. emit(idx,
// valid[G], state[G]) after each record; err[G] at the end.
template <bool kIntOpt, int G, class Emit>
M3_HD void walk_streams(const StreamLane* L, const int* num_bits, const int* unit, int t,
                        bool* err, Emit&& emit) {
  State st[G];
  uint64_t nt[G];
  for (int i = 0; i < G; ++i) {
    State& s = st[i];
    s.pos = 0;
    s.done = num_bits[i] <= 0;
    s.err = false;
    s.is_float = false;
    s.time_unit = unit[i];
    s.mult = 0;
    s.sig = 0;
    s.prev_time = s.prev_delta = s.prev_float_bits = s.prev_xor = s.int_val = 0ull;
    nt[i] = L[i].fetch(0).a;  // the stream's first 64 bits
  }
  for (int idx = 0; idx < t; ++idx) {
    const bool first = idx == 0;
    Window ws[G];
    int pos[G];
    bool was[G], plain[G], ts_ok[G], need_int[G], need_xor[G], in_int[G], in_float[G];
    bool valid[G];
    for (int i = 0; i < G; ++i) {
      was[i] = !st[i].done && !st[i].err;
      pos[i] = first ? st[i].pos + 64 : st[i].pos;
      ws[i] = L[i].fetch(pos[i]);
      plain[i] = !was[i] || (!ts_marker(ws[i], pos[i], num_bits[i]) && st[i].time_unit >= 1 &&
                             st[i].time_unit <= 4);
    }
    const bool all_plain = group_all<G>(plain);
    for (int i = 0; i < G; ++i) {
      if (all_plain) decode_timestamp<true, true>(ws[i], pos[i], num_bits[i], st[i], first, nt[i]);
      else decode_timestamp<true, false>(ws[i], pos[i], num_bits[i], st[i], first, nt[i]);
      ts_ok[i] = !st[i].done && !st[i].err;
      // an inactive lane's value decode is inactive too: its window is unused
      ws[i] = L[i].fetch(st[i].pos);
      in_int[i] = !ts_ok[i] || (!first && !st[i].is_float);
      in_float[i] = !ts_ok[i] || (!first && st[i].is_float);
    }
    if (!kIntOpt) {
      for (int i = 0; i < G; ++i) decode_value_float(ws[i], st[i], first);
    } else if (group_all<G>(in_int)) {
      for (int i = 0; i < G; ++i) value_needs<kInt>(ws[i], st[i], false, need_int[i], need_xor[i]);
      const bool do_int = group_any<G>(need_int);
      for (int i = 0; i < G; ++i) decode_value<kInt>(ws[i], st[i], false, do_int, false);
    } else if (group_all<G>(in_float)) {
      for (int i = 0; i < G; ++i)
        value_needs<kFloat>(ws[i], st[i], false, need_int[i], need_xor[i]);
      const bool do_int = group_any<G>(need_int), do_xor = group_any<G>(need_xor);
      for (int i = 0; i < G; ++i) decode_value<kFloat>(ws[i], st[i], false, do_int, do_xor);
    } else {
      for (int i = 0; i < G; ++i) value_needs<kAny>(ws[i], st[i], first, need_int[i], need_xor[i]);
      const bool do_int = group_any<G>(need_int), do_xor = group_any<G>(need_xor);
      for (int i = 0; i < G; ++i) decode_value<kAny>(ws[i], st[i], first, do_int, do_xor);
    }
    for (int i = 0; i < G; ++i) valid[i] = was[i] && ts_ok[i] && !st[i].done && !st[i].err;
    emit(idx, valid, st);
  }
  for (int i = 0; i < G; ++i) err[i] = st[i].err;
}

// B-6's outputs, row-major [S, T] (err [S] apart): a record's timestamp,
// value bits (f64 bits of a float point, else the int value),
// point_is_float, mult, valid and its f32 value. vec16 / vec8 / vec4: the
// u8 planes / ts and bits / values_f32 take 16-byte stores (T a multiple of
// 16 / 2 / 4 and the plane 16-byte aligned).
struct RecordRows {
  int64_t* ts;
  int64_t* bits;
  uint8_t* pif;
  uint8_t* mult;
  uint8_t* valid;
  float* f32;
  bool vec16, vec8, vec4;
};

// The outputs' pointers, with the 16-byte store flags for this T.
inline RecordRows record_rows(int64_t t, int64_t* ts, int64_t* bits, uint8_t* pif, uint8_t* mult,
                              uint8_t* valid, float* f32) {
  const auto al = [](const void* p) { return ((uintptr_t)p & 15u) == 0; };
  return {ts, bits, pif, mult, valid, f32,
          t % 16 == 0 && al(pif) && al(mult) && al(valid), t % 2 == 0 && al(ts) && al(bits),
          t % 4 == 0 && al(f32)};
}

// 16 bytes at p (16-byte aligned): one vector store on the card.
M3_HD void store16(void* p, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
#ifdef __CUDACC__
  *reinterpret_cast<uint4*>(p) = make_uint4(a, b, c, d);
#else
  const uint32_t v[4] = {a, b, c, d};
  std::memcpy(p, v, 16);
#endif
}

// The 4 bytes at p (4-byte aligned) as one word: one load on the card.
M3_HD uint32_t load_u32(const uint8_t* p) {
#ifdef __CUDACC__
  return *reinterpret_cast<const uint32_t*>(p);
#else
  uint32_t x;
  std::memcpy(&x, p, 4);
  return x;
#endif
}

// A record's values_f32 from its staged bits and flag byte, by the
// reference's formulas, NaN where invalid; each conversion only if some
// valid record of the warp's flush needs it (do_f, do_i). Every NaN is
// stored as 0x7FC00000, the bits the reference's sign * NaN keeps on the
// CPU (the card's multiply returns its own NaN).
M3_HD uint32_t record_f32(uint64_t b, uint32_t flag, bool do_f, bool do_i) {
  const bool pif = (flag & 1u) != 0, ok = (flag & 2u) != 0;
  const float vf = do_f ? f64_bits_to_f32(b) : 0.0f;
  const float vi = do_i ? to_f32(b) * mult_rcp((int)(flag >> 2)) : 0.0f;
  const float v = pif ? vf : vi;
  return ok && v == v ? (uint32_t)__float_as_int(v) : 0x7FC00000u;
}

// Thread j's share (items j, j + kGroup, ...) of a warp's flush of the
// records idx0 .. idx0 + cnt - 1 of its 32 series (rows row0 ..): each
// series' run of ts and bits (16 bytes = 2 records a store) and of
// values_f32 (4 records a store), or a record a store where the runs are
// not aligned so. Each series' run is contiguous, so a warp's store covers
// whole sectors.
M3_HD void b6_flush_records(const B6Stage& sg, int j, int cnt, int idx0, int64_t row0, int64_t s,
                            int t, const RecordRows& out, bool do_f, bool do_i) {
  const int f0 = idx0 % kB6FlagGroup;  // the run's first flag slot
  if (out.vec8 && cnt % 2 == 0) {
    const int per = cnt / 2;
    for (int k = j; k < kGroup * per; k += kGroup) {
      const int ln = k / per, r = 2 * (k - ln * per);
      if (row0 + ln >= s) continue;
      const int64_t o = (row0 + ln) * t + idx0 + r;
      const uint64_t* a = sg.ts + ln * kB6Stride + r;
      const uint64_t* b = sg.bits + ln * kB6Stride + r;
      store16(out.ts + o, (uint32_t)a[0], (uint32_t)(a[0] >> 32), (uint32_t)a[1],
              (uint32_t)(a[1] >> 32));
      store16(out.bits + o, (uint32_t)b[0], (uint32_t)(b[0] >> 32), (uint32_t)b[1],
              (uint32_t)(b[1] >> 32));
    }
  } else {
    for (int k = j; k < kGroup * cnt; k += kGroup) {
      const int ln = k / cnt, r = k - ln * cnt;
      if (row0 + ln >= s) continue;
      const int64_t o = (row0 + ln) * t + idx0 + r;
      out.ts[o] = (int64_t)sg.ts[ln * kB6Stride + r];
      out.bits[o] = (int64_t)sg.bits[ln * kB6Stride + r];
    }
  }
  if (out.vec4 && cnt % 4 == 0) {
    const int per = cnt / 4;
    for (int k = j; k < kGroup * per; k += kGroup) {
      const int ln = k / per, r = 4 * (k - ln * per);
      if (row0 + ln >= s) continue;
      const uint64_t* b = sg.bits + ln * kB6Stride + r;
      const uint8_t* f = sg.flags + ln * kB6FlagStride + f0 + r;
      store16(out.f32 + (row0 + ln) * t + idx0 + r, record_f32(b[0], f[0], do_f, do_i),
              record_f32(b[1], f[1], do_f, do_i), record_f32(b[2], f[2], do_f, do_i),
              record_f32(b[3], f[3], do_f, do_i));
    }
  } else {
    for (int k = j; k < kGroup * cnt; k += kGroup) {
      const int ln = k / cnt, r = k - ln * cnt;
      if (row0 + ln >= s) continue;
      const uint32_t v = record_f32(sg.bits[ln * kB6Stride + r],
                                    sg.flags[ln * kB6FlagStride + f0 + r], do_f, do_i);
      out.f32[(row0 + ln) * t + idx0 + r] = __int_as_float((int)v);
    }
  }
}

// Thread j's share of a warp's flush of the three u8 planes of the records
// idx0 .. idx0 + cnt - 1 (idx0 a multiple of kB6FlagGroup): 16 records of a
// series a store where the runs are aligned so, else a record a store.
M3_HD void b6_flush_flags(const B6Stage& sg, int j, int cnt, int idx0, int64_t row0, int64_t s,
                          int t, const RecordRows& out) {
  if (out.vec16 && cnt % 16 == 0) {
    const int per = cnt / 16;
    for (int k = j; k < kGroup * per; k += kGroup) {
      const int ln = k / per, r = 16 * (k - ln * per);
      if (row0 + ln >= s) continue;
      const uint8_t* f = sg.flags + ln * kB6FlagStride + r;
      uint32_t pif[4], valid[4], mult[4];
      for (int q = 0; q < 4; ++q) {
        const uint32_t x = load_u32(f + 4 * q);
        pif[q] = x & 0x01010101u;
        valid[q] = (x >> 1) & 0x01010101u;
        mult[q] = (x >> 2) & 0x3F3F3F3Fu;
      }
      const int64_t o = (row0 + ln) * t + idx0 + r;
      store16(out.pif + o, pif[0], pif[1], pif[2], pif[3]);
      store16(out.mult + o, mult[0], mult[1], mult[2], mult[3]);
      store16(out.valid + o, valid[0], valid[1], valid[2], valid[3]);
    }
  } else {
    for (int k = j; k < kGroup * cnt; k += kGroup) {
      const int ln = k / cnt, r = k - ln * cnt;
      if (row0 + ln >= s) continue;
      const uint32_t x = sg.flags[ln * kB6FlagStride + r];
      const int64_t o = (row0 + ln) * t + idx0 + r;
      out.pif[o] = (uint8_t)(x & 1u);
      out.mult[o] = (uint8_t)(x >> 2);
      out.valid[o] = (uint8_t)((x >> 1) & 1u);
    }
  }
}

// What walk_streams emits into, for a group of G lanes of one warp (lanes
// lane0 .. lane0 + G - 1 of the warp's 32): each record into the stage;
// after every kB6Group records (and the last) the warp's flush of ts, bits
// and values_f32, after every kB6FlagGroup the u8 planes', then each lane's
// ring moved to its cursor. On the card G = 1 and the 32 threads of the
// warp each flush their share; the host runs the 32 shares in turn.
template <int G>
struct B6Sink {
  B6Stage sg;
  StreamLane* L;
  int lane0;
  int64_t row0, s;
  int t;
  RecordRows out;
  bool any_f[G], any_i[G];  // a valid float / int record since the last flush

  M3_HD void operator()(int idx, const bool* valid, const State* st) {
    const int g = idx % kB6Group;
    for (int i = 0; i < G; ++i) {
      const int l = lane0 + i;
      const bool f = st[i].is_float;
      sg.ts[l * kB6Stride + g] = st[i].prev_time;
      sg.bits[l * kB6Stride + g] = f ? st[i].prev_float_bits : st[i].int_val;
      sg.flags[l * kB6FlagStride + idx % kB6FlagGroup] =
          (uint8_t)((f ? 1u : 0u) | (valid[i] ? 2u : 0u) | ((uint32_t)st[i].mult << 2));
      any_f[i] = (g != 0 && any_f[i]) || (valid[i] && f);
      any_i[i] = (g != 0 && any_i[i]) || (valid[i] && !f);
    }
    if (g != kB6Group - 1 && idx != t - 1) return;  // the same for the whole warp
#ifdef __CUDA_ARCH__
    __syncwarp();
#endif
    const bool do_f = group_any<G>(any_f), do_i = group_any<G>(any_i);
    const int fg = idx % kB6FlagGroup;
    for (int j = lane0; j < lane0 + (G == 1 ? 1 : kGroup); ++j) {
      if (g == kB6Group - 1) b6_flush_records(sg, j, kB6Group, idx - g, row0, s, t, out, do_f, do_i);
      else b6_flush_records(sg, j, g + 1, idx - g, row0, s, t, out, do_f, do_i);
      if (fg == kB6FlagGroup - 1) b6_flush_flags(sg, j, kB6FlagGroup, idx - fg, row0, s, t, out);
      else if (idx == t - 1) b6_flush_flags(sg, j, fg + 1, idx - fg, row0, s, t, out);
    }
#ifdef __CUDA_ARCH__
    __syncwarp();  // the stages are read before the next records land
#endif
    if (idx != t - 1)
      for (int i = 0; i < G; ++i) L[i].refill(st[i].pos);
  }
};

// _ts_consumed_fast: width of a marker-free {s, ms} timestamp record. The
// leading ones of its 4-bit head (0..4) pick 1, 9, 12, 16 or 36 bits, here
// a byte of one constant: no branch, so lanes whose widths differ do not
// diverge.
M3_HD int ts_consumed_fast(const Window& ws) {
  const uint32_t h = (uint32_t)(ws.a >> 60);
  const int ones = clz32(~(h << 28));  // the low 28 bits are set: at most 4
  return (int)((0x24100C0901ull >> (8 * ones)) & 0xFFu);
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

// Kernel R's per-warp record stage: kRecGroup records of each of a warp's 32
// lanes (row stride kRecGroup + 1, odd, so the 64-bit stores and loads are
// free of bank conflicts), flushed by the warp after every kRecGroup records.
constexpr int kRecGroup = 8;
constexpr int kRecStride = kRecGroup + 1;
constexpr int kRecBytes = 8 + 8 + 1 + 1 + 1;  // ts, bits, pif, mult, valid
constexpr size_t kRecStageBytes = (size_t)kSlab * kRecStride * kRecBytes;

// Words from one of B3's staged lane rows to the next: CW words and four
// zero words, odd, so the words of a warp's rows at one index fall in
// distinct banks.
M3_HDX int fields_row_stride(int cw) { return (cw + 4) | 1; }

// The three lane kernels, as m3_lane_smem_bytes and m3_lane_resident_blocks
// name them.
enum LaneKernel { kB1 = 0, kR = 1, kB3 = 2 };

// Bytes of shared memory a block of `which` needs at windows of cw words:
// B1's and R's slab stage (R's record stage after it), B3's 128 staged lane
// rows.
inline size_t smem_bytes(int which, int cw, int mask) {
  if (which == kB3) return (size_t)kSlab * fields_row_stride(cw) * 4;
  return stage_bytes(cw, mask) + (which == kR ? kRecStageBytes : 0);
}

// Whether a block of `which` takes windows of cw words.
inline bool smem_ok(int which, int cw, int mask) {
  return cw > 0 && smem_bytes(which, cw, mask) <= m3::kSmemMax;
}

// Whether B1 takes this shape: 128-lane slabs that tile Npad and never
// straddle two tiles, and a stage that fits a block's shared memory.
inline bool slab_shape_ok(int64_t npad, int64_t tile_lanes, int cw, int mask) {
  return npad % kSlab == 0 && tile_lanes > 0 && tile_lanes % kSlab == 0 &&
         smem_ok(kB1, cw, mask);
}
inline bool records_shape_ok(int cw, int mask, int k) { return k > 0 && smem_ok(kR, cw, mask); }
inline bool fields_shape_ok(int cw, int mask, int k) { return k > 0 && smem_ok(kB3, cw, mask); }

#ifdef __CUDACC__
// The slab at column `col` of the word-major [CW, Npad] windows into the
// stage: `live` lanes (the rest zero). A full slab of a 16-byte aligned
// array whose rows are 16-byte aligned (Npad % 4 == 0) comes in as 16-byte
// copies, others word by word.
__device__ __forceinline__ void stage_packed(uint32_t* s, const uint32_t* windows, int64_t npad,
                                             int64_t col, int cw, int live, bool vec) {
  const int tid = threadIdx.x;
  if (vec && live == kSlab) {
    for (int j = tid; j < cw * 32; j += kSlab) {
      const int row = j >> 5, q = (j & 31) * 4;
      m3::cp_async16(s + row * kSlab + q, windows + row * npad + col + q);
    }
  } else {
    for (int j = tid; j < cw * kSlab; j += kSlab) {
      const int row = j >> 7, c = j & (kSlab - 1);
      if (c < live) m3::cp_async4(s + j, windows + row * npad + col + c);
      else s[j] = 0u;
    }
  }
  m3::cp_async_commit();
  m3::cp_async_wait<0>();
  __syncthreads();  // every thread's copies have landed
}

// Zero rows after the CW window rows (copies never write them).
__device__ __forceinline__ void zero_rows(uint32_t* s, int cw, int mask) {
  const int stage_words = stage_rows(cw, mask) * kSlab;
  for (int j = cw * kSlab + (int)threadIdx.x; j < stage_words; j += kSlab) s[j] = 0u;
}

// B1: a block walks 128-lane slabs (slab += gridDim.x), decoding each with
// the body its tile's flag picks (tile_lanes is a multiple of 128).
__global__ void __launch_bounds__(kSlab)
lane_aggregates_slab_kernel(const uint32_t* __restrict__ windows,
                            const uint32_t* __restrict__ lanes,
                            const int32_t* __restrict__ tile_flags, int64_t npad, int cw,
                            int mask, int k, int64_t tile_lanes, float* __restrict__ out_f,
                            int32_t* __restrict__ out_cnt, uint8_t* __restrict__ out_err) {
  extern __shared__ __align__(16) uint32_t s_stage[];
  __shared__ float s_rcp[8];
  const int64_t nslab = npad / kSlab;
  const int tid = threadIdx.x;
  zero_rows(s_stage, cw, mask);
  fill_rcp_table(s_rcp, tid);
  for (int64_t slab = blockIdx.x; slab < nslab; slab += gridDim.x) {
    const int64_t col = slab * kSlab;
    stage_packed(s_stage, windows, npad, col, cw, kSlab, true);
    const SlabLane L = slab_lane(s_stage, lanes, npad, col + tid, tid, cw, mask, true);
    const int flag = __ldg(tile_flags + col / tile_lanes);
    Acc acc;
    acc.init();
    bool err = false;
    if (flag == 1) {
      run_fast_int(L, k, acc);
    } else if (flag == 2) {
      run_fast_float(L, k, acc);
    } else {
      run_general<1>(&L, k, &acc, &err, RcpTable{s_rcp});
    }
    store_lane(acc, err, col + tid, npad, out_f, out_cnt, out_err);
    __syncthreads();  // the stage is read before it is refilled
  }
}

// Kernel R: a block walks 128-lane slabs of the first n lanes; each thread
// walks its lane with the general body and kTime, staging its records in
// its warp's record stage, which the warp flushes every kRecGroup records:
// kRecGroup consecutive records of a lane are one 64-byte run of ts and of
// bits (two whole sectors) and 8 bytes of each u8 array.
__global__ void __launch_bounds__(kSlab)
decode_records_slab_kernel(const uint32_t* __restrict__ windows,
                           const uint32_t* __restrict__ lanes, int64_t npad, int64_t n, int cw,
                           int mask, int k, bool vec, int64_t* __restrict__ out_ts,
                           int64_t* __restrict__ out_bits, uint8_t* __restrict__ out_pif,
                           uint8_t* __restrict__ out_mult, uint8_t* __restrict__ out_valid,
                           uint8_t* __restrict__ out_err) {
  extern __shared__ __align__(16) uint32_t s_stage[];
  const int tid = threadIdx.x, l32 = tid & 31, warp = tid >> 5;
  // the record stage after the window stage, one part of kGroup rows per warp
  int64_t* s_ts = reinterpret_cast<int64_t*>(s_stage + stage_rows(cw, mask) * kSlab);
  int64_t* s_bits = s_ts + kSlab * kRecStride;
  uint8_t* s_small = reinterpret_cast<uint8_t*>(s_bits + kSlab * kRecStride);
  const int wrow = warp * kGroup * kRecStride;  // this warp's first stage row
  const int64_t nslab = (n + kSlab - 1) / kSlab;
  zero_rows(s_stage, cw, mask);
  for (int64_t slab = blockIdx.x; slab < nslab; slab += gridDim.x) {
    const int64_t col = slab * kSlab;
    const int live = n - col < kSlab ? (int)(n - col) : kSlab;
    stage_packed(s_stage, windows, npad, col, cw, live, vec);
    const SlabLane L = slab_lane(s_stage, lanes, npad, col + tid, tid, cw, mask, tid < live);
    const int64_t wlane = col + warp * kGroup;  // the warp's first lane
    bool err;
    walk_general<true, 1>(&L, k, &err, [&](int idx, const bool* valid, const State* st) {
      const int g = idx % kRecGroup;
      const int i = wrow + l32 * kRecStride + g;
      s_ts[i] = (int64_t)st->prev_time;
      s_bits[i] = (int64_t)(st->is_float ? st->prev_float_bits : st->int_val);
      s_small[i] = st->is_float ? 1 : 0;
      s_small[kSlab * kRecStride + i] = (uint8_t)st->mult;
      s_small[2 * kSlab * kRecStride + i] = valid[0] ? 1 : 0;
      if (g == kRecGroup - 1 || idx == k - 1) {  // the same for the whole warp
        __syncwarp();
        const int cnt = g + 1, idx0 = idx - g;
        for (int j = l32; j < kGroup * cnt; j += kGroup) {
          const int ln = j / cnt, r = j - ln * cnt;
          const int64_t lane = wlane + ln;
          if (lane < n) {
            const int si = wrow + ln * kRecStride + r;
            const int64_t o = lane * k + idx0 + r;
            out_ts[o] = s_ts[si];
            out_bits[o] = s_bits[si];
            out_pif[o] = s_small[si];
            out_mult[o] = s_small[kSlab * kRecStride + si];
            out_valid[o] = s_small[2 * kSlab * kRecStride + si];
          }
        }
        __syncwarp();  // the stage is read before the next records land
      }
    });
    if (tid < live) out_err[col + tid] = err ? 1 : 0;
    __syncthreads();  // the window stage is read before it is refilled
  }
}

// B3's slab `slab` of the lane-major [n, CW] windows into `rows`, lane t's
// row at rows[t * fields_row_stride(cw)]: consecutive threads copy
// consecutive words by cp.async (coalesced reads, and conflict-free writes
// at the odd row stride), rows past the last lane zero. The zero words
// after each row are written once (zero_row_tails).
__device__ __forceinline__ void stage_fields(uint32_t* rows, const uint32_t* windows, int64_t n,
                                             int64_t slab, int cw) {
  const int64_t base = slab * kSlab;
  const int here = n - base < kSlab ? (int)(n - base) : kSlab;
  const uint32_t* src = windows + base * cw;
  const int stride = fields_row_stride(cw), total = here * cw;
  int ln = (int)threadIdx.x / cw, w = (int)threadIdx.x - ln * cw;
  const int step_ln = kSlab / cw, step_w = kSlab - step_ln * cw;
  for (int i = threadIdx.x; i < kSlab * cw; i += kSlab) {
    if (i < total) m3::cp_async4(rows + ln * stride + w, src + i);
    else rows[ln * stride + w] = 0u;
    ln += step_ln;
    w += step_w;
    if (w >= cw) {
      w -= cw;
      ++ln;
    }
  }
  m3::cp_async_commit();
  m3::cp_async_wait<0>();
  __syncthreads();  // every thread's copies have landed
}

// The zero words after each of B3's staged rows (copies never write them).
__device__ __forceinline__ void zero_row_tails(uint32_t* rows, int cw) {
  const int stride = fields_row_stride(cw);
  for (int j = cw; j < stride; ++j) rows[threadIdx.x * stride + j] = 0u;
}

// B3: a block walks 128-lane slabs of the lane-major [n, CW] windows,
// stages each (stage_fields) and decodes it with the general body, each
// thread from its lane's row.
__global__ void __launch_bounds__(kSlab)
lane_aggregates_fields_slab_kernel(const uint32_t* __restrict__ windows, const FieldPlanes f,
                                   int64_t n, int cw, int mask, int k,
                                   float* __restrict__ out_f, int32_t* __restrict__ out_cnt,
                                   uint8_t* __restrict__ out_err) {
  extern __shared__ __align__(16) uint32_t s_rows[];
  __shared__ float s_rcp[8];
  const int tid = threadIdx.x;
  const int64_t nslab = (n + kSlab - 1) / kSlab;
  fill_rcp_table(s_rcp, tid);
  zero_row_tails(s_rows, cw);
  for (int64_t slab = blockIdx.x; slab < nslab; slab += gridDim.x) {
    stage_fields(s_rows, windows, n, slab, cw);
    const int64_t lane = slab * kSlab + tid;
    const bool live = lane < n;
    const FieldLane L = field_lane(s_rows + tid * fields_row_stride(cw), f, lane, cw, mask, live);
    Acc acc;
    acc.init();
    bool err;
    run_general<1>(&L, k, &acc, &err, RcpTable{s_rcp});
    if (live) store_lane(acc, err, lane, n, out_f, out_cnt, out_err);
    __syncthreads();  // the rows are read before they are refilled
  }
}

// Kernel B-6: the whole-stream decode, the port of the XLA program
// m3_tpu/ops/decode.py:542 decode_batched (a max_points-step lax.scan over
// every series' state, called by m3_tpu/parallel/scan.py:116
// _local_scan_aggregate). Each thread walks one series from bit 0 for t
// records with the state in registers; its warp's 32 series are 32
// consecutive rows.
//
// Bound: bytes. Each series' stream words are read once and 23 bytes a
// record written (ts, bits, values_f32, three flags): at 1,048,576 series x
// 720 gauge points that is ~1.8 GB read and ~17.4 GB written, some 5.7 ms
// at 3.35 TB/s (chip_smoke.py prints the bound of its run). A thread's own
// row-major stores would be strided by T across its warp: each store
// instruction touching 32 sectors for 1 to 8 bytes of each, six of them a
// record, which took 95% of the first version's 360 ms on the H100
// (PERF.md). So:
// - Records go to the warp's stage in shared memory (B6Stage: ts and bits
//   at an odd row stride, one flag byte), and every kB6Group (16) records
//   the warp stores each series' run of ts and bits (128 bytes, a whole
//   line) and values_f32 (64 bytes, converted there from the staged bits
//   and flags, each conversion only if a valid record of the flush needs
//   it) with 16-byte stores; every kB6FlagGroup (32) records the three u8
//   planes (32 bytes a series each). Each byte of the outputs is written
//   once. Runs of 8 records took 1.5x as long, runs of 32 cost occupancy.
// - With the stage in shared memory the rows' lines no longer stay in L1,
//   so each lane reads its stream through a ring of its next kB6Ring (32)
//   words in shared memory (lane-interleaved: a warp's reads at any word
//   indices fall in distinct banks), moved to the lane's cursor after each
//   flush by cp.async of the words it lacks. A marker-free record is at most
//   148 bits (a 68-bit timestamp, an 80-bit to-int value), a first one 210,
//   so a run of 16 wide records goes past the ring, and those fetches read
//   the row (StreamLane::fetch); the scan's gauges take ~20 bits a record
//   and never do. Without the ring the same kernel took 1.9x as long.
// - The record steps take walk_general's warp votes (walk_streams): 10%
//   of the time on the scan's int gauges. Every lane of a warp stays in the
//   loop (rows past S walk as done lanes); a warp with no series returns.
// What remains is the walk's instructions: with its stores suppressed the
// kernel takes 87% of its time (PERF.md).
template <bool kIntOpt>
__global__ void __launch_bounds__(kB6Threads)
decode_batched_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ num_bits,
                      const int32_t* __restrict__ initial_unit, int64_t s, int64_t w, int t,
                      RecordRows out, uint8_t* __restrict__ out_err) {
  extern __shared__ __align__(16) uint8_t s_b6[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t row0 = ((int64_t)blockIdx.x * kB6Warps + warp) * kGroup;
  if (row0 >= s) return;  // the whole warp: no series of its own
  const int64_t row = row0 + lane;
  const bool live = row < s;  // a lane past the last series walks as a done lane
  const B6Stage sg = b6_stage(s_b6 + warp * kB6WarpBytes);
  StreamLane L = stream_lane(words, w, live ? row : 0, sg.ring + lane);
  const int nb = live ? __ldg(num_bits + row) : 0;
  const int unit = live ? __ldg(initial_unit + row) : 0;
  B6Sink<1> sink{sg, &L, lane, row0, s, t, out, {}, {}};
  bool err;
  walk_streams<kIntOpt, 1>(&L, &nb, &unit, t, &err, sink);
  if (live) out_err[row] = err ? 1 : 0;
}

// Launch `kernel` on a persistent grid: at most as many blocks as the card
// holds at once, and no more than there are slabs.
template <class Kernel, class... Args>
int launch_slabs(Kernel kernel, int64_t nslab, size_t smem, void* stream, Args... args) {
  if (nslab > 0) {
    int64_t cap = 0;
    const cudaError_t e = m3::resident_blocks(kernel, kSlab, smem, &cap);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)(nslab < cap ? nslab : cap), kSlab, smem, (cudaStream_t)stream>>>(args...);
  }
  return (int)cudaGetLastError();
}
#else
// The host's stage of a packed slab, as stage_packed leaves it: `live`
// lanes' columns of the CW window rows, zeros elsewhere.
void host_stage_packed(std::vector<uint32_t>& s, const uint32_t* windows, int64_t npad,
                       int64_t col, int cw, int live) {
  std::fill(s.begin(), s.end(), 0u);
  for (int w = 0; w < cw; ++w)
    std::memcpy(&s[(size_t)w * kSlab], windows + w * npad + col, (size_t)live * 4);
}

// Runs fn(lanes, count) over the slab's groups of kGroup lanes
template <class Lane, class Fn>
void host_groups(const Lane* lanes, Fn&& fn) {
  for (int g = 0; g < kSlab; g += kGroup) fn(lanes + g, g);
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
  return launch_slabs(lane_aggregates_slab_kernel, npad / kSlab, smem_bytes(kB1, cw, mask),
                      stream, windows, lanes, tile_flags, npad, cw, mask, k, tile_lanes, out_f,
                      out_cnt, out_err);
}

// Kernel R. windows u32[cw, npad] (16-byte aligned), lanes u32[17, npad] as
// for m3_lane_aggregates but of any npad; the first n lanes are decoded with
// the general body. Outputs, lane-major [n, k]: out_ts i64 (prev_time after
// each record), out_bits i64 (f64 bits if the point is float, else the int
// value), out_pif / out_mult / out_valid u8; out_err u8[n]. Returns
// cudaGetLastError() after the launch (cudaErrorInvalidValue for a shape
// whose stages exceed shared memory, or unaligned windows).
extern "C" int m3_decode_records(const uint32_t* windows, const uint32_t* lanes, int64_t npad,
                                 int64_t n, int cw, int mask, int k, int64_t* out_ts,
                                 int64_t* out_bits, uint8_t* out_pif, uint8_t* out_mult,
                                 uint8_t* out_valid, uint8_t* out_err, void* stream) {
  if (!records_shape_ok(cw, mask, k) || ((uintptr_t)windows & 15u) != 0 || n > npad)
    return (int)cudaErrorInvalidValue;
  const bool vec = npad % 4 == 0;
  return launch_slabs(decode_records_slab_kernel, (n + kSlab - 1) / kSlab,
                      smem_bytes(kR, cw, mask), stream, windows, lanes, npad, n, cw,
                      mask, k, vec, out_ts, out_bits, out_pif, out_mult, out_valid, out_err);
}

// B3. windows u32[n, cw] lane-major; fields: a host array of 17 device
// pointers in Plane order (rel_pos ... is_float), each an [n] array, u32
// but for first and is_float (bool as u8). Outputs as m3_lane_aggregates',
// over n lanes. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue if a slab's stage exceeds shared memory).
extern "C" int m3_lane_aggregates_fields(const uint32_t* windows, const void* const* fields,
                                         int64_t n, int cw, int mask, int k, float* out_f,
                                         int32_t* out_cnt, uint8_t* out_err, void* stream) {
  if (!fields_shape_ok(cw, mask, k)) return (int)cudaErrorInvalidValue;
  return launch_slabs(lane_aggregates_fields_slab_kernel, (n + kSlab - 1) / kSlab,
                      smem_bytes(kB3, cw, mask), stream, windows, make_field_planes(fields), n, cw,
                      mask, k, out_f, out_cnt, out_err);
}
// Kernel B-6. words u32[s, w] row-major (w >= 1), num_bits and
// initial_unit i32[s]; int_optimized 0 or 1. Outputs, row-major [s, t]:
// out_ts i64, out_bits i64, out_pif / out_mult / out_valid u8, out_f32 f32;
// out_err u8[s]. Returns cudaGetLastError() after the launch
// (cudaErrorInvalidValue for w < 1 or t < 1).
extern "C" int m3_decode_batched(const uint32_t* words, const int32_t* num_bits,
                                 const int32_t* initial_unit, int64_t s, int64_t w, int t,
                                 int int_optimized, int64_t* out_ts, int64_t* out_bits,
                                 uint8_t* out_pif, uint8_t* out_mult, uint8_t* out_valid,
                                 uint8_t* out_err, float* out_f32, void* stream) {
  if (s < 0 || w < 1 || t < 1) return (int)cudaErrorInvalidValue;
  if (s > 0) {
    const RecordRows out = record_rows(t, out_ts, out_bits, out_pif, out_mult, out_valid, out_f32);
    const int64_t blocks = (s + kB6Threads - 1) / kB6Threads;
    const size_t smem = kB6Warps * kB6WarpBytes;
    if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
    const auto kernel = int_optimized ? decode_batched_kernel<true> : decode_batched_kernel<false>;
    int64_t cap = 0;  // raises the kernel's shared memory limit to smem
    const cudaError_t e = m3::resident_blocks(kernel, kB6Threads, smem, &cap);
    if (e != cudaSuccess) return (int)e;
    kernel<<<(unsigned)blocks, kB6Threads, smem, (cudaStream_t)stream>>>(
        words, num_bits, initial_unit, s, w, t, out, out_err);
  }
  return (int)cudaGetLastError();
}

// B-6's launch at s series (int_optimized's kernel): out[9] = warps a
// block, blocks, blocks the card holds at once, shared memory a block,
// registers a thread, local memory a thread, kB6Group, kB6FlagGroup,
// kB6Ring. Returns a CUDA error code.
extern "C" int m3_decode_batched_shape(int64_t s, int64_t* out) {
  cudaFuncAttributes attr;
  const size_t smem = kB6Warps * kB6WarpBytes;
  cudaError_t e = cudaFuncGetAttributes(&attr, decode_batched_kernel<true>);
  int64_t cap = 0;
  if (e == cudaSuccess) e = m3::resident_blocks(decode_batched_kernel<true>, kB6Threads, smem, &cap);
  if (e != cudaSuccess) return (int)e;
  const int64_t v[9] = {kB6Warps, (s + kB6Threads - 1) / kB6Threads, cap, (int64_t)smem,
                        attr.numRegs, (int64_t)attr.localSizeBytes, kB6Group, kB6FlagGroup,
                        kB6Ring};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// Blocks of each kernel the card holds at once (SMs x blocks per SM) at
// windows of cw words, and the registers a thread of the loaded kernel
// uses: which = 0 B1, 1 R, 2 B3. Returns a CUDA error code.
extern "C" int m3_lane_resident_blocks(int which, int cw, int mask, int64_t* out, int* regs) {
  const void* fn = which == kB1  ? (const void*)lane_aggregates_slab_kernel
                   : which == kR ? (const void*)decode_records_slab_kernel
                                 : (const void*)lane_aggregates_fields_slab_kernel;
  cudaFuncAttributes attr;
  cudaError_t e = cudaFuncGetAttributes(&attr, fn);
  if (e != cudaSuccess) return (int)e;
  *regs = attr.numRegs;
  const size_t smem = smem_bytes(which, cw, mask);
  if (which == kB1) {
    e = m3::resident_blocks(lane_aggregates_slab_kernel, kSlab, smem, out);
  } else if (which == kR) {
    e = m3::resident_blocks(decode_records_slab_kernel, kSlab, smem, out);
  } else {
    e = m3::resident_blocks(lane_aggregates_fields_slab_kernel, kSlab, smem, out);
  }
  return (int)e;
}
#else
// Host builds of the three entries, with subnormals flushed as -ftz=true
// flushes them on the card, and lanes decoded as the card decodes them:
// each 128-lane slab staged word-major and read through the same lanes, the
// general body's lanes walked in groups of kGroup that take the warp's
// decisions together. Each returns 1 for a shape its kernel does not take.
extern "C" int m3_lane_aggregates_host(const uint32_t* windows, const uint32_t* lanes,
                                       const int32_t* tile_flags, int64_t npad, int cw,
                                       int mask, int k, int64_t tile_lanes, float* out_f,
                                       int32_t* out_cnt, uint8_t* out_err) {
  if (!slab_shape_ok(npad, tile_lanes, cw, mask)) return 1;
  const unsigned csr = _mm_getcsr();
  _mm_setcsr(csr | 0x8040u);  // FTZ | DAZ
  std::vector<uint32_t> st((size_t)stage_rows(cw, mask) * kSlab, 0u);
  std::vector<SlabLane> L(kSlab);
  float rcp[8];
  for (int i = 0; i < 8; ++i) fill_rcp_table(rcp, i);
  for (int64_t col = 0; col < npad; col += kSlab) {
    host_stage_packed(st, windows, npad, col, cw, kSlab);
    for (int t = 0; t < kSlab; ++t)
      L[t] = slab_lane(st.data(), lanes, npad, col + t, t, cw, mask, true);
    const int flag = tile_flags[col / tile_lanes];
    host_groups(L.data(), [&](const SlabLane* g, int t0) {
      Acc acc[kGroup];
      bool err[kGroup] = {};
      for (int i = 0; i < kGroup; ++i) acc[i].init();
      if (flag == 0) run_general<kGroup>(g, k, acc, err, RcpTable{rcp});
      for (int i = 0; i < kGroup; ++i) {
        if (flag == 1) run_fast_int(g[i], k, acc[i]);
        if (flag == 2) run_fast_float(g[i], k, acc[i]);
        store_lane(acc[i], err[i], col + t0 + i, npad, out_f, out_cnt, out_err);
      }
    });
  }
  _mm_setcsr(csr);
  return 0;
}

// Host build of kernel R (no f32 arithmetic, so no FTZ setting needed).
extern "C" int m3_decode_records_host(const uint32_t* windows, const uint32_t* lanes, int64_t npad,
                                      int64_t n, int cw, int mask, int k, int64_t* out_ts,
                                      int64_t* out_bits, uint8_t* out_pif, uint8_t* out_mult,
                                      uint8_t* out_valid, uint8_t* out_err) {
  if (!records_shape_ok(cw, mask, k) || n > npad) return 1;
  std::vector<uint32_t> st((size_t)stage_rows(cw, mask) * kSlab, 0u);
  std::vector<SlabLane> L(kSlab);
  for (int64_t col = 0; col < n; col += kSlab) {
    const int live = n - col < kSlab ? (int)(n - col) : kSlab;
    host_stage_packed(st, windows, npad, col, cw, live);
    for (int t = 0; t < kSlab; ++t)
      L[t] = slab_lane(st.data(), lanes, npad, col + t, t, cw, mask, t < live);
    host_groups(L.data(), [&](const SlabLane* g, int t0) {
      bool err[kGroup];
      walk_general<true, kGroup>(g, k, err, [&](int idx, const bool* valid, const State* s) {
        for (int i = 0; i < kGroup && t0 + i < live; ++i) {
          const int64_t o = (col + t0 + i) * k + idx;
          out_ts[o] = (int64_t)s[i].prev_time;
          out_bits[o] = (int64_t)(s[i].is_float ? s[i].prev_float_bits : s[i].int_val);
          out_pif[o] = s[i].is_float ? 1 : 0;
          out_mult[o] = (uint8_t)s[i].mult;
          out_valid[o] = valid[i] ? 1 : 0;
        }
      });
      for (int i = 0; i < kGroup && t0 + i < live; ++i) out_err[col + t0 + i] = err[i] ? 1 : 0;
    });
  }
  return 0;
}

// Host build of kernel B-6: each warp's 32 series walked in step as the
// card walks them (the same votes, rings, stages and flushes), with
// subnormals flushed as -ftz=true flushes them.
extern "C" int m3_decode_batched_host(const uint32_t* words, const int32_t* num_bits,
                                      const int32_t* initial_unit, int64_t s, int64_t w, int t,
                                      int int_optimized, int64_t* out_ts, int64_t* out_bits,
                                      uint8_t* out_pif, uint8_t* out_mult, uint8_t* out_valid,
                                      uint8_t* out_err, float* out_f32) {
  if (s < 0 || w < 1 || t < 1) return 1;
  const unsigned csr = _mm_getcsr();
  _mm_setcsr(csr | 0x8040u);  // FTZ | DAZ
  b6_far_fetches = 0;
  const RecordRows out = record_rows(t, out_ts, out_bits, out_pif, out_mult, out_valid, out_f32);
  std::vector<uint64_t> stage(kB6WarpBytes / 8);
  const B6Stage sg = b6_stage(reinterpret_cast<uint8_t*>(stage.data()));
  for (int64_t row0 = 0; row0 < s; row0 += kGroup) {
    StreamLane L[kGroup];
    int nb[kGroup], unit[kGroup];
    for (int i = 0; i < kGroup; ++i) {
      const bool live = row0 + i < s;
      L[i] = stream_lane(words, w, live ? row0 + i : 0, sg.ring + i);
      nb[i] = live ? num_bits[row0 + i] : 0;
      unit[i] = live ? initial_unit[row0 + i] : 0;
    }
    B6Sink<kGroup> sink{sg, L, 0, row0, s, t, out, {}, {}};
    bool err[kGroup];
    if (int_optimized) walk_streams<true, kGroup>(L, nb, unit, t, err, sink);
    else walk_streams<false, kGroup>(L, nb, unit, t, err, sink);
    for (int i = 0; i < kGroup && row0 + i < s; ++i) out_err[row0 + i] = err[i] ? 1 : 0;
  }
  _mm_setcsr(csr);
  return 0;
}

// Fetches the last m3_decode_batched_host call served from the series'
// rows rather than their rings (records wider than a ring holds ahead).
extern "C" int64_t m3_decode_batched_host_far_fetches() { return b6_far_fetches; }

// B-6's geometry as the card's m3_decode_batched_shape reports it; the
// card's fields (blocks, registers, ...) 0.
extern "C" int m3_decode_batched_shape(int64_t s, int64_t* out) {
  const int64_t v[9] = {kB6Warps, (s + kB6Threads - 1) / kB6Threads, 0, (int64_t)(kB6Warps * kB6WarpBytes),
                        0, 0, kB6Group, kB6FlagGroup, kB6Ring};
  for (int i = 0; i < 9; ++i) out[i] = v[i];
  return 0;
}

// Host build of B3: each slab's lane rows staged as the card stages them.
extern "C" int m3_lane_aggregates_fields_host(const uint32_t* windows, const void* const* fields,
                                              int64_t n, int cw, int mask, int k, float* out_f,
                                              int32_t* out_cnt, uint8_t* out_err) {
  if (!fields_shape_ok(cw, mask, k)) return 1;
  const FieldPlanes f = make_field_planes(fields);
  const unsigned csr = _mm_getcsr();
  _mm_setcsr(csr | 0x8040u);  // FTZ | DAZ
  const int stride = fields_row_stride(cw);
  std::vector<uint32_t> rows((size_t)kSlab * stride);
  std::vector<FieldLane> L(kSlab);
  float rcp[8];
  for (int i = 0; i < 8; ++i) fill_rcp_table(rcp, i);
  for (int64_t base = 0; base < n; base += kSlab) {
    const int live = n - base < kSlab ? (int)(n - base) : kSlab;
    std::fill(rows.begin(), rows.end(), 0u);
    for (int t = 0; t < live; ++t)
      std::memcpy(&rows[(size_t)t * stride], windows + (base + t) * cw, (size_t)cw * 4);
    for (int t = 0; t < kSlab; ++t)
      L[t] = field_lane(&rows[(size_t)t * stride], f, base + t, cw, mask, t < live);
    host_groups(L.data(), [&](const FieldLane* g, int t0) {
      Acc acc[kGroup];
      bool err[kGroup];
      for (int i = 0; i < kGroup; ++i) acc[i].init();
      run_general<kGroup>(g, k, acc, err, RcpTable{rcp});
      for (int i = 0; i < kGroup && t0 + i < live; ++i)
        store_lane(acc[i], err[i], base + t0 + i, n, out_f, out_cnt, out_err);
    });
  }
  _mm_setcsr(csr);
  return 0;
}
#endif

// Bytes of shared memory a block of kernel `which` (0 B1, 1 R, 2 B3) needs
// at windows of cw words (both builds: the wrappers check a shape with it
// before any launch).
extern "C" int64_t m3_lane_smem_bytes(int which, int cw, int mask) {
  return (int64_t)smem_bytes(which, cw, mask);
}

// The most shared memory a block may use.
extern "C" int64_t m3_lane_smem_max_bytes() { return (int64_t)m3::kSmemMax; }
