// M3TSZ host codec: batch encoder, side-table prescanner, batch decoder,
// the aggregator's window densify and murmur3 shard routing.
//
// The port's own copy of the JAX package's host codec library (the role the
// hot paths of M3's Go encoder and iterator play: src/dbnode/encoding/
// m3tsz/{encoder.go,iterator.go,timestamp_encoder.go,timestamp_iterator.go},
// scheme.go). Bit-exact with the pure-Python codec in codec/m3tsz.py and
// ops/chunked.snapshot_stream, which stay in the package as its plain
// version. Exposed through a plain C ABI consumed via ctypes
// (m3_tpu_torch/native/__init__.py); batch entry points fan out across
// std::thread workers. Built with g++ by ops/_build.py into build/kernels/
// at first use (HOST_SOURCES there: -O3 -std=c++17 -ffp-contract=off, no
// -march=native, since a library named by a hash of its source can be
// loaded on another host).
//
// Where this copy differs from the JAX package's library (every valid
// input gives the same bytes, records, points and shard ids):
// - a point whose time unit has no delta-of-delta scheme (minutes, hours,
//   days, years, or an invalid code) after its unit's marker: the encoders
//   return -1 (the Python encoder raises ValueError there) instead of
//   dereferencing a null scheme;
// - m3agg_window_keys returns -1, and writes no torder, when a group key
//   id * n_windows + w falls outside [0, INT32_MAX] (the int32 key would
//   wrap); m3agg_count returns -1 for a key outside [0, n_groups) instead
//   of counting out of bounds.
#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t MASK64 = ~0ull;

// ---------- bit output stream (codec/ostream.py semantics) ----------
struct Bits {
  std::vector<uint8_t> buf;
  int pos = 0;  // bits used in last byte; 0 when buf empty or last byte full->8

  void write_bits(uint64_t v, int n) {
    // MSB-first append of the low n bits of v
    for (int i = n - 1; i >= 0; i--) {
      int bit = (int)((v >> i) & 1);
      if (buf.empty() || pos == 8) {
        buf.push_back((uint8_t)(bit << 7));
        pos = 1;
      } else {
        if (bit) buf.back() |= (uint8_t)(1u << (7 - pos));
        pos++;
      }
    }
  }
  void write_bit(int b) { write_bits((uint64_t)b, 1); }
  void write_byte(uint32_t b) { write_bits(b, 8); }
  void write_bytes(const uint8_t* d, size_t n) {
    for (size_t i = 0; i < n; i++) write_byte(d[i]);
  }
  int64_t bit_len() const {
    if (buf.empty()) return 0;
    return (int64_t)(buf.size() - 1) * 8 + pos;
  }
};

// ---------- marker/bucket scheme (codec/scheme.py) ----------
constexpr uint32_t MARKER_OPCODE = 0x100;
constexpr int NUM_MARKER_OPCODE_BITS = 9;
constexpr int NUM_MARKER_VALUE_BITS = 2;
constexpr int NUM_MARKER_BITS = 11;
constexpr int EOS_MARKER = 0;
constexpr int ANNOTATION_MARKER = 1;
constexpr int TIME_UNIT_MARKER = 2;

struct TimeBucket {
  uint32_t opcode;
  int num_opcode_bits;
  int num_value_bits;
  int64_t mn() const { return -(1ll << (num_value_bits - 1)); }
  int64_t mx() const { return (1ll << (num_value_bits - 1)) - 1; }
};

struct Scheme {
  TimeBucket zero{0, 1, 0};
  TimeBucket buckets[3];
  TimeBucket dflt;
};

Scheme make_scheme(int default_bits) {
  Scheme s;
  int bucket_bits[3] = {7, 9, 12};
  uint32_t opcode = 0;
  int nob = 1;
  for (int i = 0; i < 3; i++) {
    opcode = (1u << (i + 1)) | opcode;
    s.buckets[i] = TimeBucket{opcode, nob + 1, bucket_bits[i]};
    nob++;
  }
  s.dflt = TimeBucket{opcode | 1u, nob, default_bits};
  return s;
}

const Scheme SCHEME32 = make_scheme(32);
const Scheme SCHEME64 = make_scheme(64);

// unit codes: 1=s 2=ms 3=us 4=ns 5=min 6=h 7=d 8=y (utils/xtime.py)
int64_t unit_nanos(int unit) {
  switch (unit) {
    case 1: return 1000000000ll;
    case 2: return 1000000ll;
    case 3: return 1000ll;
    case 4: return 1ll;
    case 5: return 60ll * 1000000000ll;
    case 6: return 3600ll * 1000000000ll;
    case 7: return 86400ll * 1000000000ll;
    case 8: return 365ll * 86400ll * 1000000000ll;
    default: return 0;
  }
}

const Scheme* scheme_for_unit(int unit) {
  switch (unit) {
    case 1:
    case 2: return &SCHEME32;
    case 3:
    case 4: return &SCHEME64;
    default: return nullptr;  // min/h/d/y have no dod scheme
  }
}

int64_t to_normalized(int64_t nanos, int unit) {
  int64_t u = unit_nanos(unit);
  return nanos / u;  // C++ truncates toward zero, same as Go
}

void write_marker(Bits& os, int marker) {
  os.write_bits(MARKER_OPCODE, NUM_MARKER_OPCODE_BITS);
  os.write_bits((uint64_t)marker, NUM_MARKER_VALUE_BITS);
}

// ---------- int optimization (m3tsz.go:78-118) ----------
constexpr double MAX_INT = 9223372036854775808.0;   // 2^63
constexpr double MIN_INT = -9223372036854775808.0;  // -2^63
constexpr double MAX_OPT_INT = 1e13;
constexpr int MAX_MULT = 6;
const double MULTIPLIERS[7] = {1, 10, 100, 1000, 10000, 100000, 1000000};

struct IntFloat {
  double val;
  int mult;
  bool is_float;
};

IntFloat convert_to_int_float(double v, int cur_max_mult) {
  if (cur_max_mult == 0 && v < MAX_INT) {
    double i;
    double frac = std::modf(v, &i);
    if (frac == 0) return {i, 0, false};
  }
  double val = v * MULTIPLIERS[cur_max_mult];
  double sign = 1.0;
  if (v < 0) {
    sign = -1.0;
    val = -val;
  }
  int mult = cur_max_mult;
  while (mult <= MAX_MULT && val < MAX_OPT_INT) {
    double i;
    double frac = std::modf(val, &i);
    if (frac == 0) return {sign * i, mult, false};
    if (frac < 0.1) {
      if (std::nextafter(val, 0.0) <= i) return {sign * i, mult, false};
    } else if (frac > 0.9) {
      double nxt = i + 1;
      if (std::nextafter(val, nxt) >= nxt) return {sign * nxt, mult, false};
    }
    val *= 10.0;
    mult++;
  }
  return {v, 0, true};
}

int num_sig(uint64_t v) { return v == 0 ? 0 : 64 - __builtin_clzll(v); }

uint64_t f2b(double d) {
  uint64_t b;
  std::memcpy(&b, &d, 8);
  return b;
}

// ---------- encoder (m3tsz.py Encoder parity) ----------
constexpr int SIG_DIFF_THRESHOLD = 3;
constexpr int SIG_REPEAT_THRESHOLD = 5;

struct Encoder {
  Bits os;
  // timestamp state
  int64_t prev_time;
  int64_t prev_delta = 0;
  int time_unit;  // 0 = none
  bool tu_encoded_manually = false;
  bool wrote_first = false;
  // float state
  uint64_t prev_float_bits = 0;
  uint64_t prev_xor = 0;
  // int state
  double int_val = 0;
  int max_mult = 0;
  bool is_float = false;
  int num_encoded = 0;
  bool int_optimized;
  // sig tracker
  int nsig = 0, cur_highest_lower_sig = 0, num_lower_sig = 0;
  // a point's unit had no delta-of-delta scheme: the stream is unusable
  bool err = false;

  Encoder(int64_t start_nanos, int default_unit, bool int_opt)
      : prev_time(start_nanos), int_optimized(int_opt) {
    int64_t u = unit_nanos(default_unit);
    time_unit = (u != 0 && start_nanos % u == 0) ? default_unit : 0;
  }

  void write_full_float(uint64_t bits) {
    prev_float_bits = bits;
    prev_xor = bits;
    os.write_bits(bits, 64);
  }

  void write_next_float(uint64_t bits) {
    uint64_t x = prev_float_bits ^ bits;
    if (x == 0) {
      os.write_bit(0);
    } else {
      int pl = prev_xor ? __builtin_clzll(prev_xor) : 64;
      int pt = prev_xor ? __builtin_ctzll(prev_xor) : 0;
      int cl = __builtin_clzll(x);
      int ct = __builtin_ctzll(x);
      if (cl >= pl && ct >= pt) {
        os.write_bits(0x2, 2);
        os.write_bits(x >> pt, 64 - pl - pt);
      } else {
        os.write_bits(0x3, 2);
        os.write_bits((uint64_t)cl, 6);
        int nm = 64 - cl - ct;
        os.write_bits((uint64_t)(nm - 1), 6);
        os.write_bits(x >> ct, nm);
      }
    }
    prev_xor = x;
    prev_float_bits = bits;
  }

  void write_dod_unchanged(int64_t prev_d, int64_t cur_d, int unit) {
    const Scheme* s = scheme_for_unit(unit);
    if (!s) {  // the Python encoder raises "no time encoding scheme" here
      err = true;
      return;
    }
    int64_t dod = to_normalized(cur_d - prev_d, unit);
    if (dod == 0) {
      os.write_bits(s->zero.opcode, s->zero.num_opcode_bits);
      return;
    }
    for (int i = 0; i < 3; i++) {
      const TimeBucket& b = s->buckets[i];
      if (b.mn() <= dod && dod <= b.mx()) {
        os.write_bits(b.opcode, b.num_opcode_bits);
        os.write_bits((uint64_t)dod & ((1ull << b.num_value_bits) - 1),
                      b.num_value_bits);
        return;
      }
    }
    const TimeBucket& d = s->dflt;
    os.write_bits(d.opcode, d.num_opcode_bits);
    uint64_t mask = d.num_value_bits == 64 ? MASK64 : ((1ull << d.num_value_bits) - 1);
    os.write_bits((uint64_t)dod & mask, d.num_value_bits);
  }

  void write_time(int64_t t, int unit) {
    if (!wrote_first) {
      os.write_bits((uint64_t)prev_time, 64);
      wrote_first = true;
      write_next_time(t, unit);
      return;
    }
    write_next_time(t, unit);
  }

  void write_next_time(int64_t t, int unit) {
    bool tu_changed = false;
    if (unit_nanos(unit) != 0 && unit != time_unit) {
      write_marker(os, TIME_UNIT_MARKER);
      os.write_byte((uint32_t)unit);
      time_unit = unit;
      tu_encoded_manually = true;
      tu_changed = true;
    }
    int64_t delta = t - prev_time;
    prev_time = t;
    if (tu_changed || tu_encoded_manually) {
      int64_t dod = delta - prev_delta;
      os.write_bits((uint64_t)dod, 64);
      prev_delta = 0;
      tu_encoded_manually = false;
      return;
    }
    write_dod_unchanged(prev_delta, delta, unit);
    prev_delta = delta;
  }

  // sig tracker (int_sig_bits_tracker.go)
  void write_int_val_diff(uint64_t bits, bool neg) {
    os.write_bit(neg ? 1 : 0);
    os.write_bits(bits, nsig);
  }
  void write_int_sig(int sig) {
    if (nsig != sig) {
      os.write_bit(1);
      if (sig == 0) {
        os.write_bit(0);
      } else {
        os.write_bit(1);
        os.write_bits((uint64_t)(sig - 1), 6);
      }
    } else {
      os.write_bit(0);
    }
    nsig = sig;
  }
  int track_new_sig(int sig) {
    int new_sig = nsig;
    if (sig > nsig) {
      new_sig = sig;
    } else if (nsig - sig >= SIG_DIFF_THRESHOLD) {
      if (num_lower_sig == 0) cur_highest_lower_sig = sig;
      else if (sig > cur_highest_lower_sig) cur_highest_lower_sig = sig;
      num_lower_sig++;
      if (num_lower_sig >= SIG_REPEAT_THRESHOLD) {
        new_sig = cur_highest_lower_sig;
        num_lower_sig = 0;
      }
    } else {
      num_lower_sig = 0;
    }
    return new_sig;
  }

  void write_int_sig_mult(int sig, int mult, bool float_changed) {
    write_int_sig(sig);
    if (mult > max_mult) {
      os.write_bit(1);
      os.write_bits((uint64_t)mult, 3);
      max_mult = mult;
    } else if (nsig == sig && max_mult == mult && float_changed) {
      os.write_bit(1);
      os.write_bits((uint64_t)max_mult, 3);
    } else {
      os.write_bit(0);
    }
  }

  void write_first_value(double v) {
    if (!int_optimized) {
      write_full_float(f2b(v));
      return;
    }
    IntFloat r = convert_to_int_float(v, 0);
    if (r.is_float) {
      os.write_bit(1);  // float mode
      write_full_float(f2b(v));
      is_float = true;
      max_mult = r.mult;
      return;
    }
    os.write_bit(0);  // int mode
    int_val = r.val;
    bool neg_diff = true;
    double val = r.val;
    if (val < 0) {
      neg_diff = false;
      val = -val;
    }
    uint64_t bits = (uint64_t)(int64_t)val;
    int sig = num_sig(bits);
    write_int_sig_mult(sig, r.mult, false);
    write_int_val_diff(bits, neg_diff);
  }

  void write_float_val(uint64_t bits, int mult) {
    if (!is_float) {
      os.write_bit(0);  // update
      os.write_bit(0);  // no repeat
      os.write_bit(1);  // float mode
      write_full_float(bits);
      is_float = true;
      max_mult = mult;
      return;
    }
    if (bits == prev_float_bits) {
      os.write_bit(0);
      os.write_bit(1);  // repeat
      return;
    }
    os.write_bit(1);  // no update
    write_next_float(bits);
  }

  void write_int_val(double val, int mult, bool isf, double val_diff) {
    if (val_diff == 0 && isf == is_float && mult == max_mult) {
      os.write_bit(0);
      os.write_bit(1);  // repeat
      return;
    }
    bool neg = false;
    if (val_diff < 0) {
      neg = true;
      val_diff = -val_diff;
    }
    uint64_t bits = (uint64_t)(int64_t)val_diff;
    int sig = num_sig(bits);
    int new_sig = track_new_sig(sig);
    bool float_changed = isf != is_float;
    if (mult > max_mult || nsig != new_sig || float_changed) {
      os.write_bit(0);  // update
      os.write_bit(0);  // no repeat
      os.write_bit(0);  // int mode
      write_int_sig_mult(new_sig, mult, float_changed);
      write_int_val_diff(bits, neg);
      is_float = false;
    } else {
      os.write_bit(1);  // no update
      write_int_val_diff(bits, neg);
    }
    int_val = val;
  }

  void write_next_value(double v) {
    if (!int_optimized) {
      write_next_float(f2b(v));
      return;
    }
    IntFloat r = convert_to_int_float(v, max_mult);
    double val_diff = 0;
    if (!r.is_float) val_diff = int_val - r.val;
    if (r.is_float || val_diff >= MAX_INT || val_diff <= MIN_INT) {
      write_float_val(f2b(r.val), r.mult);
      return;
    }
    write_int_val(r.val, r.mult, r.is_float, val_diff);
  }

  void encode(int64_t t, double v, int unit) {
    write_time(t, unit);
    if (num_encoded == 0) {
      write_first_value(v);
    } else {
      write_next_value(v);
    }
    num_encoded++;
  }

  // finalized stream (encoder.go:383-418 head+tail)
  std::vector<uint8_t> stream() const {
    std::vector<uint8_t> out;
    if (os.buf.empty()) return out;
    out.assign(os.buf.begin(), os.buf.end() - 1);
    // tail: top pos bits of last byte + EOS marker
    Bits tmp;
    tmp.write_bits((uint64_t)(os.buf.back() >> (8 - os.pos)), os.pos);
    write_marker(tmp, EOS_MARKER);
    out.insert(out.end(), tmp.buf.begin(), tmp.buf.end());
    return out;
  }
};

// ---------- prescan (ReaderIterator walk emitting chunk snapshots) ----------
struct BitReader {
  const uint8_t* data;
  int64_t nbits;
  int64_t pos = 0;

  // byte-wise big-endian extraction (the bit-at-a-time loop was the decode
  // hot spot: up to 64 iterations per read; 1-bit control reads dominate)
  static uint64_t extract(const uint8_t* data, int64_t p, int n) {
    uint64_t v = 0;
    int remaining = n;
    int bit_off = (int)(p & 7);
    if (bit_off) {
      int take = 8 - bit_off;
      if (take > remaining) take = remaining;
      uint8_t byte = data[p >> 3];
      v = (byte >> (8 - bit_off - take)) & ((1u << take) - 1);
      remaining -= take;
      p += take;
    }
    while (remaining >= 8) {
      v = (v << 8) | data[p >> 3];
      remaining -= 8;
      p += 8;
    }
    if (remaining) {
      v = (v << remaining) | (data[p >> 3] >> (8 - remaining));
    }
    return v;
  }

  bool read(int n, uint64_t* out) {
    if (pos + n > nbits) return false;
    if (n == 1) {
      *out = (data[pos >> 3] >> (7 - (pos & 7))) & 1;
      pos++;
      return true;
    }
    *out = extract(data, pos, n);
    pos += n;
    return true;
  }
  bool peek(int n, uint64_t* out) const {
    if (pos + n > nbits) return false;
    *out = extract(data, pos, n);
    return true;
  }
};

int64_t sign_extend(uint64_t v, int n) {
  if (n >= 64) return (int64_t)v;
  uint64_t sign = 1ull << (n - 1);
  return (int64_t)((v ^ sign) - sign);
}

#pragma pack(push, 1)
struct SnapRec {  // matches storage/fs.py SIDE_DTYPE (v2, with flags); 49 bytes
  uint32_t off;
  uint64_t prev_time;
  uint64_t prev_delta;
  uint64_t prev_float_bits;
  uint64_t prev_xor;
  uint64_t int_val;
  uint8_t time_unit;
  uint8_t sig;
  uint8_t mult;
  uint8_t is_float;
  uint8_t flags;  // bit 0: int fast chunk; bit 1: float-mode fast chunk
};
#pragma pack(pop)

struct Iter {
  BitReader r;
  int64_t prev_time = 0, prev_delta = 0;
  int time_unit = 0;
  bool tu_changed = false;
  int markers = 0;  // markers consumed (EOS/annotation/time-unit)
  int annotations = 0;  // annotation markers specifically
  bool done = false, err = false;
  uint64_t prev_float_bits = 0, prev_xor = 0;
  double int_val = 0;
  int mult = 0, sig = 0;
  bool is_float = false;
  bool int_optimized;
  int default_unit;

  bool read_varint_skip() {  // annotation length varint (zigzag) + bytes
    uint64_t shift = 0;
    uint64_t ux = 0;
    for (int i = 0; i < 10; i++) {
      uint64_t b;
      if (!r.read(8, &b)) return false;
      ux |= (b & 0x7f) << shift;
      if (!(b & 0x80)) {
        int64_t x = (int64_t)(ux >> 1);
        if (ux & 1) x = -x - 1;
        int64_t len = x + 1;  // encoder wrote len-1 (timestamp_encoder.go:158)
        if (len <= 0) return false;
        if (r.pos + len * 8 > r.nbits) return false;
        r.pos += len * 8;  // skip annotation payload
        return true;
      }
      shift += 7;
    }
    return false;
  }

  bool read_dod(int64_t* dod_out) {
    // marker peek
    uint64_t peeked;
    if (r.peek(NUM_MARKER_BITS, &peeked) &&
        (peeked >> NUM_MARKER_VALUE_BITS) == MARKER_OPCODE) {
      int marker = (int)(peeked & 3);
      if (marker == EOS_MARKER) {
        r.pos += NUM_MARKER_BITS;
        done = true;
        markers++;
        *dod_out = 0;
        return true;
      } else if (marker == ANNOTATION_MARKER) {
        r.pos += NUM_MARKER_BITS;
        markers++;
        annotations++;
        if (!read_varint_skip()) return false;
        return read_dod(dod_out);
      } else if (marker == TIME_UNIT_MARKER) {
        r.pos += NUM_MARKER_BITS;
        markers++;
        uint64_t tu;
        if (!r.read(8, &tu)) return false;
        if (unit_nanos((int)tu) != 0 && (int)tu != time_unit) tu_changed = true;
        time_unit = (int)tu;
        return read_dod(dod_out);
      }
    }
    if (tu_changed) {
      uint64_t v;
      if (!r.read(64, &v)) return false;
      *dod_out = (int64_t)v;
      return true;
    }
    const Scheme* s = scheme_for_unit(time_unit);
    if (!s) {
      err = true;
      return false;
    }
    uint64_t cb;
    if (!r.read(1, &cb)) return false;
    if (cb == 0) {
      *dod_out = 0;
      return true;
    }
    for (int i = 0; i < 3; i++) {
      uint64_t b;
      if (!r.read(1, &b)) return false;
      cb = (cb << 1) | b;
      if (cb == s->buckets[i].opcode) {
        uint64_t v;
        if (!r.read(s->buckets[i].num_value_bits, &v)) return false;
        *dod_out = sign_extend(v, s->buckets[i].num_value_bits) *
                   unit_nanos(time_unit);
        return true;
      }
    }
    uint64_t v;
    if (!r.read(s->dflt.num_value_bits, &v)) return false;
    *dod_out = sign_extend(v, s->dflt.num_value_bits);
    if (s->dflt.num_value_bits != 64) *dod_out *= unit_nanos(time_unit);
    return true;
  }

  bool read_timestamp(bool first) {
    if (first) {
      uint64_t nt;
      if (!r.read(64, &nt)) return false;
      prev_time = (int64_t)nt;
      int64_t u = unit_nanos(default_unit);
      time_unit = (u != 0 && prev_time % u == 0) ? default_unit : 0;
      int64_t dod;
      if (!read_dod(&dod) || done) return !done ? true : false;
      prev_delta += dod;
      prev_time += prev_delta;
    } else {
      int64_t dod;
      if (!read_dod(&dod)) return false;
      if (done) return false;
      prev_delta += dod;
      prev_time += prev_delta;
    }
    if (tu_changed) {
      prev_delta = 0;
      tu_changed = false;
    }
    return true;
  }

  bool read_full_float() {
    uint64_t v;
    if (!r.read(64, &v)) return false;
    prev_float_bits = v;
    prev_xor = v;
    return true;
  }

  bool read_next_float() {
    uint64_t cb;
    if (!r.read(1, &cb)) return false;
    if (cb == 0) {
      prev_xor = 0;
      return true;
    }
    uint64_t b;
    if (!r.read(1, &b)) return false;
    cb = (cb << 1) | b;
    if (cb == 0x2) {
      int pl = prev_xor ? __builtin_clzll(prev_xor) : 64;
      int pt = prev_xor ? __builtin_ctzll(prev_xor) : 0;
      int nm = 64 - pl - pt;
      uint64_t m;
      if (!r.read(nm, &m)) return false;
      prev_xor = m << pt;
      prev_float_bits ^= prev_xor;
      return true;
    }
    uint64_t packed;
    if (!r.read(12, &packed)) return false;
    int nl = (int)((packed >> 6) & 0x3f);
    int nm = (int)(packed & 0x3f) + 1;
    uint64_t m;
    if (!r.read(nm, &m)) return false;
    int nt = 64 - nl - nm;
    prev_xor = m << nt;
    prev_float_bits ^= prev_xor;
    return true;
  }

  bool read_int_sig_mult() {
    uint64_t b;
    if (!r.read(1, &b)) return false;
    if (b == 1) {
      if (!r.read(1, &b)) return false;
      if (b == 0) {
        sig = 0;
      } else {
        uint64_t s6;
        if (!r.read(6, &s6)) return false;
        sig = (int)s6 + 1;
      }
    }
    if (!r.read(1, &b)) return false;
    if (b == 1) {
      uint64_t m3;
      if (!r.read(3, &m3)) return false;
      mult = (int)m3;
      if (mult > MAX_MULT) {
        err = true;
        return false;
      }
    }
    return true;
  }

  bool read_int_val_diff() {
    uint64_t sb;
    if (!r.read(1, &sb)) return false;
    double sgn = sb == 1 ? 1.0 : -1.0;
    uint64_t d = 0;
    if (sig > 0 && !r.read(sig, &d)) return false;
    int_val += sgn * (double)d;
    return true;
  }

  bool read_value(bool first) {
    if (first) {
      if (!int_optimized) return read_full_float();
      uint64_t b;
      if (!r.read(1, &b)) return false;
      if (b == 1) {
        is_float = true;
        return read_full_float();
      }
      return read_int_sig_mult() && read_int_val_diff();
    }
    if (!int_optimized) return read_next_float();
    uint64_t b;
    if (!r.read(1, &b)) return false;
    if (b == 0) {  // update
      if (!r.read(1, &b)) return false;
      if (b == 1) return true;  // repeat
      if (!r.read(1, &b)) return false;
      if (b == 1) {
        is_float = true;
        return read_full_float();
      }
      if (!(read_int_sig_mult() && read_int_val_diff())) return false;
      is_float = false;
      return true;
    }
    if (is_float) return read_next_float();
    return read_int_val_diff();
  }

  bool next(bool first) {
    if (done || err) return false;
    if (!read_timestamp(first)) return false;
    if (done) return false;
    return read_value(first);
  }
};

}  // namespace

extern "C" {

// Encode one series. Returns byte length written to out (capacity out_cap),
// or -(needed) if out_cap too small, or -1 on error (a point's time unit
// has no delta-of-delta scheme).
int64_t m3tsz_encode_series(const int64_t* times, const double* values,
                            int32_t n, int default_unit, const int32_t* units,
                            int int_optimized, uint8_t* out, int64_t out_cap) {
  if (n <= 0) return 0;
  Encoder enc(times[0], default_unit, int_optimized != 0);
  for (int32_t i = 0; i < n && !enc.err; i++) {
    enc.encode(times[i], values[i], units ? units[i] : default_unit);
  }
  if (enc.err) return -1;
  std::vector<uint8_t> s = enc.stream();
  if ((int64_t)s.size() > out_cap) return -(int64_t)s.size();
  std::memcpy(out, s.data(), s.size());
  return (int64_t)s.size();
}

// Batch encode with threads: lengths[i] points per series, times/values are
// concatenated. out_offsets[n_series+1] receives stream offsets into out.
// Returns total bytes, or -(needed) if out_cap too small, or -1 on error (the
// default unit has no delta-of-delta scheme; a non-empty stream is at least
// 9 bytes, so -1 never means a size).
int64_t m3tsz_encode_batch(const int64_t* times, const double* values,
                           const int32_t* lengths, int32_t n_series,
                           int default_unit, int int_optimized, uint8_t* out,
                           int64_t out_cap, int64_t* out_offsets,
                           int32_t n_threads) {
  std::vector<std::vector<uint8_t>> streams(n_series);
  std::vector<int64_t> starts(n_series + 1, 0);
  for (int32_t i = 0; i < n_series; i++) starts[i + 1] = starts[i] + lengths[i];
  std::atomic<bool> failed{false};

  auto work = [&](int32_t lo, int32_t hi) {
    for (int32_t i = lo; i < hi; i++) {
      int32_t n = lengths[i];
      if (n <= 0) continue;
      const int64_t* t = times + starts[i];
      const double* v = values + starts[i];
      Encoder enc(t[0], default_unit, int_optimized != 0);
      for (int32_t j = 0; j < n && !enc.err; j++) enc.encode(t[j], v[j], default_unit);
      if (enc.err) {
        failed.store(true, std::memory_order_relaxed);
        return;
      }
      streams[i] = enc.stream();
    }
  };
  if (n_threads <= 1 || n_series < 4) {
    work(0, n_series);
  } else {
    int32_t nt = n_threads;
    std::vector<std::thread> ts;
    int32_t per = (n_series + nt - 1) / nt;
    for (int32_t k = 0; k < nt; k++) {
      int32_t lo = k * per, hi = std::min(n_series, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
  if (failed.load()) return -1;

  int64_t total = 0;
  for (auto& s : streams) total += (int64_t)s.size();
  if (total > out_cap) return -total;
  int64_t off = 0;
  for (int32_t i = 0; i < n_series; i++) {
    out_offsets[i] = off;
    std::memcpy(out + off, streams[i].data(), streams[i].size());
    off += (int64_t)streams[i].size();
  }
  out_offsets[n_series] = off;
  return total;
}

// Prescan one stream: emit a SnapRec every k records. Returns snapshot count
// (clamped at max_snaps), or -1 on decode error before the first snapshot.
int32_t m3tsz_prescan(const uint8_t* data, int64_t len_bytes, int32_t k,
                      int default_unit, int int_optimized, SnapRec* out,
                      int32_t max_snaps) {
  Iter it;
  it.r.data = data;
  it.r.nbits = len_bytes * 8;
  it.int_optimized = int_optimized != 0;
  it.default_unit = default_unit;
  int32_t nsnap = 0;
  int64_t nrec = 0;
  // fast-chunk classification mirrors ops/chunked.snapshot_stream
  bool chunk_fast = true;
  bool chunk_fast_float = true;   // flags bit 1: float-mode fast chunk
  bool chunk_start_float = false;
  int chunk_recs = 0;
  // initial unit for the first snapshot (mirrors snapshot_stream)
  while (true) {
    SnapRec pending;
    bool has_pending = false;
    if (nrec % k == 0 && nsnap < max_snaps) {
      if (nsnap > 0) {
        // previous chunk completed all k records: seal its flags
        uint8_t fl = (chunk_fast && chunk_recs == k) ? 1 : 0;
        if (chunk_fast_float && chunk_start_float && chunk_recs == k) fl |= 2;
        out[nsnap - 1].flags = fl;
      }
      chunk_fast = true;
      chunk_fast_float = true;
      chunk_start_float = it.is_float && it.int_optimized;
      chunk_recs = 0;
      pending.off = (uint32_t)it.r.pos;
      pending.prev_time = (uint64_t)it.prev_time;
      pending.prev_delta = (uint64_t)it.prev_delta;
      pending.prev_float_bits = it.prev_float_bits;
      pending.prev_xor = it.prev_xor;
      pending.int_val = (uint64_t)(int64_t)it.int_val;
      int unit = it.time_unit;
      if (nrec == 0 && len_bytes >= 8) {
        uint64_t nt = 0;
        for (int i = 0; i < 8; i++) nt = (nt << 8) | data[i];
        int64_t u = unit_nanos(default_unit);
        unit = (u != 0 && (int64_t)nt % u == 0) ? default_unit : 0;
      }
      pending.time_unit = (uint8_t)unit;
      pending.sig = (uint8_t)it.sig;
      pending.mult = (uint8_t)it.mult;
      pending.is_float = it.is_float ? 1 : 0;
      pending.flags = 0;
      has_pending = true;
    }
    int markers_before = it.markers;
    if (!it.next(nrec == 0)) break;
    if (has_pending) out[nsnap++] = pending;
    nrec++;
    chunk_recs++;
    bool marker_seen = it.markers != markers_before;
    bool unit_ok = (it.time_unit == 1 || it.time_unit == 2);
    if (marker_seen || it.is_float || !unit_ok || !it.int_optimized ||
        it.sig > 31 || std::fabs(it.int_val) > 2147483647.0) {
      chunk_fast = false;
    }
    if (marker_seen || !it.is_float || !unit_ok || !it.int_optimized) {
      chunk_fast_float = false;
    }
    if (it.done || it.err) break;
  }
  if (nsnap > 0 && chunk_recs > 0) {
    uint8_t fl = (chunk_fast && chunk_recs == k) ? 1 : 0;
    if (chunk_fast_float && chunk_start_float && chunk_recs == k) fl |= 2;
    out[nsnap - 1].flags = fl;
  }
  return nsnap;
}

// Decode one stream into (times, values); returns count, or -1 on a real
// decode error (EOF-at-end is stream end, matching decode() in
// codec/m3tsz.py and the Go iterator's io.EOF handling,
// src/dbnode/encoding/m3tsz/iterator.go:64).
static int64_t decode_one(const uint8_t* data, int64_t len_bytes,
                          int default_unit, int int_optimized, int64_t cap,
                          int64_t* out_times, double* out_values,
                          uint8_t* out_units, uint8_t* flags) {
  *flags = 0;
  if (len_bytes <= 0) return 0;
  Iter it;  // the reader state machine (shared with prescan)
  it.r.data = data;
  it.r.pos = 0;
  it.r.nbits = len_bytes * 8;
  it.int_optimized = int_optimized != 0;
  it.default_unit = default_unit;
  static const double MULT10[MAX_MULT + 1] = {1.0,    10.0,    100.0,  1000.0,
                                              10000.0, 100000.0, 1000000.0};
  int64_t n = 0;
  while (it.next(n == 0)) {
    if (n >= cap) return -2;  // caller's capacity too small
    out_times[n] = it.prev_time;
    out_units[n] = (uint8_t)it.time_unit;
    double v;
    if (!it.int_optimized || it.is_float) {
      uint64_t b = it.prev_float_bits;
      double d;
      std::memcpy(&d, &b, 8);
      v = d;
    } else {
      v = it.mult <= MAX_MULT ? it.int_val / MULT10[it.mult] : it.int_val;
    }
    out_values[n] = v;
    n++;
    if (it.done || it.err) break;
  }
  if (it.annotations > 0) *flags |= 1;  // caller re-decodes via the
                                        // annotation-capable path
  return it.err ? -1 : n;
}

// Batch decode with threads: streams concatenated; offsets[n+1]. Each
// series writes up to cap points at out_{times,values,units} + i*cap;
// counts[i] receives the point count (-1 decode error, -2 cap overflow);
// out_flags[i] bit0 = stream carries annotations. Returns the number of
// series that failed.
int32_t m3tsz_decode_batch(const uint8_t* data, const int64_t* offsets,
                           int32_t n_series, int default_unit,
                           int int_optimized, int64_t cap, int64_t* out_times,
                           double* out_values, uint8_t* out_units,
                           int64_t* out_counts, uint8_t* out_flags,
                           int32_t n_threads) {
  std::atomic<int32_t> failed{0};
  auto work = [&](int32_t lo, int32_t hi) {
    for (int32_t i = lo; i < hi; i++) {
      int64_t r = decode_one(data + offsets[i], offsets[i + 1] - offsets[i],
                             default_unit, int_optimized, cap,
                             out_times + (int64_t)i * cap,
                             out_values + (int64_t)i * cap,
                             out_units + (int64_t)i * cap, out_flags + i);
      out_counts[i] = r;
      if (r < 0) failed.fetch_add(1, std::memory_order_relaxed);
    }
  };
  if (n_threads <= 1 || n_series < 4) {
    work(0, n_series);
  } else {
    std::vector<std::thread> ts;
    int32_t per = (n_series + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
      int32_t lo = t * per, hi = std::min(n_series, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
  return failed.load();
}

// Batch prescan with threads. data: concatenated streams; offsets[n+1].
// snaps_out: SnapRec buffer; snap_counts[i] receives per-series count;
// per-series snapshot capacity is max_snaps_per. Returns 0.
int32_t m3tsz_prescan_batch(const uint8_t* data, const int64_t* offsets,
                            int32_t n_series, int32_t k, int default_unit,
                            int int_optimized, SnapRec* snaps_out,
                            int32_t max_snaps_per, int32_t* snap_counts,
                            int32_t n_threads) {
  auto work = [&](int32_t lo, int32_t hi) {
    for (int32_t i = lo; i < hi; i++) {
      snap_counts[i] = m3tsz_prescan(
          data + offsets[i], offsets[i + 1] - offsets[i], k, default_unit,
          int_optimized, snaps_out + (int64_t)i * max_snaps_per, max_snaps_per);
    }
  };
  if (n_threads <= 1 || n_series < 4) {
    work(0, n_series);
  } else {
    std::vector<std::thread> ts;
    int32_t per = (n_series + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
      int32_t lo = t * per, hi = std::min(n_series, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
  return 0;
}

// ---------------------------------------------------------------------------
// Aggregator host densify (aggregation/{counter,timer,gauge}.go hot loop):
// fused window bucketing + dense [G, P] pack feeding the device reduction
// kernels (aggregator/kernels.py aggregate_dense). The numpy path
// pays ~3.5s at 60M samples in gather/scatter chains; these single-purpose
// passes are memory-bound.

// Fused window keys: key = id * n_windows + clamp(w), torder = in-window
// nanos offset downshifted so it always fits i32. The shift is derived from
// the DATA's max offset (two passes), exactly like the numpy fallback
// (kernels.py window_keys): clamped out-of-range samples carry offsets far
// beyond the resolution, so a resolution-derived shift would overflow i32
// and invert their `last` ordering. Returns 0, or -1 (torder unwritten)
// when a key id * n_windows + w falls outside [0, INT32_MAX]: an int32 key
// would wrap, and m3agg_count would index with it. Callers whose grid
// (n_series x n_windows) passes INT32_MAX take the int64-keyed numpy path.
int32_t m3agg_window_keys(const int64_t* ids, const int64_t* times, int64_t n,
                          int64_t window0, int64_t resolution, int32_t n_windows,
                          int32_t* out_keys, int32_t* out_torder,
                          int32_t n_threads) {
  auto run = [&](auto body) {
    if (n_threads <= 1 || n < (1 << 16)) {
      body(0, 0, n);
      return 1;
    }
    std::vector<std::thread> ts;
    int64_t per = (n + n_threads - 1) / n_threads;
    int32_t used = 0;
    for (int32_t t = 0; t < n_threads; t++) {
      int64_t lo = t * per, hi = std::min(n, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(body, t, lo, hi);
      used++;
    }
    for (auto& th : ts) th.join();
    return (int)used;
  };

  auto window_of = [&](int64_t t) {
    int64_t w = (t - window0) / resolution;
    // C++ division truncates toward zero; match python floor division for
    // pre-window0 samples before clamping
    if (w * resolution > t - window0) w--;
    if (w < 0) w = 0;
    if (w >= n_windows) w = n_windows - 1;
    return w;
  };

  std::vector<int64_t> tmax(std::max(n_threads, 1), 0);
  std::atomic<bool> wraps{false};
  run([&](int32_t tid, int64_t lo, int64_t hi) {
    int64_t mx = 0;
    bool out_of_range = false;
    for (int64_t i = lo; i < hi; i++) {
      int64_t w = window_of(times[i]);
      int64_t key = ids[i] * n_windows + w;
      out_of_range |= key < 0 || key > std::numeric_limits<int32_t>::max();
      out_keys[i] = (int32_t)key;
      int64_t off = times[i] - (window0 + w * resolution);
      if (off > mx) mx = off;
    }
    tmax[tid] = mx;
    if (out_of_range) wraps.store(true, std::memory_order_relaxed);
  });
  if (wraps.load()) return -1;
  int64_t maxoff = 0;
  for (int64_t m : tmax) maxoff = std::max(maxoff, m);
  int shift = 0;
  while ((maxoff >> shift) > 0x3FFFFFFF) shift++;

  run([&](int32_t, int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      int64_t w = window_of(times[i]);
      out_torder[i] =
          (int32_t)((times[i] - (window0 + w * resolution)) >> shift);
    }
  });
  return 0;
}

// Histogram per group (atomic adds; low contention — P entries per group).
// Returns the max group count (the dense P dimension), or -1 when a key lies
// outside [0, n_groups) (it is not counted).
int32_t m3agg_count(const int32_t* keys, int64_t n, int64_t n_groups,
                    int32_t* counts, int32_t n_threads) {
  auto* acounts = reinterpret_cast<std::atomic<int32_t>*>(counts);
  std::atomic<bool> outside{false};
  auto work = [&](int64_t lo, int64_t hi) {
    for (int64_t i = lo; i < hi; i++) {
      if (keys[i] < 0 || keys[i] >= n_groups) {
        outside.store(true, std::memory_order_relaxed);
        continue;
      }
      acounts[keys[i]].fetch_add(1, std::memory_order_relaxed);
    }
  };
  if (n_threads <= 1 || n < (1 << 16)) {
    work(0, n);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (n + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
      int64_t lo = t * per, hi = std::min(n, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
  if (outside.load()) return -1;
  int32_t mx = 0;
  for (int64_t g = 0; g < n_groups; g++) mx = std::max(mx, counts[g]);
  return mx;
}

// Dense pack: out_vals[g*P + c] = values[i] in ARRIVAL ORDER within each
// group (first-arrival tie semantics for `last`, gauge.go:57-66). Threads
// shard the GROUP range and each scans all keys, so writes are disjoint and
// order is exact — no atomics, no cross-thread interleaving. Slots past a
// group's count are NaN / 0.
void m3agg_pack(const int32_t* keys, const float* values,
                const int32_t* torder, int64_t n, int64_t n_groups, int32_t P,
                const int32_t* counts, float* out_vals, int32_t* out_tor,
                int32_t n_threads) {
  float nanf = std::numeric_limits<float>::quiet_NaN();
  auto work = [&](int64_t glo, int64_t ghi) {
    std::vector<int32_t> cursor(ghi - glo, 0);
    for (int64_t g = glo; g < ghi; g++) {
      int64_t base = g * P;
      for (int32_t c = counts[g]; c < P; c++) {
        out_vals[base + c] = nanf;
        out_tor[base + c] = 0;
      }
    }
    for (int64_t i = 0; i < n; i++) {
      int64_t g = keys[i];
      if (g < glo || g >= ghi) continue;
      int32_t c = cursor[g - glo]++;
      out_vals[g * P + c] = values[i];
      out_tor[g * P + c] = torder[i];
    }
  };
  if (n_threads <= 1 || n < (1 << 16)) {
    work(0, n_groups);
  } else {
    std::vector<std::thread> ts;
    int64_t per = (n_groups + n_threads - 1) / n_threads;
    for (int32_t t = 0; t < n_threads; t++) {
      int64_t lo = t * per, hi = std::min(n_groups, lo + per);
      if (lo >= hi) break;
      ts.emplace_back(work, lo, hi);
    }
    for (auto& th : ts) th.join();
  }
}

// ---------------------------------------------------------------------------
// murmur3-32 batch shard routing (sharding/shardset.go:149 DefaultHashFn =
// murmur3.Sum32(id) % numShards) — exact parity with utils/hash.py.

static inline uint32_t rotl32(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

static uint32_t murmur3_32(const uint8_t* data, int64_t n, uint32_t seed) {
  uint32_t h = seed;
  int64_t nblocks = n / 4;
  for (int64_t i = 0; i < nblocks; i++) {
    uint32_t k;
    std::memcpy(&k, data + i * 4, 4);  // little-endian load
    k *= 0xCC9E2D51u;
    k = rotl32(k, 15);
    k *= 0x1B873593u;
    h ^= k;
    h = rotl32(h, 13);
    h = h * 5 + 0xE6546B64u;
  }
  const uint8_t* tail = data + nblocks * 4;
  uint32_t k = 0;
  switch (n & 3) {
    case 3: k ^= (uint32_t)tail[2] << 16; [[fallthrough]];
    case 2: k ^= (uint32_t)tail[1] << 8; [[fallthrough]];
    case 1:
      k ^= tail[0];
      k *= 0xCC9E2D51u;
      k = rotl32(k, 15);
      k *= 0x1B873593u;
      h ^= k;
  }
  h ^= (uint32_t)n;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h;
}

// ids concatenated; offsets[n+1]; out[i] = murmur3(id_i) % num_shards.
void m3hash_shards(const uint8_t* ids, const int64_t* offsets, int32_t n,
                   int32_t num_shards, int32_t* out) {
  for (int32_t i = 0; i < n; i++) {
    out[i] = (int32_t)(murmur3_32(ids + offsets[i],
                                  offsets[i + 1] - offsets[i], 0) %
                       (uint32_t)num_shards);
  }
}

}  // extern "C"
