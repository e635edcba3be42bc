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
//   '10'; an XOR x whose leading and trailing zeros cover the previous
//   nonzero XOR's writes '110' and the bits between the previous XOR's
//   zeros, else '111', 6 bits of leading zeros, 6 of meaningful bits - 1,
//   and the meaningful bits;
// - then EOS: 0x400 in 11 bits.
// C++ shifts by the width or more are undefined where XLA's give 0, and
// clz/ctz of 0 are 64 in the reference: each such place is written out.
//
// Design. A thread walks one lane's records in order: it carries the
// tracker, the previous value's bits and the previous XOR, appends each
// slot to a 64-bit accumulator and stores whole words into its own row (no
// atomics, no cumsum, no scatter). The rows are zeroed by one memset first.
// Reads are coalesced (record-major planes: neighbouring threads read
// neighbouring lanes); each thread's stores go to its own row, W words
// apart from its neighbours', and merge in L2. Bound: bytes -- the records
// read once, the [M, W] rows written once, zeros included, and the chunk
// tables. Making it fast (a warp a lane with a shuffle prefix sum of the
// slot lengths, coalesced stores) is later work.
//
// No float arithmetic touches the values, only their bits: -fmad=false as
// the common flags have it, no -ftz needed.

#include <cstddef>
#include <cstdint>
#include <cstring>

#ifdef __CUDACC__
#include <cuda_runtime.h>
#define M3_HD __host__ __device__ __forceinline__
#else
#define M3_HD inline
#endif

namespace {

constexpr int kThreads = 128;
constexpr uint32_t kEos = 0x400;
constexpr int kEosBits = 11;
constexpr int kSigDiffThreshold = 3;
constexpr int kSigRepeatThreshold = 5;

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

// MSB-first bit writer into one lane's row of words.
struct BitWriter {
  uint32_t* row;
  uint64_t acc;   // the last `nacc` bits written and not yet stored
  int nacc;       // < 32 between appends
  int64_t pos;    // bits written
  int64_t word;   // next word to store

  M3_HD void put(uint32_t value, int len) {
    if (len <= 0) return;
    const uint64_t v = len >= 32 ? (uint64_t)value : (uint64_t)value & ((1ull << len) - 1);
    acc = (acc << len) | v;
    nacc += len;
    pos += len;
    if (nacc >= 32) {
      nacc -= 32;
      row[word++] = (uint32_t)(acc >> nacc);
    }
  }

  M3_HD void finish() {
    if (nacc > 0) row[word++] = (uint32_t)(acc << (32 - nacc));
    nacc = 0;
  }
};

// One lane, records 0 .. n-1, then its chunk rows past n and the EOS.
M3_HD void encode_lane(int64_t m, int64_t M, const int64_t* t0, const int32_t* counts,
                       const uint8_t* float_lane, const int32_t* dod, const int64_t* vbits,
                       int k, int64_t W, int64_t C, uint32_t* words, int32_t* total_bits,
                       int32_t* chunk_offs, int32_t* chunk_sigs) {
  const int n = counts[m];
  const bool is_float = float_lane[m] != 0;
  BitWriter w{words + m * W, 0, 0, 0, 0};
  int ns = 0, ch = 0, nl = 0;  // the int tracker
  int64_t prev_iv = 0;
  uint64_t prev_vb = 0, pxr = 0;  // previous value's bits, previous nonzero XOR
  for (int j = 0; j < n; ++j) {
    if (j % k == 0) {
      chunk_offs[(j / k) * M + m] = (int32_t)w.pos;
      chunk_sigs[(j / k) * M + m] = ns;
    }
    if (j == 0) {
      const uint64_t t = (uint64_t)t0[m];
      w.put((uint32_t)(t >> 32), 32);
      w.put((uint32_t)t, 32);
    }
    const int32_t dd = dod[(int64_t)j * M + m];
    if (dd == 0) {
      w.put(0, 1);
    } else if (dd >= -64 && dd <= 63) {
      w.put(2, 2);
      w.put((uint32_t)dd, 7);
    } else if (dd >= -256 && dd <= 255) {
      w.put(6, 3);
      w.put((uint32_t)dd, 9);
    } else if (dd >= -2048 && dd <= 2047) {
      w.put(14, 4);
      w.put((uint32_t)dd, 12);
    } else {
      w.put(15, 4);
      w.put((uint32_t)dd, 32);
    }
    const int64_t raw = vbits[(int64_t)j * M + m];
    if (is_float) {
      const uint64_t vb = (uint64_t)raw;
      if (j == 0) {
        w.put(1, 1);
        w.put((uint32_t)(vb >> 32), 32);
        w.put((uint32_t)vb, 32);
        pxr = vb;
      } else {
        const uint64_t x = vb ^ prev_vb;
        if (x == 0) {
          w.put(1, 2);
        } else {
          const int pl = clz64(pxr), pt = ctz64(pxr);
          const int cl = clz64(x), ct = ctz64(x);
          int flen;
          uint64_t pay;
          if (cl >= pl && ct >= pt) {  // pxr != 0 here, so pt <= 63
            w.put(6, 3);
            flen = 64 - pl - pt;
            pay = x >> pt;
          } else {
            const int nm = 64 - cl - ct;
            w.put(7, 3);
            w.put((uint32_t)((cl << 6) | (nm - 1)), 12);
            flen = nm;
            pay = x >> ct;  // x != 0, so ct <= 63
          }
          w.put((uint32_t)(pay >> 32), flen > 32 ? flen - 32 : 0);
          w.put((uint32_t)pay, flen < 32 ? flen : 32);
          pxr = x;
        }
      }
      prev_vb = vb;
      continue;
    }
    const int64_t d = j == 0 ? raw : prev_iv - raw;
    prev_iv = raw;
    const uint32_t absval = (uint32_t)(d < 0 ? -d : d);
    const int sig = 32 - clz32(absval);
    if (j == 0) {
      // write_int_sig(sig) only, counters untouched; the width is sig
      ns = sig;
      w.put(0, 1);
      if (sig > 0) w.put(0x180u | ((uint32_t)(sig - 1) << 1), 9);
      else w.put(0, 2);
      const uint32_t neg = raw >= 0 ? 1u : 0u;
      w.put((uint32_t)(((uint64_t)neg << sig) | absval), 1 + sig);
      continue;
    }
    if (d == 0) {  // a repeat: the tracker does not move
      w.put(1, 2);
      continue;
    }
    const int before = ns;
    if (sig > ns) {
      ns = sig;
    } else if (ns - sig >= kSigDiffThreshold) {
      ch = nl == 0 ? sig : (ch > sig ? ch : sig);
      ++nl;
      if (nl >= kSigRepeatThreshold) {
        ns = ch;
        nl = 0;
      }
    } else {
      nl = 0;
    }
    if (ns != before) {
      w.put(0, 3);
      w.put(0x180u | ((uint32_t)(ns - 1) << 1), 9);
    } else {
      w.put(1, 1);
    }
    const uint32_t neg = d < 0 ? 1u : 0u;
    w.put((uint32_t)(((uint64_t)neg << ns) | absval), 1 + ns);
  }
  for (int64_t c = (n + k - 1) / k; c < C; ++c) {
    chunk_offs[c * M + m] = (int32_t)w.pos;
    chunk_sigs[c * M + m] = ns;
  }
  w.put(kEos, kEosBits);
  total_bits[m] = (int32_t)w.pos;
  w.finish();
}

#ifdef __CUDACC__
__global__ void __launch_bounds__(kThreads)
    encode_kernel(const int64_t* t0, const int32_t* counts, const uint8_t* float_lane,
                  const int32_t* dod, const int64_t* vbits, int64_t M, int k, int64_t W,
                  int64_t C, uint32_t* words, int32_t* total_bits, int32_t* chunk_offs,
                  int32_t* chunk_sigs) {
  const int64_t m = (int64_t)blockIdx.x * kThreads + threadIdx.x;
  if (m >= M) return;
  encode_lane(m, M, t0, counts, float_lane, dod, vbits, k, W, C, words, total_bits, chunk_offs,
              chunk_sigs);
}
#endif

}  // namespace

#ifdef __CUDACC__

// B-4: the planes above (contiguous, on the card), M lanes, T records, k
// records a chunk, W words a row, C = ceil(T / k) chunk rows -> words
// (int32 [M, W]), total_bits (int32 [M]), chunk_offs and chunk_sigs
// (int32 [C, M]). Returns the CUDA error of the memset or the launch, or -1
// for arguments out of range.
extern "C" int m3_encode_lanes(const int64_t* t0, const int32_t* counts, const uint8_t* float_lane,
                               const int32_t* dod, const int64_t* vbits, int64_t M, int64_t T,
                               int k, int64_t W, int64_t C, int32_t* words, int32_t* total_bits,
                               int32_t* chunk_offs, int32_t* chunk_sigs, void* stream) {
  if (M < 0 || T < 1 || k < 1 || W < 1 || C != (T + k - 1) / k) return -1;
  if (M == 0) return 0;
  const cudaStream_t s = (cudaStream_t)stream;
  cudaError_t e = cudaMemsetAsync(words, 0, (size_t)M * (size_t)W * sizeof(int32_t), s);
  if (e != cudaSuccess) return (int)e;
  const unsigned grid = (unsigned)((M + kThreads - 1) / kThreads);
  encode_kernel<<<grid, kThreads, 0, s>>>(t0, counts, float_lane, dod, vbits, M, k, W, C,
                                          (uint32_t*)words, total_bits, chunk_offs, chunk_sigs);
  return (int)cudaGetLastError();
}

#else  // host C++ build of the same walk, one lane after the other

extern "C" int m3_encode_lanes_host(const int64_t* t0, const int32_t* counts,
                                    const uint8_t* float_lane, const int32_t* dod,
                                    const int64_t* vbits, int64_t M, int64_t T, int k, int64_t W,
                                    int64_t C, int32_t* words, int32_t* total_bits,
                                    int32_t* chunk_offs, int32_t* chunk_sigs) {
  if (M < 0 || T < 1 || k < 1 || W < 1 || C != (T + k - 1) / k) return -1;
  std::memset(words, 0, (size_t)M * (size_t)W * sizeof(int32_t));
  for (int64_t m = 0; m < M; ++m)
    encode_lane(m, M, t0, counts, float_lane, dod, vbits, k, W, C, (uint32_t*)words, total_bits,
                chunk_offs, chunk_sigs);
  return 0;
}

#endif
