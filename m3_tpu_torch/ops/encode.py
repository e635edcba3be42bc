"""Batched M3TSZ encode on the card: the write path's kernel B-4.

Port of ``m3_tpu/ops/encode.py``. A sealing block's lanes are encoded on
the device, so that a flush's streams are born as resident-pool pages
(``resident/pool.admit_block_device``) instead of host-encoded bytes
uploaded again. ``codec/m3tsz.py`` stays the oracle: for every lane the
encoder takes, its bytes are those of the host encoder, and every lane it
cannot express (annotations, time-unit changes, starts or times that are
not whole seconds, int/float mode mixing, deltas past int32) is encoded by
the host codec at seal. Correctness never depends on the classifier, only
throughput does.

- ``classify_lane`` (one lane) and ``classify_lanes`` (a batch, vectorised)
  gate each lane INT (every value takes ``convert_to_int_float``'s quick
  path and every value and delta fits int32) or FLOAT (every value probes
  float: the stream is XOR records after the first).
- ``encode_inputs`` (``pack_lanes`` on the host, then ``upload_lanes``)
  packs a batch with no loop over the lanes' points: one concatenate of the
  lanes, then record-major planes [T_pad, M] (T_pad
  the reference's power-of-two bucket): the delta-of-delta in seconds
  (int32) and each value's bits (int64: the value as an integer for INT
  lanes, its IEEE-754 bits for FLOAT lanes), with each lane's first time
  (int64 nanos), its record count and its kind. The planes cross to the
  device in one copy each.
- ``encode_planes`` runs kernel B-4 (``csrc/encode.cu``) for CUDA planes
  and its plain PyTorch twin ``encode_reference`` for CPU planes. Both give
  ``words`` [M, W] (int32 holding the big-endian u32 words of each stream,
  the row zero past its end), ``total_bits`` [M], and ``chunk_offs`` and
  ``chunk_sigs`` [C, M] (the bit offset and the int tracker's significant
  bits before every K-th record; rows past a lane's last record hold the
  offset before its EOS and the tracker's last state), bit for bit those of
  ``m3_tpu.ops.encode.encode_lanes``.

The twin computes what the reference's XLA program computes, the same way:
up to 8 slots of <= 32 bits a record (first time hi/lo, dod opcode, dod
value, value control, header, value hi, value lo), the int
significant-bits hysteresis as a loop over the records vectorised across
lanes, an exclusive cumsum of the slot lengths for the offsets, and two
scatter-adds a slot into big-endian words (slots never share a bit, so add
is or). Every unsigned word is carried in int64 and masked, since torch on
the CPU has no uint32 shifts. The kernel runs a lane in one warp instead,
32 records a step, their offsets by a shuffle prefix sum (see the note in
``csrc/encode.cu``).
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import device_guard, resolve_device
from ._build import launch_error, load_library

NANOS_PER_SECOND = 1_000_000_000
I32_MAX = 2_147_483_647
CHUNK_K_DEFAULT = 32

# int-mode significant-bit hysteresis (codec/m3tsz.py IntSigBitsTracker)
_SIG_DIFF_THRESHOLD = 3
_SIG_REPEAT_THRESHOLD = 5

KIND_NONE = 0  # host-codec fallback lane
KIND_INT = 1
KIND_FLOAT = 2

_SLOTS = 8  # emission slots a record, each <= 32 bits
# worst-case record widths (bits): rec0 float 65+1+64; later float
# 36+3+12+64; later int 36+3+9+33 -- float dominates
_REC0_BITS = 130
_REC_BITS = 115
_EOS_BITS = 11
_EOS = 0x400  # 9-bit opcode 0x100 + 2-bit value 0
_M32 = 0xFFFFFFFF

# Launches of kernel B-4, counted by its wrapper where it launches.
LAUNCHES = {"encode": 0}


def probe_is_float(v: np.ndarray) -> np.ndarray:
    """Vectorized ``convert_to_int_float(v, 0)[2]``: True where the host
    probe keeps the value in float mode. Bit-exact with the scalar probe
    (same modf/nextafter ladder, mult 0..6, MAX_OPT_INT cutoff); the
    ``nextafter`` tests run only where the fraction is below 0.1 or above
    0.9, the only places they can decide."""
    v = np.asarray(v, np.float64)
    frac, _ = np.modf(v)
    # quick path: already an int and below float64(MaxInt64)
    decided_int = (v < float(2**63)) & (frac == 0)
    val = np.abs(v)
    for _ in range(7):  # mult = 0..MAX_MULT
        active = ~decided_int & (val < 10.0**13)
        if not active.any():
            break
        frac, i = np.modf(val)
        hit = frac == 0
        low = np.nonzero(active & (frac < 0.1) & ~hit)[0]
        hit[low] = np.nextafter(val[low], 0.0) <= i[low]
        high = np.nonzero(active & (frac > 0.9))[0]
        hit[high] = np.nextafter(val[high], i[high] + 1.0) >= i[high] + 1.0
        decided_int |= active & hit
        val = np.where(active, val * 10.0, val)
    return ~decided_int


class LaneClass(NamedTuple):
    kind: int  # KIND_NONE / KIND_INT / KIND_FLOAT
    reason: str  # why a lane fell back (counter labels / debugging)


def _dod_seconds(dd: np.ndarray) -> np.ndarray:
    """Delta-of-delta nanos -> seconds, truncated toward zero."""
    return np.where(dd >= 0, dd // NANOS_PER_SECOND, -((-dd) // NANOS_PER_SECOND))


def classify_lane(t: np.ndarray, v: np.ndarray, u: np.ndarray) -> LaneClass:
    """Gate one merged lane (times int64 nanos, values float64, unit
    ints) for the device encoder. Conservative: anything the kernel
    cannot reproduce BIT-EXACTLY against codec/m3tsz.py is KIND_NONE."""
    n = len(t)
    if n == 0:
        return LaneClass(KIND_NONE, "empty")
    if not (np.asarray(u) == 1).all():  # Unit.SECOND only
        return LaneClass(KIND_NONE, "unit")
    t = np.asarray(t, np.int64)
    if t[0] < 0 or (t % NANOS_PER_SECOND != 0).any():
        # an unaligned START makes initial_time_unit NONE (the first record
        # then emits a time-unit marker the kernel does not speak); an
        # unaligned LATER timestamp makes the dod normalization lossy
        return LaneClass(KIND_NONE, "unaligned")
    if n > 1 and not (t[1:] > t[:-1]).all():
        return LaneClass(KIND_NONE, "unsorted")
    deltas = np.concatenate([np.zeros(1, np.int64), np.diff(t)])
    dd = deltas - np.concatenate([np.zeros(1, np.int64), deltas[:-1]])
    if (np.abs(_dod_seconds(dd)) > I32_MAX).any():
        return LaneClass(KIND_NONE, "dod_overflow")
    v = np.asarray(v, np.float64)
    frac, _ = np.modf(v)
    quick_int = (v < float(2**63)) & (frac == 0)
    if quick_int.all():
        with np.errstate(invalid="ignore"):
            if not (np.abs(v) <= I32_MAX).all():
                return LaneClass(KIND_NONE, "int_overflow")
        iv = v.astype(np.int64)
        if n > 1 and (np.abs(np.diff(iv)) > I32_MAX).any():
            return LaneClass(KIND_NONE, "diff_overflow")
        return LaneClass(KIND_INT, "")
    if probe_is_float(v).all():
        return LaneClass(KIND_FLOAT, "")
    return LaneClass(KIND_NONE, "mixed_mode")


def classify_lanes(times: np.ndarray, values: np.ndarray, units: np.ndarray,
                   counts: np.ndarray) -> np.ndarray:
    """``classify_lane(...).kind`` of every lane of a batch at once: the
    lanes laid end to end (``counts[i]`` points of lane i) -> int8[L]."""
    counts = np.asarray(counts, np.int64)
    L = len(counts)
    kinds = np.zeros(L, np.int8)
    live = counts > 0
    if not live.any():
        return kinds
    t = np.asarray(times, np.int64)
    v = np.asarray(values, np.float64)
    u = np.asarray(units)
    starts = np.cumsum(counts) - counts
    first = np.zeros(len(t), bool)
    first[starts[live]] = True
    seg = starts[live]

    def any_in(flags: np.ndarray) -> np.ndarray:
        out = np.zeros(L, bool)
        out[live] = np.logical_or.reduceat(flags, seg)
        return out

    def all_in(flags: np.ndarray) -> np.ndarray:
        out = np.zeros(L, bool)
        out[live] = np.logical_and.reduceat(flags, seg)
        return out

    prev_t = np.empty_like(t)
    prev_t[1:] = t[:-1]
    prev_t[first] = 0
    deltas = np.where(first, 0, t - prev_t)
    prev_d = np.empty_like(deltas)
    prev_d[1:] = deltas[:-1]
    prev_d[first] = 0
    dd = deltas - prev_d
    neg_start = np.zeros(L, bool)
    neg_start[live] = t[seg] < 0
    bad = (~live | neg_start | any_in(u != 1) | any_in(t % NANOS_PER_SECOND != 0)
           | any_in(~first & (t <= prev_t)) | any_in(np.abs(_dod_seconds(dd)) > I32_MAX))
    frac, _ = np.modf(v)
    quick_int = (v < float(2**63)) & (frac == 0)
    int_lane = all_in(quick_int)
    with np.errstate(invalid="ignore"):
        fits = np.abs(v) <= I32_MAX
        iv = np.where(quick_int & fits, v, 0.0).astype(np.int64)
    prev_iv = np.empty_like(iv)
    prev_iv[1:] = iv[:-1]
    prev_iv[first] = iv[first]
    int_ok = all_in(fits) & ~any_in(np.abs(iv - prev_iv) > I32_MAX)
    # the probe only where a lane is not int (an int lane never probes)
    probe = np.ones(len(v), bool)
    rest = ~np.repeat(int_lane, counts)
    probe[rest] = probe_is_float(v[rest])
    float_lane = ~int_lane & all_in(probe)
    kinds[~bad & int_lane & int_ok] = KIND_INT
    kinds[~bad & float_lane] = KIND_FLOAT
    return kinds


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def words_bound(T: int, round_words_to: int = 1) -> int:
    bits = _REC0_BITS + _REC_BITS * max(T - 1, 0) + _EOS_BITS + 31
    return _round_up(max(bits // 32, 1), round_words_to)


def t_bucket(T: int) -> int:
    """The reference's record bucket: the next power of two, at least 8."""
    return max(8, 1 << int(np.ceil(np.log2(max(T, 1)))))


class EncodeInput(NamedTuple):
    """A packed lane batch: kernel B-4's inputs, on one device."""

    t0: torch.Tensor  # int64 [M] first time, nanos
    counts: torch.Tensor  # int32 [M] records a lane (>= 1)
    float_lane: torch.Tensor  # uint8 [M] 1 = FLOAT lane
    dod: torch.Tensor  # int32 [T_pad, M] delta-of-delta, seconds (0 at record 0)
    vbits: torch.Tensor  # int64 [T_pad, M] int value (INT) / IEEE-754 bits (FLOAT)
    k: int  # records a chunk
    words: int  # W, words a lane's row


def pack_lanes(lanes: list, kinds):
    """Host planes of a classified batch (``lanes`` a list of ``(times
    int64[N], values float64[N])``, ``kinds`` KIND_INT / KIND_FLOAT): the
    lanes concatenated once, every plane computed over all their points and
    filled through one mask, never lane by lane. Returns (t0 int64[M],
    counts int32[M], float_lane uint8[M], dod int32[M, T_pad], vbits
    int64[M, T_pad]), lane-major."""
    kinds = np.asarray(kinds, np.int8)
    counts = np.fromiter(map(len, (t for t, _ in lanes)), np.int64, len(lanes))
    M = len(lanes)
    T_pad = t_bucket(int(counts.max()))
    t = np.concatenate([np.asarray(t, np.int64) for t, _ in lanes])
    v = np.concatenate([np.asarray(v, np.float64) for _, v in lanes])
    starts = np.cumsum(counts) - counts
    first = np.zeros(len(t), bool)
    first[starts] = True
    deltas = np.empty_like(t)
    deltas[1:] = t[1:] - t[:-1]
    deltas[first] = 0
    prev_d = np.empty_like(deltas)
    prev_d[1:] = deltas[:-1]
    prev_d[first] = 0
    dod = _dod_seconds(deltas - prev_d).astype(np.int32)
    vbits = v.view(np.int64).copy()
    is_int = np.repeat(kinds == KIND_INT, counts)
    vbits[is_int] = v[is_int].astype(np.int64)
    mask = np.arange(T_pad)[None, :] < counts[:, None]
    dod_p = np.zeros((M, T_pad), np.int32)
    dod_p[mask] = dod
    vb_p = np.zeros((M, T_pad), np.int64)
    vb_p[mask] = vbits
    return (t[starts], counts.astype(np.int32), (kinds == KIND_FLOAT).astype(np.uint8),
            dod_p, vb_p)


def encode_inputs(lanes: list, kinds, k: int = CHUNK_K_DEFAULT, round_words_to: int = 1,
                  device="cuda") -> EncodeInput:
    """Pack a classified batch and move it to ``device`` (one copy a plane);
    the record-major planes are transposed there."""
    return upload_lanes(pack_lanes(lanes, kinds), k, round_words_to, device)


def upload_lanes(packed: tuple, k: int = CHUNK_K_DEFAULT, round_words_to: int = 1,
                 device="cuda") -> EncodeInput:
    """``pack_lanes``' host planes on ``device``, as kernel B-4 takes them."""
    dev = resolve_device(device)
    t0, counts, fl, dod, vb = packed
    W = words_bound(dod.shape[1], round_words_to)

    def up(a):
        return torch.from_numpy(a).to(dev)

    return EncodeInput(up(t0), up(counts), up(fl), up(dod).t().contiguous(),
                       up(vb).t().contiguous(), int(k), W)


def _check_input(inp: EncodeInput) -> tuple[int, int, int]:
    T, M = inp.dod.shape
    want = {"t0": (torch.int64, (M,)), "counts": (torch.int32, (M,)),
            "float_lane": (torch.uint8, (M,)), "dod": (torch.int32, (T, M)),
            "vbits": (torch.int64, (T, M))}
    for name, (dtype, shape) in want.items():
        x = getattr(inp, name)
        if x.dtype != dtype or tuple(x.shape) != shape or not x.is_contiguous() \
                or x.device != inp.dod.device:
            raise ValueError(f"want contiguous {dtype} {list(shape)} {name} on dod's device, "
                             f"got {x.dtype} {tuple(x.shape)} on {x.device}")
    if inp.k < 1 or inp.words < words_bound(T):
        raise ValueError(f"want k >= 1 and words >= {words_bound(T)}, got {inp.k}, {inp.words}")
    return T, M, max((T + inp.k - 1) // inp.k, 1)


def encode_planes(inp: EncodeInput):
    """(words int32 [M, W], total_bits int32 [M], chunk_offs int32 [C, M],
    chunk_sigs int32 [C, M]) on the planes' device: kernel B-4 for CUDA
    planes (one launch; raises if the build or the launch fails), its twin
    for CPU planes."""
    if inp.dod.device.type == "cpu":
        return encode_reference(inp)
    return launch_encode(inp)


def launch_encode(inp: EncodeInput):
    """Kernel B-4 on planes on one card."""
    T, M, C = _check_input(inp)
    if inp.dod.device.type != "cuda":
        raise ValueError(f"kernel B-4 runs on a card, got planes on {inp.dod.device}")
    dev = inp.dod.device
    words = torch.empty((M, inp.words), dtype=torch.int32, device=dev)
    total = torch.empty(M, dtype=torch.int32, device=dev)
    offs = torch.empty((C, M), dtype=torch.int32, device=dev)
    sigs = torch.empty((C, M), dtype=torch.int32, device=dev)
    if M == 0:
        return words, total, offs, sigs
    lib = load_library("encode")
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_encode_lanes(inp.t0.data_ptr(), inp.counts.data_ptr(),
                                 inp.float_lane.data_ptr(), inp.dod.data_ptr(),
                                 inp.vbits.data_ptr(), M, T, inp.k, inp.words, C,
                                 words.data_ptr(), total.data_ptr(), offs.data_ptr(),
                                 sigs.data_ptr(), stream)
    if rc != 0:
        raise launch_error("encode", rc, dod=inp.dod, vbits=inp.vbits, words=words)
    LAUNCHES["encode"] += 1
    return words, total, offs, sigs


def launch_shape(M: int, device="cuda") -> dict:
    """How kernel B-4 runs M lanes: warps a block (a lane a warp), the
    blocks the launch starts and those the card holds at once, shared
    memory a block, registers and local (spilled) bytes a thread."""
    import ctypes

    out = (ctypes.c_int64 * 6)()
    with device_guard(torch.device(device)):
        rc = load_library("encode").m3_encode_shape(M, out)
    if rc != 0:
        raise RuntimeError(f"encode launch_shape({M}): CUDA error {rc}")
    keys = ("warps", "blocks", "resident_blocks", "smem_bytes", "registers", "local_bytes")
    return dict(zip(keys, (int(x) for x in out)))


# ---------------------------------------------------------------------------
# the plain PyTorch twin
# ---------------------------------------------------------------------------


def _clz32(x: torch.Tensor) -> torch.Tensor:
    """Leading zeros of u32 values held in int64; 32 for 0."""
    n = torch.zeros_like(x)
    y = x
    for s in (16, 8, 4, 2, 1):
        small = y < (1 << (32 - s))
        n = n + small.to(x.dtype) * s
        y = torch.where(small, y << s, y)
    return torch.where(x == 0, 32, n)


def _ctz32(x: torch.Tensor) -> torch.Tensor:
    return torch.where(x == 0, 32, 31 - _clz32(x & -x))


def _shr64(hi, lo, s):
    """Logical right shift of (hi, lo) u32 pairs by s in [0, 64]."""
    s1 = s.clamp(max=31)
    lo_a = (lo >> s1) | torch.where(s1 == 0, 0, (hi << (32 - s1)) & _M32)
    hi_a = hi >> s1
    lo_b = hi >> (s - 32).clamp(0, 31)
    lt32 = s < 32
    return (torch.where(lt32, hi_a, 0),
            torch.where(lt32, lo_a, torch.where(s >= 64, 0, lo_b)))


def _tracker(sig_in: torch.Tensor, active: torch.Tensor):
    """The int significant-bits hysteresis (IntSigBitsTracker), one record
    at a time across all lanes: ns before and after each record [T, M]."""
    T, M = sig_in.shape
    z = torch.zeros(M, dtype=torch.int64, device=sig_in.device)
    ns, ch, nl = z, z, z
    before = torch.empty_like(sig_in)
    after = torch.empty_like(sig_in)
    for j in range(T):
        sig, act = sig_in[j], active[j]
        before[j] = ns
        if j == 0:
            # first record: write_int_sig(sig) only, counters untouched
            ns = torch.where(act, sig, ns)
        else:
            gt = sig > ns
            low = (ns - sig) >= _SIG_DIFF_THRESHOLD
            ch_l = torch.where(nl == 0, sig, torch.maximum(ch, sig))
            nl_l = nl + 1
            hit = nl_l >= _SIG_REPEAT_THRESHOLD
            ns_low = torch.where(hit, ch_l, ns)
            nl_l = torch.where(hit, 0, nl_l)
            new_sig = torch.where(gt, sig, torch.where(low, ns_low, ns))
            ch_n = torch.where(low, ch_l, ch)
            nl_n = torch.where(gt, nl, torch.where(low, nl_l, 0))
            ns = torch.where(act, new_sig, ns)
            ch = torch.where(act, ch_n, ch)
            nl = torch.where(act, nl_n, nl)
        after[j] = ns
    return before, after


def encode_reference(inp: EncodeInput, lanes_a_pass: int = 0):
    """Kernel B-4's plain PyTorch twin, on any device: the reference's XLA
    program step for step (slots, tracker, exclusive cumsum, scatter-adds).
    ``lanes_a_pass`` bounds the lanes whose slot planes are built at once
    (0: all, or what keeps a plane near 2^25 slots)."""
    T, M, C = _check_input(inp)
    K, W = inp.k, inp.words
    dev = inp.dod.device
    i64 = torch.int64
    j_idx = torch.arange(T, device=dev)[:, None]
    valid = j_idx < inp.counts.to(i64)[None, :]
    fl = inp.float_lane.bool()[None, :]
    int_v = valid & ~fl
    rec0 = (j_idx == 0) & valid
    later = (j_idx > 0) & valid

    # int planes: d = v0 at record 0, prev - cur after
    iv = inp.vbits
    prev_iv = torch.cat([iv[:1], iv[:-1]])
    d = torch.where(j_idx == 0, iv, prev_iv - iv)
    absval = torch.where(int_v, d.abs() & _M32, 0)
    negbit = torch.where(int_v, torch.where(j_idx == 0, iv >= 0, d < 0), False).to(i64)
    int_repeat = later & ~fl & (d == 0)
    sig_in = 32 - _clz32(absval)
    active = int_v & ~int_repeat
    ns_before, ns_after = _tracker(sig_in, active)

    out_words = torch.empty((M, W), dtype=torch.int32, device=dev)
    total_bits = torch.empty(M, dtype=torch.int32, device=dev)
    chunk_offs = torch.empty((C, M), dtype=torch.int32, device=dev)
    step = lanes_a_pass or max(1, (1 << 25) // (T * _SLOTS + 1))
    for a in range(0, M, step):
        b = min(M, a + step)
        cols = slice(a, b)
        words, tb, co = _emit_lanes(
            inp.t0[cols], inp.dod[:, cols], inp.vbits[:, cols], valid[:, cols], fl[:, cols],
            rec0[:, cols], later[:, cols], absval[:, cols], negbit[:, cols],
            int_repeat[:, cols], sig_in[:, cols], ns_before[:, cols], ns_after[:, cols], K, W)
        out_words[cols] = words
        total_bits[cols] = tb
        chunk_offs[:, cols] = co
    chunk_sigs = ns_before[::K][:C].to(torch.int32)
    return out_words, total_bits, chunk_offs, chunk_sigs


def _emit_lanes(t0, dod, vbits, valid, fl, rec0, later, absval, negbit, int_repeat,
                sig_in, ns_before, ns_after, K, W):
    T, L = dod.shape
    dev = dod.device
    i64 = torch.int64
    j_idx = torch.arange(T, device=dev)[:, None]
    zero64 = torch.zeros((), dtype=i64, device=dev)

    def z(x):  # length / value 0 where the record is invalid
        return torch.where(valid, x, zero64)

    # --- timestamp slots ---
    l_tsh = torch.where(rec0, 32, 0)
    v_tsh = torch.where(rec0, (t0 >> 32)[None, :] & _M32, 0)
    l_tsl = l_tsh
    v_tsl = torch.where(rec0, t0[None, :] & _M32, 0)
    dd = dod.to(i64)
    zero = dd == 0
    b7 = (dd >= -64) & (dd <= 63)
    b9 = (dd >= -256) & (dd <= 255)
    b12 = (dd >= -2048) & (dd <= 2047)
    l_op = torch.where(zero, 1, torch.where(b7, 2, torch.where(b9, 3, 4)))
    v_op = torch.where(zero, 0, torch.where(b7, 2, torch.where(b9, 6, torch.where(b12, 14, 15))))
    l_dv = torch.where(zero, 0, torch.where(b7, 7, torch.where(b9, 9, torch.where(b12, 12, 32))))
    v_dv = dd & ((torch.ones_like(l_dv) << l_dv) - 1)
    l_op, l_dv = z(l_op), z(l_dv)

    # --- int value slots ---
    width = torch.where(j_idx == 0, sig_in, ns_after)
    upd = later & (ns_before != ns_after)
    i_ctrl_v = torch.where(rec0, 0, torch.where(int_repeat, 1, torch.where(upd, 0, 1)))
    i_ctrl_l = torch.where(rec0, 1, torch.where(int_repeat, 2, torch.where(upd, 3, 1)))
    hdr9 = 0x180 | (((width - 1) & _M32) << 1)
    i_hdr_v = torch.where(rec0 & (sig_in > 0), hdr9, torch.where(upd, hdr9, 0))
    i_hdr_l = torch.where(rec0, torch.where(sig_in > 0, 9, 2), torch.where(upd, 9, 0))
    # a u32 shift by >= 32 gives 0, as XLA's does
    i_val_v = (((negbit << width) & _M32) | absval) & _M32
    i_val_l = 1 + width
    irep = int_repeat & later
    i_hdr_v = torch.where(irep, 0, i_hdr_v)
    i_hdr_l = torch.where(irep, 0, i_hdr_l)
    i_val_v = torch.where(irep, 0, i_val_v)
    i_val_l = torch.where(irep, 0, i_val_l)

    # --- float value slots ---
    vb_hi = (vbits >> 32) & _M32
    vb_lo = vbits & _M32
    pvb_hi = torch.cat([vb_hi[:1], vb_hi[:-1]])
    pvb_lo = torch.cat([vb_lo[:1], vb_lo[:-1]])
    f_rep = later & (vb_hi == pvb_hi) & (vb_lo == pvb_lo)
    x_hi = vb_hi ^ pvb_hi
    x_lo = vb_lo ^ pvb_lo
    # prev_xor BEFORE record j: forward fill of nonzero xors, seeded with
    # the first value's bits (write_full_float)
    updated = (j_idx == 0) | (x_hi != 0) | (x_lo != 0)
    idx = torch.where(updated, j_idx, 0).expand(T, L)
    last = torch.cummax(idx, dim=0).values
    src_hi = torch.where(j_idx == 0, vb_hi, x_hi)
    src_lo = torch.where(j_idx == 0, vb_lo, x_lo)
    pa_hi = torch.gather(src_hi, 0, last)
    pa_lo = torch.gather(src_lo, 0, last)
    pxr_hi = torch.cat([torch.zeros_like(pa_hi[:1]), pa_hi[:-1]])
    pxr_lo = torch.cat([torch.zeros_like(pa_lo[:1]), pa_lo[:-1]])
    pl = torch.where(pxr_hi != 0, _clz32(pxr_hi), 32 + _clz32(pxr_lo))
    pt = torch.where(pxr_lo != 0, _ctz32(pxr_lo), 32 + _ctz32(pxr_hi))
    cl = torch.where(x_hi != 0, _clz32(x_hi), 32 + _clz32(x_lo))
    ct = torch.where(x_lo != 0, _ctz32(x_lo), 32 + _ctz32(x_hi))
    contained = (cl >= pl) & (ct >= pt)
    len_c = 64 - pl - pt
    nm = 64 - cl - ct
    pc_hi, pc_lo = _shr64(x_hi, x_lo, pt)
    pu_hi, pu_lo = _shr64(x_hi, x_lo, ct)
    flen = torch.where(contained, len_c, nm)
    pay_hi = torch.where(contained, pc_hi, pu_hi)
    pay_lo = torch.where(contained, pc_lo, pu_lo)
    f_ctrl_v = torch.where(rec0, 1, torch.where(f_rep, 1, torch.where(contained, 6, 7)))
    f_ctrl_l = torch.where(rec0, 1, torch.where(f_rep, 2, 3))
    unc = later & ~f_rep & ~contained
    f_hdr_v = torch.where(unc, ((cl & _M32) << 6) | ((nm - 1) & _M32), 0)
    f_hdr_l = torch.where(unc, 12, 0)
    f_vhi_v = torch.where(rec0, vb_hi, torch.where(f_rep, 0, pay_hi))
    f_vhi_l = torch.where(rec0, 32, torch.where(f_rep, 0, (flen - 32).clamp(min=0)))
    f_vlo_v = torch.where(rec0, vb_lo, torch.where(f_rep, 0, pay_lo))
    f_vlo_l = torch.where(rec0, 32, torch.where(f_rep, 0, flen.clamp(max=32)))

    # --- merge lanes, mask invalid records ---
    vals = torch.stack([
        v_tsh, v_tsl, v_op, v_dv, torch.where(fl, f_ctrl_v, i_ctrl_v),
        torch.where(fl, f_hdr_v, i_hdr_v), torch.where(fl, f_vhi_v, i_val_v),
        torch.where(fl, f_vlo_v, 0)], 1).to(i64).reshape(T * _SLOTS, L)
    lens = torch.stack([
        l_tsh, l_tsl, l_op, l_dv, z(torch.where(fl, f_ctrl_l, i_ctrl_l)),
        z(torch.where(fl, f_hdr_l, i_hdr_l)), z(torch.where(fl, f_vhi_l, i_val_l)),
        z(torch.where(fl, f_vlo_l, 0))], 1).to(i64).reshape(T * _SLOTS, L)
    vals = torch.cat([vals, torch.full((1, L), _EOS, dtype=i64, device=dev)])
    lens = torch.cat([lens, torch.full((1, L), _EOS_BITS, dtype=i64, device=dev)])

    inc = torch.cumsum(lens, 0)
    offs = inc - lens  # exclusive
    C = max((T + K - 1) // K, 1)
    chunk_offs = offs[:: K * _SLOTS][:C]

    # --- emission: two scatter-adds a slot into big-endian words ---
    b = offs & 31
    end = b + lens
    hi = torch.where(end <= 32, (vals << (32 - end).clamp(0, 31)) & _M32,
                     vals >> (end - 32).clamp(0, 31))
    lo = torch.where(end > 32, (vals << (64 - end).clamp(0, 31)) & _M32, 0)
    live = lens > 0
    w = offs >> 5
    lane = torch.arange(L, device=dev)[None, :] * W
    hi = torch.where(live & (w < W), hi, 0)
    lo = torch.where(live & (w + 1 < W), lo, 0)
    out = torch.zeros(L * W, dtype=i64, device=dev)
    out.scatter_add_(0, (lane + w.clamp(max=W - 1)).reshape(-1), hi.reshape(-1))
    out.scatter_add_(0, (lane + (w + 1).clamp(max=W - 1)).reshape(-1), lo.reshape(-1))
    words = (((out + (1 << 31)) & _M32) - (1 << 31)).to(torch.int32).reshape(L, W)
    return words, inc[-1].to(torch.int32), chunk_offs.to(torch.int32)


# ---------------------------------------------------------------------------
# results
# ---------------------------------------------------------------------------


class EncodeResult(NamedTuple):
    """Device-encoded lane batch. ``words`` stays on the device (the
    resident pool admits it without re-upload); everything else is small
    host metadata."""

    words: torch.Tensor  # int32 [M, W] on the device: big-endian u32 words
    total_bits: np.ndarray  # int64[M], EOS included
    nbytes: np.ndarray  # int64[M] finalized stream length
    chunk_offs: np.ndarray  # int64[Cmax, M] bit offset at each chunk start
    chunk_sigs: np.ndarray  # int32[Cmax, M] tracker num_sig at chunk start
    n_chunks: np.ndarray  # int32[M]
    kinds: np.ndarray  # int8[M] KIND_INT / KIND_FLOAT
    counts: np.ndarray  # int32[M]
    chunk_k: int

    def streams(self) -> list[bytes]:
        """Finalized m3tsz byte streams -- ONE device->host copy for the
        whole batch (fileset persistence / oracle tests), never on the
        admission hot path."""
        host = self.words.cpu().numpy().view(np.uint32).astype(">u4")
        return [host[m].tobytes()[: int(self.nbytes[m])] for m in range(host.shape[0])]


def encode_lanes(lanes: list, kinds, k: int = CHUNK_K_DEFAULT, round_words_to: int = 1,
                 device="cuda") -> EncodeResult | None:
    """Encode classified lanes on ``device`` (kernel B-4 on the card, its
    twin on the CPU). ``lanes`` is a list of ``(times int64[N], values
    float64[N])``; ``kinds[i]`` must be KIND_INT or KIND_FLOAT (run
    :func:`classify_lane` first). Returns None for an empty batch."""
    if len(lanes) == 0:
        return None
    kinds = np.asarray(kinds, np.int8)
    inp = encode_inputs(lanes, kinds, k, round_words_to, device)
    return result_of(inp, encode_planes(inp), kinds)


def result_of(inp: EncodeInput, out, kinds) -> EncodeResult:
    """The EncodeResult of a batch's planes and its B-4 outputs (the small
    outputs copied to the host)."""
    words, total_bits, chunk_offs, chunk_sigs = out
    counts = inp.counts.cpu().numpy().astype(np.int32)
    total_bits = total_bits.cpu().numpy().astype(np.int64)
    k = inp.k
    return EncodeResult(
        words=words,
        total_bits=total_bits,
        nbytes=(total_bits + 7) // 8,
        chunk_offs=chunk_offs.cpu().numpy().astype(np.int64),
        chunk_sigs=chunk_sigs.cpu().numpy(),
        n_chunks=((counts + k - 1) // k).astype(np.int32),
        kinds=np.asarray(kinds, np.int8),
        counts=counts,
        chunk_k=k,
    )


def lane_max_span(result: EncodeResult, m: int) -> int:
    """Widest chunk span in bits for lane ``m`` (resident-pool window
    sizing) -- matches snapshot_stream's post-hoc ``span``: offset deltas
    with the final chunk extending to the padded stream end (``nbytes *
    8``, EOS and byte padding included)."""
    nc = int(result.n_chunks[m])
    if nc == 0:
        return 0
    offs = result.chunk_offs[:nc, m]
    ends = np.concatenate([offs[1:], np.asarray([int(result.nbytes[m]) * 8], np.int64)])
    return int((ends - offs).max())


def side_rows_for(result: EncodeResult, lanes: list, block_start: int) -> list:
    """Packed 10-word side rows per lane, bit-identical to
    ``pack_side_rows(snapshot_stream(stream))`` for every device-encoded
    lane (None where a chunk overflows the packed ranges -- that lane
    admits without side planes and decodes streamed)."""
    from .sideplane import pack_side_rows_vec

    k = result.chunk_k
    out = []
    for m, (t, v) in enumerate(lanes):
        t = np.asarray(t, np.int64)
        v = np.asarray(v, np.float64)
        n = int(result.counts[m])
        nc = int(result.n_chunks[m])
        ci = np.arange(nc)
        j = ci * k  # records consumed before each chunk
        off = result.chunk_offs[:nc, m]
        prev_time = np.where(j > 0, t[np.maximum(j - 1, 0)], 0).astype(np.uint64)
        pd = np.zeros(nc, np.uint64)
        ge2 = j >= 2
        pd[ge2] = (t[j[ge2] - 1] - t[j[ge2] - 2]).astype(np.uint64)
        full = (j + k) <= n
        if result.kinds[m] == KIND_INT:
            iv = v.astype(np.int64)
            int_val = np.where(j > 0, iv[np.maximum(j - 1, 0)], 0).astype(np.uint64)
            sig = result.chunk_sigs[:nc, m]
            rows = pack_side_rows_vec(
                off, prev_time, pd, np.ones(nc, np.uint64),
                np.zeros(nc, np.uint64), np.zeros(nc, np.uint64), int_val,
                sig, np.zeros(nc, np.uint64), np.zeros(nc, bool),
                full, np.zeros(nc, bool), block_start,
            )
        else:
            vb = v.view(np.uint64)
            pfb = np.zeros(nc, np.uint64)
            pxr = np.zeros(nc, np.uint64)
            if n > 1 or nc > 0:
                src = np.concatenate([vb[:1], vb[1:] ^ vb[:-1]])
                updated = np.concatenate([[True], vb[1:] != vb[:-1]])
                last = np.maximum.accumulate(np.where(updated, np.arange(n), 0))
                px_after = src[last]
                gt0 = j > 0
                pfb[gt0] = vb[j[gt0] - 1]
                pxr[gt0] = px_after[j[gt0] - 1]
            # chunk 0's snapshot predates the first record: is_float is
            # still False and fast_float needs float mode AT chunk start
            rows = pack_side_rows_vec(
                off, prev_time, pd, np.ones(nc, np.uint64),
                pfb, pxr, np.zeros(nc, np.uint64),
                np.zeros(nc, np.uint64), np.zeros(nc, np.uint64), j > 0,
                np.zeros(nc, bool), full & (ci > 0), block_start,
            )
        out.append(rows)
    return out


def encode_block(points: list, block_start: int, k: int = CHUNK_K_DEFAULT,
                 round_words_to: int = 1, device="cuda"):
    """Convenience seal-path entry: classify + encode + side rows.

    ``points`` is a list of per-lane ``(times, values, units)`` triples.
    Returns ``(kinds int8[L], result EncodeResult | None, lane_index
    int32[L], side_rows list)`` where ``lane_index[i]`` is the row of
    lane i in the encode batch, or -1 for host-fallback lanes."""
    kinds = np.zeros(len(points), np.int8)
    for i, (t, v, u) in enumerate(points):
        kinds[i] = classify_lane(t, v, u).kind
    lane_index = np.full(len(points), -1, np.int32)
    eligible = [i for i in range(len(points)) if kinds[i] != KIND_NONE]
    lane_index[eligible] = np.arange(len(eligible), dtype=np.int32)
    lanes = [(points[i][0], points[i][1]) for i in eligible]
    result = encode_lanes(lanes, kinds[eligible], k=k, round_words_to=round_words_to,
                          device=device)
    side = side_rows_for(result, lanes, block_start) if result is not None else []
    return kinds, result, lane_index, side
