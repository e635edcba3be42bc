"""One M3TSZ record step in plain PyTorch: the twin of the CUDA kernel.

Port of the per-record functions of ``m3_tpu/ops/decode.py`` and the f32
conversions of ``m3_tpu/ops/u64.py``. The CUDA kernels
(``ops/csrc/lane_aggregates.cu``) run the same arithmetic with native
64-bit integers; this module is their plain version, run by the CPU tests
against the JAX package and by ``chip_smoke.py`` against the kernels. Its
last section is the whole-stream decode, ``decode_batched``: kernel B-6's
wrapper and its twin.

Word convention: torch's uint32/uint64 lack shifts, compares and ``where``
on the CPU, so a 32-bit word is carried as an int64 tensor holding a value
in [0, 2**32), and a 64-bit quantity as a (hi, lo) pair of such words, as
the reference's ``u64`` module does. Left shifts are masked back to 32
bits; right shifts of a non-negative int64 are logical.

Float convention: the reference computes in f32 with subnormals flushed to
zero (XLA on the CPU and the TPU both flush inputs and outputs). Every f32
op here that can produce a subnormal is followed by ``_ftz``, and the
kernel is compiled with ``-ftz=true``, so all three agree bit for bit.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils.xtime import Unit

M32 = 0xFFFFFFFF
F32 = torch.float32
FLT_MIN = 2.0**-126

# Marker scheme constants (encoding/scheme.go:28-38).
_MARKER_OPCODE = 0x100
_MARKER_BITS = 11
_EOS = 0
_ANNOTATION = 1
_TIME_UNIT = 2
_TU_DOD_OFF = _MARKER_BITS + 8

_UNIT_NANOS = {
    int(Unit.SECOND): 1_000_000_000,
    int(Unit.MILLISECOND): 1_000_000,
    int(Unit.MICROSECOND): 1_000,
    int(Unit.NANOSECOND): 1,
}


class DecodeState(NamedTuple):
    pos: torch.Tensor  # int64[N] bit cursor relative to the chunk start
    done: torch.Tensor  # bool[N]
    err: torch.Tensor  # bool[N]
    prev_time: tuple  # (hi, lo) u32-in-int64 pair
    prev_delta: tuple
    time_unit: torch.Tensor  # int64[N]
    prev_float_bits: tuple
    prev_xor: tuple
    int_val: tuple  # signed 64-bit as a pair; int32 in the fast body
    mult: torch.Tensor  # int64[N]
    sig: torch.Tensor  # int64[N]
    is_float: torch.Tensor  # bool[N]


# ---------------------------------------------------------------------------
# 32-bit words and (hi, lo) pairs carried in int64
# ---------------------------------------------------------------------------


def _w(x, like):
    """A Python int or tensor as a tensor shaped like ``like``."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.full_like(like, int(x))


def shl32(a, s):
    return (a << s) & M32


def wrap_i32(x):
    """Two's-complement wrap of an int64 tensor into int32 range."""
    return ((x + 2**31) & M32) - 2**31


def as_i32(a):
    """u32 word → its int32 value (bitcast)."""
    return torch.where(a >= 2**31, a - 2**32, a)


def pair_from_i32(x):
    """Sign-extend an int32 value into a pair."""
    return torch.where(x < 0, M32, 0), x & M32


def pair_add(a, b):
    lo = a[1] + b[1]
    carry = lo >> 32
    return (a[0] + b[0] + carry) & M32, lo & M32


def pair_neg(a):
    return pair_add(((~a[0]) & M32, (~a[1]) & M32), (torch.zeros_like(a[0]), torch.ones_like(a[1])))


def pair_select(pred, a, b):
    return torch.where(pred, a[0], b[0]), torch.where(pred, a[1], b[1])


def pair_is_zero(a):
    return (a[0] == 0) & (a[1] == 0)


def pair_shl(a, s):
    """Logical left shift by s in [0, 64] (int or tensor); >= 64 gives 0."""
    hi, lo = a
    s = _w(s, hi)
    s1 = torch.clamp(s, max=31)
    hi_a = shl32(hi, s1) | torch.where(s1 == 0, 0, lo >> (32 - s1))
    lo_a = shl32(lo, s1)
    s2 = torch.clamp(s - 32, 0, 31)
    hi_b = shl32(lo, s2)
    lt32 = s < 32
    out_hi = torch.where(lt32, hi_a, torch.where(s >= 64, 0, hi_b))
    out_lo = torch.where(lt32, lo_a, 0)
    return out_hi, out_lo


def pair_shr(a, s):
    """Logical right shift by s >= 0 (int or tensor); >= 64 gives 0."""
    hi, lo = a
    s = _w(s, hi)
    s1 = torch.clamp(s, max=31)
    lo_a = (lo >> s1) | torch.where(s1 == 0, 0, shl32(hi, 32 - s1))
    hi_a = hi >> s1
    s2 = torch.clamp(s - 32, 0, 31)
    lo_b = hi >> s2
    lt32 = s < 32
    out_hi = torch.where(lt32, hi_a, 0)
    out_lo = torch.where(lt32, lo_a, torch.where(s >= 64, 0, lo_b))
    return out_hi, out_lo


def clz32(x):
    """Leading zeros of a u32 word (32 for zero)."""
    n = torch.zeros_like(x)
    y = x
    for sh in (16, 8, 4, 2, 1):
        small = y < (1 << (32 - sh))
        n = n + torch.where(small, sh, 0)
        y = torch.where(small, shl32(y, sh), y)
    return torch.where(x == 0, 32, n)


def ctz32(x):
    """Trailing zeros of a u32 word (32 for zero)."""
    low = x & ((-x) & M32)
    return torch.where(x == 0, 32, 31 - clz32(low))


def pair_clz(a):
    return torch.where(a[0] != 0, clz32(a[0]), 32 + clz32(a[1]))


def pair_ctz(a):
    return torch.where(a[1] != 0, ctz32(a[1]), 32 + ctz32(a[0]))


def pair_mul_u32(a, m):
    """(hi, lo) * u32 mod 2**64."""
    hi, lo = a
    # a full 32x32 product can exceed int64: split m into 16-bit halves
    m_lo, m_hi = m & 0xFFFF, m >> 16
    p0 = lo * m_lo  # < 2**48
    p1 = lo * m_hi  # < 2**48
    low = p0 + ((p1 & 0xFFFF) << 16)
    p_lo = low & M32
    p_hi = (low >> 32) + (p1 >> 16)
    hi_m = hi * m_lo + (((hi * m_hi) & 0xFFFF) << 16)  # hi * m mod 2**32
    return (hi_m + p_hi) & M32, p_lo


# ---------------------------------------------------------------------------
# Window fetch and bit extracts
# ---------------------------------------------------------------------------


def barrel_mask(cw: int) -> int:
    """Word-index mask of the reference's barrel fetch (chunked.py
    _fetch4_select): its stages cover the bits of the largest power of two
    <= cw-1 and below, so word indices wrap modulo twice that."""
    if cw - 1 <= 0:
        return 0
    s = 1
    while s * 2 <= cw - 1:
        s *= 2
    return 2 * s - 1


def fetch4(win_ext, mask: int, rel, pos):
    """Four words at bit ``rel + pos`` of each lane, aligned to that bit.

    ``win_ext`` is int64[N, W] with W >= mask + 4 and zeros past the
    lane's CW real words; word indices wrap with ``mask`` exactly as the
    reference's barrel select does. The fourth word is not refilled from a
    fifth (the reference's window has no fifth word)."""
    p = rel + pos
    widx = (p >> 5) & mask
    idx = widx[:, None] + torch.arange(4, device=p.device)[None, :]
    return _align(torch.gather(win_ext, 1, idx), p & 31)


def fetch4_clamped(words, pos):
    """Four words at bit ``pos`` of each series' whole stream, aligned to
    that bit (m3_tpu/ops/decode.py:152 _fetch4): ``words`` is int64[S, W]
    of u32 values, and each word index is clipped to W - 1, so a fetch past
    the end repeats the last word."""
    last = words.shape[1] - 1
    widx = (pos >> 5).clamp(0, last)
    idx = (widx[:, None] + torch.arange(4, device=pos.device)[None, :]).clamp(max=last)
    return _align(torch.gather(words, 1, idx), pos & 31)


def _align(w, r):
    """Words [N, 4] shifted left by r bits (per lane), each refilled from
    the next; the fourth is not refilled (the reference has no fifth)."""
    nz = r != 0
    inv = 32 - r

    def sh(a, b):
        return shl32(a, r) | torch.where(nz, b >> inv, 0)

    w0, w1, w2, w3 = w.unbind(1)
    return sh(w0, w1), sh(w1, w2), sh(w2, w3), shl32(w3, r)


def _extract(ws, start, n):
    """``n`` (<= 64) bits at bit ``start`` of a 4-word window, right-aligned
    in a pair. ``start`` and ``n`` may be ints or tensors."""
    zero = torch.zeros_like(ws[0])
    opts = list(ws) + [zero, zero, zero]
    if isinstance(start, int):
        k, r = start >> 5, start & 31
        w0, w1, w2 = opts[k], opts[k + 1], opts[k + 2]
        if r == 0:
            hi, lo = w0, w1
        else:
            hi = shl32(w0, r) | (w1 >> (32 - r))
            lo = shl32(w1, r) | (w2 >> (32 - r))
    else:
        k = start >> 5
        r = start & 31

        def pick(i):
            out = zero
            for j in range(6):
                out = torch.where(i == j, opts[j], out)
            return out

        w0, w1, w2 = pick(k), pick(k + 1), pick(k + 2)
        nz = r != 0
        hi = shl32(w0, r) | torch.where(nz, w1 >> (32 - r), 0)
        lo = shl32(w1, r) | torch.where(nz, w2 >> (32 - r), 0)
    if isinstance(n, int):
        return pair_shr((hi, lo), 64 - n)
    # a negative shift (n > 64) is a huge unsigned shift in the reference: 0
    s = 64 - n
    out = pair_shr((hi, lo), torch.clamp(s, min=0))
    return pair_select(s < 0, (zero, zero), out)


def _extract32(ws, start, n):
    return _extract(ws, start, n)[1]


# ---------------------------------------------------------------------------
# Record decode (general body)
# ---------------------------------------------------------------------------


def _unit_nanos(unit):
    out = torch.zeros_like(unit)
    for code, nanos in _UNIT_NANOS.items():
        out = torch.where(unit == code, nanos, out)
    return out


def _sext(x, bits: int):
    half = 1 << (bits - 1)
    return (x ^ half) - half


def _decode_timestamp(fetch, num_bits, state: DecodeState, first, nt):
    """One timestamp record for every lane (decode.py _decode_timestamp)."""
    pos = torch.where(first, state.pos + 64, state.pos)
    prev_time = pair_select(first, nt, state.prev_time)
    ws = fetch(pos)
    in_range = (pos + _MARKER_BITS) <= num_bits
    peek = _extract32(ws, 0, _MARKER_BITS)
    is_marker = in_range & ((peek >> 2) == _MARKER_OPCODE)
    marker_val = peek & 3
    eos = is_marker & (marker_val == _EOS)
    ann = is_marker & (marker_val == _ANNOTATION)
    tu_marker = is_marker & (marker_val == _TIME_UNIT)

    new_unit = _extract32(ws, _MARKER_BITS, 8)
    tu_supported = (new_unit >= 1) & (new_unit <= 4)
    tu_changed = tu_marker & tu_supported & (new_unit != state.time_unit)
    time_unit = torch.where(tu_marker & tu_supported, new_unit, state.time_unit)
    dod_off = torch.where(tu_marker, _TU_DOD_OFF, 0)

    dod_changed = _extract(ws, _TU_DOD_OFF, 64)
    head16 = torch.where(tu_marker, _extract32(ws, _TU_DOD_OFF, 16), _extract32(ws, 0, 16))
    b0 = (head16 >> 15) & 1
    b1 = (head16 >> 14) & 1
    b2 = (head16 >> 13) & 1
    b3 = (head16 >> 12) & 1
    zero_dod = b0 == 0
    sel7 = (b0 == 1) & (b1 == 0)
    sel9 = (b0 == 1) & (b1 == 1) & (b2 == 0)
    sel12 = (b0 == 1) & (b1 == 1) & (b2 == 1) & (b3 == 0)
    default_bits = torch.where((time_unit == 1) | (time_unit == 2), 32, 64)
    nbits = torch.where(sel7, 7, torch.where(sel9, 9, torch.where(sel12, 12, default_bits)))
    opbits = torch.where(sel7, 2, torch.where(sel9, 3, 4))
    d7 = _sext((head16 >> 7) & 0x7F, 7)
    d9 = _sext((head16 >> 4) & 0x1FF, 9)
    d12 = _sext(head16 & 0xFFF, 12)
    d_small = torch.where(sel7, d7, torch.where(sel9, d9, d12))
    raw32 = as_i32(torch.where(tu_marker, _extract32(ws, _TU_DOD_OFF + 4, 32), _extract32(ws, 4, 32)))
    raw64 = pair_select(tu_marker, _extract(ws, _TU_DOD_OFF + 4, 64), _extract(ws, 4, 64))
    dod_def = pair_select(default_bits == 32, pair_from_i32(raw32), raw64)
    dod_norm = pair_select(sel7 | sel9 | sel12, pair_from_i32(d_small), dod_def)
    dod_bucket = pair_mul_u32(dod_norm, _unit_nanos(time_unit))
    bucket_consumed = torch.where(zero_dod, 1, opbits + nbits)

    zero = torch.zeros_like(pos)
    dod = pair_select(tu_changed, dod_changed, dod_bucket)
    dod = pair_select(zero_dod & ~tu_changed, (zero, zero), dod)
    consumed = dod_off + torch.where(tu_changed, 64, bucket_consumed)

    unit_ok = (time_unit >= 1) & (time_unit <= 4)
    err_now = (ann | ~unit_ok | (tu_marker & ~tu_supported)) & ~state.done & ~eos

    prev_delta = pair_add(state.prev_delta, dod)
    prev_time = pair_add(prev_time, prev_delta)
    prev_delta = pair_select(tu_changed, (zero, zero), prev_delta)

    active = ~state.done & ~state.err & ~eos & ~err_now
    return state._replace(
        pos=torch.where(active, pos + consumed, state.pos),
        done=state.done | eos,
        err=state.err | err_now,
        prev_time=pair_select(active, prev_time, state.prev_time),
        prev_delta=pair_select(active, prev_delta, state.prev_delta),
        time_unit=torch.where(active, time_unit, state.time_unit),
    )


def _read_int_header12(hb, sig, mult):
    """sig/mult update header from its 12 head bits. Returns (sig', mult',
    consumed, mult_invalid)."""
    upd = ((hb >> 11) & 1) == 1
    zero_sig = ((hb >> 10) & 1) == 0
    sig_m1 = (hb >> 4) & 0x3F
    new_sig = torch.where(upd, torch.where(zero_sig, 0, sig_m1 + 1), sig)
    sig_consumed = torch.where(upd, torch.where(zero_sig, 2, 8), 1)
    is1 = ~upd
    is2 = upd & zero_sig
    b_mult_upd = torch.where(is1, (hb >> 10) & 1, torch.where(is2, (hb >> 9) & 1, (hb >> 3) & 1))
    mult_v = torch.where(is1, (hb >> 7) & 7, torch.where(is2, (hb >> 6) & 7, hb & 7))
    mupd = b_mult_upd == 1
    new_mult = torch.where(mupd, mult_v, mult)
    consumed = sig_consumed + torch.where(mupd, 4, 1)
    return new_sig, new_mult, consumed, mupd & (mult_v > 6)


def _read_int_diff(ws, off, sig, int_val):
    """Sign + sig-bit diff. Returns (int_val', consumed)."""
    sign_bit = _extract32(ws, off, 1)
    diff = _extract(ws, off + 1, sig)
    delta = pair_select(sign_bit == 1, diff, pair_neg(diff))
    return pair_add(int_val, delta), 1 + sig


def _read_xor(ws, off: int, prev_float_bits, prev_xor):
    """Gorilla XOR float record. Returns (float_bits', xor', consumed)."""
    c0 = _extract32(ws, off, 1)
    c1 = _extract32(ws, off + 1, 1)
    zero_path = c0 == 0
    contained = (c0 == 1) & (c1 == 0)

    prev_nonzero = ~pair_is_zero(prev_xor)
    prev_lead = torch.where(prev_nonzero, pair_clz(prev_xor), 64)
    prev_trail = torch.where(prev_nonzero, pair_ctz(prev_xor), 0)
    nm_c = torch.clamp(64 - prev_lead - prev_trail, 0, 64)
    xor_c = pair_shl(_extract(ws, off + 2, nm_c), prev_trail)
    consumed_c = 2 + nm_c

    lead_u = _extract32(ws, off + 2, 6)
    nm_u = _extract32(ws, off + 8, 6) + 1
    trail_u = torch.clamp(64 - lead_u - nm_u, 0, 64)
    xor_u = pair_shl(_extract(ws, off + 14, nm_u), trail_u)
    consumed_u = 14 + nm_u

    zero = torch.zeros_like(c0)
    xor = pair_select(contained, xor_c, xor_u)
    xor = pair_select(zero_path, (zero, zero), xor)
    consumed = torch.where(zero_path, 1, torch.where(contained, consumed_c, consumed_u))
    new_bits = (prev_float_bits[0] ^ xor[0], prev_float_bits[1] ^ xor[1])
    return new_bits, xor, consumed


def _decode_value(fetch, state: DecodeState, first):
    """One int-optimized value record for every lane (decode.py
    _decode_value with int_optimized=True)."""
    pos = state.pos
    ws = fetch(pos)
    head3 = _extract32(ws, 0, 3)
    first_is_float = ((head3 >> 2) & 1) == 1
    b0 = (head3 >> 2) & 1
    b1 = (head3 >> 1) & 1
    b2 = head3 & 1
    upd = b0 == 0
    repeat = upd & (b1 == 1)
    to_float = upd & ~repeat & (b2 == 1)
    to_int = upd & ~repeat & (b2 == 0)
    stay = ~upd

    sel_first_float = first & first_is_float
    sel_first_int = first & ~first_is_float
    sel_to_float = ~first & to_float
    sel_to_int = ~first & to_int
    sel_stay_float = ~first & stay & state.is_float
    sel_stay_int = ~first & stay & ~state.is_float

    full = pair_select(first, _extract(ws, 1, 64), _extract(ws, 3, 64))
    takes_header = sel_first_int | sel_to_int
    hdr12 = torch.where(first, _extract32(ws, 1, 12), _extract32(ws, 3, 12))
    h_sig, h_mult, h_consumed, h_mult_bad = _read_int_header12(hdr12, state.sig, state.mult)
    diff_off = torch.where(first, 1 + h_consumed, torch.where(to_int, 3 + h_consumed, 1))
    diff_sig = torch.where(takes_header, h_sig, state.sig)
    zero = torch.zeros_like(pos)
    diff_base = pair_select(first, (zero, zero), state.int_val)
    d_int_val, d_consumed = _read_int_diff(ws, diff_off, diff_sig, diff_base)
    x_bits, x_xor, x_consumed = _read_xor(ws, 1, state.prev_float_bits, state.prev_xor)

    first_consumed = torch.where(first_is_float, 65, 1 + h_consumed + d_consumed)
    next_consumed = torch.where(
        repeat, 2,
        torch.where(
            to_float, 3 + 64,
            torch.where(
                to_int, 3 + h_consumed + d_consumed,
                torch.where(state.is_float, 1 + x_consumed, 1 + d_consumed),
            ),
        ),
    )
    consumed = torch.where(first, first_consumed, next_consumed)

    new_is_float = (sel_first_float | sel_to_float) | (
        ~(sel_first_int | sel_to_int) & state.is_float
    )
    takes_full = sel_first_float | sel_to_float
    new_float_bits = pair_select(takes_full, full, state.prev_float_bits)
    new_float_bits = pair_select(sel_stay_float, x_bits, new_float_bits)
    new_xor = pair_select(takes_full, full, state.prev_xor)
    new_xor = pair_select(sel_stay_float, x_xor, new_xor)
    takes_diff = sel_first_int | sel_to_int | sel_stay_int
    new_int_val = pair_select(takes_diff, d_int_val, state.int_val)
    new_sig = torch.where(takes_header, h_sig, state.sig)
    new_mult = torch.where(takes_header, h_mult, state.mult)
    err_now = takes_header & h_mult_bad

    active = ~state.done & ~state.err & ~err_now
    return state._replace(
        pos=torch.where(active, pos + consumed, state.pos),
        err=state.err | (err_now & ~state.done),
        prev_float_bits=pair_select(active, new_float_bits, state.prev_float_bits),
        prev_xor=pair_select(active, new_xor, state.prev_xor),
        int_val=pair_select(active, new_int_val, state.int_val),
        sig=torch.where(active, new_sig, state.sig),
        mult=torch.where(active, new_mult, state.mult),
        is_float=torch.where(active, new_is_float, state.is_float),
    )


def _decode_value_float(fetch, state: DecodeState, first):
    """One value record of the float-only scheme for every lane (decode.py
    _decode_value with int_optimized=False, :431-444): the first record is
    a 64-bit float, every later one an XOR record; every point is float."""
    pos = state.pos
    ws = fetch(pos)
    full = _extract(ws, 0, 64)
    x_bits, x_xor, x_consumed = _read_xor(ws, 0, state.prev_float_bits, state.prev_xor)
    active = ~state.done & ~state.err
    return state._replace(
        pos=torch.where(active, pos + torch.where(first, 64, x_consumed), pos),
        prev_float_bits=pair_select(active, pair_select(first, full, x_bits),
                                    state.prev_float_bits),
        prev_xor=pair_select(active, pair_select(first, full, x_xor), state.prev_xor),
        is_float=torch.ones_like(state.is_float),
    )


# ---------------------------------------------------------------------------
# Record decode (fast bodies: host-classified chunks, see ops/chunked.py)
# ---------------------------------------------------------------------------


def _ts_consumed_fast(ws):
    """Width of a marker-free {s, ms} timestamp record (its value is never
    needed: the fused kernel emits aggregates only)."""
    head4 = _extract32(ws, 0, 4)
    b0 = (head4 >> 3) & 1
    b1 = (head4 >> 2) & 1
    b2 = (head4 >> 1) & 1
    return torch.where(
        b0 == 0, 1,
        torch.where(
            b1 == 0, 9,
            torch.where(b2 == 0, 12, torch.where((head4 & 1) == 0, 16, 36)),
        ),
    )


def _decode_value_fast(fetch, pos, iv, sig, mult):
    """Int-mode-only value record in 32-bit arithmetic (repeat / stay-int /
    update-int). ``iv`` is the int32 value (as int64). Returns (pos', iv',
    sig', mult')."""
    ws = fetch(pos)
    head2 = _extract32(ws, 0, 2)
    b0 = (head2 >> 1) & 1
    b1 = head2 & 1
    repeat = (b0 == 0) & (b1 == 1)
    to_int = (b0 == 0) & (b1 == 0)

    h_sig, h_mult, h_consumed, _ = _read_int_header12(_extract32(ws, 3, 12), sig, mult)
    diff_off = torch.where(to_int, 3 + h_consumed, 1)  # in [1, 17]: never 0
    diff_sig = torch.where(to_int, h_sig, sig)
    r = diff_off
    hi32 = shl32(ws[0], r) | (ws[1] >> (32 - r))
    bit32 = shl32(ws[1], r) >> 31
    sign_bit = hi32 >> 31
    body = shl32(hi32, 1) | bit32
    n = diff_sig
    # shifts of 32 or more give 0, as XLA's do
    diff = torch.where((n == 0) | (n > 32), 0, body >> torch.clamp(32 - n, 0, 31))
    diff_i = as_i32(diff)
    delta = torch.where(sign_bit == 1, diff_i, wrap_i32(-diff_i))
    new_iv = torch.where(repeat, iv, wrap_i32(iv + delta))
    consumed = torch.where(repeat, 2, torch.where(to_int, 3 + h_consumed + 1 + h_sig, 2 + sig))
    return (
        pos + consumed,
        new_iv,
        torch.where(to_int, h_sig, sig),
        torch.where(to_int, h_mult, mult),
    )


# ---------------------------------------------------------------------------
# f32 conversions (copies of the reference formulas, not native casts)
# ---------------------------------------------------------------------------


def _ftz(x):
    """Flush f32 subnormals to a zero of the same sign."""
    return torch.where(x.abs() < FLT_MIN, x * 0.0, x)


def _f32(x):
    return x.to(F32)


def u32_to_f32(x):
    """u32 word → f32 through two exact 16-bit halves (u64.u32_to_f32)."""
    return _f32(x >> 16) * 65536.0 + _f32(x & 0xFFFF)


def to_f32(a):
    """Signed 64-bit pair → f32 as the reference approximates it
    (u64.to_f32): hi as int32 times 2**32 plus lo. Small negative values
    come out wrong (-3 gives 0.0); the port keeps the formula as written."""
    return _f32(as_i32(a[0])) * 4294967296.0 + u32_to_f32(a[1])


def _pow2(e):
    return ((e + 127) << 23).to(torch.int32).view(F32)


def f64_bits_to_f32(a):
    """float64 bits → f32 value by the reference formula (u64.f64_bits_to_f32);
    not correctly rounded, so a native cast would differ."""
    hi, lo = a
    sign = torch.where((hi >> 31) != 0, -1.0, 1.0).to(F32)
    exp = (hi >> 20) & 0x7FF
    mant = _f32(hi & 0xFFFFF) * 2.0**32 + u32_to_f32(lo)
    frac = mant * 2.0**-52
    e = torch.clamp(exp - 1023, -149, 128)
    e1 = torch.clamp(e, -126, 127)
    magnitude = _ftz((1.0 + frac) * _pow2(e1) * _pow2(e - e1))
    magnitude = torch.where(exp == 0, _ftz(frac * _pow2(torch.full_like(exp, -126))), magnitude)
    special = exp == 0x7FF
    magnitude = torch.where(
        special, torch.where(mant == 0, torch.inf, torch.nan).to(F32), magnitude
    )
    return sign * magnitude


_RECIPROCALS = (1.0, 0.1, 0.01, 1e-3, 1e-4, 1e-5, 1e-6)


def _mult_reciprocal(mult, like):
    """10**-mult as correctly rounded f32 constants (mult in [0, 6], else 1)."""
    rcp = torch.ones_like(like)
    for m, s in enumerate(_RECIPROCALS):
        if m:
            rcp = torch.where(mult == m, torch.tensor(s, dtype=F32, device=like.device), rcp)
    return rcp


def _int32_val_to_f32(iv, mult):
    v = _f32(iv)
    return v * _mult_reciprocal(mult, v)


def _int_val_to_f32(pair, mult):
    v = to_f32(pair)
    return v * _mult_reciprocal(mult, v)


# ---------------------------------------------------------------------------
# Decoded records and their exact f64 values
# ---------------------------------------------------------------------------


class DecodeResult(NamedTuple):
    """Per-record outputs of a decode, [S, T] (or [N, K] per lane):
    ``m3_tpu/ops/decode.py`` DecodeResult with native 64-bit fields in
    place of its (hi, lo) pairs. ``values_f32`` (the records' approximate
    f32 values, NaN where invalid) is filled by the whole-stream decode
    (``decode_batched``), whose scan reads it; the chunked decode leaves it
    None (its callers convert with ``record_values_f32`` or finalize_decode)."""

    ts: torch.Tensor  # int64: prev_time after each record (nanos)
    bits: torch.Tensor  # int64: float64 bits if point_is_float, else the int value
    point_is_float: torch.Tensor  # bool
    mult: torch.Tensor  # uint8: decimal exponent of an int point (0..6)
    valid: torch.Tensor  # bool
    err: torch.Tensor  # bool[S] (or [N]): decode hit an unsupported feature
    values_f32: torch.Tensor | None = None  # f32


# records a block of record_values_f32: its int64 temporaries stay at a
# few hundred MB (at 1M x 720 records whole ones would take tens of GB)
_F32_BLOCK_RECORDS = 1 << 24


def record_values_f32(bits, point_is_float, mult, valid):
    """The records' approximate f32 values, NaN where invalid (the
    reference's ``values_f32``: float points by u64.f64_bits_to_f32, int
    points by _int_val_to_f32, its formulas), converted in blocks of rows."""
    out = torch.empty(bits.shape, dtype=F32, device=bits.device)
    rows = max(1, _F32_BLOCK_RECORDS // max(1, bits.shape[1:].numel()))
    for start in range(0, bits.shape[0], rows):
        r = slice(start, start + rows)
        b = bits[r]
        pair = ((b >> 32) & M32, b & M32)
        vals = torch.where(point_is_float[r], f64_bits_to_f32(pair),
                           _int_val_to_f32(pair, mult[r].to(torch.int64)))
        out[r] = torch.where(valid[r], vals, torch.nan)
    return out


def pair_to_i64(a):
    """A (hi, lo) pair of u32 words → the int64 with those 64 bits."""
    return as_i32(a[0]) * 2**32 + a[1]


# 10**m for m in 0..6 as exact float64 constants: np.power(10.0, m) is exact
# there, a device pow is not guaranteed to be
_POW10 = (1.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6)


def finalize_values(bits, point_is_float, mult):
    """Exact f64 values (decode.py finalize_decode): float points are their
    bits viewed as f64, int points int64 → f64 divided by 10**mult, the CPU
    iterator's convertFromIntFloat arithmetic, so values equal numpy's bit
    for bit."""
    table = torch.tensor(_POW10, dtype=torch.float64, device=bits.device)
    scale = table[mult.to(torch.int64).clamp(0, len(_POW10) - 1)]
    return torch.where(point_is_float, bits.view(torch.float64), bits.to(torch.float64) / scale)


def finalize_decode(res: DecodeResult):
    """(timestamps int64, values float64, valid bool) on the records'
    device (m3_tpu/ops/decode.py:656 finalize_decode)."""
    return res.ts, finalize_values(res.bits, res.point_is_float, res.mult), res.valid


# ---------------------------------------------------------------------------
# Whole-stream decode: kernel B-6 and its twin
# ---------------------------------------------------------------------------

# Launches of kernel B-6, counted by decode_batched where it launches.
LAUNCHES = 0


def batched_device_args(seg, device="cuda"):
    """A BatchedSegments -> ``decode_batched``'s (words int32 [S, W] of u32
    bits, num_bits int32 [S], initial_unit int32 [S] for the default unit,
    seconds) on ``device``."""
    import numpy as np

    from .. import resolve_device

    dev = resolve_device(device)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x).view(np.int32)).to(dev)
    return (put(np.asarray(seg.words, np.uint32)), put(np.asarray(seg.num_bits, np.int32)),
            put(seg.initial_units().astype(np.int32)))


def _check_batched(words, num_bits, initial_unit, max_points):
    if any(x.dtype != torch.int32 for x in (words, num_bits, initial_unit)):
        raise TypeError("words, num_bits and initial_unit must be int32 tensors")
    s = words.shape[0]
    if words.dim() != 2 or words.shape[1] < 1 or num_bits.shape != (s,) \
            or initial_unit.shape != (s,):
        raise ValueError(f"want words [S, W >= 1] and num_bits, initial_unit [S]; got "
                         f"{tuple(words.shape)}, {tuple(num_bits.shape)}, "
                         f"{tuple(initial_unit.shape)}")
    if num_bits.device != words.device or initial_unit.device != words.device:
        raise ValueError("words, num_bits and initial_unit lie on different devices")
    if max_points <= 0:
        raise ValueError(f"max_points must be positive, got {max_points}")


def decode_batched(words, num_bits, initial_unit, max_points: int,
                   int_optimized: bool = True) -> DecodeResult:
    """Decode up to ``max_points`` records of every series' whole stream,
    from bit 0 (m3_tpu/ops/decode.py:542 decode_batched). ``words`` are the
    u32 words of ``BatchedSegments.words`` as int32 [S, W], ``num_bits`` and
    ``initial_unit`` int32 [S] (``batched_device_args``). Returns [S, T]
    records with ``values_f32``; ``err`` is per series.

    For CUDA tensors this launches kernel B-6 (``csrc/lane_aggregates.cu``
    m3_decode_batched) and raises if the build or the launch fails; for CPU
    tensors it runs the plain twin."""
    _check_batched(words, num_bits, initial_unit, max_points)
    if words.device.type == "cpu" or words.shape[0] == 0:
        return decode_batched_reference(words, num_bits, initial_unit, max_points, int_optimized)
    if words.device.type != "cuda":
        raise ValueError(f"unsupported device {words.device}")
    return _launch_batched(words, num_bits, initial_unit, max_points, int_optimized)


def _launch_batched(words, num_bits, initial_unit, t, int_optimized) -> DecodeResult:
    global LAUNCHES
    import ctypes

    from .. import device_guard
    from ._build import launch_error, load_library

    lib = load_library("lane_aggregates")
    words, num_bits, initial_unit = (x.contiguous() for x in (words, num_bits, initial_unit))
    s, w = words.shape
    dev = words.device
    ts = torch.empty((s, t), dtype=torch.int64, device=dev)
    bits = torch.empty((s, t), dtype=torch.int64, device=dev)
    small = torch.empty((3, s, t), dtype=torch.uint8, device=dev)  # pif, mult, valid
    err = torch.empty(s, dtype=torch.uint8, device=dev)
    vals = torch.empty((s, t), dtype=F32, device=dev)
    ptr = lambda x: ctypes.c_void_p(x.data_ptr())
    with device_guard(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.m3_decode_batched(
            ptr(words), ptr(num_bits), ptr(initial_unit), s, w, t, int(int_optimized),
            ptr(ts), ptr(bits), ptr(small[0]), ptr(small[1]), ptr(small[2]), ptr(err), ptr(vals),
            ctypes.c_void_p(stream),
        )
    if rc != 0:
        raise launch_error("decode_batched", rc, words=words, num_bits=num_bits,
                           initial_unit=initial_unit, ts=ts, values_f32=vals)
    LAUNCHES += 1
    return DecodeResult(
        ts=ts, bits=bits, point_is_float=small[0].view(torch.bool), mult=small[1],
        valid=small[2].view(torch.bool), err=err.view(torch.bool), values_f32=vals,
    )


def launch_shape(s: int, device="cuda") -> dict:
    """How kernel B-6 runs s series: warps a block (a series a lane), the
    blocks the launch starts and those the card holds at once, shared
    memory a block, registers and local (spilled) bytes a thread, and its
    geometry: records between flushes of ts/bits/values_f32 (group) and of
    the u8 planes (flag_group), words of a series' ring."""
    import ctypes

    from .. import device_guard
    from ._build import load_library

    out = (ctypes.c_int64 * 9)()
    with device_guard(torch.device(device)):
        rc = load_library("lane_aggregates").m3_decode_batched_shape(s, out)
    if rc != 0:
        raise RuntimeError(f"decode_batched launch_shape({s}): CUDA error {rc}")
    keys = ("warps", "blocks", "resident_blocks", "smem_bytes", "registers", "local_bytes",
            "group", "flag_group", "ring_words")
    return dict(zip(keys, (int(x) for x in out)))


def decode_batched_cost(words, num_bits, initial_unit, max_points: int) -> dict:
    """Kernel B-6's work on one launch, for ``KernelProfiler.capture_cost``:
    the bytes it moves (each series' stream words up to its valid bits, at
    most W, num_bits and initial_unit, 23 bytes a record and 1 a series
    written) and no floating-point operations counted. Reads one sum back
    from the device."""
    s, w = words.shape
    used = ((num_bits.to(torch.int64).clamp(min=0) + 31) // 32).clamp(max=w)
    return {"flops": 0.0,
            "bytes_accessed": float(int(used.sum()) * 4 + s * 8 + s * max_points * 23 + s)}


def decode_batched_reference(words, num_bits, initial_unit, max_points: int,
                             int_optimized: bool = True) -> DecodeResult:
    """Plain PyTorch version of kernel B-6, on any device: a
    ``max_points``-step loop over [S] decoder state, each step the
    timestamp and value record steps above with the clamped whole-stream
    fetch."""
    _check_batched(words, num_bits, initial_unit, max_points)
    s, t = words.shape[0], max_points
    dev = words.device
    words64 = words.to(torch.int64) & M32
    nb = num_bits.to(torch.int64)
    fetch = lambda pos: fetch4_clamped(words64, pos)
    zero = torch.zeros(s, dtype=torch.int64, device=dev)
    no = torch.zeros(s, dtype=torch.bool, device=dev)
    state = DecodeState(
        pos=zero, done=nb <= 0, err=no, prev_time=(zero, zero), prev_delta=(zero, zero),
        time_unit=initial_unit.to(torch.int64), prev_float_bits=(zero, zero),
        prev_xor=(zero, zero), int_val=(zero, zero), mult=zero, sig=zero, is_float=no,
    )
    nt = _extract(fetch(zero), 0, 64)
    ts = torch.empty((s, t), dtype=torch.int64, device=dev)
    bits = torch.empty((s, t), dtype=torch.int64, device=dev)
    pif = torch.empty((s, t), dtype=torch.bool, device=dev)
    mult = torch.empty((s, t), dtype=torch.uint8, device=dev)
    valid = torch.empty((s, t), dtype=torch.bool, device=dev)
    yes = ~no
    for idx in range(t):
        first = yes if idx == 0 else no
        was_active = ~state.done & ~state.err
        state = _decode_timestamp(fetch, nb, state, first, nt)
        ts_active = ~state.done & ~state.err
        if int_optimized:
            state = _decode_value(fetch, state, first)
        else:
            state = _decode_value_float(fetch, state, first)
        ts[:, idx] = pair_to_i64(state.prev_time)
        bits[:, idx] = pair_to_i64(pair_select(state.is_float, state.prev_float_bits,
                                               state.int_val))
        pif[:, idx] = state.is_float
        mult[:, idx] = state.mult.to(torch.uint8)
        valid[:, idx] = was_active & ts_active & ~state.done & ~state.err
    return DecodeResult(ts=ts, bits=bits, point_is_float=pif, mult=mult, valid=valid,
                        err=state.err, values_f32=record_values_f32(bits, pif, mult, valid))
