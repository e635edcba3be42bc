"""M3TSZ streaming codec — bit-exact CPU reference implementation.

This is the ground-truth contract for the CUDA decode kernel. Behavioral parity
with upstream M3 src/dbnode/encoding/m3tsz/:
- timestamps: delta-of-delta with per-unit bucketed variable-width encoding
  (timestamp_encoder.go:175-206), first timestamp as 64-bit unix nanos
  (timestamp_encoder.go:77-84), in-stream markers for end-of-stream /
  annotation / time-unit change (scheme.go:28-38, timestamp_iterator.go:147-201).
- values: Gorilla XOR floats (float_encoder_iterator.go:69-103) with optional
  int optimization — decimal scaling probe, significant-bit tracking with
  hysteresis, sign+diff records (encoder.go:111-249, m3tsz.go:78-118,
  int_sig_bits_tracker.go).
- stream finalization: head bytes + canonical tail carrying the EOS marker
  (encoder.go:383-446).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

from ..utils import varint
from ..utils.bits import (
    MASK64,
    bits_to_float,
    float_to_bits,
    leading_and_trailing_zeros,
    num_sig,
    sign_extend,
)
from ..utils.xtime import Unit, from_normalized, initial_time_unit, to_normalized
from . import scheme
from .istream import IStream
from .ostream import OStream

# Value-stream opcodes (m3tsz.go:32-55).
OPCODE_ZERO_SIG = 0x0
OPCODE_NON_ZERO_SIG = 0x1
NUM_SIG_BITS = 6

OPCODE_ZERO_VALUE_XOR = 0x0
OPCODE_CONTAINED_VALUE_XOR = 0x2
OPCODE_UNCONTAINED_VALUE_XOR = 0x3
OPCODE_NO_UPDATE_SIG = 0x0
OPCODE_UPDATE_SIG = 0x1
OPCODE_UPDATE = 0x0
OPCODE_NO_UPDATE = 0x1
OPCODE_UPDATE_MULT = 0x1
OPCODE_NO_UPDATE_MULT = 0x0
OPCODE_POSITIVE = 0x0
OPCODE_NEGATIVE = 0x1
OPCODE_REPEAT = 0x1
OPCODE_NO_REPEAT = 0x0
OPCODE_FLOAT_MODE = 0x1
OPCODE_INT_MODE = 0x0

SIG_DIFF_THRESHOLD = 3
SIG_REPEAT_THRESHOLD = 5

MAX_MULT = 6
NUM_MULT_BITS = 3

MAX_INT = float(2**63)  # float64(math.MaxInt64) rounds up to 2^63
MIN_INT = float(-(2**63))
MAX_OPT_INT = 10.0**13

_MULTIPLIERS = [10.0**i for i in range(MAX_MULT + 1)]

DEFAULT_INT_OPTIMIZATION = True


def convert_to_int_float(v: float, cur_max_mult: int) -> tuple[float, int, bool]:
    """Probe decimal scaling of a float (m3tsz.go convertToIntFloat:78-118).

    Returns (value, multiplier, is_float). When is_float is False, ``value`` is
    an integral float equal to v * 10^multiplier (sign preserved).
    """
    if cur_max_mult == 0 and v < MAX_INT:
        # Quick check for values that are already ints.
        frac, i = math.modf(v)
        if frac == 0:
            return i, 0, False

    if cur_max_mult > MAX_MULT:
        raise ValueError("supplied multiplier is invalid")

    val = v * _MULTIPLIERS[cur_max_mult]
    sign = 1.0
    if v < 0:
        sign = -1.0
        val = val * -1.0

    mult = cur_max_mult
    while mult <= MAX_MULT and val < MAX_OPT_INT:
        frac, i = math.modf(val)
        if frac == 0:
            return sign * i, mult, False
        elif frac < 0.1:
            # Round down and check.
            if math.nextafter(val, 0.0) <= i:
                return sign * i, mult, False
        elif frac > 0.9:
            # Round up and check.
            nxt = i + 1
            if math.nextafter(val, nxt) >= nxt:
                return sign * nxt, mult, False
        val = val * 10.0
        mult += 1

    return v, 0, True


def convert_from_int_float(val: float, mult: int) -> float:
    if mult == 0:
        return val
    return val / _MULTIPLIERS[mult]


class FloatXOR:
    """XOR float codec state (float_encoder_iterator.go:36-166)."""

    __slots__ = ("prev_xor", "prev_float_bits")

    def __init__(self) -> None:
        self.prev_xor = 0
        self.prev_float_bits = 0

    # --- encode ---

    def write_full_float(self, os: OStream, val_bits: int) -> None:
        self.prev_float_bits = val_bits
        self.prev_xor = val_bits
        os.write_bits(val_bits, 64)

    def write_next_float(self, os: OStream, val_bits: int) -> None:
        xor = self.prev_float_bits ^ val_bits
        self._write_xor(os, xor)
        self.prev_xor = xor
        self.prev_float_bits = val_bits

    def _write_xor(self, os: OStream, cur_xor: int) -> None:
        if cur_xor == 0:
            os.write_bits(OPCODE_ZERO_VALUE_XOR, 1)
            return
        prev_leading, prev_trailing = leading_and_trailing_zeros(self.prev_xor)
        cur_leading, cur_trailing = leading_and_trailing_zeros(cur_xor)
        if cur_leading >= prev_leading and cur_trailing >= prev_trailing:
            os.write_bits(OPCODE_CONTAINED_VALUE_XOR, 2)
            os.write_bits(cur_xor >> prev_trailing, 64 - prev_leading - prev_trailing)
            return
        os.write_bits(OPCODE_UNCONTAINED_VALUE_XOR, 2)
        os.write_bits(cur_leading, 6)
        num_meaningful = 64 - cur_leading - cur_trailing
        os.write_bits(num_meaningful - 1, 6)
        os.write_bits(cur_xor >> cur_trailing, num_meaningful)

    # --- decode ---

    def read_full_float(self, stream: IStream) -> None:
        vb = stream.read_bits(64)
        self.prev_float_bits = vb
        self.prev_xor = vb

    def read_next_float(self, stream: IStream) -> None:
        cb = stream.read_bits(1)
        if cb == OPCODE_ZERO_VALUE_XOR:
            self.prev_xor = 0
            return
        cb = (cb << 1) | stream.read_bits(1)
        if cb == OPCODE_CONTAINED_VALUE_XOR:
            prev_leading, prev_trailing = leading_and_trailing_zeros(self.prev_xor)
            num_meaningful = 64 - prev_leading - prev_trailing
            meaningful = stream.read_bits(num_meaningful)
            self.prev_xor = (meaningful << prev_trailing) & MASK64
            self.prev_float_bits ^= self.prev_xor
            return
        packed = stream.read_bits(12)
        num_leading = (packed >> 6) & 0x3F
        num_meaningful = (packed & 0x3F) + 1
        meaningful = stream.read_bits(num_meaningful)
        num_trailing = 64 - num_leading - num_meaningful
        self.prev_xor = (meaningful << num_trailing) & MASK64
        self.prev_float_bits ^= self.prev_xor


class IntSigBitsTracker:
    """Significant-bit tracking with hysteresis (int_sig_bits_tracker.go)."""

    __slots__ = ("num_sig", "cur_highest_lower_sig", "num_lower_sig")

    def __init__(self) -> None:
        self.num_sig = 0
        self.cur_highest_lower_sig = 0
        self.num_lower_sig = 0

    def write_int_val_diff(self, os: OStream, val_bits: int, neg: bool) -> None:
        os.write_bit(OPCODE_NEGATIVE if neg else OPCODE_POSITIVE)
        os.write_bits(val_bits, self.num_sig)

    def write_int_sig(self, os: OStream, sig: int) -> None:
        if self.num_sig != sig:
            os.write_bit(OPCODE_UPDATE_SIG)
            if sig == 0:
                os.write_bit(OPCODE_ZERO_SIG)
            else:
                os.write_bit(OPCODE_NON_ZERO_SIG)
                os.write_bits(sig - 1, NUM_SIG_BITS)
        else:
            os.write_bit(OPCODE_NO_UPDATE_SIG)
        self.num_sig = sig

    def track_new_sig(self, sig: int) -> int:
        new_sig = self.num_sig
        if sig > self.num_sig:
            new_sig = sig
        elif self.num_sig - sig >= SIG_DIFF_THRESHOLD:
            if self.num_lower_sig == 0:
                self.cur_highest_lower_sig = sig
            elif sig > self.cur_highest_lower_sig:
                self.cur_highest_lower_sig = sig
            self.num_lower_sig += 1
            if self.num_lower_sig >= SIG_REPEAT_THRESHOLD:
                new_sig = self.cur_highest_lower_sig
                self.num_lower_sig = 0
        else:
            self.num_lower_sig = 0
        return new_sig


class TimestampEncoder:
    """Delta-of-delta timestamp encoder (timestamp_encoder.go)."""

    def __init__(self, start_nanos: int, unit: Unit = Unit.SECOND) -> None:
        self.prev_time = start_nanos
        self.prev_time_delta = 0
        self.prev_annotation: bytes | None = None
        self.time_unit = initial_time_unit(start_nanos, unit)
        self._time_unit_encoded_manually = False
        self._has_written_first = False

    def write_time(self, os: OStream, t_nanos: int, annotation: bytes | None, unit: Unit) -> None:
        if not self._has_written_first:
            self.write_first_time(os, t_nanos, annotation, unit)
            self._has_written_first = True
            return
        self.write_next_time(os, t_nanos, annotation, unit)

    def write_first_time(self, os: OStream, t_nanos: int, annotation: bytes | None, unit: Unit) -> None:
        # First time is always written in nanoseconds (timestamp_encoder.go:77-84).
        os.write_bits(self.prev_time & MASK64, 64)
        self.write_next_time(os, t_nanos, annotation, unit)

    def write_next_time(self, os: OStream, t_nanos: int, annotation: bytes | None, unit: Unit) -> None:
        self._write_annotation(os, annotation)
        tu_changed = self._maybe_write_time_unit_change(os, unit)

        time_delta = t_nanos - self.prev_time
        self.prev_time = t_nanos
        if tu_changed or self._time_unit_encoded_manually:
            # Normalized 64-bit nanos dod; reset delta (timestamp_encoder.go:94-102).
            dod = time_delta - self.prev_time_delta
            os.write_bits(dod & MASK64, 64)
            self.prev_time_delta = 0
            self._time_unit_encoded_manually = False
            return
        self._write_dod_unchanged(os, self.prev_time_delta, time_delta, unit)
        self.prev_time_delta = time_delta

    def write_time_unit(self, os: OStream, unit: Unit) -> None:
        os.write_byte(int(unit))
        self.time_unit = unit
        self._time_unit_encoded_manually = True

    def _maybe_write_time_unit_change(self, os: OStream, unit: Unit) -> bool:
        if not unit.is_valid() or unit == self.time_unit:
            return False
        scheme.write_special_marker(os, scheme.TIME_UNIT_MARKER)
        self.write_time_unit(os, unit)
        return True

    def _write_annotation(self, os: OStream, annotation: bytes | None) -> None:
        if not annotation or annotation == self.prev_annotation:
            return
        scheme.write_special_marker(os, scheme.ANNOTATION_MARKER)
        # Length-1 for varint savings (timestamp_encoder.go:158-163).
        os.write_bytes(varint.put_varint(len(annotation) - 1))
        os.write_bytes(annotation)
        self.prev_annotation = annotation

    def _write_dod_unchanged(self, os: OStream, prev_delta: int, cur_delta: int, unit: Unit) -> None:
        dod = to_normalized(cur_delta - prev_delta, unit)
        tes = scheme.scheme_for_unit(unit)
        if tes is None:
            raise ValueError(f"no time encoding scheme for unit {unit!r}")
        if dod == 0:
            zb = tes.zero_bucket
            os.write_bits(zb.opcode, zb.num_opcode_bits)
            return
        for bucket in tes.buckets:
            if bucket.min <= dod <= bucket.max:
                os.write_bits(bucket.opcode, bucket.num_opcode_bits)
                os.write_bits(dod & ((1 << bucket.num_value_bits) - 1), bucket.num_value_bits)
                return
        db = tes.default_bucket
        os.write_bits(db.opcode, db.num_opcode_bits)
        os.write_bits(dod & ((1 << db.num_value_bits) - 1), db.num_value_bits)


class Encoder:
    """M3TSZ encoder (encoder.go). Produces the finalized stream via stream()."""

    def __init__(
        self,
        start_nanos: int,
        int_optimized: bool = DEFAULT_INT_OPTIMIZATION,
        default_unit: Unit = Unit.SECOND,
    ) -> None:
        # The initial stream unit comes from the options default (encoder.go:80,
        # options.go defaultDefaultTimeUnit); per-write units are signalled with
        # time-unit markers when they differ.
        self.os = OStream()
        self.ts_encoder = TimestampEncoder(start_nanos, default_unit)
        self.float_enc = FloatXOR()
        self.sig_tracker = IntSigBitsTracker()
        self.int_val = 0.0
        self.num_encoded = 0
        self.max_mult = 0
        self.int_optimized = int_optimized
        self.is_float = False

    def encode(
        self,
        t_nanos: int,
        value: float,
        unit: Unit = Unit.SECOND,
        annotation: bytes | None = None,
    ) -> None:
        self.ts_encoder.write_time(self.os, t_nanos, annotation, unit)
        if self.num_encoded == 0:
            self._write_first_value(value)
        else:
            self._write_next_value(value)
        self.num_encoded += 1

    def _write_first_value(self, v: float) -> None:
        if not self.int_optimized:
            self.float_enc.write_full_float(self.os, float_to_bits(v))
            return

        val, mult, is_float = convert_to_int_float(v, 0)
        if is_float:
            self.os.write_bit(OPCODE_FLOAT_MODE)
            self.float_enc.write_full_float(self.os, float_to_bits(v))
            self.is_float = True
            self.max_mult = mult
            return

        self.os.write_bit(OPCODE_INT_MODE)
        self.int_val = val
        neg_diff = True
        if val < 0:
            neg_diff = False
            val = -1 * val

        val_bits = int(val) & MASK64
        sig = num_sig(val_bits)
        self._write_int_sig_mult(sig, mult, False)
        self.sig_tracker.write_int_val_diff(self.os, val_bits, neg_diff)

    def _write_next_value(self, v: float) -> None:
        if not self.int_optimized:
            self.float_enc.write_next_float(self.os, float_to_bits(v))
            return

        val, mult, is_float = convert_to_int_float(v, self.max_mult)
        val_diff = 0.0
        if not is_float:
            val_diff = self.int_val - val

        if is_float or val_diff >= MAX_INT or val_diff <= MIN_INT:
            self._write_float_val(float_to_bits(val), mult)
            return
        self._write_int_val(val, mult, is_float, val_diff)

    def _write_float_val(self, val_bits: int, mult: int) -> None:
        if not self.is_float:
            # Converting from int to float mode (encoder.go:175-186).
            self.os.write_bit(OPCODE_UPDATE)
            self.os.write_bit(OPCODE_NO_REPEAT)
            self.os.write_bit(OPCODE_FLOAT_MODE)
            self.float_enc.write_full_float(self.os, val_bits)
            self.is_float = True
            self.max_mult = mult
            return
        if val_bits == self.float_enc.prev_float_bits:
            self.os.write_bit(OPCODE_UPDATE)
            self.os.write_bit(OPCODE_REPEAT)
            return
        self.os.write_bit(OPCODE_NO_UPDATE)
        self.float_enc.write_next_float(self.os, val_bits)

    def _write_int_val(self, val: float, mult: int, is_float: bool, val_diff: float) -> None:
        if val_diff == 0 and is_float == self.is_float and mult == self.max_mult:
            self.os.write_bit(OPCODE_UPDATE)
            self.os.write_bit(OPCODE_REPEAT)
            return

        neg = False
        if val_diff < 0:
            neg = True
            val_diff = -1 * val_diff

        val_diff_bits = int(val_diff) & MASK64
        sig = num_sig(val_diff_bits)
        new_sig = self.sig_tracker.track_new_sig(sig)
        is_float_changed = is_float != self.is_float
        if mult > self.max_mult or self.sig_tracker.num_sig != new_sig or is_float_changed:
            self.os.write_bit(OPCODE_UPDATE)
            self.os.write_bit(OPCODE_NO_REPEAT)
            self.os.write_bit(OPCODE_INT_MODE)
            self._write_int_sig_mult(new_sig, mult, is_float_changed)
            self.sig_tracker.write_int_val_diff(self.os, val_diff_bits, neg)
            self.is_float = False
        else:
            self.os.write_bit(OPCODE_NO_UPDATE)
            self.sig_tracker.write_int_val_diff(self.os, val_diff_bits, neg)

        self.int_val = val

    def _write_int_sig_mult(self, sig: int, mult: int, float_changed: bool) -> None:
        self.sig_tracker.write_int_sig(self.os, sig)
        if mult > self.max_mult:
            self.os.write_bit(OPCODE_UPDATE_MULT)
            self.os.write_bits(mult, NUM_MULT_BITS)
            self.max_mult = mult
        elif self.sig_tracker.num_sig == sig and self.max_mult == mult and float_changed:
            # Only float mode changed: update mult anyway (encoder.go:241-245).
            self.os.write_bit(OPCODE_UPDATE_MULT)
            self.os.write_bits(self.max_mult, NUM_MULT_BITS)
        else:
            self.os.write_bit(OPCODE_NO_UPDATE_MULT)

    def stream(self) -> bytes:
        """Finalized stream: head bytes + canonical EOS tail (encoder.go:383-418)."""
        raw, pos = self.os.raw_bytes()
        if not raw:
            return b""
        return raw[:-1] + scheme.tail(raw[-1], pos)

    def __len__(self) -> int:
        raw, pos = self.os.raw_bytes()
        if not raw:
            return 0
        return len(raw) - 1 + len(scheme.tail(raw[-1], pos))


@dataclass
class Datapoint:
    timestamp: int  # unix nanos
    value: float
    unit: Unit = Unit.SECOND
    annotation: bytes | None = None


class TimestampIterator:
    """Delta-of-delta timestamp decoder (timestamp_iterator.go)."""

    def __init__(self, default_unit: Unit = Unit.SECOND, skip_markers: bool = False) -> None:
        self.prev_time = 0
        self.prev_time_delta = 0
        self.prev_annotation: bytes | None = None
        self.time_unit = Unit.NONE
        self.default_unit = default_unit
        self.time_unit_changed = False
        self.done = False
        self.skip_markers = skip_markers
        self.num_markers = 0  # markers consumed (EOS/annotation/time-unit)

    def read_timestamp(self, stream: IStream) -> bool:
        """Returns True when this was the first timestamp."""
        self.prev_annotation = None
        first = False
        if self.prev_time == 0:
            first = True
            self._read_first_timestamp(stream)
        else:
            self._read_next_timestamp(stream)
        if self.time_unit_changed:
            self.prev_time_delta = 0
            self.time_unit_changed = False
        return first

    def read_time_unit(self, stream: IStream) -> None:
        tu = stream.read_byte()
        try:
            unit = Unit(tu)
        except ValueError:
            unit = Unit.NONE
        if unit.is_valid() and unit != self.time_unit:
            self.time_unit_changed = True
        self.time_unit = unit

    def _read_first_timestamp(self, stream: IStream) -> None:
        nt = stream.read_bits(64)
        if self.time_unit == Unit.NONE:
            self.time_unit = initial_time_unit(nt, self.default_unit)
        self._read_next_timestamp(stream)
        self.prev_time = nt + self.prev_time_delta

    def _read_next_timestamp(self, stream: IStream) -> None:
        dod = self._read_marker_or_dod(stream)
        self.prev_time_delta += dod
        self.prev_time = self.prev_time + self.prev_time_delta

    def _try_read_marker(self, stream: IStream) -> tuple[int, bool]:
        try:
            opcode_and_value = stream.peek_bits(scheme.NUM_MARKER_BITS)
        except EOFError:
            return 0, False
        opcode = opcode_and_value >> scheme.NUM_MARKER_VALUE_BITS
        if opcode != scheme.MARKER_OPCODE:
            return 0, False
        marker = opcode_and_value & ((1 << scheme.NUM_MARKER_VALUE_BITS) - 1)
        if marker == scheme.END_OF_STREAM_MARKER:
            stream.read_bits(scheme.NUM_MARKER_BITS)
            self.done = True
            self.num_markers += 1
            return 0, True
        elif marker == scheme.ANNOTATION_MARKER:
            stream.read_bits(scheme.NUM_MARKER_BITS)
            self._read_annotation(stream)
            self.num_markers += 1
            return self._read_marker_or_dod(stream), True
        elif marker == scheme.TIME_UNIT_MARKER:
            stream.read_bits(scheme.NUM_MARKER_BITS)
            self.read_time_unit(stream)
            self.num_markers += 1
            return self._read_marker_or_dod(stream), True
        return 0, False

    def _read_marker_or_dod(self, stream: IStream) -> int:
        if not self.skip_markers:
            dod, success = self._try_read_marker(stream)
            if self.done:
                return 0
            if success:
                return dod
        tes = scheme.scheme_for_unit(self.time_unit)
        if tes is None:
            raise ValueError(f"no time encoding scheme for unit {self.time_unit!r}")
        return self._read_dod(stream, tes)

    def _read_dod(self, stream: IStream, tes: scheme.TimeEncodingScheme) -> int:
        if self.time_unit_changed:
            # 64-bit normalized nanos dod (timestamp_iterator.go:228-238).
            dod_bits = stream.read_bits(64)
            return sign_extend(dod_bits, 64)

        cb = stream.read_bits(1)
        if cb == tes.zero_bucket.opcode:
            return 0
        for bucket in tes.buckets:
            cb = (cb << 1) | stream.read_bits(1)
            if cb == bucket.opcode:
                dod_bits = stream.read_bits(bucket.num_value_bits)
                dod = sign_extend(dod_bits, bucket.num_value_bits)
                return from_normalized(dod, self.time_unit)
        dod_bits = stream.read_bits(tes.default_bucket.num_value_bits)
        dod = sign_extend(dod_bits, tes.default_bucket.num_value_bits)
        return from_normalized(dod, self.time_unit)

    def _read_annotation(self, stream: IStream) -> None:
        ant_len = varint.read_varint(stream.read_byte) + 1
        if ant_len <= 0:
            raise ValueError(f"unexpected annotation length {ant_len}")
        self.prev_annotation = stream.read(ant_len)


class ReaderIterator:
    """M3TSZ decoder with the reference's iterator API (iterator.go).

    Usage::

        it = ReaderIterator(data)
        while it.next():
            dp = it.current()
    """

    def __init__(
        self,
        data: bytes,
        int_optimized: bool = DEFAULT_INT_OPTIMIZATION,
        default_unit: Unit = Unit.SECOND,
    ) -> None:
        self.stream = IStream(data)
        self.ts_iterator = TimestampIterator(default_unit)
        self.float_iter = FloatXOR()
        self.int_val = 0.0
        self.mult = 0
        self.sig = 0
        self.int_optimized = int_optimized
        self.is_float = False
        self.err: Exception | None = None
        self.closed = False

    # --- iteration ---

    def next(self) -> bool:
        if not self._has_next():
            return False
        try:
            first = self.ts_iterator.read_timestamp(self.stream)
            if self.ts_iterator.done:
                return False
            self._read_value(first)
        except (EOFError, ValueError) as e:  # parity: errors end iteration
            self.err = e
            return False
        return self._has_next()

    def current(self) -> Datapoint:
        if not self.int_optimized or self.is_float:
            value = bits_to_float(self.float_iter.prev_float_bits)
        else:
            value = convert_from_int_float(self.int_val, self.mult)
        return Datapoint(
            timestamp=self.ts_iterator.prev_time,
            value=value,
            unit=self.ts_iterator.time_unit,
            annotation=self.ts_iterator.prev_annotation,
        )

    def _has_next(self) -> bool:
        return self.err is None and not self.ts_iterator.done and not self.closed

    # --- value decode ---

    def _read_value(self, first: bool) -> None:
        if first:
            self._read_first_value()
        else:
            self._read_next_value()

    def _read_first_value(self) -> None:
        if not self.int_optimized:
            self.float_iter.read_full_float(self.stream)
            return
        if self.stream.read_bits(1) == OPCODE_FLOAT_MODE:
            self.float_iter.read_full_float(self.stream)
            self.is_float = True
            return
        self._read_int_sig_mult()
        self._read_int_val_diff()

    def _read_next_value(self) -> None:
        if not self.int_optimized:
            self.float_iter.read_next_float(self.stream)
            return
        if self.stream.read_bits(1) == OPCODE_UPDATE:
            if self.stream.read_bits(1) == OPCODE_REPEAT:
                return
            if self.stream.read_bits(1) == OPCODE_FLOAT_MODE:
                self.float_iter.read_full_float(self.stream)
                self.is_float = True
                return
            self._read_int_sig_mult()
            self._read_int_val_diff()
            self.is_float = False
            return
        if self.is_float:
            self.float_iter.read_next_float(self.stream)
        else:
            self._read_int_val_diff()

    def _read_int_sig_mult(self) -> None:
        if self.stream.read_bits(1) == OPCODE_UPDATE_SIG:
            if self.stream.read_bits(1) == OPCODE_ZERO_SIG:
                self.sig = 0
            else:
                self.sig = self.stream.read_bits(NUM_SIG_BITS) + 1
        if self.stream.read_bits(1) == OPCODE_UPDATE_MULT:
            self.mult = self.stream.read_bits(NUM_MULT_BITS)
            if self.mult > MAX_MULT:
                raise ValueError("supplied multiplier is invalid")

    def _read_int_val_diff(self) -> None:
        sign = -1.0
        if self.stream.read_bits(1) == OPCODE_NEGATIVE:
            sign = 1.0
        self.int_val += sign * self.stream.read_bits(self.sig)


def decode(
    data: bytes,
    int_optimized: bool = DEFAULT_INT_OPTIMIZATION,
    default_unit: Unit = Unit.SECOND,
) -> list[Datapoint]:
    """Decode a full M3TSZ stream into datapoints."""
    it = ReaderIterator(data, int_optimized=int_optimized, default_unit=default_unit)
    out = []
    while it.next():
        out.append(it.current())
    # Parity with Go callers: io.EOF is treated as stream end, anything else
    # (e.g. an invalid multiplier) is a real decode error.
    if it.err is not None and not isinstance(it.err, EOFError):
        raise it.err
    return out


def encode_series(
    timestamps: list[int],
    values: list[float],
    start_nanos: int | None = None,
    int_optimized: bool = DEFAULT_INT_OPTIMIZATION,
    unit: Unit = Unit.SECOND,
) -> bytes:
    """Encode a series of (nanos, value) into a finalized M3TSZ stream."""
    if len(timestamps) != len(values):
        raise ValueError("timestamps and values must have the same length")
    if not timestamps:
        return b""
    if start_nanos is None:
        start_nanos = timestamps[0]
    enc = Encoder(start_nanos, int_optimized=int_optimized)
    for t, v in zip(timestamps, values):
        enc.encode(t, v, unit=unit)
    return enc.stream()
