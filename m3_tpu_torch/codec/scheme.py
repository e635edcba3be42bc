"""Marker and delta-of-delta time encoding schemes.

Behavioral parity with upstream M3 src/dbnode/encoding/scheme.go:
- markers: 9-bit opcode 0x100 + 2-bit marker value (EOS=0, annotation=1,
  time-unit=2) embedded mid-stream; decoders peek 11 bits ahead of each
  delta-of-delta record to detect them (scheme.go:28-38).
- time buckets: zero bucket (1 bit '0'), escalating opcodes 0b10/0b110/0b1110
  with 7/9/12 value bits, then a default bucket 0b1111 with 32 value bits for
  second/millisecond streams and 64 for micro/nanosecond (scheme.go:42-52,
  143-165).
"""

from __future__ import annotations

from dataclasses import dataclass

from ..utils.xtime import Unit

# Marker scheme constants (scheme.go:28-38).
MARKER_OPCODE = 0x100
NUM_MARKER_OPCODE_BITS = 9
NUM_MARKER_VALUE_BITS = 2
NUM_MARKER_BITS = NUM_MARKER_OPCODE_BITS + NUM_MARKER_VALUE_BITS  # 11

END_OF_STREAM_MARKER = 0
ANNOTATION_MARKER = 1
TIME_UNIT_MARKER = 2


@dataclass(frozen=True)
class TimeBucket:
    opcode: int
    num_opcode_bits: int
    num_value_bits: int

    @property
    def min(self) -> int:
        return -(1 << (self.num_value_bits - 1))

    @property
    def max(self) -> int:
        return (1 << (self.num_value_bits - 1)) - 1


@dataclass(frozen=True)
class TimeEncodingScheme:
    zero_bucket: TimeBucket
    buckets: tuple[TimeBucket, ...]
    default_bucket: TimeBucket


def _new_scheme(bucket_value_bits: list[int], default_value_bits: int) -> TimeEncodingScheme:
    buckets = []
    num_opcode_bits = 1
    opcode = 0
    for i, vb in enumerate(bucket_value_bits):
        opcode = (1 << (i + 1)) | opcode
        buckets.append(TimeBucket(opcode, num_opcode_bits + 1, vb))
        num_opcode_bits += 1
    default_bucket = TimeBucket(opcode | 0x1, num_opcode_bits, default_value_bits)
    return TimeEncodingScheme(TimeBucket(0x0, 1, 0), tuple(buckets), default_bucket)


_BUCKET_BITS = [7, 9, 12]

TIME_ENCODING_SCHEMES: dict[Unit, TimeEncodingScheme] = {
    Unit.SECOND: _new_scheme(_BUCKET_BITS, 32),
    Unit.MILLISECOND: _new_scheme(_BUCKET_BITS, 32),
    Unit.MICROSECOND: _new_scheme(_BUCKET_BITS, 64),
    Unit.NANOSECOND: _new_scheme(_BUCKET_BITS, 64),
}


def scheme_for_unit(unit: Unit) -> TimeEncodingScheme | None:
    return TIME_ENCODING_SCHEMES.get(unit)


def write_special_marker(os, marker: int) -> None:
    """Write marker opcode + value (scheme.go WriteSpecialMarker)."""
    os.write_bits(MARKER_OPCODE, NUM_MARKER_OPCODE_BITS)
    os.write_bits(marker, NUM_MARKER_VALUE_BITS)


def tail(last_byte: int, pos: int) -> bytes:
    """Canonical stream tail: top ``pos`` bits of the last byte followed by the
    end-of-stream marker (scheme.go:243-258). The encoder's finalized stream is
    head (all full bytes but the last) + this tail.
    """
    from .ostream import OStream

    tmp = OStream()
    tmp.write_bits((last_byte & 0xFF) >> (8 - pos), pos)
    write_special_marker(tmp, END_OF_STREAM_MARKER)
    raw, _ = tmp.raw_bytes()
    return raw
