"""64-bit integer/float bit twiddling used throughout the codec.

Parity with reference helpers in upstream M3 src/dbnode/encoding/encoding.go
(NumSig, LeadingAndTrailingZeros, SignExtend) plus float64<->uint64 bit casts.
All functions operate on plain Python ints masked to 64 bits.
"""

from __future__ import annotations

import struct

MASK64 = (1 << 64) - 1


def float_to_bits(v: float) -> int:
    """math.Float64bits: IEEE-754 bit pattern of a float64 as uint64."""
    return struct.unpack("<Q", struct.pack("<d", v))[0]


def bits_to_float(b: int) -> float:
    """math.Float64frombits."""
    return struct.unpack("<d", struct.pack("<Q", b & MASK64))[0]


def num_sig(v: int) -> int:
    """Number of significant bits in a uint64 (encoding.go NumSig)."""
    return (v & MASK64).bit_length()


def leading_zeros64(v: int) -> int:
    v &= MASK64
    return 64 - v.bit_length()


def trailing_zeros64(v: int) -> int:
    v &= MASK64
    if v == 0:
        return 0  # matches LeadingAndTrailingZeros(0) == (64, 0)
    return (v & -v).bit_length() - 1


def leading_and_trailing_zeros(v: int) -> tuple[int, int]:
    v &= MASK64
    if v == 0:
        return 64, 0
    return leading_zeros64(v), trailing_zeros64(v)


def sign_extend(v: int, num_bits: int) -> int:
    """Sign-extend the top bit of an unsigned ``num_bits`` value (encoding.go SignExtend)."""
    v &= (1 << num_bits) - 1
    if num_bits < 64 and v & (1 << (num_bits - 1)):
        return v - (1 << num_bits)
    if num_bits == 64 and v & (1 << 63):
        return v - (1 << 64)
    return v


def to_uint64(v: int) -> int:
    """Interpret a Python int as a two's-complement uint64 (Go uint64(x))."""
    return v & MASK64


def to_int64(v: int) -> int:
    """Interpret a uint64 bit pattern as an int64 (Go int64(x))."""
    v &= MASK64
    return v - (1 << 64) if v & (1 << 63) else v
