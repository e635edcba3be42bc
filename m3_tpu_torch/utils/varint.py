"""Go-compatible signed varints (encoding/binary PutVarint/ReadVarint).

Used for annotation length prefixes in the M3TSZ stream
(upstream M3 src/dbnode/encoding/m3tsz/timestamp_encoder.go:158-163).
Zig-zag maps signed to unsigned, then LEB128 little-endian 7-bit groups.
"""

from __future__ import annotations


def put_varint(x: int) -> bytes:
    """Encode a signed int like Go's binary.PutVarint."""
    # Zig-zag: x >= 0 -> 2x, x < 0 -> -2x-1.
    if x >= 0:
        ux = x << 1
    else:
        ux = ((-x) << 1) - 1
    out = bytearray()
    while ux >= 0x80:
        out.append((ux & 0x7F) | 0x80)
        ux >>= 7
    out.append(ux)
    return bytes(out)


def read_varint(read_byte) -> int:
    """Decode a signed varint; ``read_byte`` is a callable returning one int byte."""
    ux = 0
    shift = 0
    while True:
        b = read_byte()
        ux |= (b & 0x7F) << shift
        if b < 0x80:
            break
        shift += 7
        if shift > 63:
            raise ValueError("varint overflows 64 bits")
    x = ux >> 1
    if ux & 1:
        x = -x - 1
    return x
