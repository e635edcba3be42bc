"""MSB-first bit output stream.

Behavioral parity with the reference OStream
(upstream M3 src/dbnode/encoding/ostream.go): bits fill each byte from the
most-significant end; ``pos`` counts used bits (1..8) in the last byte.
"""

from __future__ import annotations


class OStream:
    __slots__ = ("buf", "pos")

    def __init__(self) -> None:
        self.buf = bytearray()
        self.pos = 0  # bits used in last byte; 0 when buffer empty, else 1..8

    def __len__(self) -> int:
        return len(self.buf)

    @property
    def bit_len(self) -> int:
        if not self.buf:
            return 0
        return (len(self.buf) - 1) * 8 + self.pos

    def _has_unused_bits(self) -> bool:
        return 0 < self.pos < 8

    def _grow(self, v: int, n: int) -> None:
        self.buf.append(v & 0xFF)
        self.pos = n

    def _fill_unused(self, v: int) -> None:
        self.buf[-1] |= (v & 0xFF) >> self.pos

    def write_bit(self, v: int) -> None:
        v = (v & 1) << 7
        if not self._has_unused_bits():
            self._grow(v, 1)
            return
        self._fill_unused(v)
        self.pos += 1

    def write_byte(self, v: int) -> None:
        v &= 0xFF
        if not self._has_unused_bits():
            self._grow(v, 8)
            return
        self._fill_unused(v)
        self._grow((v << (8 - self.pos)) & 0xFF, self.pos)

    def write_bytes(self, data: bytes) -> None:
        if not self._has_unused_bits():
            self.buf.extend(data)
            if data:
                self.pos = 8
            return
        for b in data:
            self.write_byte(b)

    def write_bits(self, v: int, num_bits: int) -> None:
        """Write the low ``num_bits`` of v, MSB first (ostream.go WriteBits)."""
        if num_bits <= 0:
            return
        if num_bits > 64:
            num_bits = 64
        v = (v << (64 - num_bits)) & ((1 << 64) - 1)
        while num_bits >= 8:
            self.write_byte(v >> 56)
            v = (v << 8) & ((1 << 64) - 1)
            num_bits -= 8
        while num_bits > 0:
            self.write_bit((v >> 63) & 1)
            v = (v << 1) & ((1 << 64) - 1)
            num_bits -= 1

    def raw_bytes(self) -> tuple[bytes, int]:
        return bytes(self.buf), self.pos
