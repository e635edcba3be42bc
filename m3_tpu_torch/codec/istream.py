"""MSB-first bit input stream over an in-memory byte buffer.

Behavioral parity with the reference IStream
(upstream M3 src/dbnode/encoding/istream.go): ReadBits/PeekBits/ReadByte
with unaligned reads. Raises EOFError past the end (the reference surfaces
io.EOF the same way; iterators treat it as stream end).
"""

from __future__ import annotations


class IStream:
    __slots__ = ("data", "byte_pos", "bit_pos")

    def __init__(self, data: bytes) -> None:
        self.data = data
        self.byte_pos = 0  # next byte index
        self.bit_pos = 0  # bits consumed in current byte (0..7)

    @property
    def remaining_bits(self) -> int:
        return (len(self.data) - self.byte_pos) * 8 - self.bit_pos

    def read_bit(self) -> int:
        return self.read_bits(1)

    def read_byte(self) -> int:
        return self.read_bits(8)

    def read_bits(self, num_bits: int) -> int:
        if num_bits > self.remaining_bits:
            raise EOFError("end of stream")
        res = 0
        n = num_bits
        data, bp, bit = self.data, self.byte_pos, self.bit_pos
        while n > 0:
            avail = 8 - bit
            take = avail if avail < n else n
            cur = data[bp]
            # take `take` bits starting at offset `bit` from MSB
            chunk = (cur >> (8 - bit - take)) & ((1 << take) - 1)
            res = (res << take) | chunk
            bit += take
            if bit == 8:
                bit = 0
                bp += 1
            n -= take
        self.byte_pos, self.bit_pos = bp, bit
        return res

    def peek_bits(self, num_bits: int) -> int:
        """Read without consuming; raises EOFError if not enough bits remain."""
        if num_bits > self.remaining_bits:
            raise EOFError("end of stream")
        save = (self.byte_pos, self.bit_pos)
        try:
            return self.read_bits(num_bits)
        finally:
            self.byte_pos, self.bit_pos = save

    def read(self, n: int) -> bytes:
        return bytes(self.read_byte() for _ in range(n))
