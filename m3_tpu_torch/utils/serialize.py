"""Tag wire codec: length-prefixed canonical tag serialization.

A copy of ``m3_tpu/utils/serialize.py``: the index's segment formats store
doc tags in it, so both packages read each other's bytes.

The reference stores tags (and builds series IDs) with a length-prefixed
binary format — 2-byte magic, uint16 tag count, uint16-length-prefixed
name/value bytes per tag (M3's src/x/serialize/encoder.go:55-191)
— precisely so tag bytes containing separator characters can never collide.
This module is that format for the TPU framework: the encoded form IS the
canonical series ID stored in filesets, the WAL, and the reverse index.

Tags are sorted by name on encode so equal tag sets map to equal IDs
regardless of insertion order (the reference sorts IDs upstream in
models.Tags / metric ID construction).
"""

from __future__ import annotations

import struct

Tags = tuple[tuple[bytes, bytes], ...]

MAGIC = 0x4D35  # own format marker; role of the reference's headerMagicNumber
_HDR = struct.Struct("<HH")  # magic, tag count
_LEN = struct.Struct("<H")

MAX_TAGS = 0xFFFF
MAX_LEN = 0xFFFF


def encode_tags(tags) -> bytes:
    """Serialize tags (any iterable of (name, value) byte pairs), sorted by
    name then value. Raises ValueError past the uint16 wire limits
    (encoder.go enforces TagSerializationLimits the same way)."""
    pairs = sorted((bytes(k), bytes(v)) for k, v in tags)
    if len(pairs) > MAX_TAGS:
        raise ValueError(f"too many tags: {len(pairs)}")
    parts = [_HDR.pack(MAGIC, len(pairs))]
    for k, v in pairs:
        if len(k) > MAX_LEN or len(v) > MAX_LEN:
            raise ValueError("tag name/value exceeds uint16 length limit")
        parts.append(_LEN.pack(len(k)))
        parts.append(k)
        parts.append(_LEN.pack(len(v)))
        parts.append(v)
    return b"".join(parts)


def decode_tags(buf: bytes) -> Tags:
    """Inverse of encode_tags (decoder.go). Raises ValueError on a malformed
    or truncated buffer."""
    if len(buf) < _HDR.size:
        raise ValueError("tag buffer too short")
    magic, count = _HDR.unpack_from(buf, 0)
    if magic != MAGIC:
        raise ValueError(f"bad tag magic 0x{magic:04x}")
    pos = _HDR.size
    out = []
    for _ in range(count):
        if pos + _LEN.size > len(buf):
            raise ValueError("truncated tag name length")
        (klen,) = _LEN.unpack_from(buf, pos)
        pos += _LEN.size
        k = buf[pos : pos + klen]
        if len(k) != klen:
            raise ValueError("truncated tag name")
        pos += klen
        if pos + _LEN.size > len(buf):
            raise ValueError("truncated tag value length")
        (vlen,) = _LEN.unpack_from(buf, pos)
        pos += _LEN.size
        v = buf[pos : pos + vlen]
        if len(v) != vlen:
            raise ValueError("truncated tag value")
        pos += vlen
        out.append((k, v))
    if pos != len(buf):
        raise ValueError(f"trailing bytes after {count} tags")
    return tuple(out)


def is_tag_id(buf: bytes) -> bool:
    """Cheap check that a series ID is in the tag wire format."""
    return len(buf) >= _HDR.size and _HDR.unpack_from(buf, 0)[0] == MAGIC
