"""Atomic checksummed blob files.

A copy of ``m3_tpu/utils/blob.py``: ``<u32 magic><body><u32 crc32(magic+body)>``
written to a temp file, fsync'd, then atomically os.replace'd into place.
Readers get the body back only if magic and CRC check out — a torn or
corrupt file reads as absent, which is the recovery semantic every caller
wants. Writes go through the storage fault seam
(``storage/faults.py DiskIO.write_durable``), as the reference's do.
"""

from __future__ import annotations

import os
import struct
import zlib

_U32 = struct.Struct("<I")


def write_atomic_checked_blob(path: str, magic: int, body: bytes) -> None:
    # lazy import: the storage fault seam owns the write-temp -> fsync ->
    # rename primitive so injected disk faults reach blob writers too;
    # utils must not import storage at load time
    from ..storage.faults import DISK

    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    head = _U32.pack(magic)
    DISK.write_durable(path, head + body + _U32.pack(zlib.crc32(head + body)))


def read_checked_blob(path: str, magic: int) -> bytes | None:
    """Body bytes, or None when missing/torn/corrupt/wrong-magic."""
    try:
        with open(path, "rb") as f:
            blob = f.read()
    except OSError:
        return None
    if len(blob) < 2 * _U32.size:
        return None
    (got_magic,) = _U32.unpack_from(blob, 0)
    if got_magic != magic:
        return None
    body, (crc,) = blob[_U32.size : -_U32.size], _U32.unpack(blob[-_U32.size :])
    if zlib.crc32(blob[: -_U32.size]) != crc:
        return None
    return body
