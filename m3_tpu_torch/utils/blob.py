"""Atomic checksummed blob files.

A copy of ``m3_tpu/utils/blob.py``: ``<u32 magic><body><u32 crc32(magic+body)>``
written to a temp file, fsync'd, then atomically os.replace'd into place.
Readers get the body back only if magic and CRC check out — a torn or
corrupt file reads as absent, which is the recovery semantic every caller
wants. The reference writes through its storage fault seam
(``m3_tpu/storage/faults.py DiskIO.write_durable``); the port has no
storage layer yet (ROADMAP §A3), so the same write-temp → fsync → rename
sequence is written out here.
"""

from __future__ import annotations

import os
import struct
import zlib

_U32 = struct.Struct("<I")


def write_durable(path: str, payload: bytes) -> None:
    """write-temp → fsync → rename: a crash at any point leaves either the
    old file or no file, never a torn final path; a failed temp write is
    removed."""
    d = os.path.dirname(path) or "."
    tmp = os.path.join(d, f".{os.path.basename(path)}.tmp")
    try:
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass  # best-effort temp cleanup; the original error propagates
        raise
    os.replace(tmp, path)


def write_atomic_checked_blob(path: str, magic: int, body: bytes) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    head = _U32.pack(magic)
    write_durable(path, head + body + _U32.pack(zlib.crc32(head + body)))


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
