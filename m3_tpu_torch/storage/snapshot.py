"""Snapshot files: periodic capture of un-flushed series buffers.

A copy of ``m3_tpu/storage/snapshot.py``; the bytes are the reference's.

Reference: M3's src/dbnode/storage/shard.go:2335 (Snapshot) +
persist/fs/snapshot_metadata_{read,write}.go — snapshots bound commit-log
replay: once a snapshot of every buffer is durable, all earlier WAL segments
can be removed, and bootstrap = filesets + latest snapshot + WAL tail.

One snapshot file per (namespace, shard), atomically replaced
(utils/blob.py); records are (series_id, block_start, m3tsz stream). Only the
newest sequence is kept.
"""

from __future__ import annotations

import os
import re
import struct

from ..utils.blob import read_checked_blob, write_atomic_checked_blob
from .faults import crash_point

_MAGIC = 0x6D335350  # "m3SP" (v3: records the fileset volume at snapshot)
_REC = struct.Struct("<IqIi")  # id len, block_start, stream len, volume
_SNAP_RE = re.compile(r"^snapshot-(\d+)\.db$")


def _dir(base: str, ns: str, shard: int) -> str:
    return os.path.join(base, "snapshots", ns, str(shard))


def _list(base: str, ns: str, shard: int) -> list[tuple[int, str]]:
    d = _dir(base, ns, shard)
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return []
    out = []
    for n in names:
        m = _SNAP_RE.match(n)
        if m:
            out.append((int(m.group(1)), os.path.join(d, n)))
    return sorted(out)


def write_snapshot(
    base: str, ns: str, shard: int, records: list[tuple[bytes, int, bytes, int]]
) -> int:
    """Write records [(series_id, block_start, stream, volume)]; ``volume``
    is the block's fileset volume when the snapshot was taken (-1 = none) —
    bootstrap orders snapshot data against filesets with it: a fileset whose
    volume has since advanced supersedes the record (any warm or cold flush
    bumps the volume), while an unchanged volume means the record is a
    cold-write overlay NEWER than the fileset. Returns the new sequence
    number. Older snapshots are removed after the new one commits."""
    existing = _list(base, ns, shard)
    seq = (existing[-1][0] + 1) if existing else 0
    parts = [struct.pack("<I", len(records))]
    for sid, bs, stream, volume in records:
        parts.append(_REC.pack(len(sid), bs, len(stream), volume))
        parts.append(sid)
        parts.append(stream)
    write_atomic_checked_blob(
        os.path.join(_dir(base, ns, shard), f"snapshot-{seq}.db"),
        _MAGIC,
        b"".join(parts),
    )
    # the new snapshot is durable; the superseded ones still exist — a
    # kill here must leave a readable newest snapshot (read_latest walks
    # newest-first, so the stale survivors are inert)
    crash_point("snapshot:pre-cleanup")
    for _, path in existing:
        os.remove(path)
    return seq


def remove_snapshots(base: str, ns: str, shard: int) -> int:
    """Delete all snapshot files for a shard (flush covered their records);
    returns how many files were removed. Reference: storage/cleanup.go removes
    snapshots once their data is in flushed filesets."""
    removed = 0
    for _, path in _list(base, ns, shard):
        try:
            os.remove(path)
            removed += 1
        except FileNotFoundError:
            pass
    return removed


def read_latest_snapshot(
    base: str, ns: str, shard: int
) -> list[tuple[bytes, int, bytes]] | None:
    """Records of the newest valid snapshot, or None. A corrupt newest file
    falls back to the next-newest (the atomic replace makes this rare)."""
    for _, path in reversed(_list(base, ns, shard)):
        body = read_checked_blob(path, _MAGIC)
        if body is None:
            continue
        (count,) = struct.unpack_from("<I", body, 0)
        pos = 4
        out = []
        ok = True
        for _ in range(count):
            if pos + _REC.size > len(body):
                ok = False
                break
            id_len, bs, s_len, volume = _REC.unpack_from(body, pos)
            pos += _REC.size
            sid = body[pos : pos + id_len]
            pos += id_len
            stream = body[pos : pos + s_len]
            pos += s_len
            if len(sid) != id_len or len(stream) != s_len:
                ok = False
                break
            out.append((sid, bs, stream, volume))
        if ok:
            return out
    return None
