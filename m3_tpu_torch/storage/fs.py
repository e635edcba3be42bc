"""Fileset persistence: immutable per-(shard, blockStart, volume) flushed files.

Reference: M3's src/dbnode/persist/fs/ — file roles from fs.go:26-36
(`info`, `index`, `summaries`, `bloomfilter`, `data`, `digest`, `checkpoint`),
writer write.go, reader read.go, seeker seek.go:63-79 (bloom filter →
index-lookup binary search → data read), checkpoint-written-last as the atomic
commit marker (files.go:1428 reads it to decide completeness).

The on-disk format is ours (the framework defines its own filesets), but every
file role and the recovery semantics are preserved — plus one addition the
reference doesn't have: a `side` file carrying the per-chunk decoder-state
side table (ops/chunked.py) so flushed blocks device-decode without a host
prescan.

A copy of ``m3_tpu/storage/fs.py``: the files are byte for byte the
reference's, so filesets written by either package read in the other. The
chunk prescan is one host codec library call a fileset
(``native.prescan_batch``), as in the reference. The live-migration
raw-file surface waits for the cluster slice (ROADMAP §A10).
"""

from __future__ import annotations

import errno
import json
import os
import struct
import time
import zlib
from dataclasses import dataclass

import numpy as np

from .. import native
from ..utils.instrument import DEFAULT as METRICS
from .faults import DISK, DiskFullError, crash_point

from typing import TYPE_CHECKING

if TYPE_CHECKING:  # ops.chunked pulls in torch; storage nodes import lazily
    from ..ops.chunked import ChunkedBatch

CHUNK_K = 32
SUMMARY_EVERY = 64  # index-entry sampling rate for the summaries file

# per-chunk snapshot record (see snapshot_stream); v2 adds the fast-chunk
# classification flags byte (device kernel specialization, ops/fused.py)
SIDE_DTYPE_V1 = np.dtype(
    [
        ("off", "<u4"),
        ("prev_time", "<u8"),
        ("prev_delta", "<u8"),
        ("prev_float_bits", "<u8"),
        ("prev_xor", "<u8"),
        ("int_val", "<u8"),
        ("time_unit", "<u1"),
        ("sig", "<u1"),
        ("mult", "<u1"),
        ("is_float", "<u1"),
    ]
)
SIDE_DTYPE = np.dtype(SIDE_DTYPE_V1.descr + [("flags", "<u1")])
# v3: the packed 10-word-per-chunk layout (ops/sideplane.py) — the SAME
# rows the resident pool's side planes hold, so admission stages without
# re-walking streams, and the record shrinks 45 -> 40 bytes. Falls back
# to the v2 struct for a whole fileset when any chunk's state overflows
# the packed ranges; readers accept v1/v2/v3.
SIDE_VERSION = 3
SIDE_REC_V3 = 40  # SIDE_WORDS * 4

SUFFIXES = ("info", "index", "summaries", "bloomfilter", "data", "side", "digest", "checkpoint")

#: subdirectory (next to ``data/``) where corrupt fileset volumes are
#: renamed aside for post-mortem inspection instead of deleted
QUARANTINE_DIR = "quarantine"


class CorruptFilesetError(RuntimeError):
    """A checkpoint-complete fileset failed digest verification — torn or
    bit-rotted on disk after commit. Carries the per-file evidence so the
    quarantine path can count ``storage_corruption_total{file,reason}``."""

    def __init__(self, fid: "FilesetID", problems: list[tuple[str, str]]) -> None:
        super().__init__(f"corrupt fileset {fid}: {problems}")
        self.fid = fid
        self.problems = problems  # [(file_role, reason)]


def _bloom_bits(n: int) -> int:
    return max(64, 1 << (n * 10).bit_length())


class BloomFilter:
    """Simple double-hash bloom filter (role of persist/fs/bloom)."""

    def __init__(self, m_bits: int, k: int = 7, bits: np.ndarray | None = None) -> None:
        self.m = m_bits
        self.k = k
        self.bits = bits if bits is not None else np.zeros(m_bits // 8, np.uint8)

    def _hashes(self, key: bytes):
        h1 = zlib.crc32(key)
        h2 = zlib.adler32(key) | 1
        for i in range(self.k):
            yield (h1 + i * h2) % self.m

    def add(self, key: bytes) -> None:
        for h in self._hashes(key):
            self.bits[h >> 3] |= 1 << (h & 7)

    def test(self, key: bytes) -> bool:
        return all(self.bits[h >> 3] & (1 << (h & 7)) for h in self._hashes(key))


@dataclass
class FilesetID:
    namespace: str
    shard: int
    block_start: int
    volume: int = 0


def _dir(base: str, fid: FilesetID) -> str:
    return os.path.join(base, "data", fid.namespace, str(fid.shard))


def _path(base: str, fid: FilesetID, suffix: str) -> str:
    return os.path.join(
        _dir(base, fid), f"fileset-{fid.block_start}-{fid.volume}-{suffix}.db"
    )


def write_fileset(
    base: str,
    fid: FilesetID,
    series: dict[bytes, bytes],
    block_size_nanos: int,
    chunk_k: int = CHUNK_K,
    side_rows: dict | None = None,
) -> None:
    """Write all fileset files, checkpoint LAST (write.go ordering).

    ``side_rows`` optionally maps sid -> packed uint32[n_chunks, 10]
    side rows ALREADY computed (the device encode path emits them at
    seal, ops/encode.side_rows_for) — those sids skip the host prescan
    entirely; absent sids prescan as before. The rows are bit-identical
    to the prescan's packing, so the persisted side file is the same
    bytes either way."""
    os.makedirs(_dir(base, fid), exist_ok=True)
    ids = sorted(series)
    data_parts: list[bytes] = []
    index_entries: list[bytes] = []
    side_parts: list[bytes] = []
    bloom = BloomFilter(_bloom_bits(max(len(ids), 1)))
    offset = 0
    index_off = 0
    summaries: list[bytes] = []
    side_rows = {k: v for k, v in (side_rows or {}).items() if v is not None}
    need = [i for i, sid in enumerate(ids) if sid not in side_rows]
    all_snaps: list = [None] * len(ids)
    if need:
        scanned = native.prescan_batch([series[ids[i]] for i in need], k=chunk_k)
        for i, snaps in zip(need, scanned):
            all_snaps[i] = snaps
    from ..ops.sideplane import pack_side_rows

    # side-file version for THIS fileset: v3 packed rows when every
    # chunk's state fits the packed ranges, else the v2 struct for the
    # whole file (records are fixed-width; the version is per file)
    side_version = SIDE_VERSION
    packed_all = [
        side_rows[sid]
        if sid in side_rows
        else pack_side_rows(all_snaps[i], fid.block_start)
        for i, sid in enumerate(ids)
    ]
    if any(p is None for p in packed_all):
        side_version = 2
        from ..ops.sideplane import unpack_side_rows

        for i, sid in enumerate(ids):
            if all_snaps[i] is None:
                # v2 needs snapshot dicts; the packed->dict unpack is
                # bit-exact for every row the packer accepted
                all_snaps[i] = unpack_side_rows(packed_all[i], fid.block_start)

    def _side_bytes(i: int) -> bytes:
        if side_version >= 3:
            return packed_all[i].astype("<u4").tobytes()
        snaps = all_snaps[i]
        side = np.zeros(len(snaps), SIDE_DTYPE)
        for j, p in enumerate(snaps):
            side[j] = (
                p["off"],
                p["prev_time"],
                p["prev_delta"],
                p["prev_float_bits"],
                p["prev_xor"],
                p["int_val"],
                p["time_unit"],
                p["sig"],
                p["mult"],
                int(p["is_float"]),
                # flags: bit 0 int-fast chunk, bit 1 float-fast chunk
                (1 if p.get("fast") else 0) | (2 if p.get("fast_float") else 0),
            )
        return side.tobytes()

    for i, sid in enumerate(ids):
        stream = series[sid]
        n_chunks = (
            len(packed_all[i]) if all_snaps[i] is None else len(all_snaps[i])
        )
        side_bytes = _side_bytes(i)
        index_entries.append(
            struct.pack("<IIQI", len(sid), len(stream), offset, n_chunks) + sid
        )
        data_parts.append(stream)
        side_parts.append(side_bytes)
        bloom.add(sid)
        offset += len(stream)
        if i % SUMMARY_EVERY == 0:
            # sampled summaries: (id, byte offset of this entry in the INDEX
            # file) — the seeker bisects these then scans <= SUMMARY_EVERY
            # index entries (persist/fs/seek.go:79 index-lookup search)
            summaries.append(struct.pack("<IQ", len(sid), index_off) + sid)
        index_off += len(index_entries[-1])

    files = {
        "info": json.dumps(
            {
                "blockStart": fid.block_start,
                "blockSize": block_size_nanos,
                "volume": fid.volume,
                "numSeries": len(ids),
                "chunkK": chunk_k,
                "bloomBits": bloom.m,
                "bloomK": bloom.k,
                "summariesIndexOffsets": True,
                "sideVersion": side_version,
            }
        ).encode(),
        "index": b"".join(index_entries),
        "summaries": b"".join(summaries),
        "bloomfilter": bloom.bits.tobytes(),
        "data": b"".join(data_parts),
        "side": b"".join(side_parts),
    }
    digests = {}
    try:
        for suffix, payload in files.items():
            DISK.write_durable(_path(base, fid, suffix), payload)
            digests[suffix] = zlib.adler32(payload)
            if suffix == "data":
                crash_point("fileset:data-written")
        digest_payload = json.dumps(digests).encode()
        DISK.write_durable(_path(base, fid, "digest"), digest_payload)
        crash_point("fileset:pre-checkpoint")
        # checkpoint carries the digest-of-digests and commits the fileset
        DISK.write_durable(
            _path(base, fid, "checkpoint"),
            struct.pack("<I", zlib.adler32(digest_payload)),
        )
    except OSError as exc:
        # the checkpoint never landed, so the partial set was invisible —
        # remove it so the retried flush starts clean; disk-full degrades
        # to the typed retryable rejection instead of a crash
        delete_fileset(base, fid)
        if isinstance(exc, DiskFullError):
            raise
        if exc.errno in (errno.ENOSPC, errno.EDQUOT):
            raise DiskFullError(f"disk full writing fileset {fid}") from exc
        raise


def fileset_complete(base: str, fid: FilesetID) -> bool:
    """files.go:1428 — a fileset exists iff its checkpoint is valid."""
    try:
        with open(_path(base, fid, "checkpoint"), "rb") as f:
            (want,) = struct.unpack("<I", f.read(4))
        with open(_path(base, fid, "digest"), "rb") as f:
            return zlib.adler32(f.read()) == want
    except (FileNotFoundError, struct.error):
        return False


def delete_fileset(base: str, fid: FilesetID) -> None:
    """Remove every file of a fileset, checkpoint FIRST so a crash mid-delete
    leaves an incomplete (ignored) fileset rather than a corrupt-looking one."""
    for suffix in ("checkpoint", "digest") + SUFFIXES[:-2]:
        try:
            os.remove(_path(base, fid, suffix))
        except FileNotFoundError:
            pass


# --- verify + quarantine (scrub plane) ---

_CORRUPTION_CHILDREN: dict = {}
_QUARANTINE_GAUGE = METRICS.gauge(
    "storage_quarantined_volumes",
    "fileset volumes quarantined since process start",
)
_quarantined_total = 0


def _count_corruption(file_role: str, reason: str) -> None:
    child = _CORRUPTION_CHILDREN.get((file_role, reason))
    if child is None:
        child = METRICS.counter(
            "storage_corruption_total",
            "corrupt fileset files detected by verify/scrub",
            labels={"file": file_role, "reason": reason},
        )
        _CORRUPTION_CHILDREN[(file_role, reason)] = child
    child.inc()


def _read_role(base: str, fid: FilesetID, suffix: str) -> bytes:
    path = _path(base, fid, suffix)
    with DISK.open(path, "rb") as f:
        return DISK.read(f, path)


def verify_fileset(base: str, fid: FilesetID) -> list[tuple[str, str]]:
    """Digest-verify every file of a fileset against its digest file and
    the digest file against its checkpoint. Returns [] when clean, else
    (file_role, reason) evidence pairs with reason in {"missing", "torn",
    "digest-mismatch"}. Reads are full sequential file reads — callers
    cache the verdict (reader LRU / scrub cursor), never per query."""
    try:
        cp = _read_role(base, fid, "checkpoint")
    except OSError:
        return [("checkpoint", "missing")]
    if len(cp) != 4:
        return [("checkpoint", "torn")]
    try:
        digest_payload = _read_role(base, fid, "digest")
    except OSError:
        return [("digest", "missing")]
    (want,) = struct.unpack("<I", cp)
    if zlib.adler32(digest_payload) != want:
        return [("digest", "digest-mismatch")]
    digests = json.loads(digest_payload.decode())
    problems: list[tuple[str, str]] = []
    for suffix in SUFFIXES[:-2]:
        try:
            payload = _read_role(base, fid, suffix)
        except OSError:
            problems.append((suffix, "missing"))
            continue
        if zlib.adler32(payload) != digests.get(suffix):
            problems.append((suffix, "digest-mismatch"))
    return problems


def fileset_bytes(base: str, fid: FilesetID) -> int:
    """Total on-disk bytes of a fileset (the scrubber's rate-limit unit)."""
    total = 0
    for suffix in SUFFIXES:
        try:
            total += os.path.getsize(_path(base, fid, suffix))
        except OSError:
            continue
    return total


def quarantine_fileset(
    base: str, fid: FilesetID, problems: list[tuple[str, str]] | None = None
) -> str:
    """Rename a corrupt fileset aside into ``base/quarantine/<ns>/<shard>/``,
    checkpoint FIRST — the instant it moves, the volume stops being
    'complete' to every lister, so a crash mid-quarantine leaves an
    incomplete (ignored) fileset, never a half-visible one. Counts
    ``storage_corruption_total{file,reason}`` per evidence pair and bumps
    the quarantine gauge. Returns the quarantine directory."""
    global _quarantined_total
    qdir = os.path.join(base, QUARANTINE_DIR, fid.namespace, str(fid.shard))
    os.makedirs(qdir, exist_ok=True)
    for suffix in ("checkpoint", "digest") + SUFFIXES[:-2]:
        src = _path(base, fid, suffix)
        try:
            os.replace(src, os.path.join(qdir, os.path.basename(src)))
        except FileNotFoundError:
            pass
    for file_role, reason in problems or [("checkpoint", "unknown")]:
        _count_corruption(file_role, reason)
    _quarantined_total += 1
    _QUARANTINE_GAUGE.set(_quarantined_total)
    return qdir


def list_quarantined(base: str, namespace: str, shard: int) -> list[str]:
    """File names currently sitting in one shard's quarantine directory."""
    d = os.path.join(base, QUARANTINE_DIR, namespace, str(shard))
    try:
        return sorted(os.listdir(d))
    except FileNotFoundError:
        return []


_M_QUARANTINE_PRUNED = METRICS.counter(
    "storage_quarantine_pruned_total",
    "quarantined fileset volumes removed by retention GC",
)


def prune_quarantine(
    base: str, retention_secs: float, now: float | None = None
) -> int:
    """Retention GC for ``base/quarantine/``: delete quarantined fileset
    volumes whose NEWEST file is older than ``retention_secs`` (mtime is
    stamped by the quarantine rename, so age = time since quarantine).
    Whole volumes prune atomically — a volume with any fresh file is kept
    intact so post-mortem evidence is never half-deleted. Decrements the
    quarantine gauge and counts
    ``storage_quarantine_pruned_total`` per volume. Returns the number of
    volumes pruned; ``retention_secs <= 0`` means keep forever."""
    global _quarantined_total
    if retention_secs <= 0:
        return 0
    # m3lint: disable=M3L004 -- quarantine age is judged against file mtimes, which are wall-clock stamps; monotonic time has no relation to st_mtime
    cutoff = (time.time() if now is None else now) - float(retention_secs)
    pruned = 0
    for dirpath, _dirnames, filenames in os.walk(
        os.path.join(base, QUARANTINE_DIR)
    ):
        volumes: dict[tuple[str, str], list[str]] = {}
        for name in filenames:
            parts = name.split("-")
            if len(parts) != 4 or parts[0] != "fileset":
                continue
            volumes.setdefault((parts[1], parts[2]), []).append(name)
        for _vol, names in sorted(volumes.items()):
            paths = [os.path.join(dirpath, n) for n in names]
            try:
                newest = max(os.path.getmtime(p) for p in paths)
            except OSError:
                continue  # pruned by a concurrent pass
            if newest > cutoff:
                continue
            for p in paths:
                try:
                    os.remove(p)
                except FileNotFoundError:
                    pass
            pruned += 1
    if pruned:
        _M_QUARANTINE_PRUNED.inc(pruned)
        _quarantined_total = max(0, _quarantined_total - pruned)
        _QUARANTINE_GAUGE.set(_quarantined_total)
    return pruned


def list_fileset_volumes(base: str, namespace: str, shard: int) -> list[FilesetID]:
    """ALL complete volumes (not just the winning one per block)."""
    d = os.path.join(base, "data", namespace, str(shard))
    out = []
    try:
        names = os.listdir(d)
    except FileNotFoundError:
        return []
    for name in names:
        if not name.endswith("-checkpoint.db"):
            continue
        _, bs, vol, _ = name.split("-")
        fid = FilesetID(namespace, shard, int(bs), int(vol))
        if fileset_complete(base, fid):
            out.append(fid)
    return sorted(out, key=lambda f: (f.block_start, f.volume))


def list_filesets(base: str, namespace: str, shard: int) -> list[FilesetID]:
    """Latest complete volume per block start (cold flush volumes win)."""
    best: dict[int, FilesetID] = {}
    for fid in list_fileset_volumes(base, namespace, shard):
        best[fid.block_start] = fid
    return sorted(best.values(), key=lambda f: f.block_start)


def read_index_ids(base: str, fid: FilesetID) -> list[bytes]:
    """Series IDs of a complete fileset, reading ONLY the index file (used by
    bootstrap to re-index flushed series without touching data/side files)."""
    if not fileset_complete(base, fid):
        raise FileNotFoundError(f"incomplete fileset {fid}")
    with open(_path(base, fid, "index"), "rb") as f:
        buf = f.read()
    out = []
    pos = 0
    while pos < len(buf):
        id_len, _, _, _ = struct.unpack_from("<IIQI", buf, pos)
        pos += 20
        out.append(buf[pos : pos + id_len])
        pos += id_len
    return out


class FilesetReader:
    """The mmap seeker (read.go + seek.go): id lookup via bloom filter →
    summaries binary search → bounded index scan → mmap'd data slice.

    Nothing beyond the info/bloom/summaries files is materialized up front:
    data, side, and index are memory-mapped and only the bytes a lookup
    touches are faulted in (the reference's seeker mmaps data + index the
    same way, seek.go:63). Full-index parses happen lazily and only for
    whole-fileset consumers (series_ids, shard streaming)."""

    def __init__(self, base: str, fid: FilesetID, verify: bool = True) -> None:
        if not fileset_complete(base, fid):
            raise FileNotFoundError(f"incomplete fileset {fid}")
        if verify:
            # verify-on-first-read: one full digest pass when the reader
            # materializes (readers are LRU-cached by the shard, so this
            # is per serving volume, never per query)
            problems = verify_fileset(base, fid)
            if problems:
                raise CorruptFilesetError(fid, problems)
        self.fid = fid
        self.info = json.loads(self._read(base, "info"))
        self.bloom = BloomFilter(
            self.info["bloomBits"],
            self.info["bloomK"],
            np.frombuffer(self._read(base, "bloomfilter"), np.uint8).copy(),
        )
        self._data = self._mmap(base, "data")
        self._side = self._mmap(base, "side")
        self._side_version = int(self.info.get("sideVersion", 1))
        self._side_dtype = (
            SIDE_DTYPE if self._side_version >= 2 else SIDE_DTYPE_V1
        )
        # per-chunk record size drives the side-cursor walk; v3 stores
        # packed 10-word rows, v1/v2 the struct dtype
        self._side_rec = (
            SIDE_REC_V3 if self._side_version >= 3
            else self._side_dtype.itemsize
        )
        self._index_mm = self._mmap(base, "index")
        self._entries: dict[bytes, tuple[int, int, int, int] | None] = {}
        self._side_bases: dict[int, int] = {0: 0}
        self._full_index: dict[bytes, tuple[int, int, int, int]] | None = None
        self.full_index_parses = 0  # observability: whole-index scans
        # summaries: sampled (sid, index offset) pairs, sorted by sid —
        # absent on pre-seek filesets (no summariesIndexOffsets marker)
        self._summary_ids: list[bytes] = []
        self._summary_offs: list[int] = []
        if self.info.get("summariesIndexOffsets"):
            buf = self._read(base, "summaries")
            pos = 0
            while pos < len(buf):
                id_len, index_off = struct.unpack_from("<IQ", buf, pos)
                pos += 12
                self._summary_ids.append(buf[pos : pos + id_len])
                pos += id_len
                self._summary_offs.append(index_off)

    def _read(self, base: str, suffix: str) -> bytes:
        path = _path(base, self.fid, suffix)
        with DISK.open(path, "rb") as f:
            return DISK.read(f, path)

    def _mmap(self, base: str, suffix: str):
        import mmap as _mmap_mod

        with DISK.open(_path(base, self.fid, suffix), "rb") as f:
            size = os.fstat(f.fileno()).st_size
            if size == 0:
                return memoryview(b"")
            return memoryview(
                _mmap_mod.mmap(f.fileno(), size, access=_mmap_mod.ACCESS_READ)
            )

    # --- index lookup ---

    def _parse_entry(self, pos: int) -> tuple[bytes, tuple[int, int, int, int], int]:
        """Index entry at byte ``pos`` → (sid, (data_off, length, side_off,
        n_chunks), next_pos). side_off comes from a side-cursor walk at full
        parse; for seek hits it is recomputed from the entry scan below."""
        id_len, length, offset, n_chunks = struct.unpack_from(
            "<IIQI", self._index_mm, pos
        )
        pos += 20
        sid = bytes(self._index_mm[pos : pos + id_len])
        return sid, (offset, length, 0, n_chunks), pos + id_len

    def _ensure_full_index(self) -> dict[bytes, tuple[int, int, int, int]]:
        if self._full_index is None:
            self.full_index_parses += 1
            out: dict[bytes, tuple[int, int, int, int]] = {}
            pos = 0
            side_off = 0
            n = len(self._index_mm)
            while pos < n:
                sid, (offset, length, _, n_chunks), pos = self._parse_entry(pos)
                out[sid] = (offset, length, side_off, n_chunks)
                side_off += n_chunks * self._side_rec
            self._full_index = out
        return self._full_index

    def _lookup(self, sid: bytes) -> tuple[int, int, int, int] | None:
        if self._full_index is not None:
            return self._full_index.get(sid)
        if sid in self._entries:
            return self._entries[sid]
        if not self._summary_ids:
            return self._ensure_full_index().get(sid)
        # bisect the sampled summaries for the scan start; side offsets are
        # not sampled, so walk entries accumulating n_chunks from the sample.
        # Side offsets accumulate from file start, so sample i's side base is
        # unknown — recover it by scanning from the previous sample with a
        # known base: samples are every SUMMARY_EVERY entries, so instead we
        # accumulate side_off from entry 0 of the sampled region by storing
        # the side cursor alongside each region's first scan (cached below).
        import bisect

        i = bisect.bisect_right(self._summary_ids, sid) - 1
        if i < 0:
            self._entries[sid] = None
            return None
        start = self._summary_offs[i]
        side_base = self._side_base(i)
        pos, side_off = start, side_base
        n = len(self._index_mm)
        count = 0
        found = None
        while pos < n and count < SUMMARY_EVERY:
            entry_sid, (offset, length, _, n_chunks), pos = self._parse_entry(pos)
            if entry_sid == sid:
                found = (offset, length, side_off, n_chunks)
                break
            if entry_sid > sid:
                break
            side_off += n_chunks * self._side_rec
            count += 1
        self._entries[sid] = found
        return found

    def _side_base(self, sample_i: int) -> int:
        """Side-file byte offset of sample ``sample_i``'s first entry,
        computed once per sample region by walking from the nearest earlier
        known sample (region walks are <= SUMMARY_EVERY entries each)."""
        bases = self._side_bases
        known = sample_i
        while known not in bases:
            known -= 1
        while known < sample_i:
            pos = self._summary_offs[known]
            stop = self._summary_offs[known + 1]
            side_off = bases[known]
            while pos < stop:
                _, (_, _, _, n_chunks), pos = self._parse_entry(pos)
                side_off += n_chunks * self._side_rec
            known += 1
            bases[known] = side_off
        return bases[sample_i]

    @property
    def index(self) -> dict[bytes, tuple[int, int, int, int]]:
        return self._ensure_full_index()

    @property
    def series_ids(self) -> list[bytes]:
        return list(self._ensure_full_index())

    def stream(self, sid: bytes) -> bytes | None:
        if not self.bloom.test(sid):
            return None
        entry = self._lookup(sid)
        if entry is None:
            return None
        offset, length, _, _ = entry
        return bytes(self._data[offset : offset + length])

    def admission_side(self, sid: bytes):
        """What residency admission takes for the series' chunk metadata:
        the packed side rows (uint32 [n_chunks, 10], equal to
        pack_side_rows of side_table(sid)) straight from a v3 side file, or
        the snapshot dicts of side_table for a v1/v2 file; None when the
        series is absent."""
        if self._side_version < 3:
            return self.side_table(sid)
        entry = self._lookup(sid) if self.bloom.test(sid) else None
        if entry is None:
            return None
        _offset, _length, side_off, n_chunks = entry
        return np.frombuffer(
            self._side, "<u4", count=n_chunks * (SIDE_REC_V3 // 4), offset=side_off
        ).reshape(n_chunks, SIDE_REC_V3 // 4).astype(np.uint32)

    def side_table(self, sid: bytes) -> list[dict] | None:
        if not self.bloom.test(sid):
            return None
        entry = self._lookup(sid)
        if entry is None:
            return None
        offset, length, side_off, n_chunks = entry
        if self._side_version >= 3:
            from ..ops.sideplane import unpack_side_rows

            rows = np.frombuffer(
                self._side, "<u4", count=n_chunks * (SIDE_REC_V3 // 4),
                offset=side_off,
            ).reshape(n_chunks, SIDE_REC_V3 // 4)
            snaps = unpack_side_rows(rows, self.info["blockStart"])
            offs = [p["off"] for p in snaps] + [length * 8]
            for j, p in enumerate(snaps):
                p["span"] = int(offs[j + 1]) - int(p["off"])
                p["total_bits"] = length * 8
            return snaps
        raw = np.frombuffer(
            self._side, self._side_dtype, count=n_chunks, offset=side_off
        )
        snaps = []
        offs = list(raw["off"]) + [length * 8]
        for j in range(n_chunks):
            snaps.append(
                dict(
                    off=int(raw["off"][j]),
                    prev_time=int(raw["prev_time"][j]),
                    prev_delta=int(raw["prev_delta"][j]),
                    prev_float_bits=int(raw["prev_float_bits"][j]),
                    prev_xor=int(raw["prev_xor"][j]),
                    int_val=int(raw["int_val"][j]),
                    time_unit=int(raw["time_unit"][j]),
                    sig=int(raw["sig"][j]),
                    mult=int(raw["mult"][j]),
                    is_float=bool(raw["is_float"][j]),
                    fast=bool(raw["flags"][j] & 1)
                    if "flags" in raw.dtype.names
                    else False,
                    fast_float=bool(raw["flags"][j] & 2)
                    if "flags" in raw.dtype.names
                    else False,
                    span=int(offs[j + 1]) - int(raw["off"][j]),
                    total_bits=length * 8,
                )
            )
        return snaps

    def chunked_batch(self, sids: list[bytes] | None = None) -> "ChunkedBatch":
        """Assemble a device-decodable batch straight from the fileset —
        no CPU prescan (the side file already holds the snapshots)."""
        from ..ops.chunked import assemble_chunked

        sids = sids if sids is not None else self.series_ids
        streams = []
        snaps = []
        for sid in sids:
            st = self.stream(sid)
            streams.append(st or b"")
            snaps.append(self.side_table(sid) or [])
        return assemble_chunked(streams, snaps, self.info["chunkK"])
