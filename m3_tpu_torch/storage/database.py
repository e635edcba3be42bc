"""Database → namespaces → shards → series: write/read routing + lifecycle.

Reference: M3's src/dbnode/storage/ — storage.Database
(database.go: Write :573, ReadEncoded :842, Bootstrap :925, AssignShardSet
:386), dbNamespace (namespace.go, per-namespace retention/blockSize), dbShard
(shard.go: writeAndIndex :869, ReadEncoded :1060, Tick :663, WarmFlush :2146),
bootstrap chain (bootstrap/process.go:147: filesystem → commitlog → peers →
uninitialized).

Port of ``m3_tpu/storage/database.py``: the same writes, reads, flushes,
snapshots, ticks and bootstrap chain over the port's filesets, commit log,
inverted index (``index/``, with the device tier of K1/K2 when
``index_device_options`` gives it a budget) and resident pool
(``resident/``, admitted at seal and at bootstrap). Every device tier lives
on ``device`` (default the card; ``"cpu"`` runs the kernels' twins, as the
tests do).

As in the reference, the host codec library (``native/``) routes a write
batch's series ids to shards in one murmur3 call (``native.shard_batch``),
and bootstrap's unique commit-log ids in another; reads decode through it
and merge per segment (``codec/native_read.py``).

With ``ingest_options`` (device-side ingest), every write also lands in
its shard's ``ingest/ColumnWriteBuffer``, and a warm flush encodes each
sealed block's lanes on the device with kernel B-4 (``ops/encode.py``):
the fileset is written from those bytes, and the pages admit into the
resident pool device to device (``ResidentPool.admit_block_device``).
Lanes the kernel cannot express seal through the host codec and ride the
same fileset and admission batch.

Left out, raising ``NotImplementedError`` that names its ROADMAP item: a
``peers_source`` for bootstrap (peer bootstrap, §A10). The cluster surface
(``stream_shard``, ``admit_imported_fileset``, ``read_excluding``,
``bootstrap_shards``) waits for §A10 too.
"""

from __future__ import annotations

import functools
import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass

import numpy as np

from .. import native, resolve_device
from ..cache import BlockCache, BlockKey, CacheInvalidator, CacheOptions, DecodedBlock
from ..codec.iterator import MultiReaderIterator
from ..codec.m3tsz import Datapoint, Encoder, decode
from ..codec.native_read import (
    decode_stream_arrays,
    merge_segment_arrays,
    read_segments,
    read_segments_arrays,
)
from ..resident import ResidentOptions, ResidentPool
from ..query import stats as query_stats
from ..selfmon.guard import check_write
from ..utils.hash import shard_for
from ..utils.instrument import DEFAULT as METRICS
from ..utils.serialize import decode_tags, encode_tags, is_tag_id
from ..utils.trace import NOOP_SPAN, TRACER
from ..utils.xtime import Unit

# decoded bytes off the compressed-stream hot path (BENCH attribution:
# how much M3TSZ input each round actually decoded, cache hits excluded)
_M_DECODED_BYTES = METRICS.counter(
    "decoded_bytes_total", "compressed stream bytes decoded into arrays"
)
# a cold-flush volume bump makes every lower volume of the block
# unservable (the reader cache checks volume; caches/pool invalidate on
# the flush notification), so they are deleted eagerly instead of
# lingering on disk until retention expiry
_M_SUPERSEDED_DELETED = METRICS.counter(
    "db_superseded_volumes_deleted_total",
    "superseded fileset volumes deleted eagerly at cold-flush volume bump",
)
# the stages of Shard.seal_seconds: the device seal's classify (the lanes'
# merged points, classify_lanes, and the host codec's streams of the lanes
# B-4 cannot take), packing, encode (kernel B-4 and its small outputs' copy;
# the host codec on a host seal), side rows and streams (one device-to-host
# copy), then both seals' fileset write (with the host prescan of lanes
# without side rows) and admission into the resident pool
SEAL_STAGES = ("classify", "packing", "encode", "side_rows", "streams", "fileset", "admission")
_M_ENCODE_LANES = METRICS.counter(
    "encode_device_lanes_total",
    "lanes sealed through the batched device m3tsz encode kernel",
)
_M_ENCODE_FALLBACK = METRICS.counter(
    "encode_host_fallback_lanes_total",
    "sealing lanes the kernel cannot take (annotated values, sub-second "
    "timestamps, mixed int/float, delta overflows) -- encoded by the host "
    "codec, riding the same fileset and admission batch",
)
_M_ENCODE_BYTES = METRICS.counter(
    "encode_device_bytes_total",
    "compressed stream bytes produced by the device encode kernel",
)
_TODO_PEERS = "ROADMAP §A10 (peer bootstrap)"
from .bootstrap import BootstrapProcess, ShardTimeRanges, uninitialized_source
from .commitlog import CommitLog, CommitLogEntry
from .faults import DiskFullError
from .fs import (
    CHUNK_K,
    CorruptFilesetError,
    FilesetID,
    FilesetReader,
    delete_fileset,
    fileset_complete,
    list_fileset_volumes,
    list_filesets,
    quarantine_fileset,
    read_index_ids,
    verify_fileset,
    write_fileset,
)

# --commitlog-sync mapping onto the CommitLog knobs: the acked-write loss
# bound per mode on a hard process kill (pinned by
# tests/test_storage_faults.py::test_commitlog_sync_loss_bounds):
#   every    acked => appended AND fsynced; zero acked-write loss
#   interval write-behind; loss bounded by flush_every/flush_interval
#   none     fsync only at explicit barriers (flush/rotate/close); loss
#            bounded by the OS+python buffers — fastest, replay gaps OK
COMMITLOG_SYNC_MODES: dict[str, dict] = {
    "every": {"write_behind": False, "flush_every": 1},
    "interval": {},
    "none": {"write_behind": True, "flush_every": 1 << 30, "flush_interval": 1e9},
}
from .series import NANOS, BufferBucket, SeriesBuffer
from .snapshot import read_latest_snapshot, remove_snapshots, write_snapshot


@functools.lru_cache(maxsize=1 << 20)
def _shard_index(sid: bytes, num_shards: int) -> int:
    """``utils/hash.shard_for``, remembered for the last 1M series ids: the
    pure-Python murmur3 costs tens of microseconds an id, and the single-id
    routes (reads, a query's matched series, ``Namespace.shard_for``) go
    through it. Write batches and bootstrap hash all their ids in one host
    codec library call instead (``native.shard_batch``), as the reference
    does."""
    return shard_for(sid, num_shards)


class ColdWriteError(ValueError):
    """Write into a flushed block while cold writes are disabled
    (dbnode m3dberrors.ErrColdWritesNotEnabled)."""


class NewSeriesLimitError(RuntimeError):
    """New-series insert rate limit hit (kvconfig insert limit)."""


@dataclass
class NamespaceOptions:
    """namespace metadata (src/dbnode/namespace/options.go)."""

    retention_nanos: int = 2 * 24 * 3600 * NANOS
    block_size_nanos: int = 2 * 3600 * NANOS
    index_enabled: bool = True
    cold_writes_enabled: bool = True


class Shard:
    """dbShard: series map for one virtual shard.

    Reads go through a per-(block) FilesetReader cache (the role of
    persist/fs/seek_manager.go seeker cache + the wired list): a fileset is
    materialized once and reused until a newer volume replaces it or the
    block expires, instead of re-reading data+index+side files per read."""

    def __init__(
        self,
        shard_id: int,
        ns: str,
        opts: NamespaceOptions,
        base: str,
        cache: BlockCache | None = None,
        invalidator: CacheInvalidator | None = None,
        pool: ResidentPool | None = None,
        ingest_options=None,
        device="cuda",
    ) -> None:
        self.id = shard_id
        self.namespace = ns
        self.opts = opts
        self.base = base
        # device column write buffer (ingest/): write batches accumulate
        # into (series_lane, slot) planes on the device, sealed blocks
        # encode there (ops/encode.py, kernel B-4) and are born resident --
        # opt-in via Database(ingest_options=...)
        self.device = device
        self.ingest = None
        if ingest_options is not None and ingest_options.enabled:
            from ..ingest import ColumnWriteBuffer

            self.ingest = ColumnWriteBuffer(ingest_options, opts.block_size_nanos,
                                            device=device)
        # host seconds of the warm flushes' seals, summed by stage
        self.seal_seconds = dict.fromkeys(SEAL_STAGES, 0.0)
        # decoded-block cache (m3_tpu/cache/): sealed fileset blocks decode
        # once; the invalidator hooks write/flush/tick so nothing stale or
        # superseded stays resident
        self.cache = cache
        # HBM-resident compressed pool (m3_tpu/resident/): sealed blocks'
        # m3tsz bytes stay device-resident, admitted at flush/seal below
        self.pool = pool
        self.invalidator = invalidator or CacheInvalidator(cache, pool)
        # per-shard lock (shard.go RWMutex role): hot-path reads/writes
        # contend only within a shard; lifecycle ops (flush/tick) take the
        # database lock FIRST then shard locks, writers take only this one,
        # so the lock order is always db -> shard
        self.lock = threading.RLock()
        self.series: dict[bytes, SeriesBuffer] = {}
        self._flushed_blocks: set[int] = set()
        # block_start -> live bucket count across ALL series buffers: the
        # O(distinct buffered blocks) summary behind has_buffered_overlap.
        # Buckets exist only while they hold points (created on first
        # write, removed whole by flush/tick eviction), so a nonzero
        # count is exactly "some series has buffered data in this block".
        self._buffered_blocks: dict[int, int] = {}
        self._filesets: list[FilesetID] | None = None  # listdir cache
        self.fileset_epoch = 0  # bumps whenever the fileset set changes
        # block_start -> reader, LRU-bounded (wired_list.go:77 role: a cap on
        # resident block resources with least-recently-used eviction)
        self._readers: "OrderedDict[int, FilesetReader]" = OrderedDict()
        self.max_cached_readers = 128
        self.reader_materializations = 0  # observability: fileset loads

    def filesets(self) -> list[FilesetID]:
        with self.lock:
            if self._filesets is None:
                self._filesets = list_filesets(self.base, self.namespace, self.id)
            return self._filesets

    def _invalidate_filesets(self) -> None:
        self._filesets = None
        # monotone stamp of the shard's sealed-fileset topology: bumps on
        # every flush/retention/repair that changes the fileset set, so
        # the device query planner (query/plan.py) can revalidate a
        # cached plan's block set with one integer compare instead of a
        # per-query fileset listing
        self.fileset_epoch += 1

    def reader(self, fid: FilesetID) -> FilesetReader:
        with self.lock:
            return self._reader_locked(fid)

    def _reader_locked(self, fid: FilesetID) -> FilesetReader:
        cached = self._readers.get(fid.block_start)
        if cached is not None and cached.fid.volume == fid.volume:
            self._readers.move_to_end(fid.block_start)
            return cached
        try:
            reader = FilesetReader(self.base, fid)
        except CorruptFilesetError as exc:
            # verify-on-first-read tripped: the volume rotted on disk
            # after commit. Quarantine it and report the fileset missing —
            # every caller already survives a retention race deleting a
            # fileset mid-read, and subsequent listings exclude it, so the
            # shard degrades to peers/repair instead of erroring reads.
            self._quarantine_locked(fid, exc.problems)
            raise FileNotFoundError(f"fileset {fid} quarantined") from exc
        self.reader_materializations += 1
        self._readers[fid.block_start] = reader
        self._readers.move_to_end(fid.block_start)
        while len(self._readers) > self.max_cached_readers:
            self._readers.popitem(last=False)
        return reader

    def _reader_or_none_locked(self, fid: FilesetID) -> FilesetReader | None:
        """Reader, or None when the fileset vanished (retention race) or
        was just quarantined — the graceful-read spelling call sites use
        so corruption never surfaces as a client-visible error."""
        try:
            return self._reader_locked(fid)
        except FileNotFoundError:
            return None

    def reader_or_none(self, fid: FilesetID) -> FilesetReader | None:
        with self.lock:
            return self._reader_or_none_locked(fid)

    def _quarantine_locked(self, fid: FilesetID, problems: list) -> None:
        """Rename a corrupt volume aside and invalidate everything that
        could still serve its bytes: the reader LRU entry, the fileset
        listing cache + epoch (device query plans revalidate), the decoded
        cache and resident pool for the block. If no complete volume
        remains for the block it is no longer 'flushed', so bootstrap's
        peers source / the repair plane re-replicate it."""
        quarantine_fileset(self.base, fid, problems)
        self._readers.pop(fid.block_start, None)
        self._invalidate_filesets()
        remaining = [
            f
            for f in list_fileset_volumes(self.base, self.namespace, self.id)
            if f.block_start == fid.block_start
        ]
        if not remaining:
            self._flushed_blocks.discard(fid.block_start)
        self.invalidator.on_tick_expire(
            self.namespace, self.id, {fid.block_start}
        )

    def scrub(self) -> dict:
        """One verify pass over this shard's sealed filesets: every
        complete volume is digest-verified; mismatches quarantine. Returns
        {"scanned", "quarantined", "bytes"} for the scrubber's pacing."""
        from .fs import fileset_bytes

        scanned = quarantined = scrubbed_bytes = 0
        for fid in list_fileset_volumes(self.base, self.namespace, self.id):
            scrubbed_bytes += fileset_bytes(self.base, fid)
            problems = verify_fileset(self.base, fid)
            scanned += 1
            if problems:
                with self.lock:
                    # retention/supersede deletes run under the shard lock;
                    # re-verify under it so a fileset deleted mid-verify
                    # doesn't count as corruption
                    if fileset_complete(self.base, fid):
                        problems = verify_fileset(self.base, fid)
                        if problems:
                            self._quarantine_locked(fid, problems)
                            quarantined += 1
        return {
            "scanned": scanned,
            "quarantined": quarantined,
            "bytes": scrubbed_bytes,
        }

    def check_write(self, t_nanos: int) -> None:
        """Raise if a write at ``t_nanos`` would be rejected (shard.go:
        writes into flushed blocks need cold writes enabled)."""
        bs = (t_nanos // self.opts.block_size_nanos) * self.opts.block_size_nanos
        if bs in self._flushed_blocks and not self.opts.cold_writes_enabled:
            raise ColdWriteError(
                f"write at {t_nanos} targets flushed block {bs} and namespace "
                f"{self.namespace} has cold writes disabled"
            )

    def write(self, sid: bytes, t_nanos: int, value: float, unit: Unit = Unit.SECOND) -> None:
        with self.lock:
            self.check_write(t_nanos)
            buf = self.series.get(sid)
            if buf is None:
                buf = SeriesBuffer(sid, self.opts.block_size_nanos)
                self.series[sid] = buf
            bs = (t_nanos // self.opts.block_size_nanos) * self.opts.block_size_nanos
            if bs not in buf.buckets:
                self._buffered_blocks[bs] = self._buffered_blocks.get(bs, 0) + 1
            buf.write(t_nanos, value, unit)
            if self.ingest is not None:
                self.ingest.append(sid, t_nanos, value, int(unit))
            self.invalidator.on_write(self.namespace, self.id, sid, bs)

    def _buffered_dec(self, block_start: int, n: int = 1) -> None:
        """Retire ``n`` evicted buckets from the buffered-block summary."""
        left = self._buffered_blocks.get(block_start)
        if left is None:
            return
        if left <= n:
            del self._buffered_blocks[block_start]
        else:
            self._buffered_blocks[block_start] = left - n

    def read(
        self, sid: bytes, start: int, end: int, populate_cache: bool = True
    ) -> list[Datapoint]:
        """``populate_cache=False`` serves lifecycle scans (repair digests,
        peer streaming): they read every series once and would otherwise
        flush the hot query working set out of the byte-budget LRU —
        cached entries are still used, but misses don't insert."""
        with self.lock:
            return self._read_locked(sid, start, end, populate_cache)

    def _read_locked(
        self, sid: bytes, start: int, end: int, populate_cache: bool = True
    ) -> list[Datapoint]:
        # flushed filesets first (older), then buffer segments: the
        # MultiReaderIterator's latest-segment-wins dedupe gives buffer
        # precedence over filesets (shard.go:1060 ReadEncoded ordering)
        arrs = self._read_arrays_locked(sid, start, end, populate_cache)
        if arrs is not None:  # decoded-block cache path
            t, v, u = arrs
            return [
                Datapoint(tt, vv, Unit(uu))
                for tt, vv, uu in zip(t.tolist(), v.tolist(), u.tolist())
            ]
        segments = self._segments_locked(sid, start, end)
        fast = read_segments(segments, start, end)  # None when annotations
        if fast is not None:  # must survive
            return fast
        it = MultiReaderIterator(segments)
        return [dp for dp in it if start <= dp.timestamp < end]

    def _read_arrays_locked(
        self, sid: bytes, start: int, end: int, populate_cache: bool = True
    ):
        """(times, values, units) for [start, end) via the decoded-block
        cache: sealed fileset blocks come from (or populate) the cache,
        live buffer buckets overlay on top (newest wins — the same
        precedence as the segment path). None → caller falls back (cache
        disabled, or an annotated stream that must keep Datapoint
        fidelity). ``populate_cache=False``: hits are served, misses
        decode without inserting (lifecycle scans must not evict the hot
        working set)."""
        cache = self.cache
        if cache is None:
            return None
        bsz = self.opts.block_size_nanos
        triples = []
        for fid in self.filesets():
            if fid.block_start + bsz <= start or fid.block_start >= end:
                continue
            key = BlockKey(self.namespace, self.id, sid, fid.block_start, fid.volume)

            def _decode(fid=fid):
                reader = self._reader_or_none_locked(fid)
                stream = reader.stream(sid) if reader is not None else None
                _M_DECODED_BYTES.inc(len(stream) if stream else 0)
                arrs = decode_stream_arrays(stream or b"")
                return None if arrs is None else DecodedBlock(*arrs)

            if populate_cache:
                entry = cache.get_or_decode(key, _decode)
            else:
                entry = cache.get(key)
                if entry is None:
                    entry = _decode()
            if entry is None:
                return None  # annotated stream: segment-path fallback
            if len(entry):
                triples.append(entry.triple())
        buf = self.series.get(sid)
        if buf is not None:
            # buffer overlay: per-bucket decoded arrays, memoized on the
            # bucket until its next write (series.py merged_arrays keeps
            # codec-roundtrip parity with the segment path)
            for bs in sorted(buf.buckets):
                if bs + bsz <= start or bs >= end:
                    continue
                arrs = buf.buckets[bs].merged_arrays()
                if arrs is None:
                    return None  # annotated: segment-path fallback
                if len(arrs[0]):
                    triples.append(arrs)
        t, v, u = merge_segment_arrays(triples)
        lo = int(np.searchsorted(t, start, side="left"))
        hi = int(np.searchsorted(t, end, side="left"))
        return t[lo:hi], v[lo:hi], u[lo:hi]

    def read_arrays(self, sid: bytes, start: int, end: int):
        """Array read surface: (times i64, values f64, units) decoded
        arrays for [start, end) — cache-aware, always succeeds (annotated
        streams decode through the iterator path and re-materialize;
        straight to the iterator, not via _read_locked, which would retry
        the arrays path and re-decode everything)."""
        with self.lock:
            arrs = self._read_arrays_locked(sid, start, end)
            if arrs is not None:
                return arrs
            segments = self._segments_locked(sid, start, end)
            _M_DECODED_BYTES.inc(sum(len(s) for s in segments))
            arrs = read_segments_arrays(segments, start, end)
            if arrs is not None:
                return arrs
            dps = [
                dp
                for dp in MultiReaderIterator(segments)
                if start <= dp.timestamp < end
            ]
        return (
            np.asarray([dp.timestamp for dp in dps], np.int64),
            np.asarray([dp.value for dp in dps], np.float64),
            np.asarray([int(dp.unit) for dp in dps], np.uint8),
        )

    def _segments_locked(self, sid: bytes, start: int, end: int) -> list[bytes]:
        """Raw encoded segments overlapping [start, end), oldest-first —
        the compressed-read surface (rpc.thrift fetchBlocksRaw role)."""
        segments: list[bytes] = []
        for fid in self.filesets():
            if fid.block_start + self.opts.block_size_nanos <= start or fid.block_start >= end:
                continue
            reader = self._reader_or_none_locked(fid)
            stream = reader.stream(sid) if reader is not None else None
            if stream:
                segments.append(stream)
        buf = self.series.get(sid)
        if buf is not None:
            segments.extend(buf.streams(start, end))
        return segments

    def fetch_blocks(self, sid: bytes, start: int, end: int) -> list[bytes]:
        with self.lock:
            return self._segments_locked(sid, start, end)

    # --- resident-scan routing surface (resident/) ---

    def scan_block_keys(self, sid: bytes, start: int, end: int):
        """(fileset BlockKeys overlapping [start, end), buffered) — the
        residency check input: the resident path may serve this series iff
        every key is resident (or its fileset is complete-admitted and the
        series is simply absent) AND no live buffer overlaps the range
        (buffer data overlays sealed blocks at read time; a resident-only
        scan would miss it)."""
        with self.lock:
            bsz = self.opts.block_size_nanos
            keys = [
                BlockKey(self.namespace, self.id, sid, fid.block_start, fid.volume)
                for fid in self.filesets()
                if not (fid.block_start + bsz <= start or fid.block_start >= end)
            ]
            buf = self.series.get(sid)
            buffered = buf is not None and buf.has_points(start, end)
            return keys, buffered

    def has_buffered_overlap(self, start: int, end: int) -> bool:
        """True when ANY live series buffer holds points in [start, end)
        — the shard-level buffer-overlay gate the device query planner
        checks per execution (a fused plan reads sealed residency only,
        so one buffered point in range degrades the whole query to the
        staged path, which applies the per-series overlay rule). Served
        from the maintained block-start summary: O(distinct buffered
        blocks) regardless of how many series are ingesting, so a
        heavily ingesting shard answering historical queries pays a few
        integer compares, not a walk of every live buffer."""
        bsz = self.opts.block_size_nanos
        with self.lock:
            return any(
                bs + bsz > start and bs < end for bs in self._buffered_blocks
            )

    def scan_segments(self, sid: bytes, start: int, end: int) -> list[tuple]:
        """[(stream, datapoint_bound, chunk_k)] for the STREAMED scan
        path, in the same lane order the resident path uses (filesets by
        block start, then buffer buckets). Bounds come from fileset index
        entries (n_chunks * chunk_k) / buffer write counts — an upper
        bound is enough: extra decode steps land on done lanes and drop
        out of every reduction. chunk_k is the fileset's persisted chunkK
        (the resident path decodes with it via the admitted side planes,
        so the streamed twin must prescan with the SAME chunk size for
        the bit-for-bit parity contract to hold); buffer buckets have no
        fileset and report the default."""
        with self.lock:
            out: list[tuple] = []
            bsz = self.opts.block_size_nanos
            for fid in self.filesets():
                if fid.block_start + bsz <= start or fid.block_start >= end:
                    continue
                reader = self._reader_or_none_locked(fid)
                if reader is None:
                    continue
                entry = reader._lookup(sid) if reader.bloom.test(sid) else None
                if entry is None:
                    continue
                stream = reader.stream(sid)
                if not stream:
                    continue
                chunk_k = int(reader.info.get("chunkK", CHUNK_K))
                out.append((stream, entry[3] * chunk_k, chunk_k))
            buf = self.series.get(sid)
            if buf is not None:
                for bs in sorted(buf.buckets):
                    if bs + bsz <= start or bs >= end:
                        continue
                    bucket = buf.buckets[bs]
                    stream = bucket.merged_stream()
                    if stream:
                        out.append((stream, len(bucket.times), CHUNK_K))
            return out

    def warm_flush(self, flush_before_nanos: int) -> list[FilesetID]:
        """shard.go:2146 — write filesets for complete blocks, then evict;
        the flushed filesets admit into the resident pool at seal.

        With device ingest on, sealed blocks encode through kernel B-4
        (ops/encode.py) and are BORN resident: the fileset persists from the
        device-encoded bytes and admission moves the pages device to device
        (pool.admit_block_device) instead of re-reading and re-uploading
        the fileset."""
        with self.lock:
            flushed, device_payload = self._warm_flush_locked(flush_before_nanos)
            t0 = time.perf_counter()
            device_blocks = {(p[0], p[1]) for p in device_payload}
            payload = self._collect_admission_locked(
                [f for f in flushed if (f.block_start, f.volume) not in device_blocks])
        self._admit_payload(payload)
        self._admit_device_payload(device_payload)
        self.seal_seconds["admission"] += time.perf_counter() - t0
        return flushed

    def _seal_encode_locked(self, bs: int, buckets: list):
        """Device-encode one sealing block: ``buckets`` is ``[(sid,
        BufferBucket)]``. Returns ``(series_streams, fileset_side_rows,
        device_payload | None)`` where device_payload is ``(block_start,
        volume, words, dev_items, host_items, chunk_k)`` admission input.
        Ineligible lanes (annotated values, sub-second timestamps, mixed
        int/float, overflows) fall back to the host codec and ride the SAME
        admission batch as host items. Adds its host seconds by stage to
        ``seal_seconds``."""
        from ..ops import encode as dev

        clock = time.perf_counter
        t_start = clock()
        if self.ingest is not None:
            # release the sealed window's frame + clean/dirty accounting (the
            # columns themselves are read off the canonical merged buckets; a
            # clean lane's merge is a no-op)
            self.ingest.seal_window(bs)
        series: dict[bytes, bytes] = {}
        side_rows: dict[bytes, object] = {}
        host_items: list[tuple] = []
        points = [bucket.merged_points() for _sid, bucket in buckets]
        kinds = dev.classify_lanes(*(np.concatenate(col) for col in zip(*points)),
                                   np.fromiter((len(p[0]) for p in points), np.int64, len(points)))
        eligible: list[tuple] = []
        for (sid, bucket), (t, v, _u), kind in zip(buckets, points, kinds.tolist()):
            if kind == dev.KIND_NONE:
                stream = bucket.merged_stream()
                if stream:
                    series[sid] = stream
                    host_items.append((sid, stream, len(t)))
            else:
                eligible.append((sid, t, v, kind))
        _M_ENCODE_FALLBACK.inc(len(host_items))
        t_classify = clock()
        stages = self.seal_seconds
        stages["classify"] += t_classify - t_start
        if not eligible:
            return series, side_rows, None
        pw = self.pool.options.page_words if self.pool is not None and self.pool.enabled else 1
        lanes = [(c[1], c[2]) for c in eligible]
        lane_kinds = np.asarray([c[3] for c in eligible], np.int8)
        inp = dev.encode_inputs(lanes, lane_kinds, CHUNK_K, pw, self.device)
        t_pack = clock()
        res = dev.result_of(inp, dev.encode_planes(inp), lane_kinds)
        t_encode = clock()
        rows = dev.side_rows_for(res, lanes, bs)
        t_side = clock()
        streams = res.streams()
        t_streams = clock()
        stages["packing"] += t_pack - t_classify
        stages["encode"] += t_encode - t_pack
        stages["side_rows"] += t_side - t_encode
        stages["streams"] += t_streams - t_side
        _M_ENCODE_LANES.inc(len(eligible))
        _M_ENCODE_BYTES.inc(int(res.nbytes.sum()))
        dev_items = []
        for m, (sid, _t, _v, _kind) in enumerate(eligible):
            series[sid] = streams[m]
            side_rows[sid] = rows[m]
            dev_items.append((sid, m, int(res.nbytes[m]), int(res.n_chunks[m]),
                              dev.lane_max_span(res, m), rows[m]))
        return series, side_rows, (bs, 0, res.words, dev_items, host_items, CHUNK_K)

    def _admit_device_payload(self, payload: list) -> int:
        """Stage-2 admission of device-encoded seals (outside the shard
        lock, like :meth:`_admit_payload`): pages move device to device,
        no stream byte uploaded; host-fallback lanes of the same block ride
        the same batch and pay the normal upload."""
        if self.pool is None or not self.pool.enabled:
            return 0
        admitted = 0
        for block_start, volume, words, items, host_items, chunk_k in payload:
            res = self.pool.admit_block_device(
                self.namespace, self.id, block_start, volume, words, items,
                chunk_k=chunk_k, host_items=host_items,
            )
            admitted += res.admitted
        return admitted

    def _warm_flush_locked(self, flush_before_nanos: int):
        blocks: dict[int, list] = {}
        for sid, buf in self.series.items():
            for bs, bucket in buf.buckets.items():
                if (
                    bs + buf.block_size <= flush_before_nanos
                    and bucket.times
                    and bs not in self._flushed_blocks
                ):
                    blocks.setdefault(bs, []).append((sid, bucket))
        flushed = []
        device_payload = []
        stages = self.seal_seconds
        for bs, buckets in sorted(blocks.items()):
            if self.ingest is not None:
                series, side_rows, dev_payload = self._seal_encode_locked(bs, buckets)
            else:
                t0 = time.perf_counter()
                series = {
                    sid: stream
                    for sid, bucket in buckets
                    for stream in [bucket.merged_stream()]
                    if stream
                }
                side_rows, dev_payload = {}, None
                stages["encode"] += time.perf_counter() - t0
            if not series:
                continue
            fid = FilesetID(self.namespace, self.id, bs, volume=0)
            t0 = time.perf_counter()
            write_fileset(self.base, fid, series, self.opts.block_size_nanos, CHUNK_K,
                          side_rows=side_rows or None)
            stages["fileset"] += time.perf_counter() - t0
            self._flushed_blocks.add(bs)
            flushed.append(fid)
            if dev_payload is not None:
                device_payload.append(dev_payload)
        if flushed:
            self._invalidate_filesets()
            self.invalidator.on_flush(self.namespace, self.id, flushed)
        # evict only what this flush made durable — cold writes into
        # previously-flushed blocks stay buffered for cold_flush
        for buf in self.series.values():
            for fid in flushed:
                if buf.evict_block(fid.block_start):
                    self._buffered_dec(fid.block_start)
        # drop buffers the flush emptied (tick would anyway): keeps the
        # sealed-only fast path O(1) for has_buffered_overlap instead of
        # walking thousands of empty buckets per query
        for sid in [s for s, buf in self.series.items() if not buf.buckets]:
            del self.series[sid]
        return flushed, device_payload

    def cold_flush(self, flush_before_nanos: int) -> list[FilesetID]:
        """shard.go:2212 + persist/fs/merger.go — out-of-order writes into
        already-flushed blocks merge with the existing fileset ONCE PER BLOCK
        (all cold series together) and go out as one new volume."""
        with self.lock:
            flushed = self._cold_flush_locked(flush_before_nanos)
            payload = self._collect_admission_locked(flushed)
        self._admit_payload(payload)
        return flushed

    def _cold_flush_locked(self, flush_before_nanos: int) -> list[FilesetID]:
        # gather every cold stream per block first, so each block merges once
        cold: dict[int, dict[bytes, bytes]] = {}
        for sid, buf in list(self.series.items()):
            for bs, stream in buf.streams_before(flush_before_nanos).items():
                if bs in self._flushed_blocks and stream:
                    cold.setdefault(bs, {})[sid] = stream
        flushed = []
        for bs, updates in sorted(cold.items()):
            prev = next((f for f in self.filesets() if f.block_start == bs), None)
            series: dict[bytes, bytes] = {}
            reader = self._reader_or_none_locked(prev) if prev is not None else None
            if reader is not None:
                for other in reader.series_ids:
                    series[other] = reader.stream(other) or b""
            for sid, stream in updates.items():
                merged: dict[int, Datapoint] = {}
                if sid in series:
                    for dp in decode(series[sid]):
                        merged[dp.timestamp] = dp
                for dp in decode(stream):
                    merged[dp.timestamp] = dp
                enc = Encoder(min(merged))
                for t in sorted(merged):
                    dp = merged[t]
                    enc.encode(dp.timestamp, dp.value, unit=dp.unit)
                series[sid] = enc.stream()
            vol = (prev.volume + 1) if prev is not None else 0
            fid = FilesetID(self.namespace, self.id, bs, volume=vol)
            write_fileset(self.base, fid, series, self.opts.block_size_nanos, CHUNK_K)
            flushed.append(fid)
            # eager superseded-volume cleanup: every lower volume of this
            # block can never serve a read again (the reader cache checks
            # volume; caches/pool invalidate on the flush notification
            # below), so delete it NOW instead of letting it linger on
            # disk until retention expiry
            for old in list_fileset_volumes(self.base, self.namespace, self.id):
                if old.block_start == bs and old.volume < vol:
                    delete_fileset(self.base, old)
                    _M_SUPERSEDED_DELETED.inc()
            for sid in updates:
                if self.series[sid].evict_block(bs):
                    self._buffered_dec(bs)
        if flushed:
            self._invalidate_filesets()
            # a cold flush writes a NEW volume per block: every cached
            # entry of a lower volume is superseded and can never hit
            self.invalidator.on_flush(self.namespace, self.id, flushed)
        return flushed

    def _collect_admission_locked(self, fids: list[FilesetID]) -> list[tuple]:
        """Seal-time residency admission, stage 1 (under the shard lock):
        resolve each flushed fileset's reader and FORCE its full index
        parse — the only mutable state the off-lock stage touches.
        Everything else (bloom probes, index lookups against the parsed
        table, mmap'd data slices) is read-only on an immutable fileset,
        so the O(fileset bytes) stream read-back runs lock-free in
        stage 2."""
        if self.pool is None or not self.pool.enabled:
            return []
        payload = []
        for fid in fids:
            reader = self._reader_locked(fid)
            chunk_k = int(reader.info.get("chunkK", CHUNK_K))
            payload.append(
                (fid.block_start, fid.volume, reader, dict(reader.index), chunk_k)
            )
        return payload

    def _admit_payload(self, payload: list[tuple], readmission: bool = False) -> int:
        """Seal-time residency admission, stage 2 (OUTSIDE the shard
        lock): the fileset read-back, staging-array build, host->device
        upload must not stall the shard's hot read/write path. Each lane
        rides with the fileset's PERSISTED per-chunk side rows
        (fs.admission_side: the packed rows of a v3 side file, as they
        lie on disk) so the pool pages the chunk metadata into its device
        side planes without re-running the prescan — the chunk-parallel resident decoder's
        shapes then match the streamed path's exactly (same snapshots,
        same chunk_k), which keeps the two paths' decode programs (and
        f32 reduction trees) identical. Racing mutations stay correct
        without the lock: a write landing between collect and admit
        leaves buffered points that force the query router's streamed
        fallback (buffer-overlay check), and a superseding flush admits a
        HIGHER volume the router prefers; a retention expiry racing in
        leaves only an unreachable entry that ages out of the LRU.
        Returns the number of admitted lanes."""
        admitted = 0
        for block_start, volume, reader, index, chunk_k in payload:
            items = []
            for sid, (_, _, _, n_chunks) in index.items():
                stream = reader.stream(sid)
                if stream:
                    items.append(
                        (sid, stream, n_chunks * chunk_k, reader.admission_side(sid))
                    )
            res = self.pool.admit_block(
                self.namespace, self.id, block_start, volume, items,
                chunk_k=chunk_k, readmission=readmission,
            )
            admitted += res.admitted
        return admitted

    def readmit_fileset(self, fid: FilesetID) -> int:
        """Read-through re-admission: re-read one sealed fileset and
        admit it into the resident pool, keeping the two-phase admission
        discipline (collect under the shard lock, admit outside it) in
        THIS layer — callers (query routing) never touch the shard's
        lock or admission internals. Returns admitted lanes; 0 when
        retention raced the fileset away (in EITHER phase: the admit
        phase re-reads stream/side bytes off the fileset too)."""
        try:
            with self.lock:
                payload = self._collect_admission_locked([fid])
            return self._admit_payload(payload, readmission=True)
        except FileNotFoundError:
            return 0

    def tick(self, now_nanos: int) -> None:
        """shard.go:663 tickAndExpire: drop series/blocks past retention,
        expired filesets off disk, and stale cached readers."""
        with self.lock:
            self._tick_locked(now_nanos)

    def _tick_locked(self, now_nanos: int) -> None:
        expire_before = now_nanos - self.opts.retention_nanos
        for sid in list(self.series):
            buf = self.series[sid]
            for bs in buf.evict_before(expire_before):
                self._buffered_dec(bs)
            if not buf.buckets:
                del self.series[sid]
        if self.ingest is not None:
            for bs in self.ingest.open_windows():
                if bs + self.opts.block_size_nanos <= expire_before:
                    self.ingest.drop_window(bs)
        bsz = self.opts.block_size_nanos
        expired = [
            fid
            for fid in list_fileset_volumes(self.base, self.namespace, self.id)
            if fid.block_start + bsz <= expire_before
        ]
        for fid in expired:
            delete_fileset(self.base, fid)
            self._flushed_blocks.discard(fid.block_start)
            self._readers.pop(fid.block_start, None)
        if expired:
            self._invalidate_filesets()
            self.invalidator.on_tick_expire(
                self.namespace, self.id, {fid.block_start for fid in expired}
            )


class Namespace:
    def __init__(
        self,
        name: str,
        opts: NamespaceOptions,
        num_shards: int,
        base: str,
        cache: BlockCache | None = None,
        invalidator: CacheInvalidator | None = None,
        pool: ResidentPool | None = None,
        index_store=None,
        ingest_options=None,
        device="cuda",
    ) -> None:
        self.name = name
        self.opts = opts
        self.num_shards = num_shards
        self.shards = [
            Shard(
                i, name, opts, base, cache=cache, invalidator=invalidator,
                pool=pool, ingest_options=ingest_options, device=device,
            )
            for i in range(num_shards)
        ]
        self.index = None
        if opts.index_enabled:
            from ..index.ns_index import NamespaceIndex

            self.index = NamespaceIndex(
                opts.block_size_nanos, opts.retention_nanos,
                device_store=index_store,
            )

    def shard_for(self, sid: bytes) -> Shard:
        return self.shards[_shard_index(sid, self.num_shards)]


class Database:
    """Top-level storage node object (database.go). The resident pool and
    the device index tier, when their options give them a budget, live on
    ``device``; the Database raises without a card unless the caller asks
    for the CPU."""

    def __init__(
        self,
        base_dir: str,
        num_shards: int = 8,
        commitlog_enabled: bool = True,
        cache_options: CacheOptions | None = None,
        resident_options: ResidentOptions | None = None,
        index_device_options=None,
        ingest_options=None,
        commitlog_sync: str = "interval",
        device="cuda",
    ) -> None:
        self.device = resolve_device(device)
        self.base = base_dir
        self.num_shards = num_shards
        self.namespaces: dict[str, Namespace] = {}
        self.commitlog_enabled = commitlog_enabled
        if commitlog_sync not in COMMITLOG_SYNC_MODES:
            raise ValueError(
                f"commitlog_sync must be one of {sorted(COMMITLOG_SYNC_MODES)}, "
                f"got {commitlog_sync!r}"
            )
        self.commitlog_sync = commitlog_sync
        # decoded-block cache, shared across namespaces/shards (one byte
        # budget per node, like the reference's process-wide wired list)
        self.cache_options = cache_options or CacheOptions()
        self.block_cache = (
            BlockCache(self.cache_options)
            if self.cache_options.enabled and self.cache_options.max_bytes > 0
            else None
        )
        # device-resident compressed pool, one device byte budget per node
        # (resident/): sealed blocks admit at flush, warm scans decode from
        # the card. Off by default — an opt-in mode via resident_options.
        self.resident_options = resident_options or ResidentOptions(enabled=False)
        self.resident_pool = (
            ResidentPool(self.resident_options, device=self.device)
            if self.resident_options.enabled and self.resident_options.max_bytes > 0
            else None
        )
        # device-resident inverted index (index/device/): one byte budget
        # per node like the pool above; sealed index segments admit at seal
        # and queries plan onto kernels K1/K2. Off unless options are
        # given (max_bytes=0 turns it off too).
        self.index_device_options = index_device_options
        self.index_device_store = None
        if index_device_options is not None and index_device_options.max_bytes > 0:
            from ..index.device import DeviceIndexStore

            self.index_device_store = DeviceIndexStore(
                index_device_options, device=self.device
            )
        # device-side ingest (ingest/): write batches mirror into per-shard
        # column planes on the device, so seal encodes there and admits born
        # resident. Off by default -- opt-in via ingest_options.
        self.ingest_options = ingest_options
        self.cache_invalidator = CacheInvalidator(self.block_cache, self.resident_pool)
        self._commitlogs: dict[str, CommitLog] = {}
        self.bootstrapped = False
        # self-observability (x/instrument role). Write/read counters are
        # labeled {ns=...} (cardinality = operator-bounded namespace count)
        # so the self-scrape pipeline can SKIP the reserved `_m3tpu`
        # namespace's children when snapshotting — the collector's own
        # storage writes never re-enter the telemetry it stores
        # (selfmon/guard.py invariant 2). Children resolve once per
        # namespace; after that a write costs one dict lookup.
        self._m_writes: dict[str, object] = {}
        self._m_reads: dict[str, object] = {}
        self._m_write_errors: dict[str, object] = {}
        # new-series insert rate limit (runtime options; 0 = unlimited)
        self._new_series_limit = 0
        self._new_series_window = (0, 0)  # (second, count)
        self._limit_lock = threading.Lock()
        # Lifecycle lock: create_namespace / flush / snapshot / tick /
        # bootstrap / stream_shard. Hot-path reads and writes take ONLY the
        # per-shard locks (shard.go RWMutex granularity); lifecycle ops take
        # this lock first, then shard locks, so the order is always
        # db -> shard and a flush of one shard never blocks reads of others.
        self.lock = threading.RLock()

    def create_namespace(self, name: str, opts: NamespaceOptions | None = None) -> Namespace:
        # resolve the namespace's write/read counter children eagerly so
        # the families exist in the exposition from boot (scrape targets
        # and tools/check_metrics.py expect them before the first write)
        self._writes_counter(name)
        self._reads_counter(name)
        self._write_errors_counter(name)
        with self.lock:
            ns = Namespace(
                name,
                opts or NamespaceOptions(),
                self.num_shards,
                self.base,
                cache=self.block_cache,
                invalidator=self.cache_invalidator,
                pool=self.resident_pool,
                index_store=self.index_device_store,
                ingest_options=self.ingest_options,
                device=self.device,
            )
            self.namespaces[name] = ns
            if self.commitlog_enabled:
                self._commitlogs[name] = CommitLog(
                    self._commitlog_dir(name),
                    **COMMITLOG_SYNC_MODES[self.commitlog_sync],
                )
            return ns

    def _commitlog_dir(self, ns: str) -> str:
        return os.path.join(self.base, "commitlogs", ns)

    # per-namespace counter children resolve once; a benign race hands both
    # writers the SAME registry child, so the dict update is lock-free

    def _writes_counter(self, ns: str):
        c = self._m_writes.get(ns)
        if c is None:
            c = self._m_writes[ns] = METRICS.counter(
                "db_writes_total", "datapoint writes", labels={"ns": ns}
            )
        return c

    def _reads_counter(self, ns: str):
        c = self._m_reads.get(ns)
        if c is None:
            c = self._m_reads[ns] = METRICS.counter(
                "db_reads_total", "series reads", labels={"ns": ns}
            )
        return c

    def _write_errors_counter(self, ns: str):
        c = self._m_write_errors.get(ns)
        if c is None:
            c = self._m_write_errors[ns] = METRICS.counter(
                "db_write_errors_total", "rejected datapoint writes",
                labels={"ns": ns},
            )
        return c

    def write(
        self, ns: str, sid: bytes, t_nanos: int, value: float, unit: Unit = Unit.SECOND
    ) -> None:
        # reserved-namespace rule (selfmon/guard.py): only the tagged
        # self-scrape pipeline may write `_m3tpu*` telemetry namespaces
        check_write(ns)
        namespace = self.namespaces[ns]
        shard = namespace.shard_for(sid)
        cl = self._commitlogs.get(ns)
        if cl is not None and cl.disk_full:
            # shed before buffering: an accepted point the WAL cannot land
            # would be unreplayable after a crash. Typed retryable — the
            # client backs off and the write succeeds once space frees.
            raise DiskFullError(f"commit log disk full: {ns}")
        with shard.lock:
            with self._limit_lock:
                is_new = self._check_new_series(shard, sid)
            # buffer first so rejected writes (ColdWriteError) never reach the
            # WAL — a logged-but-unacceptable entry would poison replay
            try:
                shard.write(sid, t_nanos, value, unit)
            except Exception:
                self._write_errors_counter(ns).inc()
                raise
            if is_new and self._new_series_limit > 0:
                with self._limit_lock:
                    self._consume_new_series()
            # WAL append under the shard lock: buffer apply and log entry
            # are one atomic unit per series, so replay order can't diverge
            # from the order reads observed (the WAL lock nests inside
            # shard locks everywhere)
            cl = self._commitlogs.get(ns)
            if cl is not None:
                cl.write(CommitLogEntry(sid, t_nanos, value, unit))
        self._writes_counter(ns).inc()

    def write_batch(self, ns: str, entries: list[tuple[bytes, int, float]]) -> None:
        """Batched ingest, flattened to one tight loop per shard: entries
        group by shard (one lock acquisition each), then append directly
        into the raw-column buffer buckets — the per-entry method chain
        (Shard.write → SeriesBuffer.write → BufferBucket.write) cost ~12µs
        per datapoint and capped node ingest at ~80k writes/s/core. If an
        entry is rejected midway (a flush can seal a block between
        entries), everything ALREADY applied is still WAL-logged before
        the error propagates, so no applied write is ever unlogged."""
        check_write(ns)
        namespace = self.namespaces[ns]
        cl = self._commitlogs.get(ns)
        if cl is not None and cl.disk_full:
            # shed the whole batch before buffering (see write())
            raise DiskFullError(f"commit log disk full: {ns}")
        limit_on = self._new_series_limit > 0
        unit_s = int(Unit.SECOND)
        # shard routing for the whole batch in one murmur3 call of the host
        # codec library
        shard_ids = native.shard_batch([e[0] for e in entries], namespace.num_shards)
        by_shard: dict[int, tuple] = {}
        shards = namespace.shards
        for e, si in zip(entries, shard_ids.tolist()):
            rec = by_shard.get(si)
            if rec is None:
                rec = by_shard[si] = (shards[si], [])
            rec[1].append(e)
        applied: list[CommitLogEntry] = []
        cache = self.block_cache
        pool = self.resident_pool
        touched: set = set()
        try:
            for sh, items in by_shard.values():
                bsz = sh.opts.block_size_nanos
                cold_ok = sh.opts.cold_writes_enabled
                flushed = sh._flushed_blocks
                with sh.lock:
                    # decided UNDER the shard lock: cache entries for this
                    # shard's keys are only created by readers holding this
                    # lock (pool entries by flushes, which also hold it), so
                    # an empty cache AND pool here (the common case during
                    # ingest-heavy phases) safely skips the per-item set
                    # insert
                    collect = (cache is not None and len(cache) > 0) or (
                        pool is not None and len(pool) > 0
                    )
                    series = sh.series
                    for sid, t, v in items:
                        bs = (t // bsz) * bsz
                        if bs in flushed and not cold_ok:
                            raise ColdWriteError(
                                f"write at {t} targets flushed block {bs} and "
                                f"namespace {sh.namespace} has cold writes disabled"
                            )
                        if collect:
                            touched.add((sh.id, sid, bs))
                        buf = series.get(sid)
                        if buf is None:
                            if limit_on:
                                with self._limit_lock:
                                    self._check_new_series(sh, sid)
                                    self._consume_new_series()
                            buf = series[sid] = SeriesBuffer(sid, bsz)
                        bucket = buf.buckets.get(bs)
                        if bucket is None:
                            bucket = buf.buckets[bs] = BufferBucket(block_start=bs)
                            buffered = sh._buffered_blocks
                            buffered[bs] = buffered.get(bs, 0) + 1
                        bucket.times.append(t)
                        bucket.values.append(v)
                        bucket.units.append(unit_s)
                        if t > bucket.last_write_nanos:
                            bucket.last_write_nanos = t
                        bucket.num_writes += 1
                        bucket._stream_cache = None
                        bucket._arrays_cache = None
                        applied.append(CommitLogEntry(sid, t, v))
                    if sh.ingest is not None and items:
                        # mirror the batch into the device column planes (one
                        # vectorized append per shard, not per point); spilled
                        # rows just lose the device-seal shortcut -- the bucket
                        # append above stays the source of truth
                        sh.ingest.append_batch(
                            [e[0] for e in items],
                            [e[1] for e in items],
                            [e[2] for e in items],
                            [unit_s] * len(items),
                        )
            self._writes_counter(ns).inc(len(applied))
        finally:
            if touched:
                for shard_id, sid, bs in touched:
                    self.cache_invalidator.on_write(ns, shard_id, sid, bs)
            if cl is not None and applied:
                cl.write_batch(applied)

    def apply_runtime_options(self, ro) -> None:
        """Live-tunable node knobs from a ``storage/runtime.RuntimeOptions``
        (the KV-watching manager that calls this waits for ROADMAP §A10)."""
        with self.lock:
            self._new_series_limit = int(ro.write_new_series_limit_per_sec)

    def _check_new_series(self, shard: Shard, sid: bytes) -> bool:
        """ClusterNewSeriesInsertLimit (kvconfig): cap NEW series creations
        per second across the node; existing-series writes are unaffected.
        Returns whether the write WOULD create a series; the token is only
        consumed after the write succeeds (_consume_new_series), so rejected
        writes don't burn quota."""
        is_new = sid not in shard.series
        if self._new_series_limit <= 0 or not is_new:
            return is_new
        now_s = int(time.monotonic())
        sec, count = self._new_series_window
        if sec != now_s:
            sec, count = now_s, 0
            self._new_series_window = (sec, count)
        if count >= self._new_series_limit:
            raise NewSeriesLimitError(
                f"new series insert limit {self._new_series_limit}/s exceeded"
            )
        return True

    def _consume_new_series(self) -> None:
        sec, count = self._new_series_window
        self._new_series_window = (sec, count + 1)

    def read(self, ns: str, sid: bytes, start: int, end: int) -> list[Datapoint]:
        self._reads_counter(ns).inc()
        # per-shard locking (inside Shard.read): reads don't serialize
        # against other shards or the database lifecycle lock
        return self.namespaces[ns].shard_for(sid).read(sid, start, end)

    def read_arrays(self, ns: str, sid: bytes, start: int, end: int):
        """Decoded (times i64, values f64, units) arrays for one series —
        the cache-aware array read surface query engines consume without
        materializing per-point Datapoint objects."""
        self._reads_counter(ns).inc()
        return self.namespaces[ns].shard_for(sid).read_arrays(sid, start, end)

    def fetch_blocks(self, ns: str, sid: bytes, start: int, end: int) -> list[bytes]:
        """Compressed read surface: raw encoded segments overlapping the
        range, oldest-first (rpc.thrift fetchBlocksRaw; the client session
        merges replicas' segments with the SeriesIterator stack instead of
        shipping decoded datapoints)."""
        self._reads_counter(ns).inc()
        return self.namespaces[ns].shard_for(sid).fetch_blocks(sid, start, end)

    # --- tagged write / index query path (database.go:606 WriteTagged,
    # :785 QueryIDs; network FetchTagged mirrors this) ---

    def write_tagged(
        self, ns: str, tags, t_nanos: int, value: float, unit: Unit = Unit.SECOND
    ) -> bytes:
        # the canonical tag-encoded id (m3_tpu/rules/rules.py encode_tags_id)
        sid = encode_tags(tags)
        namespace = self.namespaces[ns]
        # data first: a rejected write (ColdWriteError) must not leave a
        # phantom entry in the reverse index
        self.write(ns, sid, t_nanos, value, unit)
        if namespace.index is not None:
            namespace.index.write(sid, tags, t_nanos)
        return sid

    def write_tagged_batch(self, ns: str, entries) -> list[str | None]:
        """Batched tagged writes with PER-ENTRY error isolation (the node
        side of the client's host queue, rpc.thrift writeTaggedBatchRaw +
        per-element error semantics). ``entries``: (tags, t_nanos, value,
        unit). Returns one error string or None per entry, in order."""
        errs: list[str | None] = []
        for tags, t, v, unit in entries:
            try:
                self.write_tagged(
                    ns,
                    tuple((bytes(a), bytes(b)) for a, b in tags),
                    t,
                    v,
                    Unit(unit),
                )
                errs.append(None)
            except Exception as exc:
                errs.append(f"{type(exc).__name__}: {exc}")
        return errs

    def query_ids(self, ns: str, query, start: int, end: int, limit: int | None = None,
                  force_host: bool = False):
        """Index resolution (QueryIDs). ``force_host`` bypasses the
        device index tier — the parity surface check_index and the
        property suite diff the device executor against."""
        namespace = self.namespaces[ns]
        if namespace.index is None:
            raise RuntimeError(f"namespace {ns} has no index")
        with query_stats.stage("index_resolve"):
            return namespace.index.query(
                query, start, end, limit=limit, force_host=force_host
            )

    def aggregate_query(
        self, ns: str, query, start: int, end: int, field_filter=None
    ):
        """AggregateQuery (storage/index.go:1218): distinct field names →
        values over matched docs (labels / label-values endpoints)."""
        namespace = self.namespaces[ns]
        if namespace.index is None:
            raise RuntimeError(f"namespace {ns} has no index")
        return namespace.index.aggregate_query(
            query, start, end, field_filter=field_filter
        )

    def fetch_tagged(
        self, ns: str, query, start: int, end: int, limit: int | None = None
    ) -> list[tuple[bytes, tuple, list[Datapoint]]]:
        """Index query + per-series read (the FetchTagged server path,
        tchannelthrift/node/service.go:626). Inside a traced request (e.g.
        a server-side RPC span) the index-resolve + decode work gets a
        storage span so stitched traces show where node time went."""
        span = (
            TRACER.span("storage.fetch_tagged", namespace=ns)
            if TRACER.active()
            else NOOP_SPAN
        )
        with span:
            result = self.query_ids(ns, query, start, end, limit=limit)
            out = []
            with query_stats.stage("decode"):
                for doc in result.docs:
                    out.append(
                        (doc.id, doc.fields, self.read(ns, doc.id, start, end))
                    )
            span.set_tag("series", len(out))
        return out

    def fetch_tagged_arrays(
        self, ns: str, query, start: int, end: int, limit: int | None = None,
        docs=None,
    ) -> list[tuple[bytes, tuple, tuple]]:
        """FetchTagged on the array surface: (sid, tags, (times, values))
        per matched series, served through the decoded-block cache.
        ``docs``: pre-resolved index docs — callers that already ran
        query_ids (the residency router) skip the second resolution."""
        span = (
            TRACER.span("storage.fetch_tagged", namespace=ns)
            if TRACER.active()
            else NOOP_SPAN
        )
        with span:
            if docs is None:
                docs = self.query_ids(ns, query, start, end, limit=limit).docs
            out = []
            with query_stats.stage("decode"):
                for doc in docs:
                    t, v, _u = self.read_arrays(ns, doc.id, start, end)
                    out.append((doc.id, doc.fields, (t, v)))
            span.set_tag("series", len(out))
        return out

    def cache_stats(self) -> dict:
        """Decoded-block cache stats for debug/status endpoints."""
        if self.block_cache is None:
            return {"enabled": False}
        return {"enabled": True, **self.block_cache.stats()}

    def resident_stats(self) -> dict:
        """Resident-pool stats for debug/status endpoints, plus the
        streamed-fallback byte counter so one call answers 'are warm scans
        moving block bytes?' (tools/check_resident.py asserts the deltas
        are zero across a warm resident scan)."""
        if self.resident_pool is None:
            return {"enabled": False}
        from ..resident.scan import _M_STREAMED_BYTES

        return {
            **self.resident_pool.stats(),
            "streamed_bytes": _M_STREAMED_BYTES.value,
        }

    def resident_clear(self) -> int:
        """Drop every resident entry (operator/debug surface — the wire
        face lets tools/check_resident.py exercise eviction churn + the
        read-through re-admission path against a live node). Returns the
        number of entries dropped; duplicate-safe (clearing an empty pool
        clears nothing)."""
        if self.resident_pool is None:
            return 0
        return self.resident_pool.clear()

    def index_stats(self) -> dict:
        """Device-index-tier + postings-cache stats for debug/status
        endpoints (the `index_stats` wire op and /debug/dump's
        index.json): store budget/occupancy/eviction counters plus
        per-namespace block/segment counts and cache effectiveness."""
        out: dict = {
            "enabled": self.index_device_store is not None,
            "namespaces": {},
        }
        if self.index_device_store is not None:
            out.update(self.index_device_store.stats())
        with self.lock:
            namespaces = list(self.namespaces.items())
        for name, ns in namespaces:
            ix = ns.index
            if ix is None:
                continue
            with ix.lock:
                blocks = list(ix.blocks.values())
            sealed = sum(len(b.sealed) for b in blocks)
            device_resident = sum(
                1
                for b in blocks
                for s in b.sealed
                if getattr(s, "resident", False)
            )
            out["namespaces"][name] = {
                "blocks": len(blocks),
                "sealed_segments": sealed,
                "device_resident_segments": device_resident,
                "postings_cache": ix.postings_cache.stats(),
            }
        return out

    def flush(self, ns: str, flush_before_nanos: int) -> list[FilesetID]:
        with TRACER.span("db.flush", namespace=ns):
            with self.lock:
                namespace = self.namespaces[ns]
                out = []
                for shard in namespace.shards:
                    out.extend(shard.warm_flush(flush_before_nanos))
                    if namespace.opts.cold_writes_enabled:
                        out.extend(shard.cold_flush(flush_before_nanos))
                # Rotate the WAL, then drop only sealed segments whose every entry
                # is now durable in a flushed fileset. Coverage is BLOCK-aligned:
                # only entries whose whole block is before the cutoff were
                # flushed (streams_before), so an entry in a partial block at the
                # cutoff edge keeps its segment alive. With cold writes enabled,
                # warm+cold flush together make every such point durable; with
                # cold writes disabled, writes into flushed blocks are rejected
                # at write time (never logged), so the same coverage rule holds
                # (the reference removes commit logs only once covered by
                # snapshot/fileset data — storage/cleanup.go).
                cl = self._commitlogs.get(ns)
                bsz = namespace.opts.block_size_nanos
                if cl is not None:
                    cl.rotate()
                    cl.cleanup(
                        lambda e: (e.time_nanos // bsz) * bsz + bsz
                        <= flush_before_nanos
                    )
                # Snapshots whose every record now lives in a flushed block are
                # covered by filesets; drop them so bootstrap doesn't re-buffer
                # flushed points (storage/cleanup.go snapshot cleanup).
                for shard in namespace.shards:
                    snap = read_latest_snapshot(self.base, ns, shard.id)
                    if snap and all(
                        bs + bsz <= flush_before_nanos and bs in shard._flushed_blocks
                        for _, bs, _, _ in snap
                    ):
                        remove_snapshots(self.base, ns, shard.id)
                # WarmFlush of index blocks (storage/index.go:868): seal + persist
                if namespace.index is not None:
                    namespace.index.persist_before(self.base, ns, flush_before_nanos)
                return out

    def snapshot(self, ns: str) -> int:
        """shard.go:2335 Snapshot: capture every un-flushed buffer stream so
        commit-log replay is bounded. Returns the number of records written.
        All sealed WAL segments become removable afterwards: their entries are
        either in flushed filesets or in this snapshot."""
        with TRACER.span("db.snapshot", namespace=ns):
            with self.lock:
                namespace = self.namespaces[ns]
                total = 0
                for shard in namespace.shards:
                    with shard.lock:  # consistent buffer capture vs writers
                        vol_now = {f.block_start: f.volume for f in shard.filesets()}
                        records = []
                        for sid, buf in shard.series.items():
                            for bs, bucket in buf.buckets.items():
                                stream = bucket.merged_stream()
                                if stream:
                                    records.append(
                                        (sid, bs, stream, vol_now.get(bs, -1))
                                    )
                    if records:
                        write_snapshot(self.base, ns, shard.id, records)
                    else:
                        # nothing buffered: an absent snapshot says the same
                        # thing as an empty one without the file churn
                        remove_snapshots(self.base, ns, shard.id)
                    total += len(records)
                cl = self._commitlogs.get(ns)
                if cl is not None:
                    cl.rotate()
                    cl.remove_inactive()
                return total

    def scrub(self, ns: str | None = None) -> dict:
        """One verify pass over sealed filesets (op_scrub lands here; the
        background Scrubber daemon does its own per-volume walk so it can
        pace to a byte budget): every complete volume
        is digest-verified; mismatched/torn volumes quarantine with full
        cache/pool/index invalidation and the shard falls back to the
        peer/repair machinery. Returns {"scanned","quarantined","bytes"}."""
        totals = {"scanned": 0, "quarantined": 0, "bytes": 0}
        names = [ns] if ns is not None else list(self.namespaces)
        for name in names:
            namespace = self.namespaces[name]
            for shard in namespace.shards:
                r = shard.scrub()
                for k in totals:
                    totals[k] += r[k]
        return totals

    def tick(self, now_nanos: int) -> None:
        """storage/mediator.go tick: expire buffers, filesets, and index
        blocks past retention (including their persisted segment files)."""
        with self.lock:
            for name, ns in list(self.namespaces.items()):
                for shard in ns.shards:
                    shard.tick(now_nanos)
                if ns.index is not None:
                    ns.index.evict_before(
                        now_nanos - ns.opts.retention_nanos, self.base, name
                    )

    # --- bootstrap chain (bootstrap/process.go:147) ---

    def _reindex(self, namespace: Namespace, sid: bytes, t_nanos: int) -> None:
        """Rebuild reverse-index state for a recovered series. Series IDs are
        the canonical tag wire format (utils/serialize.py), so tags are
        recoverable from the ID alone."""
        if namespace.index is not None and is_tag_id(sid):
            try:
                tags = tuple(sorted(decode_tags(sid)))
            except ValueError:
                return
            namespace.index.write(sid, tags, t_nanos)

    def bootstrap(
        self,
        peers_source=None,
        shard_filter: set[int] | None = None,
        now_nanos: int | None = None,
        has_peer_with_shard=None,
    ) -> dict:
        """Run the bootstrapper chain with shard-time-range accounting:
        filesystem → commitlog+snapshot → peers → uninitialized
        (bootstrap/process.go:147). Each source claims the block ranges it
        fulfilled; the remainder passes down the chain.

        - filesystem marks flushed blocks (fileset data reads lazily) and
          re-indexes flushed series;
        - commitlog+snapshot restores buffered streams and replays WAL
          segments — replay never skips entries: a replayed point that also
          exists in a flushed fileset dedupes at read/merge time, whereas
          skipping loses cold writes not yet cold-flushed;
        - peers streams shards with no local provenance from replicas
          (bootstrapper/peers/source.go:117); a single node has none, so
          it claims nothing, and a ``peers_source`` raises (ROADMAP §A10);
        - uninitialized claims what no replica can serve.

        ``shard_filter`` restricts the pass to gained shards on a live node.
        """
        if peers_source is not None:
            raise NotImplementedError(f"peers_source: {_TODO_PEERS}")
        with TRACER.span("db.bootstrap"):
            result = {
                "commitlog_entries": 0,
                "filesets": 0,
                "snapshot_records": 0,
                "quarantined": 0,
                "sources": {},
            }
            for name, ns in list(self.namespaces.items()):
                r = self._bootstrap_namespace(
                    name, ns, shard_filter, now_nanos, result, has_peer_with_shard,
                )
                result["sources"][name] = {
                    "target_blocks": r.target_blocks,
                    "fulfilled": dict(r.fulfilled_by_source),
                    "unfulfilled": r.unfulfilled,
                }
            if shard_filter is None:
                # full (re)start: warm the resident pool from discovered
                # filesets — gained-shard passes skip this (their data
                # arrives through the write path and admits at flush)
                self._readmit_resident()
            self.bootstrapped = True
            return result

    def _readmit_resident(self) -> None:
        """Restart warm-up for the residency mode: admission is a
        flush-time event, so blocks sealed by a PREVIOUS process would
        otherwise never re-admit and every historical query would stream
        forever. Admit discovered filesets NEWEST-first until the pool's
        budget pushes back (recency is the best eviction-order prior we
        have at boot; later flushes keep rotating newer blocks in via
        LRU); read-through re-admission (query/m3_storage.py) pulls back
        anything demand proves hot after that."""
        pool = self.resident_pool
        if pool is None or not pool.enabled:
            return
        work = []
        for ns in self.namespaces.values():
            for shard in ns.shards:
                for fid in shard.filesets():
                    work.append((fid.block_start, shard, fid))
        work.sort(key=lambda t: -t[0])
        for _, shard, fid in work:
            with shard.lock:
                payload = shard._collect_admission_locked([fid])
            for block_start, volume, reader, index, chunk_k in payload:
                items = []
                for sid, (_, _, _, n_chunks) in index.items():
                    stream = reader.stream(sid)
                    if stream:
                        items.append(
                            (sid, stream, n_chunks * chunk_k,
                             reader.admission_side(sid))
                        )
                res = pool.admit_block(
                    shard.namespace, shard.id, block_start, volume, items,
                    chunk_k=chunk_k,
                )
                if res.rejected_budget:
                    return  # budget full: the newest blocks are resident

    def flush_wals(self) -> None:
        """Barrier-fsync every namespace's commit log (write-behind WALs
        ack before fsync; callers needing a durability point use this)."""
        for cl in list(self._commitlogs.values()):
            cl.flush()

    def _bootstrap_namespace(
        self, name: str, ns: Namespace, shard_filter, now_nanos, result,
        has_peer_with_shard=None,
    ):
        bsz = ns.opts.block_size_nanos
        shards = [
            sh for sh in ns.shards if shard_filter is None or sh.id in shard_filter
        ]
        shard_ids = [sh.id for sh in shards]
        by_id = {sh.id: sh for sh in shards}

        # Re-buffering a point that already sits in a flushed fileset would
        # make the next cold_flush rewrite an identical volume, so snapshot
        # records and commitlog entries for flushed blocks are checked
        # against the fileset first (decoded lazily, cached per
        # (shard, block, series)). Points NOT in the fileset are genuine
        # un-flushed cold writes and must replay.
        pts: dict[tuple[int, int, bytes], dict[int, float]] = {}

        def _covered(sh: Shard, sid: bytes, t_nanos: int, value: float) -> bool:
            bs = (t_nanos // bsz) * bsz
            if bs not in sh._flushed_blocks:
                return False
            fid = next((f for f in sh.filesets() if f.block_start == bs), None)
            if fid is None:
                return False
            pk = (sh.id, bs, sid)
            if pk not in pts:
                reader = sh.reader_or_none(fid)
                stream = reader.stream(sid) if reader is not None else None
                pts[pk] = (
                    {dp.timestamp: dp.value for dp in decode(stream)}
                    if stream
                    else {}
                )
            return pts[pk].get(t_nanos) == value

        def _restore(sh: Shard, sid: bytes, t: int, v: float, unit) -> bool:
            if _covered(sh, sid, t, v):
                return False
            try:
                sh.write(sid, t, v, unit)
            except ColdWriteError:
                # pre-crash WAL/snapshot entry in a flushed block of a
                # cold-disabled namespace whose value changed: drop it
                return False
            return True

        # --- chain sources (each claims block ranges it fulfilled) ---

        def fs_source(ns_name: str, remaining: ShardTimeRanges) -> ShardTimeRanges:
            fulfilled = ShardTimeRanges()
            with self.lock:
                persisted: set[int] = set()
                if ns.index is not None:
                    persisted = ns.index.load_persisted(self.base, ns_name)
                for shard in shards:
                    # bootstrap-open verification: digest-check every
                    # discovered volume BEFORE trusting it as provenance.
                    # A corrupt winner quarantines and the re-listing may
                    # surface an older complete volume; blocks left with
                    # no clean volume stay unfulfilled here and fall
                    # through the chain to peers.
                    with shard.lock:
                        while True:
                            fids = shard.filesets()
                            bad = next(
                                (
                                    (fid, problems)
                                    for fid in fids
                                    if (problems := verify_fileset(self.base, fid))
                                ),
                                None,
                            )
                            if bad is None:
                                break
                            shard._quarantine_locked(bad[0], bad[1])
                            result["quarantined"] += 1
                    result["filesets"] += len(fids)
                    for fid in fids:
                        shard._flushed_blocks.add(fid.block_start)
                        fulfilled.add(shard.id, fid.block_start)
                        if fid.block_start in persisted:
                            continue
                        for sid in read_index_ids(self.base, fid):
                            self._reindex(ns, sid, fid.block_start)
            return fulfilled

        def commitlog_snapshot_source(
            ns_name: str, remaining: ShardTimeRanges
        ) -> ShardTimeRanges:
            fulfilled = ShardTimeRanges()
            with self.lock:
                for shard in shards:
                    snap = snapshots.get(shard.id)
                    if not snap:
                        continue
                    vol_now = {f.block_start: f.volume for f in shard.filesets()}
                    for sid, bs, stream, rec_vol in snap:
                        # Ordering vs filesets (the recorded volume is the
                        # arbiter): every warm/cold flush bumps the block's
                        # fileset volume, so a volume that has advanced since
                        # the snapshot means the fileset superseded this
                        # record — restoring it would shadow newer flushed
                        # values (buffer wins on read dedupe). An unchanged
                        # volume means the record is a cold-write overlay
                        # NEWER than the fileset.
                        if vol_now.get(bs, -1) > rec_vol:
                            continue
                        for dp in decode(stream):
                            _restore(shard, sid, dp.timestamp, dp.value, dp.unit)
                        fulfilled.add(shard.id, bs)
                        self._reindex(ns, sid, bs)
                    result["snapshot_records"] += len(snap)
                # The WAL is totally ordered, so for duplicate (sid, t) the
                # LAST entry is the live value (an earlier entry may be a
                # stale overwrite whose newer value now lives only in a
                # fileset — replaying it would shadow the fileset).
                final: dict[tuple[bytes, int], CommitLogEntry] = {}
                replayed = 0
                for e in wal_entries:
                    sh = shard_of[e.series_id]
                    if sh.id not in by_id:
                        continue  # outside this pass's shard filter
                    final[(e.series_id, e.time_nanos)] = e
                    replayed += 1
                for e in final.values():
                    sh = shard_of[e.series_id]
                    fulfilled.add(sh.id, (e.time_nanos // bsz) * bsz)
                    if _covered(sh, e.series_id, e.time_nanos, e.value):
                        continue
                    # value differs from (or is absent in) the fileset: with
                    # last-wins dedupe the only such survivors are post-flush
                    # cold writes, so replay them
                    if _restore(sh, e.series_id, e.time_nanos, e.value, e.unit):
                        self._reindex(ns, e.series_id, e.time_nanos)
                result["commitlog_entries"] += replayed
            return fulfilled

        def peers_src(ns_name: str, remaining: ShardTimeRanges) -> ShardTimeRanges:
            # a single node has no replica to stream from
            return ShardTimeRanges()

        # target = retention window (live operation) ∪ locally discovered
        # blocks (restarts with data older than the window still replay);
        # the WAL and each shard's snapshot are read ONCE here and reused
        # by the commitlog+snapshot source
        now = int(time.time() * NANOS) if now_nanos is None else now_nanos
        target = ShardTimeRanges.for_window(
            shard_ids, now - ns.opts.retention_nanos, now + bsz, bsz
        )
        snapshots: dict[int, list] = {}
        with self.lock:
            wal_entries = CommitLog.replay(self._commitlog_dir(name))
            # replay hashes every entry's sid up to three times across the
            # bootstrap passes: route all UNIQUE sids in one murmur3 call of
            # the host codec library, then the passes dict-lookup
            uniq = list({e.series_id for e in wal_entries})
            shard_of = dict(zip(uniq, (ns.shards[si] for si in
                                       native.shard_batch(uniq, ns.num_shards).tolist())))
            for shard in shards:
                for fid in shard.filesets():
                    target.add(shard.id, fid.block_start)
                snap = read_latest_snapshot(self.base, name, shard.id)
                snapshots[shard.id] = snap or []
                for _, bs, _, _ in snap or ():
                    target.add(shard.id, bs)
            for e in wal_entries:
                sh = shard_of[e.series_id]
                if sh.id in by_id:
                    target.add(sh.id, (e.time_nanos // bsz) * bsz)

        process = BootstrapProcess(
            [
                ("filesystem", fs_source),
                ("commitlog_snapshot", commitlog_snapshot_source),
                ("peers", peers_src),
                # uninitialized claims ranges only when topology says NO
                # replica holds the shard (fresh cluster) — an unreachable
                # replica leaves them unfulfilled so the caller retries
                ("uninitialized", uninitialized_source(has_peer_with_shard)),
            ]
        )
        return process.run(name, target)

    def close(self) -> None:
        with self.lock:
            for cl in list(self._commitlogs.values()):
                cl.close()
