"""Per-series in-memory buffer: block-windowed encoders with warm/cold writes.

A copy of ``m3_tpu/storage/series.py``. A bucket's merged stream is
encoded by the host codec library (``native.encode_one``, the bytes of
``codec/m3tsz.py``'s encoder) and decoded through ``codec/native_read.py``,
as in the reference.

Reference: M3's src/dbnode/storage/series/ — dbSeries.Write
(series.go:289) routes datapoints into dbBuffer buckets per block window
(buffer.go:250); the warm/cold decision (:268-313) classifies writes inside
the buffer-past/buffer-future window as warm, everything else as cold
(out-of-order, flushed separately). Tick merges bucket encoders
(buffer.go:413-478).
"""

from __future__ import annotations

from dataclasses import dataclass, field

from .. import native
from ..codec.m3tsz import Datapoint, decode
from ..utils.xtime import Unit

NANOS = 1_000_000_000


@dataclass
class BufferBucket:
    """One RAW-COLUMN buffer per block window — buffer.go buckets.

    The reference buckets hold incremental encoders; here the hot write
    path is an O(1) column append (the per-point Python m3tsz encode cost
    ~25µs capped node ingest at ~25k writes/s/core), and the canonical
    m3tsz stream is produced lazily, only when a reader or flush actually
    needs it, then cached until the next write. Merge semantics are unchanged: time-sorted, later write
    wins on duplicate timestamps (buffer.go:413-478)."""

    block_start: int
    times: list = field(default_factory=list)
    values: list = field(default_factory=list)
    units: list = field(default_factory=list)
    last_write_nanos: int = -1
    num_writes: int = 0
    _stream_cache: bytes | None = None
    # memoized decode of the merged stream: None = not computed,
    # False = annotated (arrays can't represent it), tuple = arrays
    _arrays_cache: "tuple | bool | None" = None

    def write(self, t_nanos: int, value: float, unit: Unit) -> None:
        self.times.append(t_nanos)
        self.values.append(value)
        self.units.append(int(unit))
        self.last_write_nanos = max(self.last_write_nanos, t_nanos)
        self.num_writes += 1
        self._stream_cache = None
        self._arrays_cache = None

    def merged_points(self):
        """(times, values, units) time-sorted, later-write-wins — the
        canonical point set, no codec round trip."""
        import numpy as np

        t = np.asarray(self.times, np.int64)
        order = np.argsort(t, kind="stable")
        ts = t[order]
        keep = np.empty(len(ts), bool)
        if len(ts):
            keep[:-1] = ts[1:] != ts[:-1]
            keep[-1] = True
        idx = order[keep]
        v = np.asarray(self.values, np.float64)[idx]
        u = np.asarray(self.units, np.int32)[idx]
        return t[idx], v, u

    def merged_stream(self) -> bytes:
        """Canonical m3tsz stream of the merged point set (the reference's
        bucket merge output), encoded by the host codec library."""
        if self._stream_cache is not None:
            return self._stream_cache
        if not self.times:
            return b""
        t, v, u = self.merged_points()
        stream = native.encode_one(t, v, u)
        self._stream_cache = stream
        return stream

    def merged_arrays(self):
        """Decoded (times, values, units) arrays of the canonical merged
        stream, memoized until the next write — the buffered-data analog
        of the decoded-block cache (repeated reads of an unsealed block
        skip the re-decode, not just the re-encode). Decoding the STREAM
        (not the raw columns) keeps codec-roundtrip parity: the codec
        truncates timestamps to the time unit. Returns None for annotated
        streams (memoized as False so the probe isn't repeated — the
        caller's iterator fallback owns those)."""
        if self._arrays_cache is None:
            from ..codec.native_read import decode_stream_arrays

            arrs = decode_stream_arrays(self.merged_stream())
            self._arrays_cache = arrs if arrs is not None else False
        return self._arrays_cache or None


class SeriesBuffer:
    """dbSeries + dbBuffer: buckets keyed by block start."""

    def __init__(self, series_id: bytes, block_size_nanos: int) -> None:
        self.id = series_id
        self.block_size = block_size_nanos
        self.buckets: dict[int, BufferBucket] = {}

    def block_start(self, t_nanos: int) -> int:
        return (t_nanos // self.block_size) * self.block_size

    def write(self, t_nanos: int, value: float, unit: Unit = Unit.SECOND) -> None:
        bs = self.block_start(t_nanos)
        bucket = self.buckets.get(bs)
        if bucket is None:
            bucket = BufferBucket(block_start=bs)
            self.buckets[bs] = bucket
        bucket.write(t_nanos, value, unit)

    def read(self, start_nanos: int, end_nanos: int) -> list[Datapoint]:
        out: list[Datapoint] = []
        for bs in sorted(self.buckets):
            if bs + self.block_size <= start_nanos or bs >= end_nanos:
                continue
            stream = self.buckets[bs].merged_stream()
            for dp in decode(stream):
                if start_nanos <= dp.timestamp < end_nanos:
                    out.append(dp)
        return out

    def streams(self, start_nanos: int, end_nanos: int) -> list[bytes]:
        """Merged per-bucket encoded streams overlapping [start, end),
        oldest block first (dbBuffer.ReadEncoded, buffer.go:633)."""
        out = []
        for bs in sorted(self.buckets):
            if bs + self.block_size <= start_nanos or bs >= end_nanos:
                continue
            stream = self.buckets[bs].merged_stream()
            if stream:
                out.append(stream)
        return out

    def has_points(self, start_nanos: int, end_nanos: int) -> bool:
        """True when any buffered bucket overlapping [start, end) holds
        datapoints — the resident-scan router's buffer-overlay check: live
        buffer data overlays sealed blocks at read time, so a scan served
        purely from residency would miss it and must fall back."""
        for bs, bucket in self.buckets.items():
            if bs + self.block_size <= start_nanos or bs >= end_nanos:
                continue
            if bucket.times:
                return True
        return False

    def streams_before(self, flush_before_nanos: int) -> dict[int, bytes]:
        """Canonical merged streams for blocks entirely before the cutoff
        (WarmFlush input, shard.go:2146)."""
        return {
            bs: b.merged_stream()
            for bs, b in self.buckets.items()
            if bs + self.block_size <= flush_before_nanos
        }

    def evict_before(self, t_nanos: int) -> list[int]:
        """Drop buckets entirely before the cutoff; returns the removed
        block starts so the shard's buffered-block summary can decrement
        exactly what disappeared."""
        removed = [b for b in self.buckets if b + self.block_size <= t_nanos]
        for bs in removed:
            del self.buckets[bs]
        return removed

    def evict_block(self, block_start: int) -> bool:
        """Drop one bucket; True iff it existed (summary bookkeeping)."""
        return self.buckets.pop(block_start, None) is not None
