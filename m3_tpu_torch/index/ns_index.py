"""Namespace reverse index: per-block-start index blocks over segments.

Reference: M3's src/dbnode/storage/index.go — nsIndex.WriteBatch
(:531) inserts into the active mutable segment of the write-time block,
Query (:1182) unions matches across blocks overlapping the query range,
AggregateQuery (:1218) returns tag names/values, WarmFlush (:868) seals
mutable segments into immutable ones.

A copy of ``m3_tpu/index/ns_index.py`` over the port's segments and
device tier; ``persist_before`` writes, and ``load_persisted`` reads, the
same files as the reference.
"""

from __future__ import annotations

import os
import re as _re
import struct
import threading
from dataclasses import dataclass

from ..block.core import Tags
from ..utils.blob import read_checked_blob
from .query import Query, execute
from .segment import Document, MutableSegment, SealedSegment

_SEG_MAGIC = 0x6D334958  # "m3IX"
_SEG_FILE_RE = _re.compile(r"^segments-(-?\d+)\.(db|idx)$")


class IndexBlock:
    def __init__(self, block_start: int) -> None:
        self.block_start = block_start
        self.mutable = MutableSegment()
        self.sealed: list[SealedSegment] = []
        # set on insert/seal, cleared once persisted — so flush only rewrites
        # blocks that actually changed
        self.dirty = False

    @property
    def segments(self):
        return ([self.mutable] if len(self.mutable) else []) + self.sealed

    def seal(self) -> None:
        """WarmFlush: mutable → immutable segment (storage/index.go:868)."""
        if len(self.mutable):
            self.sealed.append(self.mutable.seal())
            self.mutable = MutableSegment()
            self.dirty = True


@dataclass
class QueryResult:
    docs: list[Document]
    exhaustive: bool = True


class NamespaceIndex:
    """nsIndex: block-partitioned reverse index."""

    def __init__(self, block_size_nanos: int, retention_nanos: int | None = None,
                 device_store=None) -> None:
        self.block_size = block_size_nanos
        self.retention = retention_nanos
        self.blocks: dict[int, IndexBlock] = {}
        # the index has its own lock (storage/index.go insert queue +
        # RWMutex role); hot write/query paths no longer ride the db lock
        self.lock = threading.RLock()
        # device-resident tier (index/device/): sealed segments admit
        # into device memory at seal time and queries plan onto batched kernels;
        # None keeps the index fully host-side
        self.device_store = device_store
        # computed postings for regexp/field scans over immutable segments
        # (postings_list_cache.go:59)
        from .postings_cache import PostingsListCache

        self.postings_cache = PostingsListCache()

    # ---- device-tier admission (index/device/store.py) ----

    def _admit_segment(self, seg, block_start: int):
        """Wrap + admit one sealed segment into the device store.
        MUST be called with NO index lock held: admission stages and
        uploads device arrays (uploads never stall writers or queries on
        this index). Returns the wrapper, or the
        segment unchanged when there is no device tier."""
        if self.device_store is None or hasattr(seg, "search_ast"):
            return seg
        return self.device_store.admit(
            seg, block_start=block_start, label=f"block:{block_start}"
        )

    def _drop_segments(self, segments) -> None:
        """A segment left the index (compacted away, superseded, or
        expired): release its device tier and its postings-cache
        entries so neither outlives it."""
        for seg in segments:
            if self.device_store is not None:
                self.device_store.invalidate(seg)
            self.postings_cache.invalidate_segment(seg)

    def _block_for(self, t_nanos: int) -> IndexBlock:
        bs = (t_nanos // self.block_size) * self.block_size
        blk = self.blocks.get(bs)
        if blk is None:
            blk = IndexBlock(bs)
            self.blocks[bs] = blk
        return blk

    def write(self, series_id: bytes, tags: Tags, t_nanos: int) -> None:
        with self.lock:
            blk = self._block_for(t_nanos)
            blk.mutable.insert(Document(series_id, tags))
            blk.dirty = True

    def write_batch(self, entries: list[tuple[bytes, Tags, int]]) -> None:
        with self.lock:  # one acquisition for the whole batch
            for sid, tags, t in entries:
                blk = self._block_for(t)
                blk.mutable.insert(Document(sid, tags))
                blk.dirty = True

    def query(
        self, q: Query, start_nanos: int, end_nanos: int, limit: int | None = None,
        force_host: bool = False,
    ) -> QueryResult:
        """storage/index.go:1182 — union across overlapping blocks, dedupe.
        ``force_host`` unwraps device-resident segments so the whole query
        runs on the host executor — the parity surface the tests diff the
        device path against."""
        with self.lock:
            segs = []
            for bs in sorted(self.blocks):
                if bs + self.block_size <= start_nanos or bs >= end_nanos:
                    continue
                segs.extend(self.blocks[bs].segments)
        if force_host:
            segs = [getattr(s, "host", s) for s in segs]
        prematched = None
        if not force_host:
            # cross-segment batched leaf match: >1 device-resident
            # segment in range resolves ALL exact leaves in ONE binary-
            # search launch instead of one per segment (device/batch.py;
            # None when a tier was evicted meanwhile: per-segment launches)
            device_segs = [s for s in segs if getattr(s, "resident", False)]
            if len(device_segs) > 1:
                from .device import batch

                prematched = batch.prematch(device_segs, q)
        docs = execute(segs, q, limit=limit, cache=self.postings_cache,
                       prematched=prematched)
        exhaustive = limit is None or len(docs) < limit
        return QueryResult(docs=docs, exhaustive=exhaustive)

    def aggregate_query(
        self,
        q: Query | None,
        start_nanos: int,
        end_nanos: int,
        field_filter: list[bytes] | None = None,
    ) -> dict[bytes, set[bytes]]:
        """AggregateQuery (:1218): tag names → value sets, optionally only for
        docs matching q."""
        out: dict[bytes, set[bytes]] = {}
        if q is None:
            with self.lock:
                blocks = list(self.blocks.items())
            for bs, blk in blocks:
                if bs + self.block_size <= start_nanos or bs >= end_nanos:
                    continue
                for seg in blk.segments:
                    for name in seg.fields():
                        if field_filter and name not in field_filter:
                            continue
                        out.setdefault(name, set()).update(seg.terms(name))
            return out
        for doc in self.query(q, start_nanos, end_nanos).docs:
            for name, value in doc.fields:
                if field_filter and name not in field_filter:
                    continue
                out.setdefault(name, set()).add(value)
        return out

    def seal_before(self, t_nanos: int, admit: bool = True) -> None:
        """Seal eligible blocks' mutable segments, then admit the new
        immutable segments into the device tier. Admission runs OUTSIDE
        the index lock (uploads must never stall the hot path); the
        wrapper swaps in by identity afterwards, so a concurrent persist
        or eviction that already replaced the segment simply wins.
        ``admit=False`` skips the device tier — persist_before seals
        through here and admits the compacted DiskSegment instead (one
        upload per flush, not two)."""
        sealed_new: list[tuple[IndexBlock, object]] = []
        with self.lock:
            for bs, blk in list(self.blocks.items()):
                if bs + self.block_size <= t_nanos:
                    before = len(blk.sealed)
                    blk.seal()
                    if len(blk.sealed) > before:
                        sealed_new.append((blk, blk.sealed[-1]))
        if self.device_store is None or not admit:
            return
        for blk, seg in sealed_new:
            wrapper = self._admit_segment(seg, blk.block_start)
            if wrapper is seg:
                continue
            with self.lock:
                replaced = False
                # the block itself must still be SERVED (retention
                # expiry pops it from self.blocks without touching its
                # sealed list) — publishing into an orphaned block would
                # pin device budget no query can ever reach
                if self.blocks.get(blk.block_start) is blk:
                    for i, cur in enumerate(blk.sealed):
                        if cur is seg:
                            blk.sealed[i] = wrapper
                            replaced = True
                            break
            if not replaced:
                # the segment is already gone (persist compaction or
                # retention raced us): don't leak its device tier
                self._drop_segments([wrapper])

    def evict_before(
        self, t_nanos: int, base: str | None = None, ns_name: str | None = None
    ) -> None:
        """Drop index blocks entirely before ``t_nanos``; when a segment
        directory is given, also unlink their persisted segment files so
        expired blocks neither survive on disk nor resurrect at bootstrap
        (storage/index.go block expiry + its file cleanup)."""
        dropped_segments = []
        with self.lock:
            for bs in [b for b in self.blocks if b + self.block_size <= t_nanos]:
                blk = self.blocks.pop(bs)
                dropped_segments.extend(blk.sealed)
        # expired segments release their device tier and postings-cache
        # entries immediately (not on eventual LRU churn)
        self._drop_segments(dropped_segments)
        if base is None or ns_name is None:
            return
        d = self._seg_dir(base, ns_name)
        try:
            names = os.listdir(d)
        except FileNotFoundError:
            return
        for n in names:
            m = _SEG_FILE_RE.match(n)
            if m and int(m.group(1)) + self.block_size <= t_nanos:
                try:
                    os.remove(os.path.join(d, n))
                except FileNotFoundError:
                    pass

    # --- persistence (storage/index.go:868 WarmFlush of index blocks +
    # m3ninx/persist segment file sets) ---

    @staticmethod
    def _seg_dir(base: str, ns_name: str) -> str:
        return os.path.join(base, "index", ns_name)

    def persist_before(self, base: str, ns_name: str, t_nanos: int) -> list[str]:
        """Seal blocks entirely before the cutoff; each DIRTY block's
        sealed segments are COMPACTED into one immutable segment
        (builder/multi_segments role) and written in the mmap format
        (disk_segment.py, the fst segment file's role) with an atomic
        replace. The in-memory sealed list is then swapped for the
        zero-copy DiskSegment, so a persisted block's memory cost is page
        cache, not heap. Unchanged blocks are skipped. Returns paths."""
        from .disk_segment import DiskSegment, write_disk_segment
        from .segment import merge_segments

        self.seal_before(t_nanos, admit=False)
        out = []
        d = self._seg_dir(base, ns_name)
        with self.lock:
            blocks = sorted(self.blocks.items())
        for bs, blk in blocks:
            if bs + self.block_size > t_nanos or not blk.sealed:
                continue
            path = os.path.join(d, f"segments-{bs}.idx")
            if not blk.dirty and os.path.exists(path):
                continue
            os.makedirs(d, exist_ok=True)
            seg = (
                blk.sealed[0]
                if len(blk.sealed) == 1
                else merge_segments(blk.sealed)
            )
            write_disk_segment(path, seg)
            # the persisted zero-copy segment replaces the in-memory
            # sealed list; its device tier admits OUTSIDE the index lock
            # (upload staging must not stall writers), then the swap is
            # bookkeeping-only and the replaced segments drop their
            # device tiers + postings-cache entries
            disk = self._admit_segment(DiskSegment(path), bs)
            with self.lock:
                if self.blocks.get(bs) is blk:
                    replaced = blk.sealed
                    blk.sealed = [disk]
                    blk.dirty = False
                else:
                    # retention expired the block mid-persist: the new
                    # segment joins the replaced ones in the drop below
                    replaced = blk.sealed + [disk]
            self._drop_segments(replaced)
            legacy = os.path.join(d, f"segments-{bs}.db")
            if os.path.exists(legacy):
                os.remove(legacy)
            out.append(path)
        return out

    def load_persisted(self, base: str, ns_name: str) -> set[int]:
        """Load persisted index blocks; returns the block starts restored.
        Corrupt files read as absent (the block is then rebuilt from fileset
        IDs by bootstrap)."""
        d = self._seg_dir(base, ns_name)
        try:
            names = os.listdir(d)
        except FileNotFoundError:
            return set()
        # one file per block; the mmap format wins over a legacy leftover
        chosen: dict[int, tuple[str, str]] = {}
        for n in sorted(names):
            m = _SEG_FILE_RE.match(n)
            if not m:
                continue
            bs, kind = int(m.group(1)), m.group(2)
            if bs not in chosen or kind == "idx":
                chosen[bs] = (kind, n)
        loaded: set[int] = set()
        for bs, (kind, n) in sorted(chosen.items()):
            if kind == "idx":
                # mmap format: open is O(1), nothing deserialized
                from .disk_segment import DiskSegment

                try:
                    segs = [DiskSegment(os.path.join(d, n))]
                except (ValueError, OSError):
                    continue
            else:  # legacy in-memory blob format
                body = read_checked_blob(os.path.join(d, n), _SEG_MAGIC)
                if body is None:
                    continue
                try:
                    (count,) = struct.unpack_from("<I", body, 0)
                    pos = 4
                    segs = []
                    for _ in range(count):
                        (ln,) = struct.unpack_from("<Q", body, pos)
                        pos += 8
                        segs.append(SealedSegment.deserialize(body[pos : pos + ln]))
                        pos += ln
                except (struct.error, ValueError):
                    continue
            blk = self._block_for(bs)
            # bootstrap re-admission: restored segments go device-resident
            # like freshly sealed ones (no lock is contended at bootstrap,
            # and admission takes none of ours)
            blk.sealed = [self._admit_segment(s, bs) for s in segs]
            blk.dirty = False
            loaded.add(bs)
        return loaded
