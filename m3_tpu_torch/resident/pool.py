"""Device-resident compressed series store: a paged M3TSZ pool on the card.

Port of ``m3_tpu/resident/pool.py``. Sealed blocks' compressed M3TSZ
bytes stay resident in device memory and scans decode straight from it:

- ONE page buffer ``int32[num_pages, page_words]`` (u32 bit patterns,
  big-endian words of the stream) under a byte budget. Page 0 is reserved
  and always zero: plans pad short lanes with it, so a gathered lane's
  window is bit-identical to the host packer's zero padding.
- SIDE PLANES: a second buffer ``int32[num_side_pages, side_page_chunks,
  SIDE_WORDS]`` holding every resident lane's per-chunk decoder state in
  the packed 10-word layout of ``ops/sideplane.py``. Side page 0 is
  reserved and zero too (padding chunk slots unpack to done lanes).
- a HOST page table ``BlockKey -> ResidentEntry(pages, side_pages, ...)``:
  a plan hands the device gathers O(series) small int vectors; the chunk
  metadata never leaves the card after admission.

Admission uploads a batch of streams with one host-to-device copy per
buffer and writes it with ``index_copy_``. When no read lease is active
the copy writes the live buffers in place (new leases wait on the fence
meanwhile); under an active lease it writes a ``clone()``, so the lease
holder's snapshot stays bit-stable, and the clone is published after.
``inplace_admissions`` / ``copy_admissions`` count which path ran.
Eviction is LRU under the byte budget, plus explicit invalidation.

Left out: born-resident admission from the device encoder
(``admit_block_device``, with the write-path slice, ROADMAP §A.4), the
storage layer's read-through re-admission and its markers (with the
``Database`` wiring, ROADMAP §A.4), and the native batch prescan (the
port prescans with ``ops/chunked.snapshot_stream``).
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from .. import resolve_device
from ..cache.block_cache import BlockKey
from ..ops.sideplane import SIDE_WORDS as N_SIDE_PLANES
from ..ops.sideplane import pack_side_rows
from ..utils.config import ConfigError
from ..utils.instrument import DEFAULT as METRICS
from .heat import ShardHeat

# records per chunk of a fileset's side table (m3_tpu/storage/fs.py:36)
CHUNK_K = 32


class ResidentPoolError(ValueError):
    """Corrupt page-table state: raised, never read out of bounds."""


@dataclass
class ResidentOptions:
    """Knobs of the paged store.

    ``max_bytes`` budgets the page buffer (0 disables the pool);
    ``page_words`` is the page size in u32 words (512 = 2 KiB: a 720-point
    block fits in one or two pages); ``max_lane_pages`` caps one lane's
    page span; ``side_bytes`` budgets the side planes (0 = same as
    ``max_bytes``); ``side_page_chunks`` is the side-page size in chunks."""

    enabled: bool = True
    max_bytes: int = 0
    page_words: int = 512
    max_lane_pages: int = 64
    side_bytes: int = 0  # 0 = derive from max_bytes
    side_page_chunks: int = 16
    namespaces: list = field(default_factory=list)

    def validate(self) -> None:
        if self.max_bytes < 0:
            raise ConfigError("resident.max_bytes must be >= 0")
        if self.page_words <= 0:
            raise ConfigError("resident.page_words must be > 0")
        if self.max_lane_pages <= 0:
            raise ConfigError("resident.max_lane_pages must be > 0")
        if self.side_bytes < 0:
            raise ConfigError("resident.side_bytes must be >= 0")
        if self.side_page_chunks <= 0:
            raise ConfigError("resident.side_page_chunks must be > 0")
        # page 0 is reserved in both buffers: a positive budget under two
        # pages would disable the pool silently
        if 0 < self.max_bytes < 2 * self.page_bytes:
            raise ConfigError(
                f"resident.max_bytes {self.max_bytes} is under two pages "
                f"({2 * self.page_bytes}B) — 0 disables the pool explicitly"
            )
        if 0 < self.side_bytes < 2 * self.side_page_bytes:
            raise ConfigError(
                f"resident.side_bytes {self.side_bytes} is under two side "
                f"pages ({2 * self.side_page_bytes}B) — 0 derives from max_bytes"
            )

    @property
    def page_bytes(self) -> int:
        return self.page_words * 4

    @property
    def num_pages(self) -> int:
        return self.max_bytes // self.page_bytes  # page 0 included

    @property
    def side_page_bytes(self) -> int:
        return self.side_page_chunks * N_SIDE_PLANES * 4

    @property
    def num_side_pages(self) -> int:
        return (self.side_bytes or self.max_bytes) // self.side_page_bytes


class ResidentEntry(NamedTuple):
    """Page-table row of one resident (series, block, volume) lane."""

    pages: tuple  # page indices, stream order
    num_bits: int  # valid bits of the stream
    nbytes: int  # stream length in bytes
    side_pages: tuple = ()  # side-page indices, chunk order
    n_chunks: int = 0  # chunks in the side table (0 = no side planes)
    chunk_k: int = 0  # records per chunk of the side table
    max_span_bits: int = 0  # widest chunk span (window sizing)


class AdmitResult(NamedTuple):
    admitted: int
    rejected_span: int  # lanes over the max_lane_pages span limit
    rejected_budget: int  # lanes that did not fit even after eviction
    complete: bool  # every non-empty stream of the group is now resident


class ResidentChunkedPlan(NamedTuple):
    """Device gather inputs of a chunk-parallel scan (``plan_chunked``):
    the buffers plus O(series) host int vectors."""

    words: torch.Tensor  # int32[num_pages, page_words]
    side: torch.Tensor  # int32[num_side_pages, spc, SIDE_WORDS]
    page_rows: np.ndarray  # int32[S, LP] incl. trailing zero-page columns
    side_rows: np.ndarray  # int32[S, SL] side-page index per slot
    n_chunks: np.ndarray  # int32[S]
    total_bits: np.ndarray  # int32[S]
    block_hi: np.ndarray  # uint32[S] block_start >> 32 (side-plane re-base)
    block_lo: np.ndarray  # uint32[S] block_start & 0xFFFFFFFF
    chunk_k: int  # records per chunk (uniform across the plan)
    num_chunks: int  # C = max chunks per series
    window_words: int  # CW (ops/chunked.window_words over the max span)
    page_words: int
    side_page_chunks: int


class ResidentPool:
    """Paged device pool of sealed blocks' compressed streams and their
    chunk side planes, on ``device``."""

    def __init__(self, options: ResidentOptions | None = None, registry=None,
                 device="cuda") -> None:
        self.options = options or ResidentOptions()
        self.device = resolve_device(device)
        self._lock = threading.Lock()
        # serializes admissions; held across staging + upload so the table
        # lock never is
        self._upload_lock = threading.Lock()
        self._od: "OrderedDict[BlockKey, ResidentEntry]" = OrderedDict()
        # admitted but not yet uploaded: invisible to readers until the
        # upload completes, unless an invalidation drops them meanwhile
        self._pending: dict[BlockKey, ResidentEntry] = {}
        self._by_series: dict[tuple, set] = {}
        self._by_block: dict[tuple, set] = {}
        # (namespace, shard, block_start, volume) groups whose every
        # non-empty stream is resident
        self._complete: set[tuple] = set()
        # bumps on _reset_locked so an in-flight admission knows its pages
        # were reclaimed
        self._generation = 0
        self._free: list[int] = list(range(self.options.num_pages - 1, 0, -1))
        self._free_side: list[int] = list(range(self.options.num_side_pages - 1, 0, -1))
        self._words = None  # int32[num_pages, page_words], lazy
        self._side = None  # int32[side_pages, spc, SIDE_WORDS], lazy
        self._resident_bytes = 0
        # scan/admit fence: scans hold a read lease across plan + decode;
        # an admission writes in place only when no lease is active
        self._leases = 0
        self._donating = False
        self._fence = threading.Condition(self._lock)
        self.epoch = 0  # bumps on every buffer publish
        self.admissions = 0
        self.rejections = 0
        self.evictions = 0
        self.invalidations = 0
        self.upload_bytes = 0
        self.inplace_admissions = 0
        self.copy_admissions = 0
        self.side_pack_overflows = 0
        self.rebalance_evictions = 0
        reg = registry or METRICS
        self._m_admissions = reg.counter("resident_admissions_total",
                                         "blocks admitted to the resident pool")
        self._m_rejections = reg.counter("resident_rejections_total",
                                         "blocks rejected at admission")
        self._m_evictions = reg.counter("resident_evictions_total",
                                        "LRU/budget evictions from the pool")
        self._m_invalidations = reg.counter("resident_invalidations_total",
                                            "entries dropped by invalidation hooks")
        self._m_upload = reg.counter(
            "resident_upload_bytes_total",
            "host->device block bytes uploaded at admission (warm resident "
            "scans move ZERO such bytes)",
        )
        self._m_inplace = reg.counter("resident_inplace_admissions_total",
                                      "admissions written into the live buffers")
        self._m_copy = reg.counter("resident_copy_admissions_total",
                                   "admissions written into a copy because a scan lease was active")
        self._m_rebalance_evictions = reg.counter(
            "resident_rebalance_evictions_total",
            "entries evicted by the heat-driven budget rebalance")
        self._m_side_overflow = reg.counter(
            "resident_side_pack_overflows_total",
            "lanes admitted WITHOUT side planes because a chunk snapshot "
            "overflowed the packed 10-word layout")
        self._g_bytes = reg.gauge("resident_pool_bytes", "compressed bytes resident")
        self._g_pages = reg.gauge("resident_pool_pages", "pages in use (excl. zero page)")
        self._g_free = reg.gauge("resident_pool_free_pages", "pages on the free list")
        self._g_entries = reg.gauge("resident_pool_entries", "page-table entries")
        self._g_side_pages = reg.gauge("resident_side_pages",
                                       "side-plane pages in use (excl. zero page)")
        self._g_occupancy = reg.gauge("resident_pool_occupancy_ratio",
                                      "pages in use / pages total")
        self.heat = ShardHeat(registry=reg)

    # ---------- device buffers ----------

    @property
    def enabled(self) -> bool:
        o = self.options
        return o.enabled and o.num_pages > 1 and o.num_side_pages > 1

    def _ensure_words(self) -> torch.Tensor:
        """Allocate the page buffer on first admission."""
        if self._words is None:
            o = self.options
            self._words = torch.zeros((o.num_pages, o.page_words), dtype=torch.int32,
                                      device=self.device)
        return self._words

    def _ensure_side(self) -> torch.Tensor:
        if self._side is None:
            o = self.options
            self._side = torch.zeros((o.num_side_pages, o.side_page_chunks, N_SIDE_PLANES),
                                     dtype=torch.int32, device=self.device)
        return self._side

    def device_bytes(self) -> int:
        """Bytes the two buffers hold on the device now (0 before the first
        admission; never forces the allocation)."""
        with self._lock:
            n = self._words.nbytes if self._words is not None else 0
            return n + (self._side.nbytes if self._side is not None else 0)

    # ---------- scan/admit fencing ----------

    @contextmanager
    def read_lease(self):
        """Scan-side fence: while a lease is held, admissions write into a
        copy so the holder's buffer snapshots stay valid; while an in-place
        write is in flight, new leases wait, so they see the old epoch or
        the fully published one. On the card a lease covers enqueueing the
        scan: an in-place write enqueued on the same stream after the
        lease is released runs after the scan's kernels."""
        with self._lock:
            while self._donating:
                self._fence.wait()
            self._leases += 1
        try:
            yield self
        finally:
            with self._lock:
                self._leases -= 1
                if self._leases == 0:
                    self._fence.notify_all()

    # ---------- admission ----------

    def admit_block(self, namespace: str, shard_id: int, block_start: int, volume: int,
                    items: list, chunk_k: int = CHUNK_K) -> AdmitResult:
        """Admit one sealed block's streams in one batched upload.

        ``items``: ``[(series_id, stream_bytes, num_points_bound)]`` or
        ``[(series_id, stream_bytes, num_points_bound, side_snaps)]``;
        empty streams are skipped. Without ``side_snaps`` (snapshot dicts of
        ``ops/chunked.snapshot_stream``) the chunk prescan runs here. A lane
        whose snapshots overflow the packed layout is admitted without side
        planes (counted). Items that pass the same snapshot list share one
        packing.

        Three phases, so the table lock is held only for bookkeeping:
        1. under the table lock: allocate data and side pages (evicting LRU
           entries as needed) and park the new entries as pending;
        2. without it: stage the pages and upload them (in place when no
           lease is active, into a copy otherwise);
        3. under the table lock: publish the surviving pending entries (an
           invalidation that raced the upload drops its entry instead).
        """
        if not self.enabled:
            return AdmitResult(0, 0, 0, False)
        o = self.options
        if o.namespaces and namespace not in o.namespaces:
            return AdmitResult(0, 0, 0, False)
        page_bytes = o.page_bytes
        spc = o.side_page_chunks
        norm = [(it[0], it[1], it[2], it[3] if len(it) > 3 else None) for it in items]
        missing = [i for i, it in enumerate(norm) if it[3] is None and it[1]]
        if missing:
            snaps_all = self._prescan([norm[i][1] for i in missing], chunk_k)
            for i, snaps in zip(missing, snaps_all):
                norm[i] = norm[i][:3] + (snaps,)
        packed_rows: dict[int, tuple] = {}  # id(snaps) -> (rows, n_chunks, max_span)
        plan: list[tuple] = []
        rejected_span = 0
        side_overflows = 0
        for sid, stream, _num_points, snaps in norm:
            if not stream:
                continue
            n_pages = -(-len(stream) // page_bytes)
            if n_pages > o.max_lane_pages:
                rejected_span += 1
                continue
            # keyed by the identity of the item's own list, alive in `norm`
            packed = packed_rows.get(id(snaps))
            if packed is None:
                rows = pack_side_rows(snaps, block_start) if snaps else None
                if snaps and rows is None:
                    # a chunk overflows the packed layout: the lane is
                    # admitted without side planes (all or nothing), counted
                    packed = (None, 0, 0, 1)
                else:
                    packed = (rows, len(snaps or ()),
                              max((p["span"] for p in snaps or ()), default=0), 0)
                packed_rows[id(snaps)] = packed
            rows, n_chunks, max_span, overflow = packed
            side_overflows += overflow
            n_side = -(-n_chunks // spc) if n_chunks else 0
            key = BlockKey(namespace, shard_id, bytes(sid), block_start, volume)
            plan.append((key, bytes(stream), n_pages, n_side, rows, n_chunks, max_span))
        if side_overflows:
            self.side_pack_overflows += side_overflows
            self._m_side_overflow.inc(side_overflows)
        rejected_budget = 0
        admitted = 0
        batch_entries: list[tuple] = []
        with self._upload_lock:
            with self._lock:
                for key, stream, n_pages, n_side, rows, n_chunks, max_span in plan:
                    alloc = self._alloc_locked(n_pages, n_side)
                    if alloc is None:
                        rejected_budget += 1
                        continue
                    pages, side_pages = alloc
                    old = self._od.pop(key, None)
                    if old is not None:
                        self._unindex_locked(key, old)
                        self._free.extend(old.pages)
                        self._free_side.extend(old.side_pages)
                        self._resident_bytes -= old.nbytes
                    entry = ResidentEntry(
                        pages=tuple(pages), num_bits=len(stream) * 8, nbytes=len(stream),
                        side_pages=tuple(side_pages), n_chunks=n_chunks,
                        chunk_k=chunk_k if n_chunks else 0, max_span_bits=max_span,
                    )
                    self._pending[key] = entry
                    admitted += 1
                    batch_entries.append((key, entry, stream, rows))
            # ---- no table lock: stage + upload ----
            # pending pages are off the free lists (never evicted), so each
            # staged page has one owner and the scatter's indices are unique
            staged_keys: set = set()
            with self._lock:
                generation = self._generation
            try:
                if batch_entries:
                    with self._lock:
                        survivors = [t for t in batch_entries if self._pending.get(t[0]) is t[1]]
                    staged_keys = {t[0] for t in survivors}
                    words, idx, side, side_idx = self._stage(survivors)
                    if len(idx) or len(side_idx):
                        self._upload(words, idx, side, side_idx)
            except BaseException:
                # nothing was published: reclaim this batch's pages (unless a
                # failed in-place write already reset the whole pool)
                with self._lock:
                    if self._generation == generation:
                        for key, entry, _stream, _rows in batch_entries:
                            if self._pending.get(key) is entry:
                                del self._pending[key]
                            self._free.extend(entry.pages)
                            self._free_side.extend(entry.side_pages)
                        self._publish_locked()
                raise
            # ---- publish ----
            with self._lock:
                published = 0
                for key, entry, _stream, _rows in batch_entries:
                    present = self._pending.get(key) is entry
                    if present:
                        del self._pending[key]
                    if present and key in staged_keys:
                        published += 1
                        self._od[key] = entry
                        self._index_locked(key)
                        self._resident_bytes += entry.nbytes
                    else:
                        # invalidated mid-upload: never published; the pages
                        # belong to this batch, so they are reclaimed here
                        self._free.extend(entry.pages)
                        self._free_side.extend(entry.side_pages)
                complete = (
                    admitted > 0 and rejected_span == 0 and rejected_budget == 0
                    and published == len(plan)
                )
                if complete:
                    self._complete.add((namespace, shard_id, block_start, volume))
                self.admissions += admitted
                self.rejections += rejected_span + rejected_budget
                self._m_admissions.inc(admitted)
                if rejected_span + rejected_budget:
                    self._m_rejections.inc(rejected_span + rejected_budget)
                self._publish_locked()
        return AdmitResult(admitted, rejected_span, rejected_budget, complete)

    def admit_block_device(self, *args, **kwargs) -> AdmitResult:
        """Born-resident admission of pages encoded on the device: waits for
        the write-path slice (ROADMAP §A.4, device encode at seal)."""
        raise NotImplementedError(
            "admit_block_device waits for the port's write path (ROADMAP §A.4)"
        )

    @staticmethod
    def _prescan(streams: list, chunk_k: int) -> list:
        from ..ops.chunked import snapshot_stream

        return [snapshot_stream(s, chunk_k) for s in streams]

    def _stage(self, survivors: list):
        """Host staging of a batch: (pages u32[P, page_words], their page
        indices, side pages u32[Q, spc, SIDE_WORDS], their indices). Each
        stream's bytes are zero-padded to its pages and read as big-endian
        words; each lane's side rows are zero-padded to its side pages
        (padding per distinct rows array, shared by the lanes that pass
        it)."""
        o = self.options
        spc = o.side_page_chunks
        parts: list[bytes] = []
        idx: list[int] = []
        side_parts: list[np.ndarray] = []
        side_idx: list[int] = []
        padded_side: dict[int, np.ndarray] = {}
        for _key, entry, stream, rows in survivors:
            idx.extend(entry.pages)
            parts.append(stream)
            parts.append(bytes(len(entry.pages) * o.page_bytes - len(stream)))
            if rows is not None and len(rows):
                page = padded_side.get(id(rows))
                if page is None:
                    page = np.zeros((len(entry.side_pages) * spc, N_SIDE_PLANES), np.uint32)
                    page[: len(rows)] = rows
                    padded_side[id(rows)] = page
                side_parts.append(page)
                side_idx.extend(entry.side_pages)
        words = np.frombuffer(b"".join(parts), ">u4").astype(np.uint32).reshape(-1, o.page_words)
        side = (np.concatenate(side_parts).reshape(-1, spc, N_SIDE_PLANES) if side_parts
                else np.zeros((0, spc, N_SIDE_PLANES), np.uint32))
        return words, np.asarray(idx, np.int64), side, np.asarray(side_idx, np.int64)

    def _upload(self, words: np.ndarray, idx: np.ndarray, side: np.ndarray,
                side_idx: np.ndarray) -> None:
        """One host-to-device copy + ``index_copy_`` per buffer. Runs
        without the table lock (serialized by the upload lock) and
        publishes the buffers itself, under the lock acquisition that lifts
        the fence, so a lease woken by the fence sees them.

        With no lease active the live buffers are written in place and new
        leases wait meanwhile; with one active the write goes to a clone.
        If an in-place write fails, every entry may point at half-written
        pages: the pool resets (table dropped, buffers re-zeroed lazily)."""
        with self._lock:
            cur_words = self._ensure_words()
            cur_side = self._ensure_side()
            inplace = self._leases == 0
            if inplace:
                self._donating = True
        try:
            new_words = new_side = None
            if len(idx):
                self.upload_bytes += words.nbytes
                self._m_upload.inc(words.nbytes)
                new_words = _scatter(cur_words, idx, words, inplace)
            if len(side_idx):
                # side rows cross the bus like the data pages: counted, so
                # the zero-transfer contract also sees side re-uploads
                self.upload_bytes += side.nbytes
                self._m_upload.inc(side.nbytes)
                new_side = _scatter(cur_side, side_idx, side, inplace)
        except BaseException:
            with self._lock:
                if inplace:
                    self._reset_locked()
                    self._donating = False
                    self._fence.notify_all()
            raise
        with self._lock:
            if new_words is not None:
                self._words = new_words
            if new_side is not None:
                self._side = new_side
            if new_words is not None or new_side is not None:
                self.epoch += 1
            if inplace:
                self._donating = False
                self._fence.notify_all()
        if inplace:
            self.inplace_admissions += 1
            self._m_inplace.inc()
        else:
            self.copy_admissions += 1
            self._m_copy.inc()

    def _alloc_locked(self, n_pages: int, n_side: int):
        """Pop pages from both free lists, LRU-evicting until they fit (the
        reserved zero pages are never on the free lists). Returns (pages,
        side_pages) or None."""
        while len(self._free) < n_pages or len(self._free_side) < n_side:
            if not self._evict_one_locked():
                return None
        return (
            [self._free.pop() for _ in range(n_pages)],
            [self._free_side.pop() for _ in range(n_side)],
        )

    def _evict_one_locked(self) -> bool:
        if not self._od:
            return False
        key, entry = self._od.popitem(last=False)
        self._unindex_locked(key, entry)
        self._free.extend(entry.pages)
        self._free_side.extend(entry.side_pages)
        self._resident_bytes -= entry.nbytes
        self.evictions += 1
        self._m_evictions.inc()
        return True

    # ---------- lookup / scan planning ----------

    def get(self, key: BlockKey) -> ResidentEntry | None:
        with self._lock:
            entry = self._od.get(key)
            if entry is not None:
                self._od.move_to_end(key)
            return entry

    def is_complete(self, namespace: str, shard_id: int, block_start: int, volume: int) -> bool:
        with self._lock:
            return (namespace, shard_id, block_start, volume) in self._complete

    def __contains__(self, key: BlockKey) -> bool:
        with self._lock:
            return key in self._od

    def __len__(self) -> int:
        return len(self._od)

    def _entries_locked(self, keys: list):
        entries = []
        od = self._od
        for key in keys:
            e = od.get(key)
            if e is None:
                return None
            od.move_to_end(key)
            entries.append(e)
        return entries

    def _check_entries(self, n_pages, pages, num_bits, n_side, side_pages, n_chunks) -> None:
        """Raise on corrupt page-table rows (flattened over the plan's
        entries) instead of gathering out of bounds or wrapping."""
        o = self.options
        if (n_pages > o.max_lane_pages).any():
            raise ResidentPoolError(
                f"page table entry spans {int(n_pages.max())} pages > limit {o.max_lane_pages}"
            )
        short = n_pages * (o.page_words * 32) < num_bits
        if short.any():
            i = int(np.argmax(short))
            raise ResidentPoolError(
                f"page table entry holds {int(num_bits[i])} bits in {int(n_pages[i])} pages "
                f"of {o.page_words * 32} bits"
            )
        bad = (pages <= 0) | (pages >= o.num_pages)
        if bad.any():
            raise ResidentPoolError(
                f"corrupt page index {int(pages[np.argmax(bad)])} (pool has {o.num_pages} pages)"
            )
        bad = (side_pages <= 0) | (side_pages >= o.num_side_pages)
        if bad.any():
            raise ResidentPoolError(
                f"corrupt side page index {int(side_pages[np.argmax(bad)])} "
                f"(pool has {o.num_side_pages} side pages)"
            )
        over = n_chunks > n_side * o.side_page_chunks
        if over.any():
            i = int(np.argmax(over))
            raise ResidentPoolError(
                f"side table holds {int(n_chunks[i])} chunks in {int(n_side[i])} side pages"
            )

    def plan_chunked(self, keys: list) -> ResidentChunkedPlan | None:
        """The chunk-parallel gather inputs for ``keys``: page rows, side-page
        rows and per-series chunk counts — everything the device lane
        assembly (``parallel/scan.assemble_resident_*``) needs, as O(series)
        host ints. None when a key is not resident, lacks side planes, or
        the entries mix chunk sizes. Callers hold ``read_lease()`` across
        plan and use."""
        from ..ops.chunked import window_words

        o = self.options
        with self._lock:
            if not self.enabled or self._words is None or self._side is None:
                return None
            entries = self._entries_locked(keys)
            if entries is None:
                return None
            words, side = self._words, self._side
        s = len(entries)
        if s == 0:
            return None
        col = lambda f: np.fromiter((f(e) for e in entries), np.int64, count=s)
        n_pages = col(lambda e: len(e.pages))
        n_side = col(lambda e: len(e.side_pages))
        n_chunks = col(lambda e: e.n_chunks)
        num_bits = col(lambda e: e.num_bits)
        pages = np.fromiter(itertools.chain.from_iterable(e.pages for e in entries), np.int64,
                            count=int(n_pages.sum()))
        side_pages = np.fromiter(itertools.chain.from_iterable(e.side_pages for e in entries),
                                 np.int64, count=int(n_side.sum()))
        self._check_entries(n_pages, pages, num_bits, n_side, side_pages, n_chunks)
        if (n_chunks <= 0).any() or (n_side == 0).any():
            return None  # admitted without side planes
        chunk_k = col(lambda e: e.chunk_k)
        k = int(chunk_k[0])
        if k <= 0 or (chunk_k != k).any():
            return None  # mixed chunk sizes: shapes would disagree
        c = int(n_chunks.max())
        cw = window_words(max(e.max_span_bits for e in entries))
        # trailing zero-page columns: a window starting in the last stream
        # word reads its full cw span + alignment from zeros
        extra = -(-cw // o.page_words) + 1
        lp = int(n_pages.max()) + extra
        sl = int(n_side.max())

        def rows(flat, counts, width):
            out = np.zeros((s, width), np.int32)
            r = np.repeat(np.arange(s), counts)
            starts = np.cumsum(counts) - counts
            out[r, np.arange(flat.size) - np.repeat(starts, counts)] = flat
            return out

        block = np.fromiter((int(key.block_start) & ((1 << 64) - 1) for key in keys),
                            np.uint64, count=s)
        return ResidentChunkedPlan(
            words=words,
            side=side,
            page_rows=rows(pages, n_pages, lp),
            side_rows=rows(side_pages, n_side, sl),
            n_chunks=n_chunks.astype(np.int32),
            total_bits=num_bits.astype(np.int32),
            block_hi=(block >> np.uint64(32)).astype(np.uint32),
            block_lo=(block & np.uint64(0xFFFFFFFF)).astype(np.uint32),
            chunk_k=k,
            num_chunks=c,
            window_words=cw,
            page_words=o.page_words,
            side_page_chunks=o.side_page_chunks,
        )

    # ---------- invalidation surface ----------

    def invalidate_series_block(self, namespace: str, shard_id: int, series_id: bytes,
                                block_start: int) -> int:
        """Drop every volume of one (series, block): the write hook."""
        with self._lock:
            self._drop_pending_locked(
                lambda k: k.series_key == (namespace, shard_id, series_id, block_start))
            keys = self._by_series.pop((namespace, shard_id, series_id, block_start), None)
            return self._drop_locked(keys)

    def invalidate_block(self, namespace: str, shard_id: int, block_start: int,
                         below_volume=None) -> int:
        """Drop a block's entries across series; ``below_volume`` restricts
        the drop to superseded volumes."""
        with self._lock:
            self._drop_pending_locked(
                lambda k: k.block_key == (namespace, shard_id, block_start)
                and (below_volume is None or k.volume < below_volume))
            self._drop_complete_locked(namespace, shard_id, block_start, below_volume)
            keys = self._by_block.get((namespace, shard_id, block_start))
            if keys is None:
                return 0
            keys = {k for k in keys if below_volume is None or k.volume < below_volume}
            return self._drop_locked(keys)

    def drop_shard(self, namespace: str | None, shard_id: int) -> int:
        """Drop every entry of one shard (``namespace=None``: all
        namespaces): the source side of a shard handoff."""
        with self._lock:
            match = lambda k: k.shard_id == shard_id and (namespace is None or k.namespace == namespace)
            self._drop_pending_locked(match)
            keys = {k for k in self._od if match(k)}
            for k in keys:
                self._drop_complete_locked(k.namespace, k.shard_id, k.block_start, None)
            return self._drop_locked(keys)

    def clear(self) -> int:
        with self._lock:
            self._drop_pending_locked(lambda k: True)
            n = len(self._od)
            for entry in self._od.values():
                self._free.extend(entry.pages)
                self._free_side.extend(entry.side_pages)
            self._resident_bytes = 0
            self._od.clear()
            self._by_series.clear()
            self._by_block.clear()
            self._complete.clear()
            self.invalidations += n
            self._m_invalidations.inc(n)
            self._publish_locked()
            return n

    def shard_usage(self) -> dict[tuple[str, int], int]:
        """Resident bytes per (namespace, shard)."""
        with self._lock:
            return self._usage_locked()

    def _usage_locked(self) -> dict:
        usage: dict[tuple[str, int], int] = {}
        for key, entry in self._od.items():
            k = (key.namespace, key.shard_id)
            usage[k] = usage.get(k, 0) + entry.nbytes
        return usage

    def rebalance(self, heat: dict, slack: float = 0.10) -> int:
        """Heat-driven budget redistribution: shards holding more than their
        heat-weighted share of the byte budget shed LRU-oldest entries.
        ``heat`` has ``ShardHeat.dump()``'s shape; a shard's weight is
        hits + misses, floored at 1. Returns the entries evicted."""
        with self._lock:
            usage = self._usage_locked()
            if len(usage) <= 1:
                return 0
            weights = {}
            for k in usage:
                h = heat.get(str(k[1])) or {}
                weights[k] = max(float(h.get("hits", 0)) + float(h.get("misses", 0)), 1.0)
            total_w = sum(weights.values())
            budget = float(self.options.max_bytes)
            victims: list = []
            for k, used in usage.items():
                over = float(used) - budget * (weights[k] / total_w) * (1.0 + slack)
                if over <= 0:
                    continue
                for key, entry in self._od.items():  # LRU order: oldest first
                    if (key.namespace, key.shard_id) != k:
                        continue
                    victims.append(key)
                    over -= entry.nbytes
                    if over <= 0:
                        break
            for key in victims:
                entry = self._od.pop(key, None)
                if entry is None:
                    continue
                self._unindex_locked(key, entry)
                self._free.extend(entry.pages)
                self._free_side.extend(entry.side_pages)
                self._resident_bytes -= entry.nbytes
                self.evictions += 1
                self._m_evictions.inc()
                self.rebalance_evictions += 1
                self._m_rebalance_evictions.inc()
            if victims:
                self._publish_locked()
            return len(victims)

    def _reset_locked(self) -> None:
        """Recovery from a failed in-place write: drop the whole table,
        rebuild the free lists and null the buffers (re-zeroed lazily).
        Counted as invalidations."""
        n = len(self._od)
        self._od.clear()
        self._pending.clear()
        self._by_series.clear()
        self._by_block.clear()
        self._complete.clear()
        self._free = list(range(self.options.num_pages - 1, 0, -1))
        self._free_side = list(range(self.options.num_side_pages - 1, 0, -1))
        self._resident_bytes = 0
        self._words = None
        self._side = None
        self.epoch += 1
        self._generation += 1
        self.invalidations += n
        self._m_invalidations.inc(n)
        self._publish_locked()

    def _drop_pending_locked(self, match) -> None:
        """Drop matching in-flight admissions so stale data never publishes;
        their pages stay with the admitting thread, which reclaims them."""
        for key in [k for k in self._pending if match(k)]:
            del self._pending[key]

    def _drop_complete_locked(self, namespace, shard_id, block_start, below_volume) -> None:
        self._complete -= {
            g for g in self._complete
            if g[:3] == (namespace, shard_id, block_start)
            and (below_volume is None or g[3] < below_volume)
        }

    def _drop_locked(self, keys) -> int:
        if not keys:
            return 0
        dropped = 0
        for key in list(keys):
            entry = self._od.pop(key, None)
            if entry is None:
                continue
            self._unindex_locked(key, entry)
            self._free.extend(entry.pages)
            self._free_side.extend(entry.side_pages)
            self._resident_bytes -= entry.nbytes
            dropped += 1
        self.invalidations += dropped
        self._m_invalidations.inc(dropped)
        self._publish_locked()
        return dropped

    # ---------- bookkeeping ----------

    def _index_locked(self, key: BlockKey) -> None:
        self._by_series.setdefault(key.series_key, set()).add(key)
        self._by_block.setdefault(key.block_key, set()).add(key)

    def _unindex_locked(self, key: BlockKey, entry: ResidentEntry) -> None:
        for index, sub in ((self._by_series, key.series_key), (self._by_block, key.block_key)):
            keys = index.get(sub)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del index[sub]
        # any entry leaving the pool makes its group incomplete
        self._complete.discard((key.namespace, key.shard_id, key.block_start, key.volume))

    def _publish_locked(self) -> None:
        used = self.options.num_pages - 1 - len(self._free)
        side_used = self.options.num_side_pages - 1 - len(self._free_side)
        self._g_bytes.set(float(self._resident_bytes))
        self._g_pages.set(float(used))
        self._g_free.set(float(len(self._free)))
        self._g_entries.set(float(len(self._od)))
        self._g_side_pages.set(float(side_used))
        self._g_occupancy.set(used / max(self.options.num_pages - 1, 1))

    def stats(self) -> dict:
        with self._lock:
            o = self.options
            used_pages = o.num_pages - 1 - len(self._free)
            side_used = o.num_side_pages - 1 - len(self._free_side)
            return {
                "enabled": self.enabled,
                "entries": len(self._od),
                "bytes": self._resident_bytes,
                "max_bytes": o.max_bytes,
                "page_bytes": o.page_bytes,
                "pages_used": used_pages,
                "pages_total": max(o.num_pages - 1, 0),
                "occupancy": used_pages / max(o.num_pages - 1, 1),
                "side_pages_used": side_used,
                "side_pages_total": max(o.num_side_pages - 1, 0),
                "side_page_bytes": o.side_page_bytes,
                "complete_blocks": len(self._complete),
                "admissions": self.admissions,
                "rejections": self.rejections,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "upload_bytes": self.upload_bytes,
                "inplace_admissions": self.inplace_admissions,
                "copy_admissions": self.copy_admissions,
                "side_pack_overflows": self.side_pack_overflows,
                "rebalance_evictions": self.rebalance_evictions,
                "epoch": self.epoch,
                "shard_heat": self.heat.dump(),
            }


def _scatter(buf: torch.Tensor, idx: np.ndarray, staged: np.ndarray, inplace: bool) -> torch.Tensor:
    """Write ``staged`` rows at ``idx`` of ``buf`` (in place, or into a
    clone that the caller publishes)."""
    src = torch.from_numpy(np.ascontiguousarray(staged).view(np.int32)).to(buf.device)
    out = buf if inplace else buf.clone()
    out.index_copy_(0, torch.from_numpy(idx).to(buf.device), src)
    return out
