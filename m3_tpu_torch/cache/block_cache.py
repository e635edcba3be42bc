"""Byte-budget LRU cache of decoded block arrays with read-through fetch.

A copy of ``m3_tpu/cache/block_cache.py`` (host numpy arrays). Its
``BlockKey`` also keys the resident pool's page table.

Reference: M3 keeps repeated work off the hot read path with two caches —
the postings-list LRU (src/dbnode/storage/index/postings_list_cache.go:59)
and the per-shard seeker cache / wired list (persist/fs/seek_manager.go,
block/wired_list.go:77). Both key on immutable state. This cache is the
decoded-datapoint analog: one entry per sealed fileset block per series,
keyed (namespace, shard_id, series_id, block_start, volume), holding the
decoded ``times``/``values``/``valid`` ndarrays. The volume in the key makes
cold-flush supersession self-invalidating (a merged block goes out as a
NEW volume — persist/fs/merger.go); explicit hooks (invalidation.py)
reclaim superseded and expired entries' bytes eagerly.

Concurrency: ``get_or_decode`` is single-flight per key — concurrent
readers of the same cold block decode once, the rest wait on the
decoder's event and read the cached entry.
"""

from __future__ import annotations

import threading
from collections import OrderedDict
from typing import Callable, NamedTuple

import numpy as np

from ..utils.instrument import DEFAULT as METRICS

# fixed per-entry bookkeeping cost added to the arrays' nbytes (key,
# OrderedDict slot, index sets) so many tiny entries can't blow past the
# budget on overhead alone
ENTRY_OVERHEAD_BYTES = 256


class BlockKey(NamedTuple):
    """Identity of one sealed, immutable decoded block."""

    namespace: str
    shard_id: int
    series_id: bytes
    block_start: int
    volume: int

    @property
    def series_key(self) -> tuple:
        return (self.namespace, self.shard_id, self.series_id, self.block_start)

    @property
    def block_key(self) -> tuple:
        return (self.namespace, self.shard_id, self.block_start)


class DecodedBlock:
    """Decoded arrays of one block: ``times`` i64, ``values`` f64,
    ``units`` u8, ``valid`` bool — the dense device-placeable layout the
    scan-and-aggregate kernels consume. Arrays are frozen (non-writeable)
    on construction: entries are shared across readers. ``valid`` is
    materialized lazily (a decode yields all-valid points; the mask only
    costs memory once a device-packing consumer asks for it) and counts
    toward ``nbytes`` only when passed explicitly."""

    __slots__ = ("times", "values", "units", "_valid", "nbytes")

    def __init__(self, times, values, units, valid=None) -> None:
        self.times = np.ascontiguousarray(times, np.int64)
        self.values = np.ascontiguousarray(values, np.float64)
        self.units = np.ascontiguousarray(units, np.uint8)
        self._valid = None if valid is None else np.ascontiguousarray(valid, bool)
        for arr in (self.times, self.values, self.units, self._valid):
            if arr is not None:
                arr.flags.writeable = False
        self.nbytes = (
            self.times.nbytes
            + self.values.nbytes
            + self.units.nbytes
            + (self._valid.nbytes if self._valid is not None else 0)
            + ENTRY_OVERHEAD_BYTES
        )

    @property
    def valid(self) -> np.ndarray:
        if self._valid is None:
            mask = np.ones(len(self.times), bool)
            mask.flags.writeable = False
            self._valid = mask
        return self._valid

    def __len__(self) -> int:
        return len(self.times)

    def triple(self) -> tuple:
        """(times, values, units) — the merge_segment_arrays input shape."""
        return (self.times, self.values, self.units)


class _UncacheableMarker:
    """Negative-cache sentinel: the block decoded to something the cache
    cannot hold (an annotated stream). Sealed blocks are immutable, so
    uncacheable is a durable property of the key — remembering it saves a
    full decode-and-discard on every subsequent read. Invalidation and
    volume supersession purge sentinels like any entry."""

    __slots__ = ()
    nbytes = ENTRY_OVERHEAD_BYTES

    def __len__(self) -> int:  # pragma: no cover - uniformity only
        return 0


UNCACHEABLE = _UncacheableMarker()


class BlockCache:
    """LRU of DecodedBlock entries under a byte budget."""

    def __init__(self, options=None, policy=None, registry=None) -> None:
        from .policy import AdmissionPolicy, CacheOptions

        self.options = options or CacheOptions()
        self.policy = policy or AdmissionPolicy(self.options)
        self._lock = threading.Lock()
        self._od: "OrderedDict[BlockKey, DecodedBlock]" = OrderedDict()
        # secondary indexes for O(1) targeted invalidation off the hot
        # write path: series_key/block_key -> live BlockKeys
        self._by_series: dict[tuple, set] = {}
        self._by_block: dict[tuple, set] = {}
        self._inflight: dict[BlockKey, threading.Event] = {}
        self.bytes = 0
        self.hits = 0
        self.misses = 0
        self.evictions = 0
        self.invalidations = 0
        reg = registry or METRICS
        self._m_hits = reg.counter("block_cache_hits_total", "decoded-block cache hits")
        self._m_misses = reg.counter("block_cache_misses_total", "decoded-block cache misses")
        self._m_evictions = reg.counter(
            "block_cache_evictions_total", "byte-budget LRU evictions"
        )
        self._m_invalidations = reg.counter(
            "block_cache_invalidations_total", "entries dropped by invalidation hooks"
        )
        self._g_bytes = reg.gauge("block_cache_bytes", "decoded bytes resident")
        self._g_entries = reg.gauge("block_cache_entries", "entries resident")

    # ---------- core ----------

    def get(self, key: BlockKey) -> DecodedBlock | None:
        with self._lock:
            entry = self._od.get(key)
            if entry is None:
                self.misses += 1
                self._m_misses.inc()
                return None
            self._od.move_to_end(key)
            self.hits += 1
            self._m_hits.inc()
            return None if entry is UNCACHEABLE else entry

    def get_or_decode(
        self, key: BlockKey, decode: Callable[[], "DecodedBlock | None"]
    ) -> DecodedBlock | None:
        """Read-through fetch: return the cached entry or run ``decode``
        exactly once per key across racing threads. ``decode`` returning
        None marks the block uncacheable (e.g. annotated streams) — the
        None propagates, and a negative sentinel is cached so later reads
        skip the decode-and-discard (sealed blocks are immutable; only
        invalidation or supersession can change the verdict)."""
        while True:
            with self._lock:
                entry = self._od.get(key)
                if entry is not None:
                    self._od.move_to_end(key)
                    self.hits += 1
                    self._m_hits.inc()
                    return None if entry is UNCACHEABLE else entry
                event = self._inflight.get(key)
                if event is None:
                    event = self._inflight[key] = threading.Event()
                    owner = True
                else:
                    owner = False
            if owner:
                try:
                    block = decode()
                    if block is not None:
                        self.put(key, block)
                    else:
                        self._mark_uncacheable(key)
                    return block
                finally:
                    with self._lock:
                        self._inflight.pop(key, None)
                        self.misses += 1
                        self._m_misses.inc()
                    event.set()
            # another thread is decoding this key: wait, then re-check (the
            # entry may have been rejected by admission — loop makes this
            # thread the next owner rather than spinning)
            event.wait()

    def put(self, key: BlockKey, block: DecodedBlock) -> bool:
        """Insert under admission policy + byte budget; True if resident."""
        if len(block) == 0:
            # an absent/empty series in a fileset: a resident marker per
            # (series, block, volume) would flood the LRU on sparse
            # workloads (each costs ENTRY_OVERHEAD_BYTES), while re-probing
            # absence is a cheap bloom-filter hit
            return False
        if not self.policy.admit(key, block.nbytes):
            return False
        with self._lock:
            resident = self._insert_locked(key, block)
            self._publish_gauges()
            return resident

    def _mark_uncacheable(self, key: BlockKey) -> None:
        """Negative-cache a key whose decode can't be held (sentinel;
        bypasses admission — overhead-only cost, no payload)."""
        with self._lock:
            self._insert_locked(key, UNCACHEABLE)
            self._publish_gauges()

    def _insert_locked(self, key: BlockKey, block) -> bool:
        old = self._od.pop(key, None)
        if old is not None:
            self._unindex(key, old)
            self.bytes -= old.nbytes
        self._od[key] = block
        self._index(key)
        self.bytes += block.nbytes
        while self.bytes > self.options.max_bytes and len(self._od) > 1:
            victim, gone = self._od.popitem(last=False)
            self._unindex(victim, gone)
            self.bytes -= gone.nbytes
            self.evictions += 1
            self._m_evictions.inc()
        if self.bytes > self.options.max_bytes:
            # the sole survivor is this entry itself and it busts the
            # budget (admit() bounds it by max_bytes, but a concurrent
            # options change could shrink the budget)
            self._od.pop(key, None)
            self._unindex(key, block)
            self.bytes -= block.nbytes
            self.evictions += 1
            self._m_evictions.inc()
            return False
        return True

    # ---------- invalidation surface (see invalidation.py for wiring) ----------

    def invalidate_series_block(
        self, namespace: str, shard_id: int, series_id: bytes, block_start: int
    ) -> int:
        """Drop every volume of one (series, block) — the write hook."""
        with self._lock:
            keys = self._by_series.pop(
                (namespace, shard_id, series_id, block_start), None
            )
            return self._drop_locked(keys)

    def invalidate_block(
        self, namespace: str, shard_id: int, block_start: int, below_volume=None
    ) -> int:
        """Drop a whole block's entries across series; ``below_volume``
        restricts to superseded volumes (cold-flush supersession)."""
        with self._lock:
            keys = self._by_block.get((namespace, shard_id, block_start))
            if keys is None:
                return 0
            if below_volume is not None:
                keys = {k for k in keys if k.volume < below_volume}
            return self._drop_locked(set(keys))

    def clear(self) -> int:
        with self._lock:
            n = len(self._od)
            self._od.clear()
            self._by_series.clear()
            self._by_block.clear()
            self.bytes = 0
            self.invalidations += n
            self._m_invalidations.inc(n)
            self._publish_gauges()
            return n

    def _drop_locked(self, keys) -> int:
        if not keys:
            return 0
        dropped = 0
        for key in keys:
            entry = self._od.pop(key, None)
            if entry is None:
                continue
            self._unindex(key, entry)
            self.bytes -= entry.nbytes
            dropped += 1
        self.invalidations += dropped
        self._m_invalidations.inc(dropped)
        self._publish_gauges()
        return dropped

    # ---------- bookkeeping ----------

    def _index(self, key: BlockKey) -> None:
        self._by_series.setdefault(key.series_key, set()).add(key)
        self._by_block.setdefault(key.block_key, set()).add(key)

    def _unindex(self, key: BlockKey, entry: DecodedBlock) -> None:
        for index, sub in (
            (self._by_series, key.series_key),
            (self._by_block, key.block_key),
        ):
            keys = index.get(sub)
            if keys is not None:
                keys.discard(key)
                if not keys:
                    del index[sub]

    def _publish_gauges(self) -> None:
        self._g_bytes.set(float(self.bytes))
        self._g_entries.set(float(len(self._od)))

    def __len__(self) -> int:
        return len(self._od)

    def __contains__(self, key: BlockKey) -> bool:
        with self._lock:
            return key in self._od

    def stats(self) -> dict:
        with self._lock:
            lookups = self.hits + self.misses
            return {
                "entries": len(self._od),
                "bytes": self.bytes,
                "max_bytes": self.options.max_bytes,
                "hits": self.hits,
                "misses": self.misses,
                "evictions": self.evictions,
                "invalidations": self.invalidations,
                "hit_rate": (self.hits / lookups) if lookups else 0.0,
            }
