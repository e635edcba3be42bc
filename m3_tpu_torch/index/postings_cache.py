"""Postings-list LRU cache.

Reference: M3's src/dbnode/storage/index/postings_list_cache.go:59
— the reference caches computed postings lists per (segment, pattern) for
regexp/term searches so repeated queries against immutable segments skip
the FST walk. Here the cache keys (segment, kind, field, pattern); only
IMMUTABLE segments (sealed / on-disk) are cacheable — mutable segments
mutate under writes, so they bypass the cache entirely.

Coherence: cache keys are bound to a segment OBJECT (the per-object
``_plc_key``), so a superseded segment can never serve wrong results;
``invalidate_segment`` drops a segment's entries
the moment seal compaction, persist, or retention expiry replaces it
(ns_index.py calls it at every segment-replacement site).

Observability: hits/misses are counted both per-instance (``stats()``)
and in the process registry as
``m3tpu_index_postings_cache_{hits,misses}_total`` (the port's
``utils/instrument.py`` registry).

A copy of ``m3_tpu/index/postings_cache.py``.
"""

from __future__ import annotations

import itertools
import threading
from collections import OrderedDict

import numpy as np

from ..utils.instrument import DEFAULT as METRICS

_seg_keys = itertools.count(1)

_M_HITS = METRICS.counter(
    "index_postings_cache_hits_total",
    "postings-list cache hits (regexp/field scans served without a "
    "term-dictionary walk)",
)
_M_MISSES = METRICS.counter(
    "index_postings_cache_misses_total", "postings-list cache misses"
)


def segment_cache_key(seg) -> int | None:
    """Stable per-immutable-segment identity; None = not cacheable."""
    # mutable segments grow in place: never cache them
    if hasattr(seg, "insert"):
        return None
    key = getattr(seg, "_plc_key", None)
    if key is None:
        key = next(_seg_keys)
        try:
            seg._plc_key = key
        except AttributeError:
            return None
    return key


class PostingsListCache:
    """LRU of computed postings arrays."""

    def __init__(self, capacity: int = 1024) -> None:
        self.capacity = capacity
        self._lock = threading.Lock()
        self._od: OrderedDict[tuple, np.ndarray] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.invalidations = 0

    def get(self, key: tuple) -> np.ndarray | None:
        with self._lock:
            arr = self._od.get(key)
            if arr is None:
                self.misses += 1
                _M_MISSES.inc()
                return None
            self._od.move_to_end(key)
            self.hits += 1
            _M_HITS.inc()
            return arr

    def put(self, key: tuple, arr: np.ndarray) -> None:
        with self._lock:
            self._od[key] = arr
            self._od.move_to_end(key)
            while len(self._od) > self.capacity:
                self._od.popitem(last=False)

    def invalidate_segment(self, seg) -> int:
        """Drop every entry computed against ``seg`` (and, for a device
        wrapper, against its wrapped host segment — fallback searches
        cache under the host object). Called when a segment is sealed
        away, compacted into a persisted segment, or expired; returns
        the number of entries dropped."""
        seg_keys = set()
        for s in (seg, getattr(seg, "host", None)):
            k = getattr(s, "_plc_key", None) if s is not None else None
            if k is not None:
                seg_keys.add(k)
        if not seg_keys:
            return 0
        with self._lock:
            doomed = [k for k in self._od if k[0] in seg_keys]
            for k in doomed:
                del self._od[k]
            self.invalidations += len(doomed)
            return len(doomed)

    def stats(self) -> dict:
        with self._lock:
            return {
                "entries": len(self._od),
                "capacity": self.capacity,
                "hits": self.hits,
                "misses": self.misses,
                "invalidations": self.invalidations,
            }

    def __len__(self) -> int:
        return len(self._od)
