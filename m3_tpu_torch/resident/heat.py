"""Per-shard residency heat: hits, misses and streamed bytes per shard.

A copy of ``m3_tpu/resident/heat.py`` so that ``ResidentPool.stats()``
keeps its shape (``shard_heat``) and ``rebalance`` has its weights. The
label cardinality is capped (``M3_TPU_SHARD_HEAT_CAP``, default 1024):
shards past the cap collapse into ``__overflow__``, counted.
"""

from __future__ import annotations

import os
import threading

from ..utils.instrument import DEFAULT as METRICS

OVERFLOW_SHARD = "__overflow__"


def _env_cap() -> int:
    try:
        return max(int(os.environ.get("M3_TPU_SHARD_HEAT_CAP", "1024")), 1)
    except ValueError:
        return 1024


class ShardHeat:
    """Capped per-shard hit/miss/streamed-bytes accounting."""

    def __init__(self, registry=None, cap: int | None = None) -> None:
        self._reg = registry or METRICS
        self.cap = _env_cap() if cap is None else max(int(cap), 1)
        self._lock = threading.Lock()
        # shard label value -> (hits, misses, streamed_bytes counters)
        self._counters: dict = {}
        self._m_overflow = self._reg.counter(
            "resident_shard_overflow_total",
            "heat charges collapsed into the __overflow__ shard past the "
            "per-shard cardinality cap (M3_TPU_SHARD_HEAT_CAP)",
        )

    def _handles(self, shard_id):
        key = str(shard_id)
        handles = self._counters.get(key)
        if handles is not None:
            return handles
        overflowed = False
        with self._lock:
            handles = self._counters.get(key)
            if handles is not None:
                return handles
            if len(self._counters) >= self.cap and key != OVERFLOW_SHARD:
                overflowed = True
                key = OVERFLOW_SHARD
                handles = self._counters.get(key)
                if handles is not None:
                    self._m_overflow.inc()
                    return handles
            labels = {"shard": key}
            handles = self._counters[key] = (
                self._reg.counter("resident_shard_hits_total",
                                  "resident lanes served from the pool, per shard", labels=labels),
                self._reg.counter("resident_shard_misses_total",
                                  "streamed fallbacks while the pool was on, per shard",
                                  labels=labels),
                self._reg.counter("resident_shard_streamed_bytes_total",
                                  "block bytes moved by the streamed scan fallback, per shard",
                                  labels=labels),
            )
        if overflowed:
            self._m_overflow.inc()
        return handles

    def charge(self, shard_id, hits: int = 0, misses: int = 0, streamed_bytes: int = 0) -> None:
        h, m, b = self._handles(shard_id)
        if hits:
            h.inc(hits)
        if misses:
            m.inc(misses)
        if streamed_bytes:
            b.inc(streamed_bytes)

    def dump(self) -> dict:
        """{shard: {"hits", "misses", "streamedBytes"}}."""
        with self._lock:
            items = list(self._counters.items())
        return {
            shard: {"hits": h.value, "misses": m.value, "streamedBytes": b.value}
            for shard, (h, m, b) in sorted(items)
        }
