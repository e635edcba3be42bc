"""Per-query cost accounting: stage timings, scan counters, routing records.

The subset of ``m3_tpu/query/stats.py`` that the storage node and
``M3Storage`` record into. One ``QueryStats`` record rides a thread-local
through engine → storage adapter → database for the duration of a query:

- per-stage wall seconds (``parse``, ``index_resolve``, ``fetch``,
  ``decode``, ...; ``exec``, added at ``finish``, is the total minus fetch
  minus parse);
- series / datapoints / bytes scanned, decoded-block cache hits and misses,
  resident hits and misses;
- the query plan's (``query/plan.py``) hits, misses, fallbacks and
  coalesced fetches, and the plan-served fetches' device dispatches;
- with ``record_routing`` on, one entry per resident-vs-streamed routing
  decision (the record EXPLAIN renders, ``Engine.explain``);
- the namespace the engine serves and the cost-limit scope that rejected
  the query, if one did (``limit_exceeded``).

Completed records charge the process counters; ``to_dict`` is the record
under the reference's names (``planHits``, ...). The slow-query ring, the
active-query registry, the histograms, tenants, SLO objectives and the
scheduler's fields wait for ROADMAP §A5b.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

from ..utils.instrument import DEFAULT as METRICS
from ..utils.trace import TRACER


@dataclass
class QueryStats:
    """One query's cost record (mutable while the query runs)."""

    query: str = ""
    start_unix_nanos: int = 0
    duration_secs: float = 0.0
    stages: dict = field(default_factory=dict)  # stage -> seconds
    # the namespace the owning engine serves (its storage's ``namespace``)
    namespace: str = ""
    current_stage: str | None = None
    # the enforcer-chain scope that rejected the query (query / global),
    # None when no cost limit tripped
    limit_exceeded: str | None = None
    series_scanned: int = 0
    datapoints_scanned: int = 0
    bytes_scanned: int = 0
    # the subset of bytes_scanned served from device residency
    resident_bytes: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    # fetches served by decode-from-residency vs streamed fallbacks while
    # the pool was on
    resident_hits: int = 0
    resident_misses: int = 0
    # the one-program query plan (query/plan.py): fetches served by a
    # cached plan (hits), plans (re)built this query (misses), fetches that
    # degraded to the staged path (fallbacks, the routing record says why)
    plan_hits: int = 0
    plan_misses: int = 0
    plan_fallbacks: int = 0
    # fetches served by joining another concurrent query's in-flight plan
    # execution: this query dispatched nothing for them
    plan_coalesced: int = 0
    # plan executions this query dispatched, one per plan-served fetch (the
    # reference counts them at its KernelProfiler seam, which the port has
    # not yet, ROADMAP §A9): a warm plan-served query is exactly one
    device_dispatches: int = 0
    trace_id: str | None = None
    error: str | None = None
    # routing decisions, one per (series, block) — {"series", "block",
    # "path", "reason"} with path "resident" | "streamed". Bounded by
    # ROUTING_CAP; overflow is counted, never silent.
    record_routing: bool = False
    routing: list = field(default_factory=list)
    routing_dropped: int = 0

    def add_stage(self, name: str, secs: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + secs

    def to_dict(self) -> dict:
        """The record under the reference's names (the fields the port
        keeps; tenants', the scheduler's and the index tier's wait for
        §A5b)."""
        out = {
            "query": self.query,
            "namespace": self.namespace,
            "limitExceeded": self.limit_exceeded,
            "startUnixNanos": self.start_unix_nanos,
            "durationSecs": self.duration_secs,
            "stages": dict(self.stages),
            "seriesScanned": self.series_scanned,
            "datapointsScanned": self.datapoints_scanned,
            "bytesScanned": self.bytes_scanned,
            "cacheHits": self.cache_hits,
            "cacheMisses": self.cache_misses,
            "residentHits": self.resident_hits,
            "residentMisses": self.resident_misses,
            "planHits": self.plan_hits,
            "planMisses": self.plan_misses,
            "planFallbacks": self.plan_fallbacks,
            "planCoalesced": self.plan_coalesced,
            "deviceDispatches": self.device_dispatches,
            "traceId": self.trace_id,
            "error": self.error,
        }
        if self.record_routing:
            out["routing"] = list(self.routing)
            out["routingDropped"] = self.routing_dropped
        return out


# routing entries per record: enough to show every block of a real
# dashboard query, small enough that a huge selector can't balloon it
ROUTING_CAP = 256


def add_routing(series_id, block_start, path: str, reason: str = "") -> None:
    """Record one resident-vs-streamed routing decision against this
    thread's active record (no-op unless it records routing, so the storage
    adapter calls it unconditionally)."""
    st = current()
    if st is None or not st.record_routing:
        return
    if len(st.routing) >= ROUTING_CAP:
        st.routing_dropped += 1
        return
    if isinstance(series_id, bytes):
        series_id = series_id.decode("utf-8", "replace")
    st.routing.append(
        {"series": series_id, "block": block_start, "path": path, "reason": reason}
    )


_local = threading.local()


def current() -> QueryStats | None:
    """The query record active on this thread (None outside a query)."""
    return getattr(_local, "stats", None)


def start(query: str) -> QueryStats | None:
    """Begin a record for this thread's query; returns None when a record
    is already active (nested evaluation accumulates into the outer
    query's record instead of shadowing it)."""
    if current() is not None:
        return None
    st = QueryStats(query=query, start_unix_nanos=time.time_ns())
    ctx = TRACER.current_context()
    if ctx is not None:
        st.trace_id = f"{ctx['trace_id']:016x}"
    _local.stats = st
    return st


def finish(st: QueryStats, duration_secs: float, error: str | None = None) -> None:
    """Seal a record and charge the process counters."""
    _local.stats = None
    st.current_stage = None
    st.duration_secs = duration_secs
    st.error = error
    fetch = st.stages.get("fetch", 0.0)
    parse = st.stages.get("parse", 0.0)
    st.add_stage("exec", max(duration_secs - fetch - parse, 0.0))
    METRICS.counter("query_total", "completed queries").inc()
    if error is not None:
        METRICS.counter("query_errors_total", "failed queries").inc()
    METRICS.counter("query_series_scanned_total").inc(st.series_scanned)
    METRICS.counter("query_datapoints_scanned_total").inc(st.datapoints_scanned)
    METRICS.counter("query_bytes_scanned_total").inc(st.bytes_scanned)
    if st.resident_hits:
        METRICS.counter(
            "query_resident_hits_total", "fetches served from device residency"
        ).inc(st.resident_hits)
    if st.resident_misses:
        METRICS.counter(
            "query_resident_misses_total",
            "fetches that fell back to the streamed path with the pool on",
        ).inc(st.resident_misses)


def add(
    series: int = 0,
    datapoints: int = 0,
    bytes_: int = 0,
    cache_hits: int = 0,
    cache_misses: int = 0,
    resident_hits: int = 0,
    resident_misses: int = 0,
    resident_bytes: int = 0,
    plan_hits: int = 0,
    plan_misses: int = 0,
    plan_fallbacks: int = 0,
    plan_coalesced: int = 0,
    device_dispatches: int = 0,
) -> None:
    """Charge scan counters against this thread's active query (no-op
    outside a query, so storage paths call it unconditionally)."""
    st = current()
    if st is None:
        return
    st.series_scanned += series
    st.datapoints_scanned += datapoints
    st.bytes_scanned += bytes_
    st.cache_hits += cache_hits
    st.cache_misses += cache_misses
    st.resident_hits += resident_hits
    st.resident_misses += resident_misses
    st.resident_bytes += resident_bytes
    st.plan_hits += plan_hits
    st.plan_misses += plan_misses
    st.plan_fallbacks += plan_fallbacks
    st.plan_coalesced += plan_coalesced
    st.device_dispatches += device_dispatches


class _Stage:
    """``with stage("decode"):`` — accumulates elapsed wall time onto the
    active record and marks it as the query's current stage; times nothing
    outside a query."""

    __slots__ = ("name", "_t0", "_prev")

    def __init__(self, name: str) -> None:
        self.name = name

    def __enter__(self) -> "_Stage":
        self._t0 = time.perf_counter()
        st = current()
        self._prev = st.current_stage if st is not None else None
        if st is not None:
            st.current_stage = self.name
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        st = current()
        if st is not None:
            st.add_stage(self.name, time.perf_counter() - self._t0)
            st.current_stage = self._prev


def stage(name: str) -> _Stage:
    return _Stage(name)
