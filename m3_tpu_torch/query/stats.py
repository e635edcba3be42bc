"""Per-query cost accounting: stage timings, scan counters, routing
records, the slow-query ring and the active-query registry.

Port of ``m3_tpu/query/stats.py``. One ``QueryStats`` record rides a
thread-local through engine → storage adapter → database for the duration
of a query, capturing:

- per-stage wall seconds: ``parse``, ``index_resolve``, ``fetch``,
  ``decode``, ``exec`` (fetch CONTAINS index_resolve + decode when storage
  is local — stages are attributed, not disjoint; ``exec`` is total minus
  fetch minus parse);
- series / datapoints / bytes scanned, decoded-block cache hits and misses,
  resident and device-index hits and misses, the query plan's counters;
- the profiled kernel dispatches charged to it (``device_dispatches``,
  counted at the KernelProfiler seam);
- the tenant, the scheduler's queue state and priority, and the
  cost-limit scope that rejected it, if one did;
- with ``record_routing`` on, one entry per resident-vs-streamed routing
  decision (the record EXPLAIN renders).

Completed records land in a bounded ring (``RING``), feed the
``m3tpu_query_*`` histograms and counters and charge the tenant ledger;
in-flight ones are listed by ``ACTIVE``.

Configuration:

    M3_TPU_SLOW_QUERY_CAPACITY   ring capacity (default 256)
"""

from __future__ import annotations

import os
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..utils.instrument import DEFAULT as METRICS

# buckets matched to query latencies (sub-ms cached instant queries up to
# multi-second cold range scans)
QUERY_DURATION_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0,
)


@dataclass
class QueryStats:
    """One query's cost record (mutable while the query runs)."""

    query: str = ""
    start_unix_nanos: int = 0
    duration_secs: float = 0.0
    stages: dict = field(default_factory=dict)  # stage -> seconds
    # live-introspection fields (the /debug/active_queries surface): the
    # namespace the owning engine serves, and which stage the query is in
    # RIGHT NOW (set/restored by the ``stage()`` context; None between
    # stages) — only meaningful while the query is in flight
    namespace: str = ""
    current_stage: str | None = None
    # who is charged for this query (query/tenants.py): stamped from the
    # thread's tenant context at start(); "" renders as anonymous
    tenant: str = ""
    # admission-scheduler surface (query/scheduler.py): where the query is
    # in its lifecycle — "queued" (waiting for an admission slot),
    # "running", "hedged" (running, and the client fan-out issued a hedged
    # backup replica request for it), or "shed" (rejected by the
    # scheduler) — plus the priority score the scheduler computed for it
    # (higher = shed sooner)
    queue_state: str = "running"
    priority: float = 0.0
    # the enforcer-chain scope that 422'd the query (query/tenant/global),
    # None when no cost limit tripped — a rejection must leave a record
    # trail, not just an HTTP status
    limit_exceeded: str | None = None
    series_scanned: int = 0
    datapoints_scanned: int = 0
    bytes_scanned: int = 0
    # the subset of bytes_scanned served from device residency (the rest
    # streamed) — the ledger's streamed-vs-resident split
    resident_bytes: int = 0
    cache_hits: int = 0
    cache_misses: int = 0
    # device-residency routing (resident/): fetches served by the
    # decode-from-residency path vs streamed fallbacks while the pool was on
    resident_hits: int = 0
    resident_misses: int = 0
    # device index routing (index/device/): per-SEGMENT counts —
    # hits answered by the device executor, misses that fell back to the
    # host executor (evicted / not admitted / device error)
    index_device_hits: int = 0
    index_device_misses: int = 0
    # one-dispatch fused query pipeline (query/plan.py): fetches served
    # by a cached device plan (hits), plans (re)built this query
    # (misses), and fetches that degraded to the staged path (fallbacks,
    # EXPLAIN records the reason per cause)
    plan_hits: int = 0
    plan_misses: int = 0
    plan_fallbacks: int = 0
    # scan coalescing (query/plan.py singleflight): fetches served by
    # JOINING another concurrent query's in-flight device scan — this
    # query paid zero dispatches for them
    plan_coalesced: int = 0
    # profiled device-kernel dispatches charged to this query (the
    # KernelProfiler seam, utils/instrument.set_dispatch_counter): the
    # fused pipeline's acceptance metric — a warm plan-served query is
    # exactly ONE dispatch
    device_dispatches: int = 0
    trace_id: str | None = None  # links the record to its /debug/traces tree
    error: str | None = None
    # EXPLAIN support: when record_routing is on (Engine.explain sets it),
    # the storage adapter appends one entry per (series, block) routing
    # decision — {"series", "block", "path", "reason"} with path
    # "resident"|"streamed". Bounded by ROUTING_CAP; overflow is counted,
    # never silent.
    record_routing: bool = False
    routing: list = field(default_factory=list)
    routing_dropped: int = 0

    def add_stage(self, name: str, secs: float) -> None:
        self.stages[name] = self.stages.get(name, 0.0) + secs

    def to_dict(self) -> dict:
        out = {
            "query": self.query,
            "namespace": self.namespace,
            "tenant": self.tenant,
            "queueState": self.queue_state,
            "priority": self.priority,
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
            "indexDeviceHits": self.index_device_hits,
            "indexDeviceMisses": self.index_device_misses,
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
        objectives = slo_objectives_for(self.tenant)
        if objectives is not None:
            out["sloObjectives"] = objectives
        return out


# routing entries per EXPLAIN record: enough to show every block of a
# real dashboard query, small enough that a 10M-series selector can't
# balloon the record (the drop count says how much is missing)
ROUTING_CAP = 256


def add_routing(series_id, block_start, path: str, reason: str = "") -> None:
    """Record one resident-vs-streamed routing decision against this
    thread's active EXPLAIN record (no-op for normal queries — one
    attribute check — so the storage adapter calls it unconditionally)."""
    st = current()
    if st is None or not st.record_routing:
        return
    if len(st.routing) >= ROUTING_CAP:
        st.routing_dropped += 1
        return
    if isinstance(series_id, bytes):
        series_id = series_id.decode("utf-8", "replace")
    st.routing.append(
        {
            "series": series_id,
            "block": block_start,
            "path": path,
            "reason": reason,
        }
    )


# SLO-objective join seam: an SLO engine (ROADMAP §A10)
# installs a callable ``(tenant) -> [objective names]`` so debug query
# rows (/debug/slow_queries, /debug/active_queries) can say which SLOs a
# query counts against. A settable seam, not an import — the query layer
# must not depend on the SLO package.
_SLO_RESOLVER = None


def set_slo_resolver(fn) -> None:
    global _SLO_RESOLVER
    _SLO_RESOLVER = fn


def slo_objectives_for(tenant: str) -> list | None:
    """Objective names the tenant's queries count against, or None when
    no SLO engine is running (debug rows omit the field entirely then —
    absent means 'no SLO plane', [] means 'none apply')."""
    resolver = _SLO_RESOLVER
    if resolver is None:
        return None
    try:
        return list(resolver(tenant))
    except Exception:
        return None


_local = threading.local()


def current() -> QueryStats | None:
    """The query record active on this thread (None outside a query)."""
    return getattr(_local, "stats", None)


def start(query: str) -> QueryStats | None:
    """Begin a record for this thread's query; returns None when a record
    is already active (nested evaluation — e.g. federation re-entry —
    accumulates into the outer query's record instead of shadowing it)."""
    if current() is not None:
        return None
    st = QueryStats(query=query, start_unix_nanos=time.time_ns())
    from ..utils.trace import TRACER
    from . import tenants

    ctx = TRACER.current_context()
    if ctx is not None:
        st.trace_id = f"{ctx['trace_id']:016x}"
    st.tenant = tenants.current() or tenants.DEFAULT_TENANT
    _local.stats = st
    ACTIVE.register(st)
    return st


def finish(st: QueryStats, duration_secs: float, error: str | None = None) -> None:
    """Seal + publish a record: ring, histograms, counters."""
    _local.stats = None
    ACTIVE.unregister(st)
    st.current_stage = None
    st.duration_secs = duration_secs
    st.error = error
    fetch = st.stages.get("fetch", 0.0)
    parse = st.stages.get("parse", 0.0)
    st.add_stage("exec", max(duration_secs - fetch - parse, 0.0))
    RING.record(st)
    METRICS.counter("query_total", "completed queries").inc()
    if error is not None:
        METRICS.counter("query_errors_total", "failed queries").inc()
    # availability SLI events: served-vs-failed per tenant.
    # Sheds are counted (with reason) by the scheduler; 422 cost
    # rejections are the CALLER's query being over budget, not the
    # service being down — they count in neither class.
    if st.queue_state != "shed" and st.limit_exceeded is None:
        from . import tenants as _tenants

        tenant = st.tenant or _tenants.DEFAULT_TENANT
        if error is None:
            METRICS.counter(
                "query_completed_total",
                "queries served successfully (availability SLI good events)",
                labels={"tenant": tenant},
            ).inc()
        else:
            METRICS.counter(
                "query_failed_total",
                "queries that failed serving (availability SLI bad events; "
                "sheds counted separately in query_shed_total)",
                labels={"tenant": tenant},
            ).inc()
    # the trace id rides as an exemplar: a slow query_duration_seconds
    # bucket links to its stitched tree (/debug/traces) and its
    # /debug/slow_queries record via the shared id
    METRICS.histogram(
        "query_duration_seconds", "query wall time", buckets=QUERY_DURATION_BUCKETS
    ).observe(duration_secs, trace_id=st.trace_id, tenant=st.tenant or None)
    for stage, secs in st.stages.items():
        METRICS.histogram(
            "query_stage_duration_seconds",
            "per-stage query wall time",
            labels={"stage": stage},
            buckets=QUERY_DURATION_BUCKETS,
        ).observe(secs, trace_id=st.trace_id)
    METRICS.counter("query_series_scanned_total").inc(st.series_scanned)
    METRICS.counter("query_datapoints_scanned_total").inc(st.datapoints_scanned)
    METRICS.counter("query_bytes_scanned_total").inc(st.bytes_scanned)
    if st.resident_hits:
        METRICS.counter(
            "query_resident_hits_total", "fetches served from HBM residency"
        ).inc(st.resident_hits)
    if st.resident_misses:
        METRICS.counter(
            "query_resident_misses_total",
            "fetches that fell back to the streamed path with the pool on",
        ).inc(st.resident_misses)
    if st.index_device_hits:
        METRICS.counter(
            "query_index_device_hits_total",
            "index segments resolved by the device executor",
        ).inc(st.index_device_hits)
    if st.index_device_misses:
        METRICS.counter(
            "query_index_device_misses_total",
            "index segments that fell back to the host executor with the "
            "device tier on",
        ).inc(st.index_device_misses)
    # per-tenant attribution (query/tenants.py): every completed query
    # charges its scan work — and any cost-limit rejection — against the
    # tenant stamped at start(); decode device-seconds are charged
    # separately by the KernelProfiler attribution hook (sampled)
    from . import tenants

    tenants.LEDGER.charge(
        st.tenant or tenants.DEFAULT_TENANT,
        queries=1,
        series=st.series_scanned,
        datapoints=st.datapoints_scanned,
        bytes_streamed=max(st.bytes_scanned - st.resident_bytes, 0),
        bytes_resident=st.resident_bytes,
        cache_hits=st.cache_hits,
        cache_misses=st.cache_misses,
        limit_rejections=1 if st.limit_exceeded else 0,
        errors=1 if error is not None else 0,
    )


def add(
    series: int = 0,
    datapoints: int = 0,
    bytes_: int = 0,
    cache_hits: int = 0,
    cache_misses: int = 0,
    resident_hits: int = 0,
    resident_misses: int = 0,
    resident_bytes: int = 0,
    index_device_hits: int = 0,
    index_device_misses: int = 0,
    plan_hits: int = 0,
    plan_misses: int = 0,
    plan_fallbacks: int = 0,
    plan_coalesced: int = 0,
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
    st.index_device_hits += index_device_hits
    st.index_device_misses += index_device_misses
    st.plan_hits += plan_hits
    st.plan_misses += plan_misses
    st.plan_fallbacks += plan_fallbacks
    st.plan_coalesced += plan_coalesced


def _count_dispatch(_kernel: str) -> None:
    """KernelProfiler seam (utils/instrument.set_dispatch_counter):
    every profiled device-kernel dispatch charges the query record
    active on the dispatching thread — the fused pipeline's ONE-dispatch
    acceptance metric. No-op between queries (current() is None)."""
    st = current()
    if st is not None:
        st.device_dispatches += 1


from ..utils.instrument import set_dispatch_counter as _set_dispatch_counter

_set_dispatch_counter(_count_dispatch)


class _Stage:
    """``with stage("fetch"):`` — accumulates elapsed wall time onto the
    active record and marks it as the query's CURRENT stage (what
    /debug/active_queries shows for an in-flight query); no-op (still
    times nothing extra) outside a query."""

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


class ActiveQueryRegistry:
    """Bounded registry of IN-FLIGHT queries (the live sibling of the
    slow-query ring): every ``start()`` registers the thread's record,
    ``finish()`` removes it, and :meth:`dump` snapshots what is running
    RIGHT NOW — trace id, namespace, elapsed wall time, and the stage the
    query is currently in. Joined by traceId to ``/debug/slow_queries``
    and ``/debug/traces``, so "what is the coordinator doing" and "why was
    that slow" are the same id space.

    Bounded: past ``capacity`` concurrent queries, new registrations are
    dropped (counted in ``overflows``, surfaced in the dump) — the debug
    surface must not become the memory leak it exists to diagnose."""

    def __init__(self, capacity: int = 512) -> None:
        self.capacity = max(int(capacity), 1)
        self._live: dict[int, QueryStats] = {}
        self._lock = threading.Lock()
        self._overflows = 0

    def register(self, st: QueryStats) -> None:
        with self._lock:
            if len(self._live) >= self.capacity:
                self._overflows += 1
                return
            self._live[id(st)] = st

    def unregister(self, st: QueryStats) -> None:
        with self._lock:
            self._live.pop(id(st), None)

    def dump(self) -> dict:
        with self._lock:
            records = list(self._live.values())
            overflows = self._overflows
        now = time.time_ns()
        rows = []
        for st in records:
            row = {
                "query": st.query,
                "namespace": st.namespace,
                "tenant": st.tenant,
                "queueState": st.queue_state,
                "priority": st.priority,
                "traceId": st.trace_id,
                "stage": st.current_stage,
                "startUnixNanos": st.start_unix_nanos,
                "elapsedSecs": max(now - st.start_unix_nanos, 0) / 1e9,
            }
            objectives = slo_objectives_for(st.tenant)
            if objectives is not None:
                row["sloObjectives"] = objectives
            rows.append(row)
        rows.sort(key=lambda r: -r["elapsedSecs"])
        return {"queries": rows, "overflows": overflows}


# process-wide in-flight registry (what /debug/active_queries serves)
ACTIVE = ActiveQueryRegistry()


class SlowQueryRing:
    """Bounded ring of completed query records, newest last (the x/debug
    'recent expensive work' role). ``record`` is called for every completed
    query; consumers filter/sort by duration — at debug-endpoint rates the
    full ring is cheaper to ship than to pre-rank."""

    def __init__(self, capacity: int = 256) -> None:
        self._ring: deque[QueryStats] = deque(maxlen=max(capacity, 1))
        self._lock = threading.Lock()

    def record(self, st: QueryStats) -> None:
        with self._lock:
            self._ring.append(st)

    def dump(self, limit: int | None = None) -> list[dict]:
        with self._lock:
            records = list(self._ring)
        if limit is not None:
            records = records[-limit:] if limit > 0 else []
        return [r.to_dict() for r in records]


def _env_capacity() -> int:
    try:
        return int(os.environ.get("M3_TPU_SLOW_QUERY_CAPACITY", "256"))
    except ValueError:
        return 256


# process-wide ring (what /debug/slow_queries serves); engines record here
# unless constructed with their own ring
RING = SlowQueryRing(_env_capacity())
