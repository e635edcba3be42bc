"""In-process + cross-process request tracing: sampled spans in a bounded
ring buffer, with Dapper-style context propagation over the RPC layer.

A copy of ``m3_tpu/utils/trace.py``; the storage spans keep their names
(``db.flush``, ``db.bootstrap``, ``storage.fetch_tagged``).

Reference: the reference threads opentracing through its contexts
(M3's src/x/context/context.go StartSampledTraceSpan,
src/dbnode/server wiring of jaeger/lightstep tracers) and exposes debug
dumps (x/debug). This framework keeps the same shape without external
backends: a process-wide sampled tracer whose finished spans land in a ring
buffer served by the coordinator's /debug/traces route and bundled into the
/debug/dump archive.

Usage::

    from m3_tpu_torch.utils.trace import TRACER
    with TRACER.span("db.write", namespace=ns):
        ...

Spans nest through a thread-local stack: a span started while another is
open on the same thread becomes its child. Across threads or processes the
stack does NOT follow — extract the active context with
``TRACER.current_context()`` on the parent side and adopt it with
``TRACER.span_from_context(name, ctx)`` on the other side (the net/ RPC
layer does exactly this, so a query fanning out coordinator → dbnode
replicas produces ONE stitched trace).

Configuration (read once at import for the process-wide ``TRACER``):

    M3_TPU_TRACE_SAMPLE_RATE   root-span sample rate in [0, 1] (default 1.0)
    M3_TPU_TRACE_CAPACITY      finished-span ring capacity (default 4096)
"""

from __future__ import annotations

import itertools
import os
import random
import threading
import time
from collections import deque
from dataclasses import dataclass, field


@dataclass
class Span:
    trace_id: int
    span_id: int
    parent_id: int | None
    name: str
    start_nanos: int
    end_nanos: int | None = None
    tags: dict = field(default_factory=dict)
    error: str | None = None

    @property
    def duration_nanos(self) -> int | None:
        if self.end_nanos is None:
            return None
        return self.end_nanos - self.start_nanos

    def to_dict(self) -> dict:
        return {
            "traceId": f"{self.trace_id:016x}",
            "spanId": f"{self.span_id:016x}",
            "parentId": f"{self.parent_id:016x}" if self.parent_id else None,
            "name": self.name,
            "startNanos": self.start_nanos,
            "durationNanos": self.duration_nanos,
            "tags": {k: str(v) for k, v in self.tags.items()},
            "error": self.error,
        }


class _ActiveSpan:
    """Context manager binding a span to the thread-local stack."""

    def __init__(self, tracer: "Tracer", span: Span | None) -> None:
        self.tracer = tracer
        self.span = span  # None = unsampled (no-op)

    def set_tag(self, key: str, value) -> "_ActiveSpan":
        if self.span is not None:
            self.span.tags[key] = value
        return self

    def __enter__(self) -> "_ActiveSpan":
        if self.span is not None:
            self.tracer._stack().append(self.span)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if self.span is None:
            return
        stack = self.tracer._stack()
        if stack and stack[-1] is self.span:
            stack.pop()
        self.span.end_nanos = time.time_ns()
        if exc is not None:
            self.span.error = f"{exc_type.__name__}: {exc}"
        self.tracer._record(self.span)


class Tracer:
    """Process tracer: sample_rate in [0, 1], ring buffer of finished spans.

    ``started``/``sampled`` counters and the span-id sequence are guarded by
    one lock — spans start on many threads concurrently (RPC handler
    threads, host-queue flushers), so the read-modify-writes must not race.
    Span ids count up from a random 62-bit base so ids minted by different
    PROCESSES joining one trace don't collide.
    """

    def __init__(self, sample_rate: float = 1.0, capacity: int = 4096) -> None:
        self.sample_rate = sample_rate
        self.finished: deque[Span] = deque(maxlen=capacity)
        self._ids = itertools.count(random.getrandbits(62) | 1)
        self._local = threading.local()
        self._lock = threading.Lock()
        self.started = 0
        self.sampled = 0

    @classmethod
    def from_env(cls) -> "Tracer":
        """Build a tracer from M3_TPU_TRACE_SAMPLE_RATE / M3_TPU_TRACE_CAPACITY
        (malformed values fall back to the defaults rather than killing the
        process at import)."""
        try:
            rate = float(os.environ.get("M3_TPU_TRACE_SAMPLE_RATE", "1.0"))
        except ValueError:
            rate = 1.0
        try:
            capacity = int(os.environ.get("M3_TPU_TRACE_CAPACITY", "4096"))
        except ValueError:
            capacity = 4096
        return cls(sample_rate=min(max(rate, 0.0), 1.0), capacity=max(capacity, 1))

    def _stack(self) -> list:
        stack = getattr(self._local, "stack", None)
        if stack is None:
            stack = self._local.stack = []
        return stack

    def active(self) -> bool:
        """Whether a sampled span is open on THIS thread (hot paths gate
        optional child spans on this so untraced operations pay nothing)."""
        return bool(self._stack())

    def current_context(self) -> dict | None:
        """Wire-propagatable context of the innermost active span, or None.

        The dict shape is what net/wire's inject/extract helpers carry:
        {"trace_id": int, "span_id": int, "sampled": bool}.
        """
        stack = self._stack()
        if not stack:
            return None
        top = stack[-1]
        return {"trace_id": top.trace_id, "span_id": top.span_id, "sampled": True}

    def span(self, name: str, **tags) -> _ActiveSpan:
        parent = self._stack()[-1] if self._stack() else None
        with self._lock:
            self.started += 1
            if parent is None and self.sample_rate < 1.0:
                if random.random() >= self.sample_rate:
                    return _ActiveSpan(self, None)
            self.sampled += 1
            span_id = next(self._ids)
        sp = Span(
            trace_id=parent.trace_id if parent else span_id,
            span_id=span_id,
            parent_id=parent.span_id if parent else None,
            name=name,
            start_nanos=time.time_ns(),
            tags=tags,
        )
        return _ActiveSpan(self, sp)

    def span_from_context(self, name: str, ctx: dict | None, **tags) -> _ActiveSpan:
        """Start a span whose parent is a REMOTE (or cross-thread) span.

        ``ctx`` is a dict from :meth:`current_context` carried over the wire;
        the new span joins that trace instead of rooting a new one, so the
        server side of an RPC stitches into the client's tree. ``ctx`` of
        None falls back to the normal local-parent path; an EXPLICITLY
        unsampled context (sampled=False) is a no-op — the upstream decided
        not to trace this request, and rooting a fresh local trace here
        would litter every downstream ring with orphan spans.
        """
        if ctx is None:
            return self.span(name, **tags)
        if not ctx.get("sampled", True):
            with self._lock:
                self.started += 1
            return _ActiveSpan(self, None)
        with self._lock:
            self.started += 1
            self.sampled += 1
            span_id = next(self._ids)
        sp = Span(
            trace_id=int(ctx["trace_id"]),
            span_id=span_id,
            parent_id=int(ctx["span_id"]),
            name=name,
            start_nanos=time.time_ns(),
            tags=tags,
        )
        return _ActiveSpan(self, sp)

    def _record(self, span: Span) -> None:
        with self._lock:
            self.finished.append(span)

    def dump(self, limit: int | None = None) -> list[dict]:
        with self._lock:
            spans = list(self.finished)
        if limit is not None:
            spans = spans[-limit:] if limit > 0 else []
        return [s.to_dict() for s in spans]


# process-wide default (the reference hangs its tracer off instrument opts);
# sample rate / capacity configurable via M3_TPU_TRACE_* env vars
TRACER = Tracer.from_env()

# shared no-op span (what span() returns when unsampled): for callers that
# decide themselves not to trace something
NOOP_SPAN = _ActiveSpan(None, None)
