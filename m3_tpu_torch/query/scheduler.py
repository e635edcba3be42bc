"""Cost-aware admission control and load shedding for the query engine.

Port of ``m3_tpu/query/scheduler.py`` (DAGOR, "Overload Control for Scaling
WeChat Microservices", SoCC 2018): when the engine is saturated, the queries
least worth running (misbehaving tenants, expensive scans, fresh arrivals)
are shed with a typed error the client can tell from a failure, while cheap
well-behaved work keeps flowing. It sits in front of
``Engine.query_range``.

Priority is a SHED score, higher means shed first:

    score = tenant_pressure * pressure_weight     # dominant term
          + cost / (cost + cost_scale)            # expensive sheds first
          - age_seconds * aging_rate              # anti-starvation

``tenant_pressure`` is the tenant's in-window misbehaviour ratio from the
process ledger (query/tenants.LEDGER): limit_rejections /
(limit_rejections + queries + 1). Cost is grid steps x a matched-series
estimate remembered from the query's own past runs (``CostMemo``).

Sheds surface as :class:`QueryShedError` and are counted twice on purpose:
``m3tpu_query_shed_total{tenant,reason}`` with the bounded ``reason``
vocabulary {queue_full, overload, deadline}, and the tenant ledger's
``sheds`` field.
"""

from __future__ import annotations

import threading
import time
from collections import OrderedDict

from ..utils.instrument import DEFAULT as METRICS

# the bounded shed-reason vocabulary (M3L005: "reason" is allowlisted on
# the promise that it stays an enum, never request-derived)
SHED_QUEUE_FULL = "queue_full"
SHED_OVERLOAD = "overload"
SHED_DEADLINE = "deadline"

_SHED_HELP = "queries shed by the admission scheduler instead of run"


class QueryShedError(RuntimeError):
    """Typed load-shed rejection: the query was refused BEFORE any
    evaluation work ran, so it is safe to retry. ``reason`` is one of the SHED_* constants;
    ``tenant`` is the normalized tenant that absorbed the shed."""

    def __init__(self, reason: str, tenant: str) -> None:
        super().__init__(f"query shed ({reason}) for tenant {tenant}")
        self.reason = reason
        self.tenant = tenant


def tenant_pressure(tenant: str) -> float:
    """The tenant's in-window misbehavior ratio in [0, 1): how much of
    its recent traffic tripped cost limits. Reads the process ledger's
    rolling window; an unseen tenant scores 0 (innocent until measured).

    Deliberately NOT counting the tenant's own sheds: sheds feeding the
    score that causes sheds is a positive feedback loop — one unlucky
    queue-full eviction would snowball against an innocent tenant. Limit
    rejections are externally caused (the tenant exceeded ITS configured
    cap), so they are a stable misbehavior signal."""
    from .tenants import LEDGER

    totals = LEDGER.window_totals(tenant)
    if not totals:
        return 0.0
    bad = float(totals.get("limit_rejections", 0))
    good = float(totals.get("queries", 0))
    return bad / (bad + good + 1.0)


class CostMemo:
    """Bounded LRU memo of a query's last observed matched-series count,
    the cost estimator that needs no index: estimate = grid_steps x remembered series (default 1 series
    for a never-seen query — optimistic, so new queries are not shed on
    a guess)."""

    def __init__(self, capacity: int = 1024) -> None:
        self.capacity = int(capacity)
        self._memo: OrderedDict[str, int] = OrderedDict()
        self._lock = threading.Lock()

    def observe(self, query: str, series: int) -> None:
        if series <= 0:
            return
        with self._lock:
            self._memo[query] = int(series)
            self._memo.move_to_end(query)
            while len(self._memo) > self.capacity:
                self._memo.popitem(last=False)

    def series_estimate(self, query: str) -> int:
        with self._lock:
            n = self._memo.get(query)
            if n is not None:
                self._memo.move_to_end(query)
        return n if n is not None else 1

    def estimate(self, query: str, grid_steps: int) -> float:
        return float(max(1, grid_steps)) * float(self.series_estimate(query))


class _Waiter:
    """One queued admission request. State transitions under the
    scheduler's condition: queued -> admitted | shed."""

    __slots__ = ("tenant", "cost", "enqueued_at", "base_score", "state", "reason")

    def __init__(self, tenant: str, cost: float, base_score: float,
                 now: float) -> None:
        self.tenant = tenant
        self.cost = cost
        self.enqueued_at = now
        self.base_score = base_score
        self.state = "queued"
        self.reason = ""


class QueryScheduler:
    """Bounded priority admission in front of ``Engine.query_range``.

    Fast path: below ``max_inflight`` with an empty queue, admission is
    one lock acquire. Under pressure queries wait (bounded by their
    deadline or ``max_queue_wait``) in a priority queue; each release
    admits the LOWEST shed-score waiter. Shedding happens at three
    points, each with its typed reason:

    - ``queue_full``: the queue is at capacity — the WORST-scoring entry
      (which may be the newcomer) is evicted;
    - ``overload``: the queue is past ``overload_watermark`` of capacity
      and the newcomer's tenant-pressure term alone exceeds the best
      queued entry's total score — fast-fail the misbehaving tenant
      before it queues (DAGOR's business-priority gate);
    - ``deadline``: the entry's wait budget expired while queued.

    ``record`` (a query/stats.QueryStats) gets ``queue_state`` /
    ``priority`` stamped through the lifecycle so /debug/active_queries
    shows queued/running/shed with the score that decided it.
    """

    def __init__(
        self,
        max_inflight: int = 8,
        max_queue: int = 64,
        overload_watermark: float = 0.75,
        max_queue_wait: float = 5.0,
        pressure_weight: float = 8.0,
        cost_scale: float = 100_000.0,
        aging_rate: float = 0.5,
        clock=time.monotonic,
    ) -> None:
        self.max_inflight = max(1, int(max_inflight))
        self.max_queue = max(1, int(max_queue))
        self.overload_watermark = float(overload_watermark)
        self.max_queue_wait = float(max_queue_wait)
        self.pressure_weight = float(pressure_weight)
        self.cost_scale = float(cost_scale)
        self.aging_rate = float(aging_rate)
        self._clock = clock
        self.costs = CostMemo()
        self._cond = threading.Condition()
        self._inflight = 0
        self._queue: list[_Waiter] = []
        self._depth_gauge = METRICS.gauge(
            "query_sched_queue_depth", "queries waiting for admission"
        )
        self._inflight_gauge = METRICS.gauge(
            "query_sched_inflight", "queries admitted and running"
        )
        self._queued_total = METRICS.counter(
            "query_sched_queued_total",
            "queries that waited in the admission queue (vs fast-path)",
        )

    # -- scoring --

    def score(self, tenant: str, cost: float, age: float = 0.0) -> float:
        """The shed score (higher = shed first); see module docstring."""
        return (
            tenant_pressure(tenant) * self.pressure_weight
            + cost / (cost + self.cost_scale)
            - age * self.aging_rate
        )

    def _waiter_score(self, w: _Waiter, now: float) -> float:
        return w.base_score - (now - w.enqueued_at) * self.aging_rate

    # -- admission --

    def admit(self, query: str, grid_steps: int, record=None,
              deadline: float | None = None) -> None:
        """Block until admitted or raise :class:`QueryShedError`. The
        caller MUST pair a successful return with :meth:`release` (the
        engine does so in its query_range finally). ``deadline`` is a
        monotonic-clock instant bounding the queue wait; None uses
        ``max_queue_wait``."""
        from . import tenants

        tenant = tenants.current() or tenants.DEFAULT_TENANT
        cost = self.costs.estimate(query, grid_steps)
        base = self.score(tenant, cost)
        if record is not None:
            record.priority = base
        with self._cond:
            if self._inflight < self.max_inflight and not self._queue:
                self._inflight += 1
                self._inflight_gauge.set(float(self._inflight))
                return
            now = self._clock()
            # DAGOR-style fast gate: past the watermark, a tenant whose
            # pressure term ALONE already outranks everything queued is
            # shed before it can occupy a slot. Zero-pressure (innocent)
            # tenants never trip this — they queue and compete; the
            # max(…, 0.0) floor keeps an aged-negative queue from
            # turning a barely-measured tenant into a shed.
            pressure_term = tenant_pressure(tenant) * self.pressure_weight
            if (
                len(self._queue) >= self.overload_watermark * self.max_queue
                and pressure_term > 0.0
                and pressure_term > max(
                    max(self._waiter_score(w, now) for w in self._queue), 0.0
                )
            ):
                self._shed(record, tenant, SHED_OVERLOAD)
            me = _Waiter(tenant, cost, base, now)
            self._queue.append(me)
            self._queued_total.inc()
            if record is not None:
                record.queue_state = "queued"
            if len(self._queue) > self.max_queue:
                victim = max(self._queue, key=lambda w: self._waiter_score(w, now))
                victim.state = "shed"
                victim.reason = SHED_QUEUE_FULL
                self._queue.remove(victim)
                self._cond.notify_all()
                if victim is me:
                    self._shed(record, tenant, SHED_QUEUE_FULL)
            self._depth_gauge.set(float(len(self._queue)))
            limit = deadline if deadline is not None else now + self.max_queue_wait
            while me.state == "queued":
                remaining = limit - self._clock()
                if remaining <= 0:
                    me.state = "shed"
                    me.reason = SHED_DEADLINE
                    if me in self._queue:
                        self._queue.remove(me)
                    break
                self._cond.wait(remaining)
            self._depth_gauge.set(float(len(self._queue)))
            if me.state == "shed":
                self._shed(record, tenant, me.reason)
            # admitted by a releaser (who already took the inflight slot
            # on our behalf)
            if record is not None:
                record.queue_state = "running"

    def release(self) -> None:
        """Return an admission slot and admit the best waiter, if any."""
        with self._cond:
            self._inflight -= 1
            now = self._clock()
            while self._inflight < self.max_inflight and self._queue:
                best = min(self._queue, key=lambda w: self._waiter_score(w, now))
                self._queue.remove(best)
                best.state = "admitted"
                self._inflight += 1
            self._inflight_gauge.set(float(self._inflight))
            self._depth_gauge.set(float(len(self._queue)))
            self._cond.notify_all()

    def observe(self, query: str, series: int) -> None:
        """Feed a completed query's matched-series count back into the
        cost memo (the engine calls this after a successful eval)."""
        self.costs.observe(query, series)

    # -- shed bookkeeping --

    def _shed(self, record, tenant: str, reason: str) -> None:
        from .tenants import LEDGER

        if record is not None:
            record.queue_state = "shed"
        METRICS.counter(
            "query_shed_total", _SHED_HELP,
            labels={"tenant": tenant, "reason": reason},
        ).inc()
        LEDGER.charge(tenant, sheds=1)
        raise QueryShedError(reason, tenant)

    # -- introspection (for /debug + tests) --

    def snapshot(self) -> dict:
        with self._cond:
            now = self._clock()
            return {
                "inflight": self._inflight,
                "maxInflight": self.max_inflight,
                "queued": [
                    {
                        "tenant": w.tenant,
                        "cost": w.cost,
                        "ageSeconds": now - w.enqueued_at,
                        "score": self._waiter_score(w, now),
                    }
                    for w in self._queue
                ],
            }
