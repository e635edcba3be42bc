"""Per-query cost limits: bound series / datapoints a single query touches.

Port of ``m3_tpu/query/cost.py`` (M3's src/query/cost/ + src/x/cost/): a
per-query ChainedEnforcer charges each fetched block against query- and
global-scope limits and aborts the query when exceeded (the coordinator
returns 4xx instead of OOMing the node). Here an Enforcer accumulates
charges from the engine's fetch path; the chain above it is built from
:class:`GlobalEnforcer` scopes: the per-tenant middle scope
(query/tenants.TenantEnforcers) parents on the global scope, so one
tenant's runaway scan is rejected without starving the others.

Every rejection is counted in ``m3tpu_query_limit_exceeded_total{scope}``
(scope = query | tenant | global): a 422 must leave a metric trail, or
capacity incidents look like silent client errors.
"""

from __future__ import annotations

import threading
from dataclasses import dataclass

from ..utils.instrument import DEFAULT as METRICS


class QueryLimitError(Exception):
    """Cost limit exceeded — maps to HTTP 422 at the coordinator.
    ``scope`` names the chain link that tripped (query/tenant/global)."""

    def __init__(self, what: str, used: int, limit: int,
                 scope: str = "query") -> None:
        super().__init__(
            f"query limit exceeded: {what} used {used} > limit {limit}"
        )
        self.what = what
        self.used = used
        self.limit = limit
        self.scope = scope


def limit_error(scope: str, what: str, used: int, limit: int) -> QueryLimitError:
    """Build (and COUNT) a limit rejection — the one constructor every
    raise site uses, so the {scope} counter can't drift from the 422s."""
    METRICS.counter(
        "query_limit_exceeded_total",
        "cost-limit rejections (the 422 trail)",
        labels={"scope": scope},
    ).inc()
    return QueryLimitError(what, used, limit, scope=scope)


@dataclass
class QueryLimits:
    """0 = unlimited (cost/config defaults)."""

    max_series: int = 0
    max_datapoints: int = 0


class Enforcer:
    """Accumulates charges for ONE query (cost.ChainedEnforcer child)."""

    def __init__(self, limits: QueryLimits, parent: "GlobalEnforcer | None" = None):
        self.limits = limits
        self.parent = parent
        self.series = 0
        self.datapoints = 0

    def charge(self, series: int, datapoints: int) -> None:
        # record + propagate BEFORE checking own limits, so release() always
        # returns exactly what the parent received
        self.series += series
        self.datapoints += datapoints
        if self.parent is not None:
            self.parent.charge(series, datapoints)
        if 0 < self.limits.max_series < self.series:
            raise limit_error(
                "query", "series", self.series, self.limits.max_series
            )
        if 0 < self.limits.max_datapoints < self.datapoints:
            raise limit_error(
                "query", "datapoints", self.datapoints,
                self.limits.max_datapoints,
            )

    def release(self) -> None:
        if self.parent is not None:
            self.parent.release(self.series, self.datapoints)


class GlobalEnforcer:
    """A long-lived concurrent-cost scope: the sum over in-flight queries
    charged into it. With no ``parent`` it is the chain's GLOBAL ceiling;
    with one it is a middle scope (the per-tenant link) propagating up —
    charges are recorded and propagated BEFORE the local check (the
    Enforcer discipline), so release() unwinds exactly what each link
    received even when a check partway up the chain raised."""

    def __init__(self, limits: QueryLimits, scope: str = "global",
                 what: str = "global",
                 parent: "GlobalEnforcer | None" = None) -> None:
        self.limits = limits
        self.scope = scope
        self.what = what
        self.parent = parent
        self._lock = threading.Lock()
        self.series = 0
        self.datapoints = 0

    def charge(self, series: int, datapoints: int) -> None:
        with self._lock:
            self.series += series
            self.datapoints += datapoints
            used_s, used_d = self.series, self.datapoints
        if self.parent is not None:
            self.parent.charge(series, datapoints)
        if 0 < self.limits.max_series < used_s:
            raise limit_error(
                self.scope, f"{self.what} series", used_s,
                self.limits.max_series,
            )
        if 0 < self.limits.max_datapoints < used_d:
            raise limit_error(
                self.scope, f"{self.what} datapoints", used_d,
                self.limits.max_datapoints,
            )

    def release(self, series: int, datapoints: int) -> None:
        with self._lock:
            self.series -= series
            self.datapoints -= datapoints
        if self.parent is not None:
            self.parent.release(series, datapoints)
