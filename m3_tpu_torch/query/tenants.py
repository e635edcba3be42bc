"""Per-tenant cost attribution: who is spending what.

Port of ``m3_tpu/query/tenants.py``:

- a **tenant identity** rides a thread-local (:func:`tenant_context`); the
  coordinator's header and the wire frame that set it in the reference are
  ROADMAP §A10;
- a :class:`TenantLedger` keeps rolling-window and cumulative per-tenant
  accounting (queries, rpcs, writes, series, datapoints, bytes streamed vs
  resident, decode device-seconds via the KernelProfiler attribution hook,
  cache hits/misses, limit rejections, sheds, errors), exposed as
  cardinality-capped ``m3tpu_tenant_*`` counters;
- :class:`TenantEnforcers` provides the per-tenant MIDDLE scope of the
  cost-enforcer chain (query → tenant → global): per-tenant
  :class:`~m3_tpu_torch.query.cost.QueryLimits`, optionally loaded from a
  config file (:func:`load_tenant_limits`, which needs PyYAML and is not
  on any device path), so one tenant's runaway scan is rejected without
  starving the others.

Cardinality: tenant ids come from untrusted input, so every per-tenant
structure is capped: past ``max_tenants`` distinct ids, accounting
collapses into the ``__overflow__`` tenant and the collapse is counted
(``m3tpu_tenant_overflow_total``).

Configuration:

    M3_TPU_TENANT_CAP           distinct tenants tracked (default 64)
    M3_TPU_TENANT_WINDOW_SECS   rolling accounting window (default 300)
"""

from __future__ import annotations

import os
import re
import threading
import time
from collections import deque
from dataclasses import dataclass, field

from ..utils import instrument
from ..utils.instrument import DEFAULT as METRICS
from .cost import GlobalEnforcer, QueryLimits

# the identity every unattributed request gets: header/param absent, or
# work initiated by the fleet itself (ruler evals, selfmon scrapes)
DEFAULT_TENANT = "anonymous"

# where capped / invalid identities collapse (counted loudly): a flood of
# distinct wire-driven tenant ids must bound every per-tenant structure
OVERFLOW_TENANT = "__overflow__"

# sane tenant ids: bounded length, no exposition-hostile characters (the
# value lands in Prometheus label values and PromQL matchers)
TENANT_RE = re.compile(r"^[A-Za-z0-9][A-Za-z0-9._:-]{0,63}$")


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, str(default)))
    except ValueError:
        return default


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, str(default)))
    except ValueError:
        return default


def normalize(raw) -> str:
    """An untrusted tenant identity → a safe ledger/label key.

    ``None``/empty → :data:`DEFAULT_TENANT`; a malformed id (wrong type,
    oversized, exposition-hostile characters) collapses to
    :data:`OVERFLOW_TENANT` and is counted — junk must never mint new
    label values or pollute the anonymous bucket."""
    if raw is None:
        return DEFAULT_TENANT
    if not isinstance(raw, str) or not raw:
        LEDGER.count_invalid()
        return OVERFLOW_TENANT
    if raw in (DEFAULT_TENANT, OVERFLOW_TENANT):
        return raw
    if TENANT_RE.match(raw) is None:
        LEDGER.count_invalid()
        return OVERFLOW_TENANT
    return raw


# --- thread-local tenant context -----------------------------------------

_local = threading.local()


def current() -> str | None:
    """The tenant active on this thread (None outside any request)."""
    return getattr(_local, "tenant", None)


class _TenantContext:
    """``with tenant_context("alpha"):`` — set/restore the thread's tenant
    (re-entrant: nested contexts restore the outer tenant on exit)."""

    __slots__ = ("tenant", "_prev")

    def __init__(self, tenant: str | None) -> None:
        self.tenant = tenant

    def __enter__(self) -> "_TenantContext":
        self._prev = current()
        if self.tenant is not None:
            _local.tenant = self.tenant
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        _local.tenant = self._prev


def tenant_context(tenant: str | None) -> _TenantContext:
    return _TenantContext(tenant)


# --- the ledger ----------------------------------------------------------

# every accountable resource; ``charge()`` kwargs, bucket keys, metric
# fields and dump columns all share this vocabulary
FIELDS = (
    "queries",
    "rpcs",
    "writes",
    "series",
    "datapoints",
    "bytes_streamed",
    "bytes_resident",
    "decode_seconds",
    "cache_hits",
    "cache_misses",
    "limit_rejections",
    "sheds",
    "errors",
)


class _Account:
    """One tenant's totals + rolling-window buckets (guarded by the
    ledger lock — charges are a handful of dict adds, far cheaper than a
    per-account lock ladder)."""

    __slots__ = ("totals", "buckets", "handles", "first_seen")

    def __init__(self, handles: dict, now: float) -> None:
        self.totals = dict.fromkeys(FIELDS, 0.0)
        # (bucket_index, {field: amount}) — newest last
        self.buckets: deque = deque()
        self.handles = handles
        self.first_seen = now


class TenantLedger:
    """Rolling-window per-tenant resource accounting.

    Charges land in cumulative totals, per-tenant ``m3tpu_tenant_*``
    registry counters (so the selfmon collector stores them in
    ``_m3tpu``), and a ring of coarse time buckets whose in-window sum
    :meth:`dump` reports — "what is tenant X doing RIGHT NOW" next to
    "what has it done ever".

    Bounded: at most ``max_tenants`` distinct accounts; past the cap new
    identities collapse into :data:`OVERFLOW_TENANT` (counted in
    ``m3tpu_tenant_overflow_total``) — tenant ids arrive off
    untrusted input, and both the metric registry and this ledger must stay
    flood-proof."""

    def __init__(
        self,
        max_tenants: int | None = None,
        window_secs: float | None = None,
        registry=None,
        clock=time.monotonic,
    ) -> None:
        self.max_tenants = max(
            max_tenants
            if max_tenants is not None
            else _env_int("M3_TPU_TENANT_CAP", 64),
            1,
        )
        self.window_secs = max(
            window_secs
            if window_secs is not None
            else _env_float("M3_TPU_TENANT_WINDOW_SECS", 300.0),
            1.0,
        )
        # ~30 buckets per window: coarse enough to stay tiny, fine enough
        # that the window sum moves smoothly as buckets expire
        self.bucket_secs = self.window_secs / 30.0
        self.clock = clock
        self._reg = registry if registry is not None else METRICS
        self._accounts: dict[str, _Account] = {}
        self._lock = threading.Lock()
        self._overflow = self._reg.counter(
            "tenant_overflow_total",
            "tenant identities collapsed into __overflow__ past the "
            "cardinality cap",
        )
        self._invalid = self._reg.counter(
            "tenant_invalid_ids_total",
            "malformed tenant identities (wrong type/charset/length) "
            "collapsed into __overflow__",
        )
        self._active = self._reg.gauge(
            "tenant_active", "distinct tenants currently tracked"
        )

    def count_invalid(self) -> None:
        self._invalid.inc()

    def _handles(self, tenant: str) -> dict:
        reg = self._reg
        labels = {"tenant": tenant}
        return {
            "queries": reg.counter(
                "tenant_queries_total", "completed queries", labels
            ),
            "rpcs": reg.counter(
                "tenant_rpcs_total",
                "wire-attributed RPC dispatches (dbnode-side work)",
                labels,
            ),
            "writes": reg.counter(
                "tenant_datapoints_written_total",
                "ingested datapoints attributed to the tenant",
                labels,
            ),
            "series": reg.counter(
                "tenant_series_scanned_total", "", labels
            ),
            "datapoints": reg.counter(
                "tenant_datapoints_scanned_total", "", labels
            ),
            "bytes_streamed": reg.counter(
                "tenant_bytes_streamed_total",
                "scan bytes served off the streamed path",
                labels,
            ),
            "bytes_resident": reg.counter(
                "tenant_bytes_resident_total",
                "scan bytes served from HBM residency",
                labels,
            ),
            "decode_seconds": reg.counter(
                "tenant_decode_seconds_total",
                "sampled decode device-seconds (KernelProfiler "
                "attribution under M3_TPU_PROFILE_SAMPLE_RATE)",
                labels,
            ),
            "cache_hits": reg.counter(
                "tenant_cache_hits_total", "", labels
            ),
            "cache_misses": reg.counter(
                "tenant_cache_misses_total", "", labels
            ),
            "limit_rejections": reg.counter(
                "tenant_limit_exceeded_total",
                "cost-limit 422s attributed to the tenant",
                labels,
            ),
            "sheds": reg.counter(
                "tenant_shed_total",
                "requests shed at admission for the tenant",
                labels,
            ),
            "errors": reg.counter(
                "tenant_query_errors_total", "", labels
            ),
        }

    def _account(self, tenant: str) -> _Account:
        acct = self._accounts.get(tenant)
        if acct is not None:
            return acct
        with self._lock:
            acct = self._accounts.get(tenant)
            if acct is not None:
                return acct
            if (
                len(self._accounts) >= self.max_tenants
                and tenant != OVERFLOW_TENANT
            ):
                self._overflow.inc()
                tenant = OVERFLOW_TENANT
                acct = self._accounts.get(tenant)
                if acct is not None:
                    return acct
            # metric children are created here, so registry cardinality is
            # bounded by the same cap as the account dict
            acct = self._accounts[tenant] = _Account(
                self._handles(tenant), self.clock()
            )
            self._active.set(len(self._accounts))
            return acct

    def charge(self, tenant: str | None, **amounts) -> None:
        """Charge resources against ``tenant`` (None → anonymous).
        Kwargs are :data:`FIELDS`; unknown fields raise — the accounting
        vocabulary is fixed, not grow-by-typo."""
        for k in amounts:
            if k not in FIELDS:
                raise TypeError(f"unknown ledger field {k!r}")
        name = tenant if tenant is not None else DEFAULT_TENANT
        acct = self._account(name)
        bucket = int(self.clock() // self.bucket_secs)
        horizon = bucket - 30
        with self._lock:
            totals = acct.totals
            handles = acct.handles
            for k, v in amounts.items():
                if not v:
                    continue
                totals[k] += v
                handles[k].inc(v)
            ring = acct.buckets
            if not ring or ring[-1][0] != bucket:
                ring.append((bucket, dict.fromkeys(FIELDS, 0.0)))
            cur = ring[-1][1]
            for k, v in amounts.items():
                if v:
                    cur[k] += v
            while ring and ring[0][0] <= horizon:
                ring.popleft()

    def window_totals(self, tenant: str) -> dict | None:
        """In-window sums for one tenant (None if untracked)."""
        with self._lock:
            acct = self._accounts.get(tenant)
            if acct is None:
                return None
            return self._window_locked(acct)

    def _window_locked(self, acct: _Account) -> dict:
        horizon = int(self.clock() // self.bucket_secs) - 30
        out = dict.fromkeys(FIELDS, 0.0)
        for idx, vals in acct.buckets:
            if idx <= horizon:
                continue
            for k, v in vals.items():
                out[k] += v
        return out

    def dump(self) -> dict:
        """The tenants dump: per-tenant window + cumulative
        columns, heaviest (window datapoints) first, plus the loud
        overflow/invalid tallies."""
        with self._lock:
            rows = [
                {
                    "tenant": name,
                    "window": self._window_locked(acct),
                    "total": dict(acct.totals),
                }
                for name, acct in self._accounts.items()
            ]
        rows.sort(
            key=lambda r: (-r["window"]["datapoints"], r["tenant"])
        )
        return {
            "windowSecs": self.window_secs,
            "tenants": rows,
            "overflows": self._overflow.value,
            "invalidIds": self._invalid.value,
        }


# process-wide ledger (what stats.finish, the scheduler's sheds and the
# kernel attribution hook charge into)
LEDGER = TenantLedger()


def _attribute_kernel_seconds(kernel: str, secs: float) -> None:
    """KernelProfiler attribution hook: a SAMPLED dispatch, bounded by its
    wait on the device (a CUDA event on the card), that ran under a tenant
    context charges its seconds to that tenant. Sampled: totals are an
    M3_TPU_PROFILE_SAMPLE_RATE-fraction estimate, like the
    kernel_dispatch_seconds histogram they ride beside."""
    tenant = current()
    if tenant is None:
        return
    LEDGER.charge(tenant, decode_seconds=secs)


instrument.set_kernel_attribution(_attribute_kernel_seconds)


def charge_writes(n: int) -> None:
    """Attribute ``n`` ingested datapoints to the active tenant context
    (no-op outside one): the write-path twin of stats.finish's query
    charge, for the ingest surfaces (write-heavy tenants must show their
    spend too)."""
    if not n:
        return
    tenant = current()
    if tenant is None:
        return
    LEDGER.charge(tenant, writes=n)


# --- per-tenant cost-limit scopes ----------------------------------------


@dataclass
class TenantLimitSet:
    """Parsed per-tenant limits config (:func:`load_tenant_limits`)."""

    by_tenant: dict = field(default_factory=dict)  # tenant -> QueryLimits
    default_limits: QueryLimits | None = None  # unlisted tenants


def load_tenant_limits(path: str) -> TenantLimitSet:
    """Load the per-tenant limits file (YAML or JSON)::

        default:            # optional: every unlisted tenant
          max_series: 0     # 0 = unlimited
          max_datapoints: 0
        tenants:
          alpha:
            max_datapoints: 50000
          beta: {}          # listed, unlimited

    Limits bound the tenant's CONCURRENT in-flight spend (the middle
    scope of the enforcer chain), exactly like the global scope bounds
    the fleet's."""
    import yaml

    with open(path) as f:
        data = yaml.safe_load(f) or {}
    if not isinstance(data, dict):
        raise ValueError(f"tenant limits file {path}: expected a mapping")
    unknown = set(data) - {"default", "tenants"}
    if unknown:
        raise ValueError(
            f"tenant limits file {path}: unknown keys {sorted(unknown)}"
        )

    def parse_limits(what: str, raw) -> QueryLimits:
        if raw is None:
            raw = {}
        if not isinstance(raw, dict):
            raise ValueError(f"{path}: {what}: expected a mapping")
        bad = set(raw) - {"max_series", "max_datapoints"}
        if bad:
            raise ValueError(f"{path}: {what}: unknown keys {sorted(bad)}")
        return QueryLimits(
            max_series=int(raw.get("max_series", 0)),
            max_datapoints=int(raw.get("max_datapoints", 0)),
        )

    out = TenantLimitSet()
    if "default" in data and data["default"] is not None:
        out.default_limits = parse_limits("default", data["default"])
    tenants = data.get("tenants") or {}
    if not isinstance(tenants, dict):
        raise ValueError(f"{path}: tenants: expected a mapping")
    for name, raw in tenants.items():
        name = str(name)
        if TENANT_RE.match(name) is None:
            raise ValueError(f"{path}: bad tenant id {name!r}")
        out.by_tenant[name] = parse_limits(f"tenants.{name}", raw)
    return out


class TenantEnforcers:
    """The per-tenant MIDDLE scope of the chained cost enforcer
    (query → tenant → global): one long-lived
    :class:`~m3_tpu_torch.query.cost.GlobalEnforcer` per tenant accumulating
    that tenant's concurrent in-flight spend, parented on the fleet-wide
    global scope. Capped like the ledger: past ``max_tenants`` distinct
    ids share the overflow scope (default limits), so a tenant-id flood
    cannot mint unbounded enforcers."""

    def __init__(
        self,
        limits_by_tenant: dict | None = None,
        global_enforcer: GlobalEnforcer | None = None,
        default_limits: QueryLimits | None = None,
        max_tenants: int | None = None,
    ) -> None:
        self.limits_by_tenant = dict(limits_by_tenant or {})
        self.global_enforcer = global_enforcer
        self.default_limits = default_limits
        self.max_tenants = max(
            max_tenants
            if max_tenants is not None
            else _env_int("M3_TPU_TENANT_CAP", 64),
            1,
        )
        self._scopes: dict[str, GlobalEnforcer] = {}
        self._lock = threading.Lock()

    @classmethod
    def from_limit_set(
        cls,
        limit_set: TenantLimitSet,
        global_enforcer: GlobalEnforcer | None = None,
    ) -> "TenantEnforcers":
        return cls(
            limits_by_tenant=limit_set.by_tenant,
            global_enforcer=global_enforcer,
            default_limits=limit_set.default_limits,
        )

    def scope_for(self, tenant: str | None) -> GlobalEnforcer:
        name = normalize(tenant)
        scope = self._scopes.get(name)
        if scope is not None:
            return scope
        with self._lock:
            scope = self._scopes.get(name)
            if scope is not None:
                return scope
            if (
                len(self._scopes) >= self.max_tenants
                and name != OVERFLOW_TENANT
            ):
                name = OVERFLOW_TENANT
                scope = self._scopes.get(name)
                if scope is not None:
                    return scope
            limits = self.limits_by_tenant.get(name, self.default_limits)
            scope = self._scopes[name] = GlobalEnforcer(
                limits if limits is not None else QueryLimits(),
                scope="tenant",
                what=f"tenant {name}",
                parent=self.global_enforcer,
            )
            return scope
