"""Query engine: PromQL range queries over storage blocks, on one device.

Port of ``m3_tpu/query/engine.py``. Every node evaluates to a dense [S, T]
tensor on the engine's device (a [1, T] row for scalars), so each
transform is one vectorized call:

    parse (promql.py) → _fetch: the storage's fetch_grid decodes and
    consolidates the matched series onto the step grid (``M3Storage``
    through its query plan, ``query/plan.py``); a storage without
    fetch_grid, or one whose fetch_grid returns None (a plan-ineligible
    query), runs the staged path instead: ``storage.fetch`` gives each
    matched series' raw samples and ``consolidate`` puts them on the grid on
    the host →
    temporal functions (temporal_fused, kernel B2; deriv, predict_linear,
    holt_winters and quantile_over_time on temporal_window, kernel B-7) →
    grouped aggregations (aggregation.py, kernel K3; topk, bottomk,
    quantile, count_values) → binary operators with vector matching
    (binary.py) and the linear, label and time functions (linear.py).

It evaluates what the reference's does: number literals, selectors with
offset and ``@``, range functions over ranges and subqueries, every
function and aggregation, and every operator with on/ignoring and
group_left/group_right. Each node's dtype is the reference's (float64
where its numpy code computes, float32 where its jnp code does).
``limits=`` / ``global_enforcer=`` / ``tenant_enforcers=`` charge each
fetch against the cost limits along the chain query → tenant → global
(``cost.py``, ``tenants.py``); ``scheduler=`` puts every top-level query
through cost-aware admission first (``scheduler.py``), bounded by the
ambient deadline (``net/resilience.py``); ``explain`` evaluates a query
and returns its stats record.
``consolidate_row`` / ``consolidate`` are the host rule of the staged path
and of the storage's err-row stitch. ``scan_totals`` is the storage's
scan-and-aggregate as an engine surface.
"""

from __future__ import annotations

import re as _re
import threading
import time
from dataclasses import dataclass, replace
from typing import Protocol

import numpy as np
import torch

from .. import resolve_device
from ..block.core import Bounds, SeriesMeta, Tags
from ..net.resilience import current_deadline
from . import stats, tenants
from .cost import Enforcer, QueryLimitError, QueryLimits
from .functions import aggregation as A
from .functions import binary as B
from .functions import linear as L
from .functions import temporal_fused as TF
from .functions import temporal_window as TW
from .promql import (
    Aggregation,
    BinaryOp,
    Call,
    Expr,
    Matcher,
    NumberLiteral,
    RangeSelector,
    StringLiteral,
    Subquery,
    Unary,
    VectorSelector,
    parse,
)

NANOS = 1_000_000_000
DEFAULT_LOOKBACK = 5 * 60 * NANOS

@dataclass
class Result:
    """An evaluated vector: values [S, T] on the engine's device + per-series
    metas (scalar results have one row and scalar=True)."""

    values: torch.Tensor
    metas: list[SeriesMeta]
    scalar: bool = False


class Storage(Protocol):
    """The storage seam: matched series decoded and consolidated onto a
    step grid (``fetch_grid``, optional: None runs the staged path), or
    their raw samples (``fetch``)."""

    def fetch(
        self, matchers: list[Matcher], start_nanos: int, end_nanos: int,
    ) -> list[tuple[Tags, np.ndarray, np.ndarray]]:
        """→ [(tags, times i64, values f64)] for the series matching
        ``matchers`` with samples in ``[start, end)``."""
        ...

    def fetch_grid(
        self, matchers: list[Matcher], start_nanos: int, end_nanos: int,
        grid: np.ndarray, lookback_nanos: int,
    ) -> tuple[list[SeriesMeta], torch.Tensor, int] | None:
        """→ (metas, values f64[S, T], datapoints) for the series matching
        ``matchers`` with samples in ``[start, end)``."""
        ...


def consolidate_row(
    times: np.ndarray, vals: np.ndarray, grid: np.ndarray,
    lookback_nanos: int,
) -> np.ndarray:
    """ONE series' samples onto the step grid: value at step = last
    sample in (t-lookback, t]. The device consolidation (plan.py) and the
    err-row host stitch (m3_storage.py) follow this rule."""
    if len(times) == 0:
        return np.full(len(grid), np.nan)
    idx = np.searchsorted(times, grid, side="right") - 1
    ok = idx >= 0
    sample_t = times[np.maximum(idx, 0)]
    ok &= grid - sample_t < lookback_nanos
    return np.where(ok, vals[np.maximum(idx, 0)], np.nan)


def consolidate(
    series: list[tuple[Tags, np.ndarray, np.ndarray]],
    bounds: Bounds,
    lookback_nanos: int,
) -> Result:
    """Samples → step grid on the host: value at step = last sample in
    (t-lookback, t] (storage/m3/consolidators/ 'last' consolidation)."""
    s = len(series)
    grid = bounds.timestamps()
    out = np.full((s, bounds.steps), np.nan)
    metas = []
    for i, (tags, times, vals) in enumerate(series):
        metas.append(SeriesMeta(tags=tags))
        if len(times) == 0:
            continue
        out[i] = consolidate_row(times, vals, grid, lookback_nanos)
    return Result(values=torch.from_numpy(out), metas=metas)


class Engine:
    """executor.Engine equivalent over a storage with ``fetch_grid``."""

    def __init__(
        self,
        storage: Storage,
        lookback_nanos: int = DEFAULT_LOOKBACK,
        limits=None,
        global_enforcer=None,
        tenant_enforcers=None,
        scheduler=None,
        device="cuda",
    ) -> None:
        self.storage = storage
        self.lookback = lookback_nanos
        # per-query cost limits (query/cost.py); None = unlimited
        self.limits = limits
        self.global_enforcer = global_enforcer
        # per-tenant middle scopes (query/tenants.TenantEnforcers): when
        # set, the enforcer chain is query → tenant → global and each
        # query's parent scope resolves from the thread's tenant context
        self.tenant_enforcers = tenant_enforcers
        # admission scheduler (query/scheduler.QueryScheduler): when set,
        # every TOP-LEVEL query passes cost-aware admission before eval
        # and may be shed with a typed QueryShedError; nested evaluation
        # rides the outer query's slot
        self.scheduler = scheduler
        self.device = resolve_device(device)
        self._enforcer = threading.local()

    def query_range(
        self, query: str, start_nanos: int, end_nanos: int, step_nanos: int
    ) -> Result:
        # one QueryStats record rides a thread-local through engine →
        # storage → database; ``qs`` is None on nested evaluation (an outer
        # query, such as explain's, already owns the record)
        qs = stats.start(query)
        if qs is not None:
            qs.namespace = str(getattr(self.storage, "namespace", "") or "")
        t_start = time.perf_counter()
        err: str | None = None
        admitted = False
        try:
            with stats.stage("parse"):
                ast = parse(query)
            steps = int((end_nanos - start_nanos) // step_nanos) + 1
            bounds = Bounds(start_nanos, step_nanos, steps)
            # @ start()/end() bind to the TOP-LEVEL query range, even inside
            # subqueries (prometheus PreprocessExpr)
            _bind_at(ast, bounds)
            if qs is not None and self.scheduler is not None:
                # cost-aware admission: may block briefly, may shed with a
                # typed QueryShedError; only top-level queries admit. The
                # queue wait is bounded by the caller's propagated deadline
                # when one is ambient, else by the scheduler's own
                # max_queue_wait
                self.scheduler.admit(query, steps, record=qs, deadline=current_deadline())
                admitted = True
            parent = self.global_enforcer
            if self.tenant_enforcers is not None:
                # the per-tenant middle scope: charges flow query → tenant
                # → global, so a runaway tenant trips its own ceiling
                # before it can exhaust everyone's
                parent = self.tenant_enforcers.scope_for(tenants.current())
            if self.limits is None and parent is None:
                return self._eval(ast, bounds)
            enforcer = Enforcer(self.limits if self.limits is not None else QueryLimits(), parent)
            self._enforcer.current = enforcer
            try:
                return self._eval(ast, bounds)
            finally:
                self._enforcer.current = None
                enforcer.release()
        except Exception as exc:
            err = f"{type(exc).__name__}: {exc}"
            if isinstance(exc, QueryLimitError):
                # the record shows which chain scope rejected the query
                # (the outer record when this frame is a nested evaluation)
                cur = stats.current()
                if cur is not None:
                    cur.limit_exceeded = exc.scope
            raise
        finally:
            if admitted:
                self.scheduler.release()
                if err is None and qs is not None:
                    # the matched-series observation prices the NEXT run of
                    # this query from evidence, not the optimistic default
                    self.scheduler.observe(query, qs.series_scanned)
            if qs is not None:
                stats.finish(qs, time.perf_counter() - t_start, error=err)

    def query_instant(self, query: str, time_nanos: int) -> Result:
        return self.query_range(query, time_nanos, time_nanos, NANOS)

    def explain(
        self, query: str, start_nanos: int, end_nanos: int, step_nanos: int
    ) -> dict:
        """EXPLAIN: evaluate the query while recording where its time and
        data went — the per-stage timings, scan counters, the query plan's
        counters and the resident-vs-streamed routing decision per (series,
        block) from the storage adapter. Returns the sealed stats record
        (the reference's keys, for the fields the port records) plus a
        result summary; the query is recorded prefixed ``EXPLAIN``."""
        st = stats.start(f"EXPLAIN {query}")
        if st is not None:
            st.record_routing = True
            st.namespace = str(getattr(self.storage, "namespace", "") or "")
        t_start = time.perf_counter()
        err: str | None = None
        try:
            r = self.query_range(query, start_nanos, end_nanos, step_nanos)
        except Exception as exc:
            err = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            if st is not None:
                stats.finish(st, time.perf_counter() - t_start, error=err)
        out = st.to_dict() if st is not None else {"query": query}
        out["result"] = {
            "series": len(r.metas),
            "steps": int(r.values.shape[1]) if len(r.metas) else 0,
        }
        return out

    def scan_totals(self, query: str, start_nanos: int, end_nanos: int) -> dict:
        """Raw-sample scan as an engine surface: ``query`` must be a plain
        vector selector (e.g. ``metric{job="x"}``); the totals are
        whole-block reductions over the matched series' compressed
        streams, not PromQL semantics (no step grid, no lookback). Routing
        is the storage's: decode-from-residency when every matched block
        is resident, streamed upload and decode otherwise; the result's
        ``path`` says which."""
        storage_scan = getattr(self.storage, "scan_totals", None)
        if storage_scan is None:
            raise ValueError("storage does not support scan_totals")
        qs = stats.start(f"scan_totals({query})")
        if qs is not None:
            qs.namespace = str(getattr(self.storage, "namespace", "") or "")
        t_start = time.perf_counter()
        err: str | None = None
        try:
            with stats.stage("parse"):
                ast = parse(query)
            if not isinstance(ast, VectorSelector):
                raise ValueError("scan_totals: query must be a vector selector")
            if ast.at_nanos is not None or ast.offset_nanos:
                raise ValueError("scan_totals: @/offset modifiers unsupported")
            matchers = list(ast.matchers)
            if ast.name:
                matchers.append(Matcher("__name__", "=", ast.name))
            with stats.stage("fetch"):
                return storage_scan(matchers, start_nanos, end_nanos)
        except Exception as exc:
            err = f"{type(exc).__name__}: {exc}"
            raise
        finally:
            if qs is not None:
                stats.finish(qs, time.perf_counter() - t_start, error=err)

    # --- evaluation ---

    def _charge(self, series: int, datapoints: int) -> None:
        """Charge fetched series + datapoints against the query's cost
        limits (query/cost.go block accounting)."""
        enforcer = getattr(self._enforcer, "current", None)
        if enforcer is not None:
            enforcer.charge(series, datapoints)

    def _fetch(self, sel: VectorSelector, bounds: Bounds, extra_steps: int = 0) -> Result:
        start = bounds.start_nanos - sel.offset_nanos - extra_steps * bounds.step_nanos
        end = bounds.start_nanos - sel.offset_nanos + bounds.step_nanos * bounds.steps
        matchers = list(sel.matchers)
        if sel.name:
            matchers.append(Matcher("__name__", "=", sel.name))
        b = Bounds(start, bounds.step_nanos, bounds.steps + extra_steps)
        grid_fetch = getattr(self.storage, "fetch_grid", None)
        if grid_fetch is not None:
            with stats.stage("fetch"):
                fetched = grid_fetch(
                    matchers, start - self.lookback, end, b.timestamps(), self.lookback
                )
            if fetched is not None:
                metas, values, datapoints = fetched
                stats.add(series=len(metas), datapoints=datapoints)
                self._charge(len(metas), datapoints)
                return Result(values.to(self.device), list(metas))
        # the staged path: raw samples, consolidated on the host
        with stats.stage("fetch"):
            raw = self.storage.fetch(matchers, start - self.lookback, end)
        datapoints = sum(len(t) for _, t, _ in raw)
        stats.add(series=len(raw), datapoints=datapoints)
        self._charge(len(raw), datapoints)
        r = consolidate(raw, b, self.lookback)
        return Result(r.values.to(self.device), r.metas)

    def _eval(self, e: Expr, bounds: Bounds) -> Result:
        if isinstance(e, NumberLiteral):
            return Result(
                torch.full((1, bounds.steps), e.value, dtype=torch.float64, device=self.device),
                [SeriesMeta(())], scalar=True,
            )
        if isinstance(e, VectorSelector):
            if e.at_nanos is not None:
                # @ pins evaluation: one instant, broadcast across steps
                at = _resolve_at(e.at_nanos, bounds)
                r = self._fetch(replace(e, at_nanos=None), Bounds(at, bounds.step_nanos, 1))
                return Result(r.values.repeat(1, bounds.steps), r.metas)
            return self._fetch(e, bounds)
        if isinstance(e, Unary):
            r = self._eval(e.expr, bounds)
            vals = -r.values if e.op == "-" else r.values
            return Result(vals, r.metas, r.scalar)
        if isinstance(e, Call):
            return self._call(e, bounds)
        if isinstance(e, Aggregation):
            return self._aggregate(e, bounds)
        if isinstance(e, BinaryOp):
            return self._binary(e, bounds)
        if isinstance(e, RangeSelector):
            raise ValueError("promql: range selector outside function call")
        if isinstance(e, StringLiteral):
            raise ValueError("promql: string literal in value position")
        raise TypeError(f"unhandled node {e!r}")

    def _range_arg(self, arg: Expr, bounds: Bounds):
        """Range-vector argument → (values, metas, window, step_secs, post).

        ``values`` is a [S, N] sample matrix whose trailing axis a temporal
        function slides its ``window`` over; ``post`` maps the function's
        [S, N - window + 1] output onto the query's [S, steps] grid (identity
        for plain ranges; column re-selection for subqueries, whose samples
        are at the subquery step; broadcast for @-pinned ranges).
        """
        if isinstance(arg, RangeSelector):
            sel = arg.vector
            window = int(arg.range_nanos // bounds.step_nanos) + 1
            extra = window - 1
            step_s = bounds.step_nanos / NANOS
            if sel.at_nanos is not None:
                at = _resolve_at(sel.at_nanos, bounds)
                b_at = Bounds(at - extra * bounds.step_nanos, bounds.step_nanos, window)
                r = self._fetch(replace(sel, at_nanos=None), b_at)

                def post(out, _steps=bounds.steps):
                    return out[:, -1:].repeat(1, _steps)

                return r.values, r.metas, window, step_s, post
            r = self._fetch(sel, bounds, extra_steps=extra)
            return r.values, r.metas, window, step_s, lambda out: out
        if isinstance(arg, Subquery):
            return self._subquery_arg(arg, bounds)
        raise ValueError("promql: function requires a range vector")

    def _subquery_arg(self, sq: Subquery, bounds: Bounds):
        sub_step = sq.step_nanos or bounds.step_nanos
        if sq.at_nanos is not None:
            at = _resolve_at(sq.at_nanos, bounds)
            outer_ts = np.asarray([at - sq.offset_nanos], np.int64)
        else:
            outer_ts = bounds.timestamps() - sq.offset_nanos
        window = int(sq.range_nanos // sub_step) + 1
        # inner evaluation instants align to ABSOLUTE multiples of the
        # subquery step (prometheus subquery semantics), so results don't
        # shift with the outer query's start; the grid extends DOWN past
        # (outer_min - range) so the earliest outer step has a full window
        lo = int(outer_ts.min()) - sq.range_nanos
        g_start = (lo // sub_step) * sub_step
        n_sub = int((int(outer_ts.max()) - g_start) // sub_step) + 1
        sub_bounds = Bounds(g_start, sub_step, n_sub)
        inner = self._eval(sq.expr, sub_bounds)
        grid = sub_bounds.timestamps()
        # output column j of a sliced temporal result ends at grid[j + w - 1];
        # each outer step wants the window ending at the last grid point <= t
        idx = np.searchsorted(grid, outer_ts, side="right") - 1
        cols = np.clip(idx - (window - 1), 0, max(n_sub - window, 0))
        cols = torch.as_tensor(cols, dtype=torch.int64, device=self.device)

        if sq.at_nanos is not None:

            def post(out, _steps=bounds.steps, _cols=cols):
                return out[:, _cols[:1]].repeat(1, _steps)

        else:

            def post(out, _cols=cols):
                return out[:, _cols]

        return inner.values, inner.metas, window, sub_step / NANOS, post

    def _call(self, e: Call, bounds: Bounds) -> Result:
        name = e.func
        if name in TF.FUSABLE or name == "present_over_time":
            vals, metas, w, step_s, post = self._range_arg(e.args[0], bounds)
            if name == "present_over_time":
                c = TF.temporal_apply("count_over_time", vals, w, step_s)
                out = torch.where(c > 0, 1.0, torch.nan).to(torch.float64)
            else:
                out = TF.temporal_apply(name, vals, w, step_s)
            return Result(post(out[:, w - 1:]), metas)
        if name in TW.FUNCTIONS:
            # the scalar parameter comes first for quantile_over_time and
            # after the range for the others
            if name == "quantile_over_time":
                args, rng = (_number(e.args[0]),), e.args[1]
            else:
                args, rng = tuple(_number(a) for a in e.args[1:]), e.args[0]
            vals, metas, w, step_s, post = self._range_arg(rng, bounds)
            out = TW.temporal_window(name, vals, w, step_s, *args, first=w - 1)
            return Result(post(out), metas)
        if name == "label_replace":
            return self._label_replace(e, bounds)
        if name == "label_join":
            return self._label_join(e, bounds)
        if name in L.MATH_FNS:
            r = self._eval(e.args[0], bounds)
            return Result(L.MATH_FNS[name](r.values), r.metas, r.scalar)
        if name == "round":
            r = self._eval(e.args[0], bounds)
            to = _number(e.args[1]) if len(e.args) > 1 else 1.0
            return Result(L.round_to(r.values, to), r.metas, r.scalar)
        if name == "clamp_min":
            r = self._eval(e.args[0], bounds)
            return Result(L.clamp_min(r.values, _number(e.args[1])), r.metas)
        if name == "clamp_max":
            r = self._eval(e.args[0], bounds)
            return Result(L.clamp_max(r.values, _number(e.args[1])), r.metas)
        if name == "clamp":
            r = self._eval(e.args[0], bounds)
            lo, hi = _number(e.args[1]), _number(e.args[2])
            return Result(torch.clamp(r.values, lo, hi), r.metas)
        if name == "histogram_quantile":
            q = _number(e.args[0])
            r = self._eval(e.args[1], bounds)
            index, bnds, metas = L.histogram_buckets(r.metas)
            return Result(L.histogram_quantile(q, r.values, index, bnds), metas)
        if name in ("sort", "sort_desc"):
            r = self._eval(e.args[0], bounds)
            order = L.sort_series(r.values, descending=name == "sort_desc")
            rows = torch.as_tensor(order, dtype=torch.int64, device=r.values.device)
            return Result(r.values[rows], [r.metas[i] for i in order])
        if name == "absent":
            r = self._eval(e.args[0], bounds)
            return Result(A.absent(r.values), [SeriesMeta(())])
        if name == "scalar":
            r = self._eval(e.args[0], bounds)
            if len(r.metas) == 1:
                return Result(r.values[:1], [SeriesMeta(())], scalar=True)
            return Result(self._host_row(np.full(bounds.steps, np.nan)), [SeriesMeta(())],
                          scalar=True)
        if name == "vector":
            r = self._eval(e.args[0], bounds)
            return Result(r.values, [SeriesMeta(())])
        if name == "time":
            return Result(self._host_row(bounds.timestamps() / NANOS), [SeriesMeta(())],
                          scalar=True)
        if name == "timestamp":
            r = self._eval(e.args[0], bounds)
            t = self._host_row(bounds.timestamps() / NANOS)
            return Result(torch.where(torch.isnan(r.values), torch.nan, t), r.metas)
        if name in ("day_of_month", "day_of_week", "days_in_month", "hour", "minute", "month",
                    "year"):
            if e.args:
                r = self._eval(e.args[0], bounds)
                vals, metas = r.values, r.metas
            else:
                vals = self._host_row(bounds.timestamps() / NANOS)
                metas = [SeriesMeta(())]
            return Result(L.datetime_fn(name, vals), metas)
        raise ValueError(f"promql: unsupported function {name}")

    def _host_row(self, row: np.ndarray) -> torch.Tensor:
        """A float64 [1, T] row on the engine's device."""
        return torch.from_numpy(np.asarray(row, np.float64)[None, :]).to(self.device)

    # --- label manipulation (functions/label_replace, label_join —
    # src/query/functions/tag/ in M3) ---

    def _label_replace(self, e: Call, bounds: Bounds) -> Result:
        r = self._eval(e.args[0], bounds)
        dst, repl, src, regex_s = (_string(a) for a in e.args[1:5])
        pattern = _re.compile(regex_s)
        metas = []
        for m in r.metas:
            tags = dict(m.tags)
            val = tags.get(src.encode(), b"").decode()
            mm = pattern.fullmatch(val)
            if mm is not None:
                new = mm.expand(_promql_template(repl))
                if new:
                    tags[dst.encode()] = new.encode()
                else:
                    tags.pop(dst.encode(), None)
            metas.append(SeriesMeta(tags=tuple(sorted(tags.items())), name=m.name))
        return Result(r.values, metas, r.scalar)

    def _label_join(self, e: Call, bounds: Bounds) -> Result:
        r = self._eval(e.args[0], bounds)
        dst = _string(e.args[1])
        sep = _string(e.args[2])
        srcs = [_string(a).encode() for a in e.args[3:]]
        metas = []
        for m in r.metas:
            tags = dict(m.tags)
            joined = sep.encode().join(tags.get(sl, b"") for sl in srcs)
            if joined:
                tags[dst.encode()] = joined
            else:
                tags.pop(dst.encode(), None)
            metas.append(SeriesMeta(tags=tuple(sorted(tags.items())), name=m.name))
        return Result(r.values, metas, r.scalar)

    _GROUPED = {
        "sum": A.grouped_sum,
        "min": A.grouped_min,
        "max": A.grouped_max,
        "avg": A.grouped_avg,
        "count": A.grouped_count,
        "stddev": A.grouped_stddev,
        "stdvar": A.grouped_stdvar,
    }

    def _aggregate(self, e: Aggregation, bounds: Bounds) -> Result:
        r = self._eval(e.expr, bounds)
        if e.op == "count_values":
            label = e.param.value if isinstance(e.param, StringLiteral) else "value"
            out, metas = A.count_values(r.values, r.metas, label.encode())
            return Result(out, metas)
        matching = [g.encode() for g in e.grouping]
        layout = A.group_by_tags(r.metas, matching or None, e.without)
        if e.op in ("topk", "bottomk"):
            k = int(_number(e.param))
            fn = A.topk if e.op == "topk" else A.bottomk
            out = fn(r.values, layout, k)
            keep = np.flatnonzero((~torch.isnan(out)).any(dim=1).cpu().numpy())
            rows = torch.as_tensor(keep, dtype=torch.int64, device=out.device)
            return Result(out[rows], [r.metas[i] for i in keep])
        if e.op == "quantile":
            return Result(A.grouped_quantile(r.values, layout, _number(e.param)), layout.metas)
        return Result(self._GROUPED[e.op](r.values, layout), layout.metas)

    def _binary(self, e: BinaryOp, bounds: Bounds) -> Result:
        lhs = self._eval(e.lhs, bounds)
        rhs = self._eval(e.rhs, bounds)
        lv, rv = lhs.values, rhs.values

        if e.op in ("and", "or", "unless"):
            m = B.VectorMatching(on=e.on, matching_labels=tuple(x.encode() for x in e.matching_labels))
            fn = {"and": B.logical_and, "or": B.logical_or, "unless": B.logical_unless}[e.op]
            vals, metas = fn(lv, rv, lhs.metas, rhs.metas, m)
            return Result(vals, metas)

        is_comp = e.op in B.COMP_FNS
        # scalar op scalar / vector op scalar / scalar op vector
        if lhs.scalar and rhs.scalar:
            return Result(self._apply_scalar(e, lv, rv), lhs.metas, scalar=True)
        if rhs.scalar:
            out = self._apply_scalar(e, lv, rv)  # broadcast [1,T]
            return Result(out, _drop_names(lhs.metas) if not is_comp else lhs.metas)
        if lhs.scalar:
            if is_comp and not e.return_bool:
                cond = B.COMP_FNS[e.op](lv, rv)
                return Result(torch.where(cond, rv, torch.nan), rhs.metas)
            out = self._apply_scalar(e, lv, rv)
            return Result(out, _drop_names(rhs.metas) if not is_comp else rhs.metas)

        # vector op vector
        m = B.VectorMatching(on=e.on, matching_labels=tuple(x.encode() for x in e.matching_labels))
        if e.group_left or e.group_right:
            return self._binary_grouped(e, m, lhs, rhs, is_comp)
        tl, tr, metas = B.intersect(m, lhs.metas, rhs.metas)
        if is_comp:
            out = B.comparison(e.op, lv, rv, tl, tr, e.return_bool)
            metas = [lhs.metas[i] for i in tl] if not e.return_bool else metas
            return Result(out, metas)
        return Result(B.arithmetic(e.op, lv, rv, tl, tr), metas)

    def _binary_grouped(self, e: BinaryOp, m, lhs, rhs, is_comp) -> Result:
        """Many-to-one vector matching (binary.go group_left/group_right):
        each series on the MANY side joins at most one series on the ONE
        side; result keeps the many side's labels, plus any carried labels
        named in group_left(...)/group_right(...)."""
        many, one = (lhs, rhs) if e.group_left else (rhs, lhs)
        one_index: dict = {}
        for j, om in enumerate(one.metas):
            key = B._match_key(om.tags, m)
            if key in one_index:
                raise ValueError(
                    "promql: many-to-many matching: multiple series on the "
                    f"'one' side share match key {key!r}"
                )
            one_index[key] = j
        take_many, take_one, metas = [], [], []
        include = [x.encode() for x in e.include_labels]
        for i, mm in enumerate(many.metas):
            j = one_index.get(B._match_key(mm.tags, m))
            if j is None:
                continue
            take_many.append(i)
            take_one.append(j)
            tags = dict(mm.tags)
            if not is_comp:
                # arithmetic drops the metric name, as in the 1:1 path
                tags.pop(b"__name__", None)
            if include:
                one_tags = dict(one.metas[j].tags)
                for lbl in include:
                    if lbl in one_tags:
                        tags[lbl] = one_tags[lbl]
                    else:
                        tags.pop(lbl, None)
            metas.append(SeriesMeta(tags=tuple(sorted(tags.items())), name=mm.name))
        tm = np.asarray(take_many, np.int32)
        to = np.asarray(take_one, np.int32)
        # orient back to lhs/rhs for the (non-commutative) operator
        tl, tr = (tm, to) if e.group_left else (to, tm)
        if is_comp:
            return Result(B.comparison(e.op, lhs.values, rhs.values, tl, tr, e.return_bool), metas)
        return Result(B.arithmetic(e.op, lhs.values, rhs.values, tl, tr), metas)

    def _apply_scalar(self, e: BinaryOp, lv, rv):
        if e.op in B.COMP_FNS:
            cond = B.COMP_FNS[e.op](lv, rv)
            if e.return_bool:
                return cond.to(torch.float64)
            return torch.where(cond, lv, torch.nan)
        return B.ARITH_FNS[e.op](lv, rv)


def _drop_names(metas: list[SeriesMeta]) -> list[SeriesMeta]:
    return [
        SeriesMeta(tags=tuple((k, v) for k, v in m.tags if k != b"__name__"), name=m.name)
        for m in metas
    ]


def _number(e: Expr | None) -> float:
    if isinstance(e, NumberLiteral):
        return e.value
    if isinstance(e, Unary) and isinstance(e.expr, NumberLiteral):
        return -e.expr.value if e.op == "-" else e.expr.value
    raise ValueError("promql: expected a number literal")


def _string(e: Expr) -> str:
    if isinstance(e, StringLiteral):
        return e.value
    raise ValueError("promql: expected a string literal")


def _bind_at(e, bounds: Bounds) -> None:
    """Resolve @ start()/end() sentinels against the top-level query bounds
    (must run before evaluation: subqueries evaluate their inner expression
    under DIFFERENT bounds, which must not re-bind start/end)."""
    if isinstance(e, VectorSelector):
        if isinstance(e.at_nanos, str):
            e.at_nanos = _resolve_at(e.at_nanos, bounds)
    elif isinstance(e, RangeSelector):
        _bind_at(e.vector, bounds)
    elif isinstance(e, Subquery):
        if isinstance(e.at_nanos, str):
            e.at_nanos = _resolve_at(e.at_nanos, bounds)
        _bind_at(e.expr, bounds)
    elif isinstance(e, Call):
        for a in e.args:
            _bind_at(a, bounds)
    elif isinstance(e, Aggregation):
        _bind_at(e.expr, bounds)
        if e.param is not None:
            _bind_at(e.param, bounds)
    elif isinstance(e, BinaryOp):
        _bind_at(e.lhs, bounds)
        _bind_at(e.rhs, bounds)
    elif isinstance(e, Unary):
        _bind_at(e.expr, bounds)


def _resolve_at(at, bounds: Bounds) -> int:
    """@ modifier value → absolute nanos (start()/end() use the bounds)."""
    if at == "start":
        return bounds.start_nanos
    if at == "end":
        return bounds.start_nanos + bounds.step_nanos * (bounds.steps - 1)
    return int(at)


def _promql_template(repl: str) -> str:
    """label_replace templates use $1/${name}; re.Match.expand wants \\1."""
    out = _re.sub(r"\$\{(\w+)\}", r"\\g<\1>", repl)
    return _re.sub(r"\$(\d+)", r"\\\1", out)
