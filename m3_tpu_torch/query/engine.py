"""Query engine: PromQL range queries over storage blocks, on one device.

Port of the range-query path of ``m3_tpu/query/engine.py``. Every node
evaluates to a dense [S, T] tensor on the engine's device (a [1, T] row
for scalars), so each transform is one vectorized call:

    parse (promql.py) → _fetch: the storage's fetch_grid decodes and
    consolidates the matched series onto the step grid → temporal functions
    (temporal_fused, kernel B2) → grouped aggregations (aggregation.py).

Ported so far: number literals, plain vector selectors, unary minus, the
15 fused temporal functions and ``present_over_time`` over plain range
selectors, and the sum/min/max/avg/count/stddev/stdvar aggregations. The
rest raises ``NotImplementedError`` naming its ROADMAP.md item (§A.1 for
the functions and operators still to port, §A.4 for the scheduler, cost
limits, tenants and stats). ``consolidate_row`` / ``consolidate`` are the
host rule the storage's err-row stitch and the tests use.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Protocol

import numpy as np
import torch

from .. import resolve_device
from ..block.core import Bounds, SeriesMeta, Tags
from .functions import aggregation as A
from .functions import temporal_fused as TF
from .promql import (
    Aggregation,
    BinaryOp,
    Call,
    Expr,
    Matcher,
    NumberLiteral,
    RangeSelector,
    StringLiteral,
    Unary,
    VectorSelector,
    parse,
)

NANOS = 1_000_000_000
DEFAULT_LOOKBACK = 5 * 60 * NANOS

_TODO_FUNCTIONS = "ROADMAP.md §A.1 (non-fused temporal functions, linear.py, binary.py)"


@dataclass
class Result:
    """An evaluated vector: values [S, T] on the engine's device + per-series
    metas (scalar results have one row and scalar=True)."""

    values: torch.Tensor
    metas: list[SeriesMeta]
    scalar: bool = False


class Storage(Protocol):
    """The storage seam: matched series decoded and consolidated onto a
    step grid."""

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

    def __init__(self, storage: Storage, lookback_nanos: int = DEFAULT_LOOKBACK,
                 device="cuda") -> None:
        self.storage = storage
        self.lookback = lookback_nanos
        self.device = resolve_device(device)

    def query_range(
        self, query: str, start_nanos: int, end_nanos: int, step_nanos: int
    ) -> Result:
        ast = parse(query)
        steps = int((end_nanos - start_nanos) // step_nanos) + 1
        return self._eval(ast, Bounds(start_nanos, step_nanos, steps))

    def query_instant(self, query: str, time_nanos: int) -> Result:
        return self.query_range(query, time_nanos, time_nanos, NANOS)

    # --- evaluation ---

    def _fetch(self, sel: VectorSelector, bounds: Bounds, extra_steps: int = 0) -> Result:
        if sel.at_nanos is not None:
            raise NotImplementedError(f"the @ modifier: {_TODO_FUNCTIONS}")
        start = bounds.start_nanos - sel.offset_nanos - extra_steps * bounds.step_nanos
        end = bounds.start_nanos - sel.offset_nanos + bounds.step_nanos * bounds.steps
        matchers = list(sel.matchers)
        if sel.name:
            matchers.append(Matcher("__name__", "=", sel.name))
        b = Bounds(start, bounds.step_nanos, bounds.steps + extra_steps)
        fetched = self.storage.fetch_grid(
            matchers, start - self.lookback, end, b.timestamps(), self.lookback
        )
        if fetched is None:
            raise RuntimeError(
                f"storage cannot serve [{start - self.lookback}, {end}) as a step grid"
            )
        metas, values, _ = fetched
        return Result(values.to(self.device), list(metas))

    def _eval(self, e: Expr, bounds: Bounds) -> Result:
        if isinstance(e, NumberLiteral):
            return Result(
                torch.full((1, bounds.steps), e.value, dtype=torch.float64, device=self.device),
                [SeriesMeta(())], scalar=True,
            )
        if isinstance(e, VectorSelector):
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
            raise NotImplementedError(f"binary operators: {_TODO_FUNCTIONS}")
        if isinstance(e, RangeSelector):
            raise ValueError("promql: range selector outside function call")
        if isinstance(e, StringLiteral):
            raise ValueError("promql: string literal in value position")
        raise NotImplementedError(f"{type(e).__name__}: {_TODO_FUNCTIONS}")

    def _range_arg(self, arg: Expr, bounds: Bounds):
        """Plain range-vector argument → (values [S, N], metas, window,
        step_secs); a temporal function's [S, N] output sliced to
        ``[:, window - 1:]`` is the query's [S, steps] grid."""
        if not isinstance(arg, RangeSelector):
            raise NotImplementedError(f"subqueries and non-range arguments: {_TODO_FUNCTIONS}")
        window = int(arg.range_nanos // bounds.step_nanos) + 1
        r = self._fetch(arg.vector, bounds, extra_steps=window - 1)
        return r.values, r.metas, window, bounds.step_nanos / NANOS

    def _call(self, e: Call, bounds: Bounds) -> Result:
        name = e.func
        if name in TF.FUSABLE or name == "present_over_time":
            vals, metas, w, step_s = self._range_arg(e.args[0], bounds)
            if name == "present_over_time":
                c = TF.temporal_apply("count_over_time", vals, w, step_s)
                out = torch.where(c > 0, 1.0, torch.nan).to(torch.float64)
            else:
                out = TF.temporal_apply(name, vals, w, step_s)
            return Result(out[:, w - 1:], metas)
        raise NotImplementedError(f"function {name}: {_TODO_FUNCTIONS}")

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
        fn = self._GROUPED.get(e.op)
        if fn is None:
            raise NotImplementedError(f"aggregation {e.op}: {_TODO_FUNCTIONS}")
        r = self._eval(e.expr, bounds)
        matching = [g.encode() for g in e.grouping]
        layout = A.group_by_tags(r.metas, matching or None, e.without)
        return Result(fn(r.values, layout), layout.metas)
