"""Metrics domain model: aggregation types and metric types.

A copy of ``m3_tpu/metrics/types.py``: the aggregator tier's plain
Python domain model, kept here so the port imports nothing of the JAX
package.

Reference: M3's src/metrics/aggregation/type.go (type ids and
validity per metric kind, :25-175) and src/metrics/metric/types.go.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass, field


class AggregationType(enum.IntEnum):
    # Order matches type.go:32-55 so wire ids are compatible.
    UNKNOWN = 0
    LAST = 1
    MIN = 2
    MAX = 3
    MEAN = 4
    MEDIAN = 5
    COUNT = 6
    SUM = 7
    SUMSQ = 8
    STDEV = 9
    P10 = 10
    P20 = 11
    P30 = 12
    P40 = 13
    P50 = 14
    P60 = 15
    P70 = 16
    P80 = 17
    P90 = 18
    P95 = 19
    P99 = 20
    P999 = 21
    P9999 = 22

    def quantile(self) -> float | None:
        return _QUANTILES.get(self)

    def is_valid_for_counter(self) -> bool:
        # type.go:140-146
        return self in (
            AggregationType.MIN,
            AggregationType.MAX,
            AggregationType.MEAN,
            AggregationType.COUNT,
            AggregationType.SUM,
            AggregationType.SUMSQ,
            AggregationType.STDEV,
        )

    def is_valid_for_gauge(self) -> bool:
        return self in (
            AggregationType.LAST,
            AggregationType.MIN,
            AggregationType.MAX,
            AggregationType.MEAN,
            AggregationType.COUNT,
            AggregationType.SUM,
            AggregationType.SUMSQ,
            AggregationType.STDEV,
        )

    def is_valid_for_timer(self) -> bool:
        return self != AggregationType.UNKNOWN and self != AggregationType.LAST

    @property
    def type_string(self) -> str:
        # types_options.go defaultTypeStringsMap (lower/upper for min/max)
        return _TYPE_STRINGS.get(self, self.name.lower())


_QUANTILES = {
    AggregationType.MEDIAN: 0.5,
    AggregationType.P10: 0.1,
    AggregationType.P20: 0.2,
    AggregationType.P30: 0.3,
    AggregationType.P40: 0.4,
    AggregationType.P50: 0.5,
    AggregationType.P60: 0.6,
    AggregationType.P70: 0.7,
    AggregationType.P80: 0.8,
    AggregationType.P90: 0.9,
    AggregationType.P95: 0.95,
    AggregationType.P99: 0.99,
    AggregationType.P999: 0.999,
    AggregationType.P9999: 0.9999,
}

_TYPE_STRINGS = {
    AggregationType.LAST: "last",
    AggregationType.SUM: "sum",
    AggregationType.SUMSQ: "sum_sq",
    AggregationType.MEAN: "mean",
    AggregationType.MIN: "lower",
    AggregationType.MAX: "upper",
    AggregationType.COUNT: "count",
    AggregationType.STDEV: "stdev",
    AggregationType.MEDIAN: "median",
    AggregationType.P50: "p50",
    AggregationType.P95: "p95",
    AggregationType.P99: "p99",
}

# Defaults per metric type (types_options.go:125-143)
DEFAULT_COUNTER_AGGREGATIONS = (AggregationType.SUM,)
DEFAULT_TIMER_AGGREGATIONS = (
    AggregationType.SUM,
    AggregationType.SUMSQ,
    AggregationType.MEAN,
    AggregationType.MIN,
    AggregationType.MAX,
    AggregationType.COUNT,
    AggregationType.STDEV,
    AggregationType.MEDIAN,
    AggregationType.P50,
    AggregationType.P95,
    AggregationType.P99,
)
DEFAULT_GAUGE_AGGREGATIONS = (AggregationType.LAST,)


class MetricType(enum.IntEnum):
    UNKNOWN = 0
    COUNTER = 1
    TIMER = 2
    GAUGE = 3

    def default_aggregations(self):
        return {
            MetricType.COUNTER: DEFAULT_COUNTER_AGGREGATIONS,
            MetricType.TIMER: DEFAULT_TIMER_AGGREGATIONS,
            MetricType.GAUGE: DEFAULT_GAUGE_AGGREGATIONS,
        }.get(self, ())


def stdev(count, sum_sq, s):
    """Sample stdev exactly as aggregation/common.go:29-36 (0 when n < 2)."""
    div = count * (count - 1)
    if div == 0:
        return 0.0
    return math.sqrt((count * sum_sq - s * s) / div)


@dataclass
class Untimed:
    """Untimed metric union (metric/unaggregated/types.go)."""

    type: MetricType
    id: bytes
    counter_value: int = 0
    batch_timer_values: list[float] = field(default_factory=list)
    gauge_value: float = 0.0
    annotation: bytes = b""


@dataclass
class Timed:
    """Timed metric (metric/aggregated/types.go)."""

    type: MetricType
    id: bytes
    time_nanos: int
    value: float
    annotation: bytes = b""
