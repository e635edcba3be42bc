"""In-process downsampler: rule match → aggregation → pipeline → flush.

A copy of ``m3_tpu/aggregator/downsampler.py`` over the port's
``Aggregator``: a flush's rollups run on the aggregator's device, the
rule match and the rollup pipelines on the host.

Reference: M3's src/cmd/services/m3coordinator/downsample/ — the
coordinator embeds an aggregator (`NewDownsampler` options.go:547); incoming
writes pass through metrics_appender.go (rule match, rollup id construction)
into aggregation elems, and flushed values go to storage via flush_handler.go.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable

import numpy as np

from ..block.core import Tags
from ..metrics.policy import StoragePolicy
from ..metrics.transformation import APPLY
from ..metrics.types import AggregationType, MetricType
from ..rules.rules import ActiveRuleSet, RuleSet, encode_tags_id
from .aggregator import AggregatedMetric, Aggregator


@dataclass
class Downsampler:
    """downsamplerAndWriter's downsample half (ingest/write.go:138)."""

    ruleset: RuleSet
    aggregator: Aggregator = field(default_factory=Aggregator)
    # storage sink for flushed aggregated metrics (flush_handler.go)
    sink: Callable[[list[AggregatedMetric]], None] | None = None
    auto_mapping_policies: tuple[StoragePolicy, ...] = ()
    # rollup pipelines keyed by flushed metric identity
    _pipelines: dict[bytes, tuple] = field(default_factory=dict)
    _carry: dict[tuple, tuple] = field(default_factory=dict)
    # active-snapshot cache: ``RuleSet.active_at`` builds a FRESH
    # ActiveRuleSet (losing its per-ID match cache) every call, which
    # re-ran every rule filter on every write. Keyed by the set of
    # active rule indices, so a cutover lands on its exact boundary
    # while every write inside a snapshot reuses the cached matcher —
    # and with it the per-ID forward_match results.
    _active_cache: dict[tuple, ActiveRuleSet] = field(default_factory=dict)
    # tags -> encoded metric id (encode_tags per write dominated after
    # the matcher cache; ids are immutable per tag set)
    _id_cache: dict[Tags, bytes] = field(default_factory=dict)

    def _active_for(self, time_nanos: int) -> ActiveRuleSet:
        key = (
            self.ruleset.version,
            tuple(
                i
                for i, r in enumerate(self.ruleset.mapping_rules)
                if r.cutover_nanos <= time_nanos
            ),
            tuple(
                i
                for i, r in enumerate(self.ruleset.rollup_rules)
                if r.cutover_nanos <= time_nanos
            ),
        )
        active = self._active_cache.get(key)
        if active is None:
            active = self._active_cache[key] = self.ruleset.active_at(time_nanos)
        return active

    def _id_for(self, tags: Tags) -> bytes:
        mid = self._id_cache.get(tags)
        if mid is None:
            mid = self._id_cache[tags] = encode_tags_id(tags)
        return mid

    def write(
        self,
        tags: Tags,
        time_nanos: int,
        value: float,
        mtype: MetricType = MetricType.GAUGE,
    ) -> bool:
        """Returns False when a drop policy matched (metric not persisted
        unaggregated — ingest/write.go shouldWrite)."""
        return self.write_batch([(tags, time_nanos, value, mtype)])[0]

    def write_batch(self, rows) -> list[bool]:
        """Batched ingest: rule evaluation runs once per distinct tag set
        (cached matcher + cached encoded ids), and the aggregator takes
        its lock ONCE for the whole batch instead of per metric. ``rows``
        is ``[(tags, time_nanos, value, mtype)]``; returns the per-row
        keep mask (False = a drop policy matched)."""
        keep: list[bool] = []
        adds: list[tuple] = []
        for tags, time_nanos, value, mtype in rows:
            m = self._active_for(time_nanos).forward_match(tags)
            mid = self._id_for(tags)
            policies = m.policies or self.auto_mapping_policies
            if policies:
                adds.append(
                    (mid, mtype, time_nanos, value, policies,
                     m.aggregations or None)
                )
            for rtags, target in m.rollups:
                rid = self._id_for(rtags)
                self._pipelines[rid] = target.pipeline
                adds.append(
                    (
                        rid,
                        MetricType.GAUGE
                        if mtype == MetricType.GAUGE
                        else MetricType.COUNTER,
                        time_nanos,
                        value,
                        target.policies
                        or policies
                        or self.aggregator.default_policies,
                        target.aggregations or None,
                    )
                )
            keep.append(not m.drop)
        if adds:
            self.aggregator.add_timed_batch(adds)
        return keep

    def flush(self, up_to_nanos: int) -> list[AggregatedMetric]:
        flushed = self.aggregator.flush(up_to_nanos)
        out = []
        # apply rollup pipelines across consecutive flush windows, carrying
        # the previous datapoint across flush() calls (forwarded_writer.go
        # keeps equivalent per-elem state)
        by_key: dict[tuple, list[AggregatedMetric]] = {}
        for m in flushed:
            pipeline = self._pipelines.get(m.id, ())
            if not pipeline:
                out.append(m)
            else:
                by_key.setdefault((m.id, m.policy, m.agg_type), []).append(m)
        for key, ms in by_key.items():
            ms.sort(key=lambda m: m.time_nanos)
            pipeline = self._pipelines[key[0]]
            times = np.asarray([m.time_nanos for m in ms], np.int64)
            values = np.asarray([m.value for m in ms], np.float64)
            carry = self._carry.get(key)
            if carry is not None:
                times = np.concatenate([[carry[0]], times])
                values = np.concatenate([[carry[1]], values])
            t, v = times, values
            for op in pipeline:
                t, v = APPLY[int(op)](t, v)
            self._carry[key] = (int(times[-1]), float(values[-1]))
            start = 1 if carry is not None else 0
            for i in range(start, len(ms) + start):
                if not np.isnan(v[i]):
                    m = ms[i - start]
                    out.append(
                        AggregatedMetric(
                            id=m.id,
                            time_nanos=int(t[i]),
                            value=float(v[i]),
                            policy=m.policy,
                            agg_type=m.agg_type,
                        )
                    )
        if self.sink and out:
            self.sink(out)
        return out
