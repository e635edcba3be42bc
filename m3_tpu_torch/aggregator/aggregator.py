"""Streaming aggregator: sharded ingest → windowed batch rollups → flush.

Port of ``m3_tpu/aggregator/aggregator.py`` in standalone mode (one
aggregator, always the leader): ``AggregatedMetric``, the per-shard column
buffers, interning, the per-entry rate limit and TTL expiry are host code
copied from the reference; a flush densifies each shard's and policy's
drained datapoints on the host (``kernels.window_keys`` and
``pack_dense_groups``), uploads them, runs kernel B-5a (and B-5b where the
shard holds a metric that asks for a quantile) and reads each result back
in one copy. The replicated mode's ``election=`` and ``flush_times=`` need
the cluster KV store and are not ported yet (ROADMAP §A10).

Reference: M3's src/aggregator/aggregator/ — `aggregator.Aggregator`
(aggregator.go:66+ AddUntimed/AddTimed/AddForwarded), murmur3 shard routing
(:354 shardFor), per-(metric, policy) timed windows (generic_elem.go), and the
leader flush manager draining windows on resolution boundaries
(leader_flush_mgr.go:70).
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .. import resolve_device
from ..metrics.policy import StoragePolicy
from ..metrics.types import AggregationType, MetricType, Untimed
from ..utils.hash import shard_for
from .kernels import (
    FIELDS,
    aggregate_dense_fields,
    dense_quantiles,
    pack_dense_groups,
    window_keys,
)

_TODO_REPLICATION = ("the replicated aggregator (election=, flush_times=) needs the cluster "
                     "KV store, not ported yet (ROADMAP §A10)")

# FIELDS row of each aggregation type that is not a quantile
_FIELD_OF = {
    AggregationType.LAST: FIELDS.index("last"),
    AggregationType.MIN: FIELDS.index("min"),
    AggregationType.MAX: FIELDS.index("max"),
    AggregationType.MEAN: FIELDS.index("mean"),
    AggregationType.COUNT: FIELDS.index("count"),
    AggregationType.SUM: FIELDS.index("sum"),
    AggregationType.SUMSQ: FIELDS.index("sum_sq"),
    AggregationType.STDEV: FIELDS.index("stdev"),
}


@dataclass
class AggregatedMetric:
    """One flushed datapoint (metric/aggregated/types.go Metric)."""

    id: bytes
    time_nanos: int  # window END, like elems flush (generic_elem.go timestamps)
    value: float
    policy: StoragePolicy
    agg_type: AggregationType

    @property
    def suffixed_id(self) -> bytes:
        """id + '.' + type string (types_options.go suffix scheme)."""
        return self.id + b"." + self.agg_type.type_string.encode()


class _PolicyBuffer:
    """Pending raw values for one storage policy within one shard.

    Growable numpy COLUMNS (amortized-doubling appends), not Python
    lists: ingest appends whole value batches with one slice store, and
    a drain hands the flush contiguous array views."""

    __slots__ = ("ids", "times", "values", "types", "n")

    def __init__(self, cap: int = 256) -> None:
        self.ids = np.empty(cap, np.int32)
        self.times = np.empty(cap, np.int64)
        self.values = np.empty(cap, np.float32)
        self.types = np.empty(cap, np.int32)
        self.n = 0

    def _grow(self, need: int) -> None:
        cap = len(self.ids)
        if self.n + need <= cap:
            return
        new_cap = max(cap * 2, self.n + need)
        for name in ("ids", "times", "values", "types"):
            a = getattr(self, name)
            b = np.empty(new_cap, a.dtype)
            b[: self.n] = a[: self.n]
            setattr(self, name, b)

    def extend(self, idx: int, time_nanos: int, values, mtype: int) -> None:
        k = len(values)
        self._grow(k)
        n = self.n
        self.ids[n : n + k] = idx
        self.times[n : n + k] = time_nanos
        self.values[n : n + k] = values
        self.types[n : n + k] = mtype
        self.n = n + k

    def compact(self, keep: np.ndarray) -> None:
        """Retain only ``keep``-masked rows (the unflushed tail), in
        place — fancy-index RHS copies before the slice store."""
        nk = int(keep.sum())
        n = self.n
        self.ids[:nk] = self.ids[:n][keep]
        self.times[:nk] = self.times[:n][keep]
        self.values[:nk] = self.values[:n][keep]
        self.types[:nk] = self.types[:n][keep]
        self.n = nk


class _Shard:
    """aggregatorShard (shard.go): owns interned metric entries + buffers.

    Interned ids play the role of entry.go's per-metric entries: each
    carries a last-write stamp (TTL expiry, entry.go maybeExpire) and a
    token-bucket state for the per-metric value rate limit
    (rate_limit.go)."""

    def __init__(self) -> None:
        self.id_index: dict[bytes, int] = {}
        self.ids: list[bytes] = []
        self.metric_types: list[MetricType] = []
        self.agg_overrides: dict[int, tuple[AggregationType, ...]] = {}
        self.buffers: dict[StoragePolicy, _PolicyBuffer] = {}
        self.last_write: list[int] = []  # nanos, per interned id
        self.rl_tokens: list[float] = []
        self.rl_stamp: list[int] = []  # last refill nanos
        self.rate_limited = 0  # values dropped by the per-entry limit

    def intern(self, mid: bytes, mtype: MetricType) -> int:
        idx = self.id_index.get(mid)
        if idx is None:
            idx = len(self.ids)
            self.id_index[mid] = idx
            self.ids.append(mid)
            self.metric_types.append(mtype)
            self.last_write.append(0)
            self.rl_tokens.append(0.0)
            self.rl_stamp.append(-1)  # -1 = never refilled (0 is a valid time)
        return idx

    def admit(self, idx: int, n_values: int, now_nanos: int, limit: float | None) -> bool:
        """Token-bucket admission at ``limit`` values/sec (burst = one
        second's worth); None = unlimited. A write is admitted whenever the
        bucket is non-empty and may overdraw it (a batch larger than the
        burst is throttled by the resulting debt, not dropped forever)."""
        self.last_write[idx] = max(self.last_write[idx], now_nanos)
        if limit is None:
            return True
        if self.rl_stamp[idx] < 0:
            self.rl_tokens[idx] = limit  # first write: full bucket
        else:
            # out-of-order writes must not rewind the stamp (a rewound
            # stamp hands the next in-order write a spurious refill)
            elapsed = max(now_nanos - self.rl_stamp[idx], 0)
            self.rl_tokens[idx] = min(
                limit, self.rl_tokens[idx] + limit * (elapsed / 1e9)
            )
        self.rl_stamp[idx] = max(self.rl_stamp[idx], now_nanos)
        if self.rl_tokens[idx] > 0:
            self.rl_tokens[idx] -= n_values
            return True
        self.rate_limited += n_values
        return False

    def has_pending(self) -> bool:
        return any(buf.n for buf in self.buffers.values())

    def expire_entries(self, before_nanos: int) -> int:
        """Drop interned ids idle since ``before_nanos`` (entry TTL,
        entry.go ShouldExpire). Only safe with no pending buffered values
        (buffer rows hold indexes); callers run this right after a drain."""
        if self.has_pending():
            return 0
        keep = [
            i for i in range(len(self.ids)) if self.last_write[i] >= before_nanos
        ]
        if len(keep) == len(self.ids):
            return 0
        expired = len(self.ids) - len(keep)
        remap = {old: new for new, old in enumerate(keep)}
        self.ids = [self.ids[i] for i in keep]
        self.metric_types = [self.metric_types[i] for i in keep]
        self.last_write = [self.last_write[i] for i in keep]
        self.rl_tokens = [self.rl_tokens[i] for i in keep]
        self.rl_stamp = [self.rl_stamp[i] for i in keep]
        self.id_index = {mid: i for i, mid in enumerate(self.ids)}
        self.agg_overrides = {
            remap[i]: v for i, v in self.agg_overrides.items() if i in remap
        }
        return expired

    def add(
        self,
        mid: bytes,
        mtype: MetricType,
        time_nanos: int,
        values,
        policies,
        aggregations: tuple[AggregationType, ...] | None = None,
        rate_limit: float | None = None,
    ) -> None:
        idx = self.intern(mid, mtype)
        if aggregations:
            self.agg_overrides[idx] = aggregations
        if not isinstance(values, (list, tuple)):
            values = [values]
        if not self.admit(idx, len(values), time_nanos, rate_limit):
            return
        for policy in policies:
            buf = self.buffers.get(policy)
            if buf is None:
                buf = self.buffers[policy] = _PolicyBuffer()
            buf.extend(idx, time_nanos, values, int(mtype))


class Aggregator:
    """AddUntimed/AddTimed + flush (aggregator.go:181-267), standalone.

    ``flush_handler`` receives list[AggregatedMetric] — the seam where the
    reference hands results to m3msg producers (aggregator/handler/).
    ``device`` (default "cuda", raising without a card) is where a flush's
    rollups run; ``stage_seconds`` adds up the host seconds of each flush
    stage (densify, device, readback, emit) over the aggregator's life."""

    def __init__(
        self,
        num_shards: int = 16,
        default_policies: tuple[StoragePolicy, ...] = (),
        flush_handler: Callable[[list[AggregatedMetric]], None] | None = None,
        election=None,
        flush_times=None,
        value_rate_limit: float | None = None,
        entry_ttl_nanos: int | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        if election is not None or flush_times is not None:
            raise NotImplementedError(_TODO_REPLICATION)
        self.device = resolve_device(device)
        self.num_shards = num_shards
        self.shards = [_Shard() for _ in range(num_shards)]
        self.default_policies = default_policies or (StoragePolicy.parse("10s:2d"),)
        self.flush_handler = flush_handler
        # per-metric value rate limit (values/sec, entry.go rate_limit role)
        self.value_rate_limit = value_rate_limit
        # idle interned entries older than this are dropped after a drain
        # (entry.go ShouldExpire + close cycle)
        self.entry_ttl_nanos = entry_ttl_nanos
        self.expired_entries = 0
        # aggregates drained but not yet delivered (flush_handler raised);
        # retried at the next flush so a transient downstream outage doesn't
        # lose windows
        self._pending_emit: list[AggregatedMetric] = []
        # ingest servers call add_* from handler threads while a flush loop
        # drains; one lock guards the column buffers (entry.go lock role)
        self._lock = threading.Lock()
        self.passthrough_count = 0
        # undelivered passthrough metrics, retried at every flush
        self._pending_passthrough: list[AggregatedMetric] = []
        self.stage_seconds = {"densify": 0.0, "device": 0.0, "readback": 0.0, "emit": 0.0}

    def shard_for(self, mid: bytes) -> int:
        return shard_for(mid, self.num_shards)

    # --- ingest (AddUntimed aggregator.go:181, AddTimed :219) ---

    def add_untimed(
        self,
        metric: Untimed,
        time_nanos: int,
        policies: tuple[StoragePolicy, ...] | None = None,
        aggregations: tuple[AggregationType, ...] | None = None,
    ) -> None:
        shard = self.shards[self.shard_for(metric.id)]
        if metric.type == MetricType.COUNTER:
            values = [float(metric.counter_value)]
        elif metric.type == MetricType.TIMER:
            values = list(metric.batch_timer_values)
        else:
            values = [metric.gauge_value]
        with self._lock:
            shard.add(
                metric.id,
                metric.type,
                time_nanos,
                values,
                policies or self.default_policies,
                aggregations,
                rate_limit=self.value_rate_limit,
            )

    def add_timed(
        self,
        mid: bytes,
        mtype: MetricType,
        time_nanos: int,
        value: float,
        policies: tuple[StoragePolicy, ...] | None = None,
        aggregations: tuple[AggregationType, ...] | None = None,
    ) -> None:
        with self._lock:
            self.shards[self.shard_for(mid)].add(
                mid, mtype, time_nanos, [value],
                policies or self.default_policies, aggregations,
                rate_limit=self.value_rate_limit,
            )

    def add_timed_batch(self, rows) -> None:
        """Batched AddTimed: ``rows`` is ``[(mid, mtype, time_nanos,
        value, policies, aggregations)]``. One lock acquisition for the
        whole batch."""
        with self._lock:
            for mid, mtype, time_nanos, value, policies, aggregations in rows:
                self.shards[self.shard_for(mid)].add(
                    mid, mtype, time_nanos, [value],
                    policies or self.default_policies, aggregations,
                    rate_limit=self.value_rate_limit,
                )

    # AddForwarded: multi-stage rollup input — same buffer path, the pipeline
    # stage lives in rules (forwarded_writer.go equivalence).
    add_forwarded = add_timed

    def add_passthrough(
        self,
        mid: bytes,
        time_nanos: int,
        value: float,
        policy: StoragePolicy,
        agg_type: AggregationType = AggregationType.LAST,
    ) -> None:
        """AddPassthrough (aggregator.go:267-302): an ALREADY-AGGREGATED
        metric is written straight through with its storage policy — no
        windowing, no re-aggregation."""
        m = AggregatedMetric(mid, time_nanos, value, policy, agg_type)
        if self.flush_handler is not None:
            try:
                self.flush_handler([m])
            except Exception:
                # transient downstream outage: park for retry at the next
                # flush (at-least-once)
                with self._lock:
                    self._pending_passthrough.append(m)
        self.passthrough_count += 1

    @property
    def is_leader(self) -> bool:
        return True

    # --- flush (leader_flush_mgr.go drains windows per resolution) ---

    def flush(self, up_to_nanos: int) -> list[AggregatedMetric]:
        out: list[AggregatedMetric] = []
        with self._lock:
            self._drain(up_to_nanos, out)
        # undelivered aggregates stay in _pending_emit and retry next flush;
        # pending handoffs under the lock (ingest threads append
        # passthrough retries concurrently)
        with self._lock:
            pending, self._pending_emit = self._pending_emit, []
            pt_pending, self._pending_passthrough = self._pending_passthrough, []
        if self.flush_handler and (out or pending or pt_pending):
            to_send = pt_pending + pending + out
            try:
                self.flush_handler(to_send)
            except Exception:
                with self._lock:
                    self._pending_passthrough = pt_pending + self._pending_passthrough
                    self._pending_emit = pending + out + self._pending_emit
                raise
        if self.entry_ttl_nanos is not None:
            # drained buffers make expiry safe; idle entries release their
            # interned id slots (entry.go TTL close cycle)
            with self._lock:
                for shard in self.shards:
                    self.expired_entries += shard.expire_entries(
                        up_to_nanos - self.entry_ttl_nanos
                    )
        return out

    @property
    def rate_limited(self) -> int:
        return sum(s.rate_limited for s in self.shards)

    def _drain(self, up_to_nanos, out):
        for shard in self.shards:
            for policy, buf in shard.buffers.items():
                if not buf.n:
                    continue
                res = policy.resolution.window_nanos
                boundary = (up_to_nanos // res) * res
                times = buf.times[: buf.n]
                flushable = times < boundary
                if not flushable.any():
                    continue
                # fancy indexing copies, so the drained columns survive
                # the in-place compaction below
                ids = buf.ids[: buf.n][flushable]
                vals = buf.values[: buf.n][flushable]
                ts = times[flushable]
                buf.compact(~flushable)  # retain unflushed tail
                out.extend(self._flush_policy(shard, policy, ids, ts, vals, res))

    def _flush_policy(self, shard, policy, ids, ts, vals, res) -> list[AggregatedMetric]:
        stages = self.stage_seconds
        t0 = time.perf_counter()
        w0 = int(ts.min() // res) * res
        n_windows = int(ts.max() // res) - int(w0 // res) + 1
        n_metrics = len(shard.ids)
        keys, widx, torder = window_keys(ids, ts, w0, res, n_windows)
        n_groups = n_metrics * n_windows
        dvals, dtor, dvalid = pack_dense_groups(keys, vals, torder, n_groups)
        # quantiles only for shards holding a metric that asks for one
        need_q = sorted(
            {
                q
                for i in range(n_metrics)
                for t in (
                    shard.agg_overrides.get(i) or shard.metric_types[i].default_aggregations()
                )
                for q in [t.quantile()]
                if q is not None
            }
        )
        t1 = time.perf_counter()
        dev = self.device
        dv = torch.from_numpy(dvals).to(dev)
        ok = torch.from_numpy(dvalid).to(dev)
        fields = aggregate_dense_fields(dv, torch.from_numpy(dtor).to(dev), ok)
        qvals = dense_quantiles(dv, ok, tuple(need_q)) if need_q else None
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t2 = time.perf_counter()
        host = fields.cpu().numpy()
        quantiles = {}
        if qvals is not None:
            qhost = qvals.cpu().numpy()
            quantiles = {q: qhost[i] for i, q in enumerate(need_q)}
        t3 = time.perf_counter()
        out = []
        present = np.unique(keys)
        for g in present:
            midx, wi = divmod(int(g), n_windows)
            window_end = w0 + (wi + 1) * res
            aggs = shard.agg_overrides.get(midx) or shard.metric_types[
                midx
            ].default_aggregations()
            for atype in aggs:
                q = atype.quantile()
                v = quantiles[q][g] if q is not None else host[_FIELD_OF[atype]][g]
                out.append(
                    AggregatedMetric(
                        id=shard.ids[midx],
                        time_nanos=window_end,
                        value=float(v),
                        policy=policy,
                        agg_type=atype,
                    )
                )
        t4 = time.perf_counter()
        stages["densify"] += t1 - t0
        stages["device"] += t2 - t1
        stages["readback"] += t3 - t2
        stages["emit"] += t4 - t3
        return out
