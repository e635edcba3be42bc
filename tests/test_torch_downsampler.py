"""The port's ``Downsampler`` (``m3_tpu_torch/aggregator/downsampler.py``)
against ``m3_tpu``'s on the CPU: the scenarios of
``tests/test_downsampler.py`` (a mapping rule, a drop rule and a rollup
rule with a per-second pipeline whose carry spans two flushes) and a
seeded multi-host, multi-window run. The flushed metrics (id, time, type,
policy, value) are exact."""

import math

import numpy as np
import pytest

from m3_tpu.aggregator import aggregator as jagg
from m3_tpu.aggregator import downsampler as jds
from m3_tpu.block.core import make_tags as jtags
from m3_tpu.metrics import policy as jpol
from m3_tpu.metrics import types as jtypes
from m3_tpu.rules import filters as jf
from m3_tpu.rules import rules as jr
from m3_tpu_torch.aggregator import aggregator as tagg
from m3_tpu_torch.aggregator import downsampler as tds
from m3_tpu_torch.block.core import make_tags as ttags
from m3_tpu_torch.metrics import policy as tpol
from m3_tpu_torch.metrics import types as ttypes
from m3_tpu_torch.rules import filters as tf
from m3_tpu_torch.rules import rules as tr

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS

JAX = (jds, jagg, jpol, jtypes, jf, jr, jtags, {})
PORT = (tds, tagg, tpol, ttypes, tf, tr, ttags, {"device": "cpu"})


def build(pkg, pipeline=("PERSECOND",), aggs=("SUM",)):
    ds, agg, pol, types, filters, rules, _, kw = pkg
    p = pol.StoragePolicy.parse("10s:2d")
    rs = rules.RuleSet(
        mapping_rules=[
            rules.MappingRule("map", filters.TagsFilter.parse("service:auth"), policies=(p,)),
            rules.MappingRule("drop", filters.TagsFilter.parse("service:noisy"), drop=True),
        ],
        rollup_rules=[
            rules.RollupRule("rollup", filters.TagsFilter.parse("service:auth"), targets=(
                rules.RollupTarget(
                    new_name=b"auth.total", group_by=(b"dc",),
                    aggregations=tuple(types.AggregationType[a] for a in aggs), policies=(p,),
                    pipeline=tuple(rules.TransformationType[x] for x in pipeline)),
            )),
        ],
    )
    return ds.Downsampler(ruleset=rs, aggregator=agg.Aggregator(num_shards=4, **kw))


def _flat(metrics):
    return sorted((m.id, m.time_nanos, int(m.agg_type), str(m.policy),
                   "nan" if math.isnan(m.value) else float(m.value)) for m in metrics)


def _write(pkg, ds, host, dc, t, v, kind="COUNTER"):
    tags = pkg[6]({"__name__": "req", "service": "auth", "dc": dc, "host": host})
    return ds.write(tags, t, v, pkg[3].MetricType[kind])


def test_write_and_rollup_pipeline_match():
    """tests/test_downsampler.py's scenario, both packages side by side."""
    j, t = build(JAX), build(PORT)
    for w, (va, vb) in enumerate([(10, 20), (30, 40), (60, 70)]):
        at = T0 + w * 10 * NANOS + NANOS
        for pkg, ds in ((JAX, j), (PORT, t)):
            assert _write(pkg, ds, "a", "sjc", at, va) and _write(pkg, ds, "b", "sjc", at, vb)
    got, want = t.flush(T0 + 40 * NANOS), j.flush(T0 + 40 * NANOS)
    assert _flat(got) == _flat(want)
    rollups = sorted((m for m in got if b"auth.total" in m.id), key=lambda m: m.time_nanos)
    assert [m.value for m in rollups] == pytest.approx([4.0, 6.0])
    at = T0 + 31 * NANOS
    for pkg, ds in ((JAX, j), (PORT, t)):
        _write(pkg, ds, "a", "sjc", at, 100)
        _write(pkg, ds, "b", "sjc", at, 100)
    got, want = t.flush(T0 + 60 * NANOS), j.flush(T0 + 60 * NANOS)
    assert _flat(got) == _flat(want)
    assert [m.value for m in got if b"auth.total" in m.id] == pytest.approx([7.0])


def test_drop_policy_matches():
    j, t = build(JAX), build(PORT)
    assert t.write(ttags({"service": "noisy", "dc": "x"}), T0, 1.0) is False
    assert j.write(jtags({"service": "noisy", "dc": "x"}), T0, 1.0) is False
    assert t.flush(T0 + 40 * NANOS) == [] and j.flush(T0 + 40 * NANOS) == []


@pytest.mark.parametrize("pipeline,aggs", [
    (("PERSECOND",), ("SUM",)),
    (("INCREASE",), ("SUM", "MAX")),
    (("ADD", "ABSOLUTE"), ("MEAN", "P99")),
    ((), ("SUM", "COUNT")),
])
def test_seeded_traffic_matches(pipeline, aggs):
    """Three dcs of 20 hosts, counters and gauges, out of order, written in
    batches across four windows and three flushes."""
    rng = np.random.default_rng(len(pipeline) * 10 + len(aggs))
    j, t = build(JAX, pipeline, aggs), build(PORT, pipeline, aggs)
    rows = []
    for _ in range(600):
        h = int(rng.integers(0, 60))
        rows.append((f"h{h}", f"dc{h % 3}", T0 + int(rng.integers(0, 60 * NANOS)),
                     float(rng.integers(0, 1000)), "GAUGE" if h % 4 == 0 else "COUNTER"))
    for at in (25, 45, 70):
        batch = [r for r in rows if (at - 20) * NANOS <= r[2] - T0 < at * NANOS]
        for pkg, ds in ((JAX, j), (PORT, t)):
            ds.write_batch([(pkg[6]({"__name__": "req", "service": "auth", "dc": dc,
                                     "host": host}), ts, v, pkg[3].MetricType[kind])
                            for host, dc, ts, v, kind in batch])
        assert _flat(t.flush(T0 + at * NANOS)) == _flat(j.flush(T0 + at * NANOS))
