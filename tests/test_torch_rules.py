"""The port's rules and metrics modules (``m3_tpu_torch/rules/``,
``m3_tpu_torch/metrics/``) against ``m3_tpu``'s on the CPU: glob and tag
filters, mapping and rollup matches (``RuleSet.active_at``,
``ActiveRuleSet.forward_match``), tag-encoded ids, the transformation
pipelines, storage policies and aggregation types. All exact."""

import numpy as np
import pytest

from m3_tpu.block.core import make_tags as jtags
from m3_tpu.metrics import policy as jpol
from m3_tpu.metrics import transformation as jtr
from m3_tpu.metrics import types as jtypes
from m3_tpu.rules import filters as jf
from m3_tpu.rules import rules as jr
from m3_tpu_torch.block.core import make_tags as ttags
from m3_tpu_torch.metrics import policy as tpol
from m3_tpu_torch.metrics import transformation as ttr
from m3_tpu_torch.metrics import types as ttypes
from m3_tpu_torch.rules import filters as tf
from m3_tpu_torch.rules import rules as tr

NANOS = 1_000_000_000

GLOBS = ["foo*", "*.count", "serv[a-z]ce", "{prod,staging}", "!prod", "a{b,c", "x[y", "*",
         "!*", "m3.*.p[0-9][0-9]", "literal.dots+(parens)"]
VALUES = [b"foobar", b"barfoo", b"requests.count", b"service", b"serv1ce", b"prod",
          b"staging", b"dev", b"", b"a{b,c", b"x[y", b"m3.api.p99", b"literal.dots+(parens)"]


@pytest.mark.parametrize("pattern", GLOBS)
def test_glob_filters_match(pattern):
    assert tf.glob_to_regex(pattern.lstrip("!")) == jf.glob_to_regex(pattern.lstrip("!"))
    a, b = jf.Filter(pattern), tf.Filter(pattern)
    assert b.negated == a.negated
    for v in VALUES:
        assert b.matches(v) == a.matches(v) and b.matches(v.decode()) == a.matches(v.decode())


TAG_SETS = [
    {"service": "auth-api", "env": "prod", "x": "1"},
    {"service": "billing", "env": "prod"},
    {"service": "auth-api"},
    {"service": "auth-x", "env": "debug", "dc": "sjc1"},
    {"service": "auth-api", "type": "timer", "dc": "sjc1", "host": "h1"},
    {"env": "staging"},
    {},
]
TAG_FILTERS = ["service:auth* env:{prod,staging}", "env:!prod", "service:!auth* dc:*",
               "type:timer", "missing:!x"]


@pytest.mark.parametrize("spec", TAG_FILTERS)
def test_tags_filters_match(spec):
    a, b = jf.TagsFilter.parse(spec), tf.TagsFilter.parse(spec)
    assert list(b.filters) == list(a.filters)
    for d in TAG_SETS:
        assert b.matches(ttags(d)) == a.matches(jtags(d)), (spec, d)
    with pytest.raises(ValueError):
        tf.TagsFilter.parse("novalue")


def _ruleset(r, pol, types, tags_filter):
    p10s, p1m = pol.StoragePolicy.parse("10s:2d"), pol.StoragePolicy.parse("1m:40d")
    return r.RuleSet(
        mapping_rules=[
            r.MappingRule("keep-auth", tags_filter.parse("service:auth*"), policies=(p10s, p1m)),
            r.MappingRule("agg-override", tags_filter.parse("service:auth* type:timer"),
                          policies=(p1m,), aggregations=(types.AggregationType.P99,)),
            r.MappingRule("drop-debug", tags_filter.parse("env:debug"), drop=True),
            r.MappingRule("future", tags_filter.parse("service:*"), policies=(p10s,),
                          cutover_nanos=1_700_000_000 * NANOS),
        ],
        rollup_rules=[
            r.RollupRule("per-dc", tags_filter.parse("service:auth*"), targets=(
                r.RollupTarget(new_name=b"auth.requests.by_dc", group_by=(b"dc",),
                               aggregations=(types.AggregationType.SUM,), policies=(p1m,),
                               pipeline=(r.TransformationType.PERSECOND,)),
                r.RollupTarget(new_name=b"auth.requests.by_env", group_by=(b"env", b"dc"),
                               pipeline=(r.TransformationType.INCREASE,
                                         r.TransformationType.ABSOLUTE)),
            )),
            r.RollupRule("later", tags_filter.parse("env:*"), cutover_nanos=1_700_000_000 * NANOS,
                         targets=(r.RollupTarget(new_name=b"env.total", group_by=()),)),
        ],
    )


def _match_key(m):
    return (tuple(str(p) for p in m.policies), tuple(int(a) for a in m.aggregations), m.drop,
            tuple((tags, t.new_name, t.group_by, tuple(int(a) for a in t.aggregations),
                   tuple(str(p) for p in t.policies), tuple(int(x) for x in t.pipeline))
                  for tags, t in m.rollups))


@pytest.mark.parametrize("at", [1_600_000_000 * NANOS, 1_700_000_000 * NANOS])
def test_forward_match_matches(at):
    a = _ruleset(jr, jpol, jtypes, jf.TagsFilter).active_at(at)
    b = _ruleset(tr, tpol, ttypes, tf.TagsFilter).active_at(at)
    assert len(b.mapping_rules) == len(a.mapping_rules)
    for d in TAG_SETS:
        got, want = b.forward_match(ttags(d)), a.forward_match(jtags(d))
        assert _match_key(got) == _match_key(want), d
        assert b.forward_match(ttags(d)) is got  # the per-id cache


@pytest.mark.parametrize("d", TAG_SETS[:5])
def test_tags_ids_match(d):
    tags = ttags(d)
    mid = tr.encode_tags_id(tags)
    assert mid == jr.encode_tags_id(jtags(d))
    assert tr.decode_tags_id(mid) == jr.decode_tags_id(mid) == tags
    assert tr.decode_tags_id(b"") == ()


def _series(seed):
    rng = np.random.default_rng(seed)
    t = np.cumsum(rng.integers(1, 20, 40)).astype(np.int64) * NANOS
    t[7] = t[6]  # a repeated time: binary ops give NaN
    v = np.cumsum(rng.normal(5, 10, 40))
    v[[3, 17]] = np.nan
    return t, v


@pytest.mark.parametrize("pipeline", [(1,), (2,), (3,), (4,), (5,), (3, 1), (2, 4), (1, 2, 3)])
def test_transformation_pipelines_match(pipeline):
    for seed in range(3):
        t, v = _series(seed)
        got, want = ttr.apply_pipeline(pipeline, t, v), jtr.apply_pipeline(pipeline, t, v)
        assert np.array_equal(got[0], want[0])
        assert np.array_equal(got[1], want[1], equal_nan=True)
    assert set(ttr.APPLY) == set(jtr.APPLY)


@pytest.mark.parametrize("s", ["10s:2d", "1m:40d", "1m@1s:40d", "500ms:1h", "1h30m:400d",
                               "2.5s:1d"])
def test_storage_policies_match(s):
    a, b = jpol.StoragePolicy.parse(s), tpol.StoragePolicy.parse(s)
    assert (b.resolution.window_nanos, b.retention.period_nanos, str(b)) == (
        a.resolution.window_nanos, a.retention.period_nanos, str(a))
    assert tpol.parse_policy(s) == b and hash(b) == hash(tpol.StoragePolicy.parse(s))
    for bad in ("10s", "", "10x:2d"):
        with pytest.raises(ValueError):
            tpol.StoragePolicy.parse(bad)


def test_aggregation_types_match():
    for a in jtypes.AggregationType:
        b = ttypes.AggregationType(int(a))
        assert (b.name, b.quantile(), b.type_string, b.is_valid_for_counter(),
                b.is_valid_for_gauge(), b.is_valid_for_timer()) == (
            a.name, a.quantile(), a.type_string, a.is_valid_for_counter(),
            a.is_valid_for_gauge(), a.is_valid_for_timer())
    for m in jtypes.MetricType:
        assert [int(x) for x in ttypes.MetricType(int(m)).default_aggregations()] == [
            int(x) for x in m.default_aggregations()]
    for c, ss, s in ((0, 0.0, 0.0), (1, 4.0, 2.0), (5, 30.0, 10.0), (3, 14.0, 6.0)):
        assert ttypes.stdev(c, ss, s) == jtypes.stdev(c, ss, s)
