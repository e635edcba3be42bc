"""Port parity for PromQL evaluation: binary operators, the linear, label
and time functions, topk/bottomk/quantile/count_values/absent, subqueries,
``@``, cost limits and EXPLAIN (m3_tpu_torch.query against m3_tpu.query).

- Function level: ``binary``, ``linear`` and the new ``aggregation``
  functions of the port against ``m3_tpu.query.functions`` on inputs made
  with numpy from a seed, as ``tests/test_binary_linear.py`` drives them.
- Engine level: the port's ``Engine(..., device="cpu")`` against the JAX
  ``Engine`` on the storages of ``tests/test_torch_query.py`` (gapped and
  mixed M3TSZ blocks), on the series of ``tests/test_promql.py`` and
  ``tests/test_promql_extended.py``, and on a histogram namespace with
  ``le`` tags. Each query's result has equal metas, an equal scalar flag,
  an equal dtype and an equal NaN pattern, and values within 1e-4 abs +
  1e-4 rel (infinities equal). The linear regression (deriv,
  predict_linear) folds its sums in slot order where XLA sums the
  gathered window in its own order: on these inputs the two differ by at
  most 3.1e-3 abs on predict_linear values of ~1e3 (measured), inside the
  same bound.
- Cost limits and EXPLAIN: ``cost.py``'s enforcers trip at the same charge
  with the same scope and release what their parents received; the
  engine stamps the rejecting scope on the query's record; EXPLAIN returns
  the reference's keys for the fields the port records.
"""

import numpy as np
import pytest
import torch

from m3_tpu.block.core import SeriesMeta as JSeriesMeta
from m3_tpu.query import cost as jcost
from m3_tpu.query import engine as jengine
from m3_tpu.query import stats as jstats
from m3_tpu.query.functions import aggregation as jagg
from m3_tpu.query.functions import binary as jB
from m3_tpu.query.functions import linear as jL
from m3_tpu.services.comparator import SyntheticStorage
from m3_tpu_torch.block.core import SeriesMeta, make_tags
from m3_tpu_torch.query import cost as tcost
from m3_tpu_torch.query import engine as tengine
from m3_tpu_torch.query import stats as tstats
from m3_tpu_torch.query.functions import aggregation as tagg
from m3_tpu_torch.query.functions import binary as tB
from m3_tpu_torch.query.functions import linear as tL
from test_torch_query import _HostStorage, _storage, _tags

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS
STEP = 10 * NANOS
_DTYPES = {torch.float32: np.float32, torch.float64: np.float64}


def _assert_same(got, want, what, atol=1e-4, rtol=1e-4):
    """got: a torch tensor; want: the reference's array."""
    w = np.asarray(want)
    assert _DTYPES[got.dtype] == w.dtype, f"{what}: dtype {got.dtype} vs {w.dtype}"
    g = got.numpy()
    assert g.shape == w.shape, f"{what}: shape {g.shape} vs {w.shape}"
    assert np.array_equal(np.isnan(g), np.isnan(w)), f"{what}: NaN pattern differs"
    inf = np.isinf(w)
    assert np.array_equal(g[inf], w[inf]), f"{what}: infinities differ"
    m = ~np.isnan(w) & ~inf
    np.testing.assert_allclose(g[m], w[m], atol=atol, rtol=rtol, err_msg=what)


# ---------------------------------------------------------------------------
# function level
# ---------------------------------------------------------------------------


def _metas(dicts, cls):
    return [cls(tags=make_tags(d)) for d in dicts]


L_TAGS = [{"job": "a", "instance": "1", "__name__": "m1"},
          {"job": "a", "instance": "2", "__name__": "m1"},
          {"job": "b", "instance": "1", "__name__": "m1"},
          {"job": "d", "instance": "4", "__name__": "m1"}]
R_TAGS = [{"job": "a", "instance": "2", "__name__": "m2"},
          {"job": "b", "instance": "1", "__name__": "m2"},
          {"job": "c", "instance": "9", "__name__": "m2"},
          {"job": "a", "instance": "7", "__name__": "m2"}]


def _sides(dtype=np.float32):
    rng = np.random.default_rng(3)
    lv = rng.normal(0, 10, (4, 9)).astype(dtype)
    rv = rng.normal(0, 10, (4, 9)).astype(dtype)
    lv[0, 2] = rv[1, 3] = np.nan
    lv[2, 5] = rv[1, 5] = np.nan
    rv[0, :3] = 0.0
    return lv, rv


MATCHINGS = [(False, ()), (True, (b"job",)), (False, (b"instance",))]


@pytest.mark.parametrize("on,labels", MATCHINGS)
@pytest.mark.parametrize("op", list(jB.ARITH_FNS))
def test_arithmetic_matches_jax(op, on, labels):
    lv, rv = _sides()
    jm, tm = jB.VectorMatching(on, labels), tB.VectorMatching(on, labels)
    jl, jr = _metas(L_TAGS, JSeriesMeta), _metas(R_TAGS, JSeriesMeta)
    tl, tr = _metas(L_TAGS, SeriesMeta), _metas(R_TAGS, SeriesMeta)
    jtl, jtr, jmetas = jB.intersect(jm, jl, jr)
    ttl, ttr, tmetas = tB.intersect(tm, tl, tr)
    np.testing.assert_array_equal(ttl, jtl)
    np.testing.assert_array_equal(ttr, jtr)
    assert [m.tags for m in tmetas] == [m.tags for m in jmetas]
    want = jB.arithmetic(op, lv, rv, jtl, jtr)
    got = tB.arithmetic(op, torch.from_numpy(lv), torch.from_numpy(rv), ttl, ttr)
    _assert_same(got, want, f"{op} on={on} {labels}")


@pytest.mark.parametrize("op", list(jB.ARITH_FNS))
@pytest.mark.parametrize("dtypes", [(np.float64, np.float64), (np.float32, np.float64),
                                    (np.float32, np.float32)])
def test_scalar_arithmetic_dtypes_match_numpy(op, dtypes):
    """The ungathered operators the engine applies between a vector and a
    scalar row: + - * / keep numpy's promotion, ^ and % are float32."""
    lv, rv = _sides(np.float64)
    x, y = lv.astype(dtypes[0]), rv[:1].astype(dtypes[1])
    want = np.asarray(jB.ARITH_FNS[op](x, y))
    got = tB.ARITH_FNS[op](torch.from_numpy(x), torch.from_numpy(y))
    _assert_same(got, want, f"{op} {dtypes}")


@pytest.mark.parametrize("return_bool", [False, True])
@pytest.mark.parametrize("op", list(jB.COMP_FNS))
def test_comparison_matches_jax(op, return_bool):
    lv, rv = _sides()
    rv[2, :4] = lv[2, :4]  # equal values on some steps
    m = tB.VectorMatching()
    tl, tr, _ = tB.intersect(m, _metas(L_TAGS, SeriesMeta), _metas(R_TAGS, SeriesMeta))
    want = jB.comparison(op, lv, rv, tl, tr, return_bool)
    got = tB.comparison(op, torch.from_numpy(lv), torch.from_numpy(rv), tl, tr, return_bool)
    _assert_same(got, want, f"{op} bool={return_bool}")


@pytest.mark.parametrize("on,labels", MATCHINGS + [(True, (b"nope",))])
@pytest.mark.parametrize("fn", ["logical_and", "logical_or", "logical_unless"])
def test_logical_ops_match_jax(fn, on, labels):
    lv, rv = _sides()
    jm, tm = jB.VectorMatching(on, labels), tB.VectorMatching(on, labels)
    wv, wm = getattr(jB, fn)(lv, rv, _metas(L_TAGS, JSeriesMeta), _metas(R_TAGS, JSeriesMeta), jm)
    gv, gm = getattr(tB, fn)(torch.from_numpy(lv), torch.from_numpy(rv),
                             _metas(L_TAGS, SeriesMeta), _metas(R_TAGS, SeriesMeta), tm)
    assert [m.tags for m in gm] == [m.tags for m in wm]
    _assert_same(gv, wv, fn)


def test_logical_ops_with_an_empty_side():
    lv, rv = _sides()
    m, jm = tB.VectorMatching(), jB.VectorMatching()
    for fn in ("logical_and", "logical_or", "logical_unless"):
        wv, wm = getattr(jB, fn)(lv, rv[:0], _metas(L_TAGS, JSeriesMeta), [], jm)
        gv, gm = getattr(tB, fn)(torch.from_numpy(lv), torch.from_numpy(rv[:0]),
                                 _metas(L_TAGS, SeriesMeta), [], m)
        assert [x.tags for x in gm] == [x.tags for x in wm]
        _assert_same(gv, wv, fn)


def _linear_values(dtype):
    rng = np.random.default_rng(11)
    v = rng.normal(0, 40, (5, 12)).astype(dtype)
    v[0, :3] = [2.5, -2.5, 0.5]
    v[1, 4] = np.nan
    v[2, 5] = -0.0
    return v


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("name", list(jL.MATH_FNS) + ["round", "round_to_5", "clamp_min",
                                                       "clamp_max"])
def test_linear_functions_match_jax(name, dtype):
    v = _linear_values(dtype)
    if name in ("sqrt", "ln", "log2", "log10"):
        v = np.abs(v)
    if name == "exp":
        v = v / 10
    calls = {"round": lambda L, x: L.round_to(x),
             "round_to_5": lambda L, x: L.round_to(x, 5.0),
             "clamp_min": lambda L, x: L.clamp_min(x, 3.0),
             "clamp_max": lambda L, x: L.clamp_max(x, -1.5)}
    call = calls.get(name, lambda L, x: L.MATH_FNS[name](x))
    _assert_same(call(tL, torch.from_numpy(v)), call(jL, v), f"{name} {dtype.__name__}",
                 atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("descending", [False, True])
def test_sort_series_matches_jax(descending):
    v = _linear_values(np.float32)
    v[3, -1] = np.nan
    v[4, -1] = v[0, -1]
    got = tL.sort_series(torch.from_numpy(v), descending)
    np.testing.assert_array_equal(got, jL.sort_series(v, descending))


@pytest.mark.parametrize("name", ["day_of_month", "day_of_week", "days_in_month", "hour",
                                  "minute", "month", "year"])
def test_datetime_fn_matches_jax(name):
    t = np.asarray([[0.0, 1_600_000_000.0, np.nan, 951_782_400.0, 4_102_444_799.0]])
    got = tL.datetime_fn(name, torch.from_numpy(t))
    _assert_same(got, jL.datetime_fn(name, t), name)


def _histogram():
    """Three histograms (a, b, c) with buckets out of order, one group
    without a +Inf bucket (dropped) and one with a single bucket; counts
    cumulative with a non-monotonic dip, NaN steps and empty steps."""
    rng = np.random.default_rng(4)
    les = ["0.1", "+Inf", "0.5", "1", "-0.2"]
    dicts, rows = [], []
    for job in ("a", "b", "c"):
        base = np.sort(rng.uniform(0, 50, (len(les), 10)), axis=0)
        order = np.argsort([float(x) for x in les])
        for k, le in enumerate(les):
            dicts.append({"job": job, "le": le})
            rows.append(base[np.where(order == k)[0][0]])
    dicts += [{"job": "x", "le": "1"}, {"job": "x", "le": "2"}, {"job": "y", "le": "+Inf"},
              {"job": "z"}]
    rows += [rng.uniform(0, 5, 10) for _ in range(4)]
    v = np.asarray(rows, np.float32)
    v[2, 3] = v[2, 3] + 30  # a dip the monotonic pass repairs
    v[6, :2] = np.nan
    v[10:15, 7] = np.nan
    return dicts, v


@pytest.mark.parametrize("q", [-0.5, 0.0, 0.25, 0.5, 0.9, 1.0, 1.5])
def test_histogram_quantile_matches_jax(q):
    dicts, v = _histogram()
    ji, jb, jm = jL.histogram_buckets(_metas(dicts, JSeriesMeta))
    ti, tb, tm = tL.histogram_buckets(_metas(dicts, SeriesMeta))
    np.testing.assert_array_equal(ti, ji)
    np.testing.assert_array_equal(tb, jb)
    assert [m.tags for m in tm] == [m.tags for m in jm]
    _assert_same(tL.histogram_quantile(q, torch.from_numpy(v), ti, tb),
                 jL.histogram_quantile(q, v, ji, jb), f"q={q}")


def _agg_case(seed=5):
    rng = np.random.default_rng(seed)
    v = rng.normal(10, 3, (30, 16)).astype(np.float32)
    v[rng.random(v.shape) < 0.2] = np.nan
    v[::3, :4] = np.nan  # one group empty at these steps
    v[1, 8] = v[4, 8] = v[7, 8]  # ties
    v[2, 9] = np.inf
    v[5, 9] = -np.inf
    tags = [make_tags({"job": f"j{i % 3}", "host": f"h{i}"}) for i in range(30)]
    return v, tags


GROUPINGS = [(None, False), ([b"job"], False), ([b"host"], True)]


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("fn,k", [("topk", 1), ("topk", 3), ("topk", 50), ("bottomk", 2),
                                  ("bottomk", 1)])
def test_take_matches_jax(fn, k, grouping):
    v, tags = _agg_case()
    jl = jagg.group_by_tags([JSeriesMeta(tags=t) for t in tags], *grouping)
    tl = tagg.group_by_tags([SeriesMeta(tags=t) for t in tags], *grouping)
    _assert_same(getattr(tagg, fn)(torch.from_numpy(v), tl, k),
                 getattr(jagg, fn)(v, jl, k), f"{fn} k={k}")


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("q", [-0.5, 0.0, 0.3, 0.5, 0.99, 1.0, 2.0])
def test_grouped_quantile_matches_jax(q, grouping):
    v, tags = _agg_case()
    jl = jagg.group_by_tags([JSeriesMeta(tags=t) for t in tags], *grouping)
    tl = tagg.group_by_tags([SeriesMeta(tags=t) for t in tags], *grouping)
    _assert_same(tagg.grouped_quantile(torch.from_numpy(v), tl, q),
                 jagg.grouped_quantile(v, jl, q), f"q={q}")


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_absent_and_count_values_match_jax(dtype):
    v, tags = _agg_case()
    v = np.round(v / 4).astype(dtype)
    v[:, 0] = np.nan
    _assert_same(tagg.absent(torch.from_numpy(v)), jagg.absent(v), "absent")
    _assert_same(tagg.absent(torch.from_numpy(v[:0])), jagg.absent(v[:0]), "absent of none")
    gv, gm = tagg.count_values(torch.from_numpy(v), [SeriesMeta(tags=t) for t in tags], b"v")
    wv, wm = jagg.count_values(v, [JSeriesMeta(tags=t) for t in tags], b"v")
    assert [m.tags for m in gm] == [m.tags for m in wm]
    _assert_same(gv, wv, "count_values")


# ---------------------------------------------------------------------------
# engine level
# ---------------------------------------------------------------------------


class _RawStorage:
    """The engines' staged seam over raw samples held in memory: (tags,
    times, values) per series; matchers as the comparator applies them."""

    def __init__(self, series):
        self.series = series

    def fetch(self, matchers, start, end):
        out = []
        for tags, ts, vs in self.series:
            if SyntheticStorage._match(tags, matchers):
                keep = (ts >= start) & (ts < end)
                out.append((tags, ts[keep], vs[keep]))
        return out


def _assert_results(got, want, what):
    assert [m.tags for m in got.metas] == [m.tags for m in want.metas], f"{what}: metas"
    assert [m.name for m in got.metas] == [m.name for m in want.metas], f"{what}: names"
    assert got.scalar == want.scalar, f"{what}: scalar flag"
    assert got.values.device.type == "cpu"
    _assert_same(got.values, want.values, what)


def _both(storage, query, start, end, step, lookback, **kw):
    want = jengine.Engine(storage[0], lookback_nanos=lookback).query_range(query, start, end, step)
    got = tengine.Engine(storage[1], lookback_nanos=lookback, device="cpu", **kw).query_range(
        query, start, end, step)
    return got, want


SEL = 'm3_scan{job="job-1"}'
RATE = 'rate(m3_scan{job=~"job-[0-3]"}[1m])'
AT = (T0 + 400 * NANOS) // NANOS

BLOCK_QUERIES = [
    # vector op scalar, scalar op vector, scalar op scalar
    f"{SEL} + 1", f"{SEL} - 2.5", f"{SEL} * 3", f"{SEL} / 4", f"{SEL} ^ 2", f"{SEL} % 7",
    f"2 - {SEL}", f"100 / {SEL}", f"3 % {SEL}", f"-{SEL} + 1",
    "1 + 2 * 3", "2 ^ 3 ^ 2", "7 % 3", "5 > bool 3", "5 == 5", "-(4 - 1.5)",
    # comparisons, filter and bool, both orders
    f"{SEL} > 50", f"{SEL} >= 50", f"{SEL} < 50", f"{SEL} <= 50", f"{SEL} == 50.5",
    f"{SEL} != 50.5", f"{SEL} > bool 50", f"{SEL} != bool 50", f"50 < {SEL}",
    f"50 >= bool {SEL}",
    # vector op vector: 1:1, on / ignoring, many-to-one with carried labels
    f"{SEL} - {SEL} offset 1m", f"{SEL} > {SEL} offset 30s",
    f"{SEL} > bool {SEL} offset 30s", f"{SEL} / ignoring(host) {SEL} offset 1m",
    f"{RATE} / on(job) group_left sum by (job) ({RATE})",
    f"sum by (job) ({RATE}) * on(job) group_right {RATE}",
    f"{RATE} > on(job) group_left avg by (job) ({RATE})",
    f'{SEL} * on(job) group_left(tier) label_replace(max by (job) ({SEL}), "tier", "t-$1", '
    '"job", "job-(.*)")',
    # set operators
    f'{SEL} and m3_scan{{host=~"h1.*"}}', f'{SEL} or m3_scan{{job="job-2"}}',
    f'm3_scan{{job=~"job-[12]"}} unless m3_scan{{job="job-2"}}',
    f'{SEL} and on(job) m3_scan{{job="job-1", host="h6"}}',
    f"{SEL} > 50 or {SEL} offset 1m", f"{SEL} unless {SEL} > 51",
    # the B-7 functions
    f"deriv({SEL}[1m])", f"deriv({SEL}[5m])", f"predict_linear({SEL}[5m], 600)",
    f"predict_linear({SEL}[1m], -30)", f"holt_winters({SEL}[2m], 0.3, 0.6)",
    f"holt_winters({SEL}[5m], 0.1, 0.9)", f"quantile_over_time(0.5, {SEL}[1m])",
    f"quantile_over_time(0.99, {SEL}[5m])", f"quantile_over_time(-1, {SEL}[1m])",
    f"quantile_over_time(2, {SEL}[1m])",
    # math, rounding, clamps
    f"abs(-{SEL})", f"ceil({SEL})", f"floor({SEL})", f"exp({SEL} / 50)", f"sqrt({SEL})",
    f"ln({SEL})", f"log2({SEL})", f"log10({SEL})", f"round({SEL})", f"round({SEL}, 0.5)",
    f"clamp_min({SEL}, 50)", f"clamp_max({SEL}, 50)", f"clamp({SEL}, 49, 51)",
    f"clamp(rate({SEL}[1m]), -0.01, 0.01)", "abs(-3)", "round(2.5)",
    # sort, absent, scalar, vector, time, timestamp, datetime
    f"sort({SEL})", f"sort_desc({SEL})", 'absent(m3_scan{job="nope"})', f"absent({SEL})",
    f"scalar(sum({SEL}))", f"scalar({SEL})", "vector(1)", "vector(time())", "time()",
    f"timestamp({SEL})", "day_of_month()", "day_of_week()", "days_in_month()", "hour()",
    "minute()", "month()", "year()", f"minute(timestamp({SEL}))", f"hour({SEL} * 3600)",
    # labels
    f'label_replace({SEL}, "idx", "$1", "host", "h(.*)")',
    f'label_replace({SEL}, "job", "", "job", ".*")',
    f'label_replace({SEL}, "x", "${{1}}-y", "host", "zz(.*)")',
    f'label_join({SEL}, "jh", "/", "job", "host")', f'label_join({SEL}, "job", "-", "none")',
    # aggregations
    f"topk(3, {RATE})", f"bottomk(2, {SEL})", f"topk by (job) (1, {RATE})",
    f"bottomk without (host) (2, {RATE})", f"quantile(0.9, {RATE})",
    f"quantile by (job) (0.5, {RATE})", f"quantile(-1, {SEL})",
    f'count_values("v", round({SEL}))', f"count_values(round({SEL} / 2))",
    f"sum by (job) (topk(2, {SEL}))",
    # subqueries and @
    f"max_over_time(rate({SEL}[1m])[5m:1m])", f"avg_over_time({SEL}[2m:])",
    f"deriv({SEL}[5m:30s])", f"quantile_over_time(0.5, {SEL}[3m:1m])",
    f"last_over_time({SEL}[3m:1m] offset 1m)",
    f"{SEL} @ start()", f"{SEL} @ end()", f"{SEL} @ {AT}", f"rate({SEL}[1m] @ end())",
    f"deriv({SEL}[2m] @ {AT})", f"max_over_time(({SEL} @ start())[5m:1m])",
    f"max_over_time(rate({SEL}[1m])[5m:1m] @ {AT})",
    f"sum by (job) ({SEL} @ end()) - sum by (job) ({SEL})",
    # the queries the port refused before it evaluated them
    "m3_scan + 1", "topk(3, m3_scan)", "deriv(m3_scan[1m])", "rate(m3_scan[5m:1m])",
    "m3_scan @ 1600000000",
]


@pytest.mark.parametrize("kind", ["gapped", "mixed"])
@pytest.mark.parametrize("query", BLOCK_QUERIES)
def test_engine_matches_jax_engine(kind, query):
    storage = _storage(kind)
    pair = (_HostStorage(storage.streams, _tags()), storage)
    got, want = _both(pair, query, T0 + 60 * NANOS, T0 + 1150 * NANOS, STEP, 30 * NANOS)
    _assert_results(got, want, query)


def test_many_to_many_is_refused():
    storage = _storage("gapped")
    pair = (_HostStorage(storage.streams, _tags()), storage)
    q = f"{SEL} * on(job) group_left {SEL}"
    with pytest.raises(ValueError, match="many-to-many"):
        _both(pair, q, T0 + 60 * NANOS, T0 + 600 * NANOS, STEP, 30 * NANOS)


def _promql_series():
    """The series of tests/test_promql.py and tests/test_promql_extended.py:
    counters req_total (two jobs x hosts) and req, the gauge temp and the
    info series job_info, 120 points at 10 s."""
    out = []

    def add(tags, vals):
        ts = T0 + STEP * np.arange(len(vals), dtype=np.int64)
        out.append((make_tags(tags), ts, np.asarray(vals, np.float64)))

    i = np.arange(120, dtype=np.float64)
    for job, host, slope in [("api", "a", 10.0), ("api", "b", 20.0), ("db", "a", 5.0)]:
        add({"__name__": "req_total", "job": job, "host": host}, slope * i)
    add({"__name__": "temp", "host": "a"}, 50.0 + (i % 5))
    for job, host, slope in [("api", "a", 10.0), ("api", "b", 20.0)]:
        add({"__name__": "req", "job": job, "host": host}, slope * i)
    add({"__name__": "job_info", "job": "api", "env": "prod"}, np.ones(120))
    return out


PROMQL_QUERIES = [
    'req_total{job="api"}', 'rate(req_total{job="api", host="a"}[1m])',
    "sum by (job) (rate(req_total[1m]))", 'req_total{job="db"} * 2',
    "sum by (job) (rate(req_total[1m])) > 1",
    'rate(req_total{host="a"}[1m]) / on(job) sum by (job) (rate(req_total[1m]))',
    "clamp_max(abs(-temp), 52)", "avg_over_time(temp[50s])", "absent(nonexistent_metric)",
    "topk(1, rate(req_total[1m]))", f'req{{job="api", host="a"}} @ {(T0 + 70 * STEP) // NANOS}',
    'req{host="a"} @ start()', 'req{host="a"} @ end()', 'rate(req{host="a"}[5m] @ end())',
    'max_over_time(rate(req{host="a"}[1m])[5m:1m])', 'avg_over_time(req{host="a"}[2m:])',
    'last_over_time(req{host="a"}[3m:1m])', 'max_over_time((req{host="a"} @ start())[5m:1m])',
    'label_replace(req{host="a"}, "shard", "$1", "job", "(ap)i")',
    'label_replace(req{host="a"}, "shard", "$1", "job", "(zz)x")',
    'label_join(req{host="a"}, "jh", "-", "job", "host")',
    "req * on (job) group_left (env) job_info", "job_info * on (job) group_right () req",
    "deriv(req[2m])", "predict_linear(req_total[1m], 60)", "holt_winters(temp[1m], 0.5, 0.5)",
    "quantile_over_time(0.9, temp[1m])", "sum(req_total)",
]


@pytest.mark.parametrize("query", PROMQL_QUERIES)
def test_engine_matches_jax_on_promql_series(query):
    raw = _RawStorage(_promql_series())
    got, want = _both((raw, raw), query, T0 + 60 * STEP, T0 + 80 * STEP, STEP,
                      jengine.DEFAULT_LOOKBACK)
    _assert_results(got, want, query)


def test_promql_series_instant_query():
    raw = _RawStorage(_promql_series())
    want = jengine.Engine(raw).query_instant("sum(req_total)", T0 + 40 * STEP)
    got = tengine.Engine(raw, device="cpu").query_instant("sum(req_total)", T0 + 40 * STEP)
    _assert_results(got, want, "instant sum(req_total)")
    assert float(got.values[0, -1]) == pytest.approx(35.0 * 40)


def _histogram_series():
    dicts, v = _histogram()
    series = []
    rng = np.random.default_rng(8)
    for d, row in zip(dicts, v):
        # a counter per bucket: the row's values as increments
        inc = np.abs(np.nan_to_num(np.repeat(row, 12))) + rng.uniform(0, 1, 120)
        ts = T0 + STEP * np.arange(120, dtype=np.int64)
        series.append((make_tags({"__name__": "http_bucket", **d}), ts, np.cumsum(inc)))
    return series


@pytest.mark.parametrize("query", [
    "histogram_quantile(0.9, rate(http_bucket[1m]))",
    "histogram_quantile(0.5, sum by (le) (rate(http_bucket[1m])))",
    "histogram_quantile(0.99, http_bucket)", "histogram_quantile(-1, rate(http_bucket[1m]))",
    "histogram_quantile(2, rate(http_bucket[1m]))",
])
def test_engine_histogram_quantile_matches_jax(query):
    raw = _RawStorage(_histogram_series())
    got, want = _both((raw, raw), query, T0 + 60 * STEP, T0 + 110 * STEP, STEP,
                      jengine.DEFAULT_LOOKBACK)
    assert len(want.metas) == (1 if "sum by (le)" in query else 3)
    _assert_results(got, want, query)


# ---------------------------------------------------------------------------
# cost limits and EXPLAIN
# ---------------------------------------------------------------------------


def _charges(mod, limits, global_limits, charges):
    """Charge (series, datapoints) pairs into a query enforcer under a
    global one until a charge raises: (index of the raising charge, scope,
    what, the global's totals after release)."""
    glob = mod.GlobalEnforcer(mod.QueryLimits(*global_limits))
    enf = mod.Enforcer(mod.QueryLimits(*limits), glob)
    tripped = (None, None, None)
    for i, (s, d) in enumerate(charges):
        try:
            enf.charge(s, d)
        except mod.QueryLimitError as e:
            tripped = (i, e.scope, e.what)
            break
    held = (glob.series, glob.datapoints)
    enf.release()
    return tripped, held, (glob.series, glob.datapoints)


@pytest.mark.parametrize("limits,global_limits", [
    ((3, 0), (0, 0)), ((0, 100), (0, 0)), ((0, 0), (4, 0)), ((0, 0), (0, 50)),
    ((10, 1000), (2, 60)), ((0, 0), (0, 0)),
])
def test_enforcers_match_jax(limits, global_limits):
    charges = [(1, 20), (1, 20), (2, 30), (1, 40), (5, 100)]
    got = _charges(tcost, limits, global_limits, charges)
    want = _charges(jcost, limits, global_limits, charges)
    assert got == want
    assert got[2] == (0, 0)  # release returns everything the parent received


def test_global_enforcer_chain_matches_jax():
    for mod in (tcost, jcost):
        top = mod.GlobalEnforcer(mod.QueryLimits(max_series=5), scope="global")
        mid = mod.GlobalEnforcer(mod.QueryLimits(max_series=3), scope="middle", what="tier",
                                 parent=top)
        a = mod.Enforcer(mod.QueryLimits(), mid)
        a.charge(2, 10)
        with pytest.raises(mod.QueryLimitError) as e:
            a.charge(2, 10)
        assert (e.value.scope, e.value.what, e.value.used, e.value.limit) == (
            "middle", "tier series", 4, 3)
        assert (top.series, mid.series) == (4, 4)
        a.release()
        assert (top.series, top.datapoints, mid.series, mid.datapoints) == (0, 0, 0, 0)


@pytest.mark.parametrize("limits,global_limits,scope", [
    ({"max_series": 10}, None, "query"), ({"max_datapoints": 200}, None, "query"),
    (None, {"max_series": 5}, "global"),
])
def test_engine_limits_stamp_the_record(limits, global_limits, scope):
    """The same query trips the same scope in both engines, stamped on the
    active record; the global scope gets back what the query charged."""
    storage = _storage("gapped")
    pairs = [(jengine, jcost, jstats, _HostStorage(storage.streams, _tags())),
             (tengine, tcost, tstats, storage)]
    seen = []
    for eng_mod, cost_mod, stats_mod, st in pairs:
        glob = cost_mod.GlobalEnforcer(cost_mod.QueryLimits(**global_limits)) if global_limits \
            else None
        kw = {} if eng_mod is jengine else {"device": "cpu"}
        eng = eng_mod.Engine(st, lookback_nanos=30 * NANOS,
                             limits=cost_mod.QueryLimits(**limits) if limits else None,
                             global_enforcer=glob, **kw)
        rec = stats_mod.start("outer")
        try:
            with pytest.raises(cost_mod.QueryLimitError) as e:
                eng.query_range(f"sum({SEL})", T0 + 60 * NANOS, T0 + 600 * NANOS, STEP)
        finally:
            stats_mod.finish(rec, 0.0)
        assert rec.limit_exceeded == e.value.scope == scope
        assert rec.to_dict()["limitExceeded"] == scope
        if glob is not None:
            assert (glob.series, glob.datapoints) == (0, 0)
        seen.append((e.value.what, e.value.used, e.value.limit))
    assert seen[0] == seen[1]


def test_engine_limits_pass_a_small_query():
    storage = _storage("gapped")
    eng = tengine.Engine(storage, lookback_nanos=30 * NANOS, device="cpu",
                         limits=tcost.QueryLimits(max_series=19, max_datapoints=10**6))
    r = eng.query_range(SEL, T0 + 60 * NANOS, T0 + 600 * NANOS, STEP)
    assert len(r.metas) == 19


def test_explain_returns_the_reference_keys():
    storage = _storage("gapped")
    q = f"sum by (job) (rate({SEL}[1m]))"
    want = jengine.Engine(_HostStorage(storage.streams, _tags()), lookback_nanos=30 * NANOS
                          ).explain(q, T0 + 60 * NANOS, T0 + 600 * NANOS, STEP)
    got = tengine.Engine(storage, lookback_nanos=30 * NANOS, device="cpu").explain(
        q, T0 + 60 * NANOS, T0 + 600 * NANOS, STEP)
    # every key the port records is the reference's, and the reference has
    # no other but the SLO objectives, present only while an SLO engine has
    # installed its resolver (ROADMAP §A10)
    assert set(got) <= set(want)
    assert set(want) - set(got) <= {"sloObjectives"}
    for key in ("tenant", "queueState", "priority"):
        assert got[key] == want[key], key
    # BlockStorage resolves its matchers on its device index tier, the host
    # storage the reference runs on has none
    assert (got["indexDeviceHits"], got["indexDeviceMisses"]) == (1, 0)
    assert got["query"] == want["query"] == f"EXPLAIN {q}"
    assert got["result"] == want["result"] == {"series": 1, "steps": 55}
    assert set(got["stages"]) >= {"parse", "fetch", "exec"}
    assert set(got["stages"]) <= set(want["stages"]) | {"index_resolve", "decode"}
    assert got["seriesScanned"] == want["seriesScanned"] == 19
    assert got["routingDropped"] == 0
    assert all(set(r) == {"series", "block", "path", "reason"} for r in got["routing"])
    assert got["error"] is None and got["limitExceeded"] is None
