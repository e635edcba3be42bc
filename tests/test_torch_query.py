"""Port parity for the range-query path (m3_tpu_torch.query).

- ``BlockStorage.fetch_grid`` (records decode + device consolidation + the
  err-row host stitch) equals ``m3_tpu.query.engine.consolidate`` of the
  host-decoded samples bit for bit in float64, on jittered, gapped
  timestamps with lookbacks shorter than a gap.
- Tag matching follows the JAX storage path: ``m3_tpu``'s
  ``search_segment`` of ``matchers_to_index_query`` over a segment of the
  same tags (a missing tag matches no term).
- The grouped aggregations equal ``m3_tpu.query.functions.aggregation``.
- The whole slice: the port's ``Engine(BlockStorage(..., device="cpu"))``
  equals the JAX ``Engine`` over a storage that decodes the same streams
  with ``m3_tpu.codec``, within 1e-4 abs + 1e-4 rel, with identical NaN
  patterns and metas.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from m3_tpu.block.core import Bounds as JBounds
from m3_tpu.block.core import SeriesMeta as JSeriesMeta
from m3_tpu.codec.m3tsz import Encoder
from m3_tpu.codec.m3tsz import decode as jdecode
from m3_tpu.index.query import search_segment as jsearch_segment
from m3_tpu.index.segment import Document as JDocument
from m3_tpu.index.segment import MutableSegment as JMutableSegment
from m3_tpu.query import engine as jengine
from m3_tpu.query.functions import aggregation as jagg
from m3_tpu.query.m3_storage import matchers_to_index_query as jmatchers_to_index_query
from m3_tpu.query.promql import Matcher as JMatcher
from m3_tpu.services.comparator import SyntheticStorage
from m3_tpu.utils import synthetic as jsyn
from m3_tpu_torch.block.core import SeriesMeta, make_tags
from m3_tpu_torch.ops import _build
from m3_tpu_torch.query import engine as tengine
from m3_tpu_torch.query.functions import aggregation as tagg
from m3_tpu_torch.query.m3_storage import BlockStorage
from m3_tpu_torch.query.promql import Matcher

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS
N_SERIES, N_POINTS, K = 96, 120, 24


def _gapped_streams(n_unique=24, seed=21):
    """Gauge streams at 10 s with +-2 s jitter and 1-3 gaps of 40-150 s.
    Values hover around 50: on a trending row the reference's
    stddev_over_time (E[x^2] - mean^2 about the row's f32 mean) moves with
    the rounding of that mean, which XLA and torch sum in different orders
    (TOLERANCE.md: "degraded when stddev << |mean|")."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n_unique):
        ts = T0 + NANOS * (10 * np.arange(N_POINTS) + rng.integers(-2, 3, N_POINTS))
        keep = np.ones(N_POINTS, bool)
        for _ in range(rng.integers(1, 4)):
            a = int(rng.integers(5, N_POINTS - 20))
            keep[a : a + int(rng.integers(4, 16))] = False
        vals = np.round(50 + rng.normal(0, 2, N_POINTS), 2)
        enc = Encoder(int(ts[0]))
        for t, v in zip(ts[keep], vals[keep]):
            enc.encode(int(t), float(v))
        out.append(enc.stream())
    return out


def _streams(kind):
    if kind == "gapped":
        return _gapped_streams()
    # floats, counters, unit changes and annotated streams (err rows)
    return jsyn.synthetic_mixed_streams(24, N_POINTS, seed=31, frac_float=0.3,
                                        frac_tu_change=0.1, frac_annotation=0.1)


def _tags(n=N_SERIES):
    return [make_tags({"__name__": "m3_scan", "job": f"job-{i % 5}", "host": f"h{i}"})
            for i in range(n)]


_storages = {}


def _storage(kind):
    if kind not in _storages:
        _storages[kind] = BlockStorage(_streams(kind), _tags(), k=K, device="cpu")
    return _storages[kind]


def _host_series(streams, tags, matchers, start, end):
    out = []
    for i, t in enumerate(tags):
        if SyntheticStorage._match(t, matchers):
            dps = [dp for dp in jdecode(streams[i % len(streams)]) if start <= dp.timestamp < end]
            out.append((t, np.asarray([d.timestamp for d in dps], np.int64),
                        np.asarray([d.value for d in dps], np.float64)))
    return out


@pytest.mark.parametrize("kind", ["gapped", "mixed"])
@pytest.mark.parametrize("lookback_s", [5, 25, 300])
def test_fetch_grid_matches_host_consolidate(kind, lookback_s):
    storage = _storage(kind)
    lookback = lookback_s * NANOS
    bounds = JBounds(T0 + 35 * NANOS, 7 * NANOS, 160)
    start, end = bounds.start_nanos - lookback, bounds.end_nanos
    matchers = [Matcher("job", "!=", "job-2"), Matcher("__name__", "=", "m3_scan")]
    metas, values, datapoints = storage.fetch_grid(
        matchers, start, end, bounds.timestamps(), lookback)
    raw = _host_series(storage.streams, _tags(),
                       [JMatcher(m.name, m.op, m.value) for m in matchers], start, end)
    want = jengine.consolidate(raw, bounds, lookback)
    assert [m.tags for m in metas] == [m.tags for m in want.metas]
    assert values.dtype == torch.float64
    np.testing.assert_array_equal(values.numpy().view(np.int64), want.values.view(np.int64))
    # the device's count of valid records, as the reference's plan counts
    # them: a series whose decode errs counts its records up to the error
    host_count = sum(len(t) for _, t, _ in raw)
    assert datapoints == host_count if kind == "gapped" else 0 < datapoints < host_count
    if lookback_s == 5:
        assert np.isnan(want.values).any()  # the lookback is shorter than the gaps


@pytest.mark.parametrize("matchers", [
    [("job", "=", "job-1")],
    [("job", "!=", "job-1"), ("host", "=~", "h1.*")],
    [("host", "!~", "h[0-4]?[0-9]")],
    [("missing", "=", "")],
    [("missing", "!=", "")],
    [("__name__", "=~", "m3_.+"), ("job", "=~", "job-(0|3)")],
])
def test_match_follows_comparator(matchers):
    """The oracle is m3_tpu's index search over the same tags, as the JAX
    storage path resolves matchers (the comparator reads a missing tag as
    "", so {missing=""} and {missing!=""} answer differently there)."""
    storage = _storage("gapped")
    got = storage.match([Matcher(*m) for m in matchers]).tolist()
    seg = JMutableSegment()
    for i, t in enumerate(_tags()):
        seg.insert(JDocument(b"s%d" % i, t))
    q = jmatchers_to_index_query([JMatcher(*m) for m in matchers])
    want = jsearch_segment(seg.seal(), q).tolist()
    assert got == want
    if matchers == [("missing", "=", "")]:
        assert got == []
    if matchers == [("missing", "!=", "")]:
        assert got == list(range(N_SERIES))


def _agg_values():
    rng = np.random.default_rng(5)
    v = rng.normal(10, 3, (N_SERIES, 40)).astype(np.float32)
    v[rng.random(v.shape) < 0.2] = np.nan
    v[::5, :7] = np.nan  # every member of group 0 missing at these steps
    return v


@pytest.mark.parametrize("op", ["sum", "count", "avg", "min", "max", "stdvar", "stddev"])
@pytest.mark.parametrize("grouping", [("by", ["job"]), ("without", ["host"]), ("by", [])])
def test_grouped_ops_match_jax(op, grouping):
    v = _agg_values()
    tags = _tags()
    how, labels = grouping
    matching = [x.encode() for x in labels] or None
    jl = jagg.group_by_tags([JSeriesMeta(tags=t) for t in tags], matching, how == "without")
    tl = tagg.group_by_tags([SeriesMeta(tags=t) for t in tags], matching, how == "without")
    np.testing.assert_array_equal(tl.group_ids, jl.group_ids)
    np.testing.assert_array_equal(tl.pad_index, jl.pad_index)
    assert [m.tags for m in tl.metas] == [m.tags for m in jl.metas]
    want = np.asarray(getattr(jagg, f"grouped_{op}")(v, jl))
    got = getattr(tagg, f"grouped_{op}")(torch.from_numpy(v), tl).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(np.isnan(got), np.isnan(want))
    m = ~np.isnan(want)
    np.testing.assert_allclose(got[m], want[m], rtol=1e-5, atol=1e-5)


def _signed_zero_values():
    """Values whose groups hold +0, -0 and NaN together: whole columns of
    signed zeros in mixed orders, columns of one sign, an all-NaN column,
    and random values with zeros and NaN sprinkled in."""
    rng = np.random.default_rng(9)
    v = rng.normal(0, 3, (N_SERIES, 48)).astype(np.float32)
    roll = rng.random(v.shape)
    v[roll < 0.15] = 0.0
    v[(roll >= 0.15) & (roll < 0.3)] = -0.0
    v[(roll >= 0.3) & (roll < 0.45)] = np.nan
    v[:, :6] = np.where(rng.random((N_SERIES, 6)) < 0.5, 0.0, -0.0)
    v[:, 6] = -0.0
    v[:, 7] = 0.0
    v[:, 8] = np.nan
    v[::3, 9] = np.nan
    v[1::3, 9] = -0.0
    v[2::3, 9] = 0.0
    return v


def _bits_equal(got, want):
    return (np.array_equal(np.isnan(got), np.isnan(want))
            and np.array_equal(np.where(np.isnan(got), 0, got).view(np.int32),
                               np.where(np.isnan(want), 0, want).view(np.int32)))


@pytest.mark.parametrize("op", ["sum", "count", "avg", "min", "max", "stdvar", "stddev"])
@pytest.mark.parametrize("grouping", [("by", ["job"]), ("by", [])])
def test_grouped_ops_bit_identical_with_signed_zeros(op, grouping):
    """The twin (K3's CPU path) equals m3_tpu bit for bit, signed zeros
    included: min/max order -0 below +0 as XLA does, and stddev is the
    correctly rounded root."""
    v = _signed_zero_values()
    tags = _tags()
    matching = [x.encode() for x in grouping[1]] or None
    jl = jagg.group_by_tags([JSeriesMeta(tags=t) for t in tags], matching)
    tl = tagg.group_by_tags([SeriesMeta(tags=t) for t in tags], matching)
    want = np.asarray(getattr(jagg, f"grouped_{op}")(v, jl))
    got = getattr(tagg, f"grouped_{op}")(torch.from_numpy(v), tl).numpy()
    assert _bits_equal(got, want)
    if op in ("min", "max"):
        zero = got[:, :8] == 0
        assert zero.any() and np.signbit(got[:, :8][zero]).any()


@pytest.fixture(scope="module")
def host_k3(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("kernel") / "grouped_reduce_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(out), str(_build.SOURCES["grouped_reduce"][0])],
        check=True, capture_output=True, text=True,
    )
    fn = ctypes.CDLL(str(out)).m3_grouped_reduce_host
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    fn.argtypes = [P, I64, P, I64, I64, I, I, P]  # ..., op, column-block width (0: by shape), out
    fn.restype = I
    return fn


def _k3_wide_values(n_series=1100, steps=723, seed=17):
    """Values for K3's forced widths: T = 723 (odd, so rows are not 16-byte
    aligned and the last column block is ragged at every width), with +0,
    -0 and NaN in every group, an all-NaN column and a column of zeros."""
    rng = np.random.default_rng(seed)
    v = rng.normal(0, 40, (n_series, steps)).astype(np.float32)
    roll = rng.random(v.shape)
    v[roll < 0.1] = 0.0
    v[(roll >= 0.1) & (roll < 0.2)] = -0.0
    v[(roll >= 0.2) & (roll < 0.3)] = np.nan
    v[:, 5] = np.nan
    v[:, 700] = np.where(rng.random(n_series) < 0.5, 0.0, -0.0)
    return v


@pytest.mark.parametrize("op", tagg.OPS)
@pytest.mark.parametrize("values", ["signed_zeros", "agg", "t723_wc8", "t723_wc16", "t723_wc32"])
def test_k3_source_host_build_matches_twin(host_k3, op, values):
    """K3's host build == its twin bit for bit. The t723 cases force each
    column-block width on [1100, 723] values: one group of 1,100 members is
    longer than the ring at every width (1,024 members at WC 8 and 16, 512
    at 32), and five groups of 220 end inside a batch."""
    if values.startswith("t723"):
        v = _k3_wide_values()
        tags = _tags(v.shape[0])
        wc = int(values.split("wc")[1])
        groupings = (([b"job"], False), (None, False))
    else:
        v = _signed_zero_values() if values == "signed_zeros" else _agg_values()
        tags = _tags()
        wc = 0
        groupings = (([b"job"], False), ([b"host"], True), (None, False))
    for matching, without in groupings:
        tl = tagg.group_by_tags([SeriesMeta(tags=t) for t in tags], matching, without)
        pad = np.ascontiguousarray(tl.pad_index, np.int32)
        out = np.zeros((tl.num_groups, v.shape[1]), np.float32)
        assert host_k3(v.ctypes.data, v.shape[1], pad.ctypes.data, pad.shape[0], pad.shape[1],
                       tagg.OPS.index(op), wc, out.ctypes.data) == 0
        assert _bits_equal(out, tagg.grouped_reduce(torch.from_numpy(v), tl, op).numpy())


def test_launch_error_names_each_tensor():
    """A wrapper's launch error carries each launch tensor's shape, stride,
    dtype and data pointer (tensors passed as None are left out)."""
    a = torch.zeros((3, 4), dtype=torch.int32)[:, 1:]
    b = torch.zeros(5)
    e = _build.launch_error("k", 700, windows=a, flags=None, out=b)
    assert isinstance(e, RuntimeError)
    assert str(e) == (f"k kernel launch failed: CUDA error 700; windows shape (3, 3) stride (4, 1) "
                      f"torch.int32 at 0x{a.data_ptr():x}; out shape (5,) stride (1,) "
                      f"torch.float32 at 0x{b.data_ptr():x}")


class _HostStorage:
    """The JAX engine's storage seam over the same streams, decoded with
    m3_tpu.codec."""

    def __init__(self, streams, tags):
        self.streams, self.tags = streams, tags

    def fetch(self, matchers, start, end):
        return _host_series(self.streams, self.tags, matchers, start, end)


QUERIES = [f"{agg} ({fn}(m3_scan{{job=~\"job-[0-3]\"}}[1m]))"
           for fn in ("rate", "increase", "avg_over_time", "stddev_over_time", "changes")
           for agg in ("sum by (job)", "avg by (job)", "max without (host)")]


@pytest.mark.parametrize("kind", ["gapped", "mixed"])
@pytest.mark.parametrize("query", QUERIES)
def test_engine_matches_jax_engine(kind, query):
    storage = _storage(kind)
    lookback = 30 * NANOS
    start, end, step = T0 + 60 * NANOS, T0 + 1150 * NANOS, 10 * NANOS
    want = jengine.Engine(_HostStorage(storage.streams, _tags()), lookback_nanos=lookback
                          ).query_range(query, start, end, step)
    got = tengine.Engine(storage, lookback_nanos=lookback, device="cpu"
                         ).query_range(query, start, end, step)
    assert [m.tags for m in got.metas] == [m.tags for m in want.metas]
    w = np.asarray(want.values, np.float64)
    g = got.values.numpy().astype(np.float64)
    assert g.shape == w.shape == (4, 110)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    m = ~np.isnan(w)
    assert m.any()
    np.testing.assert_allclose(g[m], w[m], rtol=1e-4, atol=1e-4)


def test_engine_selector_literal_unary_and_present():
    storage = _storage("gapped")
    eng = tengine.Engine(storage, lookback_nanos=30 * NANOS, device="cpu")
    start, end, step = T0 + 60 * NANOS, T0 + 600 * NANOS, 10 * NANOS
    sel = eng.query_range('-m3_scan{host="h7"}', start, end, step)
    want = jengine.Engine(_HostStorage(storage.streams, _tags()), lookback_nanos=30 * NANOS
                          ).query_range('-m3_scan{host="h7"}', start, end, step)
    np.testing.assert_array_equal(sel.values.numpy(), np.asarray(want.values))
    assert [m.tags for m in sel.metas] == [m.tags for m in want.metas]
    lit = eng.query_range("4.5", start, end, step)
    assert lit.scalar and lit.values.shape == (1, 55) and bool((lit.values == 4.5).all())
    pres = eng.query_instant('count(present_over_time(m3_scan{job="job-1"}[1m]))', start)
    assert pres.values.shape == (1, 1) and float(pres.values[0, 0]) == N_SERIES // 5


@pytest.mark.parametrize("option", ["scheduler", "tenant_enforcers"])
def test_engine_scheduler_and_tenant_scopes(option):
    """``scheduler=`` and ``tenant_enforcers=`` against the JAX engine's on
    the same query and tenants: the admitted query's values, the cost memo
    it fed, a shed (scheduler) or a tenant-scope rejection
    (tenant_enforcers) with the same error, and the ledger charges."""
    from m3_tpu.query import scheduler as jsched
    from m3_tpu.query import tenants as jtenants
    from m3_tpu.query.cost import QueryLimitError as JQueryLimitError
    from m3_tpu.query.cost import QueryLimits as JQueryLimits
    from m3_tpu_torch.query import scheduler as tsched
    from m3_tpu_torch.query import tenants as ttenants
    from m3_tpu_torch.query.cost import QueryLimitError, QueryLimits

    storage = _storage("gapped")
    q = QUERIES[0]
    start, end, step = T0 + 60 * NANOS, T0 + 1150 * NANOS, 10 * NANOS
    sides = []
    for tenants, sched, limits, error, make in (
            (jtenants, jsched, JQueryLimits, JQueryLimitError,
             lambda **kw: jengine.Engine(_HostStorage(storage.streams, _tags()),
                                         lookback_nanos=30 * NANOS, **kw)),
            (ttenants, tsched, QueryLimits, QueryLimitError,
             lambda **kw: tengine.Engine(storage, lookback_nanos=30 * NANOS, device="cpu",
                                         **kw))):
        if option == "scheduler":
            s = sched.QueryScheduler(max_inflight=1, max_queue=4, max_queue_wait=0.05)
            eng = make(scheduler=s)
            with tenants.tenant_context("q-admitted"):
                r = eng.query_range(q, start, end, step)
            s.admit("elsewhere", 1)
            with tenants.tenant_context("q-shed"), pytest.raises(sched.QueryShedError) as ei:
                eng.query_range(q, start, end, step)
            s.release()
            outcome = (ei.value.reason, ei.value.tenant, s.costs.series_estimate(q),
                       s.snapshot()["inflight"])
        else:
            te = tenants.TenantEnforcers({"q-capped": limits(max_series=10)})
            eng = make(tenant_enforcers=te)
            with tenants.tenant_context("q-free"):
                r = eng.query_range(q, start, end, step)
            with tenants.tenant_context("q-capped"), pytest.raises(error) as ei:
                eng.query_range(q, start, end, step)
            outcome = (ei.value.scope, str(ei.value), te.scope_for("q-capped").series)
        sides.append((r, outcome))
    (want, jout), (got, tout) = sides
    assert tout == jout
    assert tout == (("deadline", "q-shed", 77, 0) if option == "scheduler"
                    else ("tenant", "query limit exceeded: tenant q-capped series used 77 > limit 10",
                          0))
    assert [m.tags for m in got.metas] == [m.tags for m in want.metas]
    w, g = np.asarray(want.values, np.float64), got.values.numpy().astype(np.float64)
    assert np.array_equal(np.isnan(g), np.isnan(w))
    m = ~np.isnan(w)
    np.testing.assert_allclose(g[m], w[m], rtol=1e-4, atol=1e-4)


def test_query_entry_points_refuse_cpu_fallback():
    """Without a card, BlockStorage and Engine raise on their default
    device; they run on the CPU only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    streams = _streams("gapped")[:2]
    with pytest.raises(RuntimeError, match="CUDA"):
        BlockStorage(streams, _tags(4))
    with pytest.raises(RuntimeError, match="CUDA"):
        tengine.Engine(_storage("gapped"))
