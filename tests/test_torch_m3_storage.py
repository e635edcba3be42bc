"""Port parity for the storage node under the query path: the port's
``Database`` + ``M3Storage`` beside ``m3_tpu``'s on the same writes and
flushes (the port on ``device="cpu"``: its kernels' twins).

- ``fetch`` results, ``scan_totals`` totals and ``path``, routing records,
  read-through re-admission counters and ``resident_stats`` keys are equal
  bit for bit, on the resident path, the streamed path after eviction, and
  with a buffered overlay.
- ``Engine.query_range`` over the port's ``M3Storage`` (staged path) equals
  ``m3_tpu``'s through its fused planner and, with ``M3_TPU_QUERY_PLAN=0``,
  through its staged path.
- Mirrors of the Database cases of ``tests/test_resident.py``; the last
  (a failed read-through re-admission) asserts the port's raise.
- Kernel B-2 (``parallel/csrc/resident_assembly.cu``) built as host C++ vs
  its plain torch twin, both layouts; the seven grouped ops vs ``m3_tpu`` on
  subnormal, +-0 and NaN inputs, and K3's host build on the same.
"""

import ctypes
import shutil
import subprocess

import numpy as np
import pytest
import torch

from m3_tpu.block.core import make_tags as jmake_tags
from m3_tpu.block.core import SeriesMeta as JSeriesMeta
from m3_tpu.index.device import IndexDeviceOptions as JIndexDeviceOptions
from m3_tpu.query import engine as jengine
from m3_tpu.query import m3_storage as jm3s
from m3_tpu.query import stats as jstats
from m3_tpu.query.functions import aggregation as jagg
from m3_tpu.query.promql import Matcher as JMatcher
from m3_tpu.resident import ResidentOptions as JResidentOptions
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.database import NamespaceOptions as JNamespaceOptions
from m3_tpu_torch.block.core import SeriesMeta
from m3_tpu_torch.cache.block_cache import BlockKey
from m3_tpu_torch.codec.m3tsz import Encoder
from m3_tpu_torch.index.device import IndexDeviceOptions
from m3_tpu_torch.ops import _build, fused
from m3_tpu_torch.parallel import scan as tscan
from m3_tpu_torch.query import engine as tengine
from m3_tpu_torch.query import m3_storage as tm3s
from m3_tpu_torch.query import stats as tstats
from m3_tpu_torch.query.functions import aggregation as tagg
from m3_tpu_torch.query.m3_storage import M3Storage
from m3_tpu_torch.query.promql import Matcher
from m3_tpu_torch.resident import ResidentOptions, ResidentPool
from m3_tpu_torch.storage.database import Database as _Database
from m3_tpu_torch.storage.database import NamespaceOptions, Shard
from m3_tpu_torch.utils.serialize import encode_tags

NANOS = 1_000_000_000
HOUR = 3600 * NANOS
BSZ = 2 * HOUR
T0 = 1_600_000_000 * NANOS
B0 = T0 // BSZ * BSZ  # the block T0 falls in
N_SERIES = 64


def Database(*args, **kwargs):
    """The port's Database on the CPU (it defaults to the card)."""
    return _Database(*args, device="cpu", **kwargs)


def _tags(i):
    return jmake_tags({b"__name__": b"m3_scan", b"job": f"job-{i % 4}".encode(),
                       b"host": f"h{i}".encode()})


def _batch(seed=0, block=B0, n_series=N_SERIES):
    """Gauge, counter and float series at 10 s steps with jitter and gaps,
    over one block: eight patterns of 65 to 96 points (three chunks of 32),
    series i taking pattern (i // 4) % 8, so every job holds all eight and
    every matcher below gives the reference's device programs one of two
    shapes (their XLA compiles are most of this file's time)."""
    rng = np.random.default_rng(seed)
    patterns = []
    for p in range(8):
        n = int(rng.integers(65, 97))
        t = block + NANOS * np.cumsum(rng.integers(5, 16, n) * (1 + (rng.random(n) < 0.05) * 9))
        t = t[t < block + BSZ]
        if p % 3 == 0:
            v = np.round(50 + rng.normal(0, 4, len(t)), 2)
        elif p % 3 == 1:
            v = np.cumsum(rng.integers(0, 9, len(t))).astype(float)
        else:
            v = rng.standard_normal(len(t)) * 1e3
        patterns.append((t, v))
    out = []
    for i in range(n_series):
        t, v = patterns[(i // 4) % 8]
        out += [(_tags(i), int(tt), float(vv), 1) for tt, vv in zip(t, v)]
    return out


def _dbs(tmp_path, device_index=True, flush=True):
    """(m3_tpu Database, port Database) over the same writes, block 0
    flushed (admitted at seal)."""
    j = JDatabase(str(tmp_path / "j"), num_shards=4, commitlog_enabled=False,
                  resident_options=JResidentOptions(max_bytes=8 << 20),
                  index_device_options=JIndexDeviceOptions(max_bytes=16 << 20)
                  if device_index else None)
    t = Database(str(tmp_path / "t"), num_shards=4, commitlog_enabled=False,
                 resident_options=ResidentOptions(max_bytes=8 << 20),
                 index_device_options=IndexDeviceOptions(max_bytes=16 << 20)
                 if device_index else None)
    batch = _batch()
    for db, opts in ((j, JNamespaceOptions()), (t, NamespaceOptions())):
        db.create_namespace("m", opts)
        assert db.write_tagged_batch("m", batch) == [None] * len(batch)
        if flush:
            db.flush("m", B0 + BSZ)
    return j, t


@pytest.fixture
def dbs(tmp_path):
    j, t = _dbs(tmp_path)
    yield j, t
    j.close()
    t.close()


@pytest.fixture(scope="module")
def shared_dbs(tmp_path_factory):
    """One pair for the tests that leave every block resident again: the
    reference compiles its device programs once per pool and shape."""
    j, t = _dbs(tmp_path_factory.mktemp("shared"))
    yield j, t
    j.close()
    t.close()


MATCHERS = [
    [("__name__", "=", "m3_scan")],
    [("__name__", "=", "m3_scan"), ("job", "=~", "job-[0-3]")],
    [("host", "=~", "h.*"), ("job", "!=", "job-9"), ("host", "!~", "x.*")],
    [("host", "=", "nope")],
]


def _m(spec, cls):
    return [cls(*x) for x in spec]


def _routed(stats_mod, fn):
    """fn() under a query record that records routing: (result, routing)."""
    st = stats_mod.start("parity")
    st.record_routing = True
    try:
        out = fn()
    finally:
        stats_mod.finish(st, 0.0)
    return out, [dict(r) for r in st.routing]


def _same_rows(got, want):
    assert len(got) == len(want)
    for (gt, gtimes, gvals), (wt, wtimes, wvals) in zip(got, want):
        assert tuple(gt) == tuple(wt)
        assert gtimes.dtype == wtimes.dtype == np.int64
        np.testing.assert_array_equal(gtimes, wtimes)
        assert np.asarray(gvals).view(np.int64).tolist() == np.asarray(wvals).view(np.int64).tolist()


def _same_totals(got, want):
    """Counts, extremes, series and path exactly; the f32 total sum within
    rtol 1e-6: torch and XLA add the per-series sums in different orders
    (the per-series sums agree; tests/test_torch_resident.py holds the
    scans the same way)."""
    assert got.keys() == want.keys()
    for k in got:
        if isinstance(want[k], float) and np.isnan(want[k]):
            assert np.isnan(got[k]), k
        elif k == "sum":
            np.testing.assert_allclose(got[k], want[k], rtol=1e-6)
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("spec", MATCHERS)
def test_fetch_and_scan_totals_match_reference(shared_dbs, spec):
    """Resident, then streamed after eviction (with read-through
    re-admission), then resident again: fetch rows, scan totals, paths,
    routing records and re-admission counters equal m3_tpu's."""
    j, t = shared_dbs
    js, ts = jm3s.M3Storage(j, "m"), M3Storage(t, "m")
    jm, tm = _m(spec, JMatcher), _m(spec, Matcher)
    span = (B0, B0 + BSZ)
    for phase in ("resident", "evicted", "readmitted"):
        if phase == "evicted":
            assert j.resident_clear() == t.resident_clear() > 0
        wrows, wroute = _routed(jstats, lambda: js.fetch(jm, *span))
        grows, groute = _routed(tstats, lambda: ts.fetch(tm, *span))
        _same_rows(grows, wrows)
        assert groute == wroute
        if phase == "evicted":
            assert j.resident_clear() == t.resident_clear()
        wtot, wroute = _routed(jstats, lambda: js.scan_totals(jm, *span))
        gtot, groute = _routed(tstats, lambda: ts.scan_totals(tm, *span))
        _same_totals(gtot, wtot)
        assert groute == wroute
        jst, tst = j.resident_stats(), t.resident_stats()
        assert jst.keys() == tst.keys()
        for k in ("entries", "complete_blocks", "admissions", "readmissions", "evictions",
                  "invalidations", "bytes", "pages_used", "rejections"):
            assert tst[k] == jst[k], k
    if spec[-1][0] != "host":
        assert gtot["path"] == "resident" and gtot["series"] == N_SERIES


def test_scan_totals_path_follows_residency(shared_dbs):
    j, t = shared_dbs
    ts, js = M3Storage(t, "m"), jm3s.M3Storage(j, "m")
    tm, jm = [Matcher("__name__", "=", "m3_scan")], [JMatcher("__name__", "=", "m3_scan")]
    span = (B0, B0 + BSZ)
    # an earlier case may have left the pools cleared: one scan re-admits
    _same_totals(ts.scan_totals(tm, *span), js.scan_totals(jm, *span))
    resident = ts.scan_totals(tm, *span)
    assert resident["path"] == "resident" and resident["series"] == N_SERIES
    up = t.resident_stats()["upload_bytes"]
    assert ts.scan_totals(tm, *span) == resident  # warm: no upload
    assert t.resident_stats()["upload_bytes"] == up
    j.resident_clear()
    t.resident_clear()
    readmitted = t.resident_stats()["readmissions"]
    streamed = ts.scan_totals(tm, *span)
    assert streamed == {**resident, "path": "streamed"}
    _same_totals(streamed, js.scan_totals(jm, *span))
    assert t.resident_stats()["readmissions"] - readmitted == N_SERIES
    assert t.resident_stats()["readmissions"] == j.resident_stats()["readmissions"]
    assert ts.scan_totals(tm, *span) == resident
    # a live write into the block: the buffered overlay streams it
    for db in (j, t):
        db.write_tagged("m", _tags(3), B0 + 7 * NANOS, 4.25)
    wtot, wroute = _routed(jstats, lambda: js.scan_totals(jm, *span))
    gtot, groute = _routed(tstats, lambda: ts.scan_totals(tm, *span))
    _same_totals(gtot, wtot)
    assert gtot["path"] == "streamed" and groute == wroute
    assert any(r["reason"] == "buffered-overlay" for r in groute)
    # the cold flush seals a new volume, admitted at seal: all resident again
    for db in (j, t):
        db.flush("m", B0 + BSZ)
    assert ts.scan_totals(tm, *span)["path"] == "resident"
    _same_totals(ts.scan_totals(tm, *span), js.scan_totals(jm, *span))


def test_raced_eviction_streams_and_is_recorded(shared_dbs, monkeypatch):
    """resident_scan_totals / resident_fetch_arrays returning None (an
    eviction raced the plan) is a route of the reference's semantics: the
    query streams and the routing record says why."""
    _, t = shared_dbs
    ts = M3Storage(t, "m")
    m = [Matcher("__name__", "=", "m3_scan")]
    want = ts.scan_totals(m, B0, B0 + BSZ)
    rows = ts.fetch(m, B0, B0 + BSZ)
    monkeypatch.setattr(tm3s, "resident_scan_totals", lambda *a, **k: None)
    monkeypatch.setattr(tm3s, "resident_fetch_arrays", lambda *a, **k: None)
    got, route = _routed(tstats, lambda: ts.scan_totals(m, B0, B0 + BSZ))
    assert got == {**want, "path": "streamed"}
    assert any("resident-plan-failed" in r["reason"] for r in route)
    got_rows, route = _routed(tstats, lambda: ts.fetch(m, B0, B0 + BSZ))
    _same_rows(got_rows, rows)
    assert any("resident-plan-failed" in r["reason"] for r in route)


QUERIES = [
    'm3_scan{job=~"job-[01]"}',
    "sum by (job) (m3_scan)",
    "max without (host) (m3_scan)",
    "sum by (job) (rate(m3_scan[1m]))",
    "avg by (job) (avg_over_time(m3_scan[1m]))",
    'count(present_over_time(m3_scan{job=~"job-[23]"}[1m]))',
]


@pytest.mark.parametrize("query", QUERIES)
@pytest.mark.parametrize("plan", ["fused", "staged"])
def test_engine_query_range_matches_reference(shared_dbs, monkeypatch, query, plan):
    """The port's Engine over M3Storage (staged path: fetch, host
    consolidation, B2's and K3's twins) equals m3_tpu's Engine through its
    fused planner and through its staged path, bit for bit."""
    if plan == "staged":
        monkeypatch.setenv("M3_TPU_QUERY_PLAN", "0")
    j, t = shared_dbs
    lookback = 30 * NANOS
    start, end, step = B0 + 10 * 60 * NANOS, B0 + 100 * 60 * NANOS, 30 * NANOS
    want = jengine.Engine(jm3s.M3Storage(j, "m"), lookback_nanos=lookback
                          ).query_range(query, start, end, step)
    got = tengine.Engine(M3Storage(t, "m"), lookback_nanos=lookback, device="cpu"
                         ).query_range(query, start, end, step)
    assert [m.tags for m in got.metas] == [m.tags for m in want.metas]
    w = np.asarray(want.values)
    g = got.values.numpy()
    assert g.dtype == w.dtype and g.shape == w.shape and g.shape[1] == 181
    assert np.array_equal(np.isnan(g), np.isnan(w))
    assert (~np.isnan(w)).any()
    assert np.array_equal(np.where(np.isnan(g), 0, g).view(np.int64 if g.itemsize == 8 else np.int32),
                          np.where(np.isnan(w), 0, w).view(np.int64 if w.itemsize == 8 else np.int32))


def test_engine_scan_totals_surface(shared_dbs):
    j, t = shared_dbs
    got = tengine.Engine(M3Storage(t, "m"), device="cpu").scan_totals(
        'm3_scan{job=~"job-[23]"}', B0, B0 + BSZ)
    want = jengine.Engine(jm3s.M3Storage(j, "m")).scan_totals('m3_scan{job=~"job-[23]"}', B0, B0 + BSZ)
    _same_totals(got, want)
    assert got["path"] == "resident"
    with pytest.raises(ValueError):
        tengine.Engine(M3Storage(t, "m"), device="cpu").scan_totals("sum(m3_scan)", B0, B0 + BSZ)


def test_query_ids_device_index_matches_host(shared_dbs):
    j, t = shared_dbs
    from m3_tpu_torch.index.query import regexp, term

    q = regexp(b"host", b"h1.*")
    dev = t.query_ids("m", q, B0, B0 + BSZ).docs
    host = t.query_ids("m", q, B0, B0 + BSZ, force_host=True).docs
    assert [d.id for d in dev] == [d.id for d in host] and len(dev) == 11
    st = t.index_stats()
    assert st["enabled"] and st["namespaces"]["m"]["device_resident_segments"] >= 1
    assert [d.id for d in t.query_ids("m", term(b"job", b"job-3"), B0, B0 + BSZ).docs] == \
        [d.id for d in j.query_ids("m", jm3s.matchers_to_index_query(
            [JMatcher("job", "=", "job-3")]), B0, B0 + BSZ).docs]


def test_left_out_options_raise_naming_roadmap(tmp_path):
    with pytest.raises(NotImplementedError, match="ROADMAP §A6"):
        Database(str(tmp_path), ingest_options=object())
    db = Database(str(tmp_path), num_shards=2)
    db.create_namespace("m", NamespaceOptions())
    with pytest.raises(NotImplementedError, match="ROADMAP §A10"):
        db.bootstrap(peers_source=lambda ns, shard: None)
    db.close()


def test_database_refuses_cpu_fallback(tmp_path):
    """Without a card the Database raises on its default device; it runs
    on the CPU only when asked."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="CUDA"):
        _Database(str(tmp_path))


# ---------- mirrors of tests/test_resident.py's Database cases ----------


@pytest.fixture
def resident_db(tmp_path):
    db = Database(
        str(tmp_path / "db"),
        num_shards=4,
        commitlog_enabled=False,
        resident_options=ResidentOptions(max_bytes=8 << 20),
    )
    db.create_namespace("ns", NamespaceOptions())
    yield db
    db.close()


def _ingest(db, n_series=8, n_points=40, seed=0, name=b"g"):
    rng = np.random.default_rng(seed)
    step = 10 * NANOS
    sids = []
    for i in range(n_series):
        tags = ((b"__name__", name), (b"s", b"%03d" % i))
        sid = encode_tags(tags)
        db.write_tagged("ns", tags, T0, float(i))
        db.write_batch(
            "ns",
            [(sid, T0 + (j + 1) * step, float(rng.standard_normal())) for j in range(n_points - 1)],
        )
        sids.append(sid)
    return sids


def test_database_admits_on_seal(resident_db):
    db = resident_db
    sids = _ingest(db)
    assert db.resident_pool.stats()["admissions"] == 0  # nothing sealed yet
    db.flush("ns", T0 + 4 * 3600 * NANOS)
    st = db.resident_pool.stats()
    assert st["admissions"] == len(sids)
    assert st["entries"] == len(sids)
    assert st["complete_blocks"] >= 1
    # resident bytes equal the persisted streams exactly
    for sid in sids:
        shard = db.namespaces["ns"].shard_for(sid)
        keys, buffered = shard.scan_block_keys(sid, T0, T0 + 3600 * NANOS)
        assert not buffered and len(keys) == 1
        entry = db.resident_pool.get(keys[0])
        fid = next(f for f in shard.filesets() if f.block_start == keys[0].block_start)
        assert entry.num_bits == len(shard.reader(fid).stream(sid)) * 8


def test_write_after_seal_invalidates_and_cold_flush_readmits(resident_db):
    db = resident_db
    sids = _ingest(db)
    db.flush("ns", T0 + 4 * 3600 * NANOS)
    pool = db.resident_pool
    shard = db.namespaces["ns"].shard_for(sids[0])
    key0 = shard.scan_block_keys(sids[0], T0, T0 + 3600 * NANOS)[0][0]
    assert key0 in pool
    # cold write into the sealed block: entry dropped, block incomplete
    db.write("ns", sids[0], T0 + 5 * NANOS, 123.0)
    assert key0 not in pool
    assert not pool.is_complete("ns", shard.id, key0.block_start, key0.volume)
    # cold flush merges into a NEW volume: it admits, the old volume stays gone
    db.flush("ns", T0 + 4 * 3600 * NANOS)
    keys, buffered = shard.scan_block_keys(sids[0], T0, T0 + 3600 * NANOS)
    assert not buffered
    assert keys[0].volume == key0.volume + 1
    assert keys[0] in pool
    assert key0 not in pool


def test_bootstrap_readmits_sealed_blocks_after_restart(tmp_path):
    """Blocks sealed by a previous process re-admit at bootstrap."""
    ropts = ResidentOptions(max_bytes=8 << 20)
    db = Database(str(tmp_path / "node"), num_shards=4, commitlog_enabled=False,
                  resident_options=ropts)
    db.create_namespace("ns", NamespaceOptions())
    _ingest(db)
    db.flush("ns", T0 + 4 * 3600 * NANOS)
    db.close()

    db2 = Database(str(tmp_path / "node"), num_shards=4, commitlog_enabled=False,
                   resident_options=ropts)
    db2.create_namespace("ns", NamespaceOptions())
    assert len(db2.resident_pool) == 0
    db2.bootstrap(now_nanos=T0 + 5 * 3600 * NANOS)
    st = db2.resident_pool.stats()
    assert st["entries"] == 8 and st["complete_blocks"] >= 1
    tot = M3Storage(db2, "ns").scan_totals([Matcher("__name__", "=", "g")], T0, T0 + 3600 * NANOS)
    assert tot["path"] == "resident"
    db2.close()


def test_streamed_fallback_readmits_sealed_blocks(resident_db):
    """Read-through re-admission: a streamed-fallback hit on sealed,
    complete blocks pulls them back into the pool, so the next scan of the
    hot set is resident again; buffered series stay out."""
    db = resident_db
    sids = _ingest(db)
    db.flush("ns", T0 + 4 * 3600 * NANOS)
    pool = db.resident_pool
    st = M3Storage(db, "ns")
    m = [Matcher("__name__", "=", "g")]
    span = (T0, T0 + 3600 * NANOS)
    assert st.scan_totals(m, *span)["path"] == "resident"
    pool.clear()
    assert pool.stats()["readmissions"] == 0
    tot = st.scan_totals(m, *span)  # cold: streams, then re-admits
    assert tot["path"] == "streamed"
    assert pool.stats()["readmissions"] == len(sids)
    tot2 = st.scan_totals(m, *span)
    assert tot2["path"] == "resident"
    assert tot2 == {**tot, "path": "resident"}
    assert pool.stats()["readmissions"] == len(sids)
    # fetch-path fallback re-admits too
    pool.clear()
    st.fetch(m, *span)
    assert pool.stats()["readmissions"] == 2 * len(sids)
    # a buffered series does NOT trigger re-admission
    pool.clear()
    db.write("ns", sids[0], T0 + 13 * NANOS, 7.0)
    only = [Matcher("__name__", "=", "g"), Matcher("s", "=", "000")]
    assert st.scan_totals(only, *span)["path"] == "streamed"
    assert pool.stats()["readmissions"] == 2 * len(sids)


def _stream(values, t0=T0, step=NANOS):
    enc = Encoder(t0)
    t = t0
    for v in values:
        t += step
        enc.encode(t, float(v))
    return enc.stream()


def _pool(max_bytes=1 << 20, page_words=16, **kw):
    kw.setdefault("side_bytes", 1 << 20)
    kw.setdefault("side_page_chunks", 4)
    return ResidentPool(ResidentOptions(max_bytes=max_bytes, page_words=page_words, **kw),
                        device="cpu")


def test_readmission_skips_already_resident_lanes():
    """One evicted lane must not re-stage its still-resident shard-mates'
    bytes: those lanes are skipped in place (LRU-touched, counted toward
    completeness)."""
    pool = _pool(max_bytes=4 << 20)
    items = [(b"r%d" % i, _stream([float(i), 2.0, 3.0]), 32) for i in range(3)]
    res = pool.admit_block("ns", 0, T0, 0, items)
    assert res.admitted == 3 and res.complete
    up0 = pool.stats()["upload_bytes"]
    res2 = pool.admit_block("ns", 0, T0, 0, items, readmission=True)
    assert res2.admitted == 0 and res2.complete
    assert pool.stats()["upload_bytes"] == up0
    assert pool.stats()["readmissions"] == 0
    pool.invalidate_series_block("ns", 0, b"r1", T0)
    res3 = pool.admit_block("ns", 0, T0, 0, items, readmission=True)
    assert res3.admitted == 1 and res3.complete
    delta = pool.stats()["upload_bytes"] - up0
    assert 0 < delta < up0
    assert pool.stats()["readmissions"] == 1
    assert pool.is_complete("ns", 0, T0, 0)


def test_budget_deferred_readmission_cooldown():
    """A budget-rejected re-admission marks the fileset deferred until
    pages free up; the marker lifts on eviction and on a full
    re-admission."""
    big = _stream(np.random.default_rng(0).standard_normal(40))
    n_pages = -(-len(big) // 64)
    assert n_pages >= 2
    pool = _pool(max_bytes=(n_pages + 2) * 64, page_words=16)
    ok = pool.admit_block("ns", 0, T0, 0, [(b"a", big, 64)])
    assert ok.admitted == 1
    rej = pool.admit_block("ns", 0, T0 + 1, 0, [(b"b", big, 64)], readmission=True)
    assert rej.rejected_budget == 1
    assert pool.budget_deferred("ns", 0, T0 + 1, 0)
    assert not pool.budget_deferred("ns", 0, T0, 0)
    pool.invalidate_block("ns", 0, T0)
    assert not pool.budget_deferred("ns", 0, T0 + 1, 0)
    ok2 = pool.admit_block("ns", 0, T0 + 1, 0, [(b"b", big, 64)], readmission=True)
    assert ok2.admitted == 1
    assert not pool.budget_deferred("ns", 0, T0 + 1, 0)


def test_readmission_failure_raises(resident_db, monkeypatch):
    """Divergence on purpose (ROADMAP §C): the reference counts a failed
    read-through re-admission and serves the streamed result it already
    holds, so a device fault there (a failed launch, a CUDA error, an OOM)
    is never seen. The port counts it and raises it: a device fault is not
    hidden behind a host answer. The pool's own budget refusal is not a
    failure (test_budget_deferred_readmission_cooldown)."""
    db = resident_db
    _ingest(db)
    db.flush("ns", T0 + 4 * 3600 * NANOS)
    st = M3Storage(db, "ns")
    m = [Matcher("__name__", "=", "g")]
    span = (T0, T0 + 3600 * NANOS)
    db.resident_pool.clear()

    def boom(self, fid):
        raise RuntimeError("CUDA error: out of memory")

    monkeypatch.setattr(Shard, "readmit_fileset", boom)
    before = tm3s._M_READMIT_FAILURES.value
    with pytest.raises(RuntimeError, match="out of memory"):
        st.scan_totals(m, *span)
    assert tm3s._M_READMIT_FAILURES.value == before + 1
    with pytest.raises(RuntimeError, match="out of memory"):
        st.fetch(m, *span)
    assert tm3s._M_READMIT_FAILURES.value == before + 2
    assert db.resident_pool.stats()["readmissions"] == 0


# ---------- kernel B-2: host build vs twin ----------


@pytest.fixture(scope="module")
def host_b2(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("kernel") / "resident_assembly_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(out), str(_build.SOURCES["resident_assembly"][0])],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.m3_resident_assembly_host.argtypes = [P] * 8 + [I64, I64, I, I, I, I, I, I, I, I64, I64, I,
                                                         P, P, P]
    lib.m3_resident_assembly_host.restype = ctypes.c_int
    lib.m3_resident_assembly_slot_words.argtypes = [I64, I]
    lib.m3_resident_assembly_slot_words.restype = ctypes.c_int
    return lib


def _resident_plan(n_series=37, seed=2, page_words=16, fast=False):
    """A pool with lanes of 1 to 4 chunks (k=8, 2 chunks a side page), some
    float, some int, spread over two blocks, and its plan over every key.
    Pages of 512 words (the pool's default), 16 and 6 put page boundaries
    at different places in the windows. fast: whole chunks, the first half
    of the series int, the rest float, so that the chunks after the first
    are int-fast or float-fast and tiles of 128 lanes get every flag."""
    rng = np.random.default_rng(seed)
    pool = ResidentPool(ResidentOptions(max_bytes=1 << 20, page_words=page_words,
                                        side_bytes=1 << 20, side_page_chunks=2), device="cpu")
    keys = []
    for i in range(n_series):
        if fast:
            n = 8 * int(rng.integers(2, 5))
            vals = rng.standard_normal(n) * 100
            vals = vals.round(0) if i < n_series // 2 else vals + np.pi
        else:
            n = int(rng.integers(1, 30))
            vals = (rng.standard_normal(n) * 100).round(1 if i % 2 else 0)
        bs = T0 if i % 3 else T0 + BSZ
        enc = Encoder(bs)
        t = bs
        for v in vals:
            t += int(rng.integers(1, 20)) * NANOS
            enc.encode(t, float(v))
        sid = b"s%03d" % i
        assert pool.admit_block("ns", i % 2, bs, 0, [(sid, enc.stream(), n)], chunk_k=8).admitted
        keys.append(BlockKey("ns", i % 2, sid, bs, 0))
    plan = pool.plan_chunked(keys)
    assert plan is not None and len(set(plan.n_chunks.tolist())) > 1
    return plan


def _b2_slot(lib, plan, route):
    """The slot words of a B-2 launch and the series it sends direct:
    "staged" is the wrapper's choice (the longest span: every series
    staged), "split" the median span (the longer series take the direct
    route in the same launch), "direct" 0 (every series, side rows too)."""
    cap = lib.m3_resident_assembly_slot_words(plan.num_chunks, plan.window_words)
    if route == "staged":
        slot, direct = tscan.assembly_slot(plan, cap)
        assert direct == 0
        return slot
    if route == "direct":
        return 0
    span = (plan.total_bits.astype(np.int64) + 31) // 32 + plan.window_words
    slot, direct = tscan.assembly_slot(plan, int(np.median(span)))
    assert 0 < direct < len(span)
    return slot


def _host_assembly(lib, plan, s_pad, order, lane_major, tile_lanes, route="staged"):
    slot = _b2_slot(lib, plan, route)
    pr, sr, nc, tb, bh, bl = tscan.pad_chunked_plan(plan, s_pad)
    vecs = [np.ascontiguousarray(x).view(np.int32) for x in (pr, sr, nc, tb.astype(np.int32), bh, bl)]
    words = np.ascontiguousarray(plan.words.numpy())
    side = np.ascontiguousarray(plan.side.numpy())
    c, cw = plan.num_chunks, plan.window_words
    n = s_pad * c
    npad = n if lane_major else -(-n // tile_lanes) * tile_lanes
    windows = np.zeros((npad, cw) if lane_major else (cw, npad), np.int32)
    planes = np.zeros((fused.NLANE, npad), np.int32)
    flags = np.zeros(max(npad // tile_lanes, 1), np.int32)
    ptr = lambda a: ctypes.c_void_p(a.ctypes.data)
    # outputs start as garbage: every word must be written
    windows[:] = planes[:] = flags[:] = 0x5A5A5A5A
    assert lib.m3_resident_assembly_host(
        ptr(words), ptr(side), *[ptr(v) for v in vecs], s_pad, c, pr.shape[1], sr.shape[1],
        plan.page_words, plan.side_page_chunks, cw, 0 if order == "c" else 1, int(lane_major),
        npad, tile_lanes, slot, ptr(windows), ptr(planes),
        ctypes.c_void_p(None) if lane_major else ptr(flags)) == 0
    return windows, planes, flags[: npad // tile_lanes]


def _b2_case(order, rows, s_pad, page_words, route="staged", series=37):
    extra = ("" if route == "staged" else f"-{route}") + ("" if series == 37 else f"-fast{series}")
    return pytest.param(order, rows, s_pad, page_words, route, series,
                        id="-".join(map(str, (order, rows, s_pad, page_words))) + extra)


@pytest.mark.parametrize("order,rows,s_pad,page_words,route,series", [
    _b2_case("c", 1, 37, 16), _b2_case("c", 1, 64, 16), _b2_case("s", 1, 40, 16),
    _b2_case("c", 32, 64, 16), _b2_case("s", 2, 37, 16), _b2_case("c", 1, 40, 6),
    _b2_case("s", 1, 37, 6),
    # the pool's default page size; series blocks of 32 that share tiles,
    # s_pad not a multiple of 32; one launch taking both routes; every
    # series on the direct route
    _b2_case("c", 1, 37, 512), _b2_case("s", 1, 40, 512), _b2_case("c", 1, 100, 512),
    _b2_case("c", 1, 100, 512, "split"), _b2_case("s", 1, 37, 512, "split"),
    _b2_case("c", 1, 37, 16, "split"), _b2_case("s", 2, 100, 16, "split"),
    _b2_case("c", 1, 40, 6, "split"), _b2_case("c", 32, 64, 6, "split"),
    _b2_case("c", 1, 37, 512, "direct"), _b2_case("s", 1, 40, 6, "direct"),
    # int-fast, float-fast and general tiles, each made up by four blocks
    _b2_case("c", 1, 256, 512, "staged", 256), _b2_case("c", 1, 300, 16, "split", 256),
    _b2_case("c", 1, 256, 6, "direct", 256)])
def test_b2_source_host_build_matches_twin_packed(host_b2, order, rows, s_pad, page_words, route,
                                                  series):
    """B1's and R's layout: windows, planes and tile flags bit for bit,
    with lanes past each series' n_chunks, padding series and padding
    tiles, on B-2's staged route, its direct route, or both in one launch."""
    plan = _resident_plan(n_series=series, page_words=page_words, fast=series != 37)
    want, _ = tscan.assemble_resident_packed(plan, s_pad, order=order, rows=rows)
    windows, planes, flags = _host_assembly(host_b2, plan, s_pad, order, False, rows * 128, route)
    np.testing.assert_array_equal(windows, want.windows.numpy())
    np.testing.assert_array_equal(planes, want.lanes.numpy())
    np.testing.assert_array_equal(flags, want.tile_flags.numpy())
    assert want.n == s_pad * plan.num_chunks
    if series != 37:
        assert set(flags.tolist()) == {0, 1, 2}


@pytest.mark.parametrize("s_pad,page_words,route", [
    pytest.param(37, 16, "staged", id="37"), pytest.param(48, 16, "staged", id="48"),
    pytest.param(37, 512, "staged", id="37-512"), pytest.param(100, 512, "split", id="100-512-split"),
    pytest.param(37, 6, "split", id="37-6-split"), pytest.param(48, 16, "direct", id="48-16-direct")])
def test_b2_source_host_build_matches_twin_fields(host_b2, s_pad, page_words, route):
    """B3's per-field layout: lane-major windows and each field."""
    plan = _resident_plan(seed=5, page_words=page_words)
    want, _ = tscan.assemble_resident_lanes(plan, s_pad)
    windows, planes, _ = _host_assembly(host_b2, plan, s_pad, "s", True, 4096, route)
    np.testing.assert_array_equal(windows, want["windows"].numpy())
    got = tscan._lane_fields(torch.from_numpy(windows), torch.from_numpy(planes))
    assert set(got) == set(want)
    for name, x in want.items():
        if isinstance(x, tuple):
            for a, b in zip(got[name], x):
                assert torch.equal(a, b), name
        else:
            assert torch.equal(got[name], x), name


# ---------- grouped ops on subnormal inputs (fault 1) ----------


def _subnormal_values(n_series=48, steps=40, seed=12):
    """Subnormal, +-0, NaN and tiny normal values whose sums, means and
    squared deviations fall into the subnormal range, in every group."""
    rng = np.random.default_rng(seed)
    v = (rng.standard_normal((n_series, steps)) * 1e-37).astype(np.float32)
    roll = rng.random(v.shape)
    v[roll < 0.2] = np.float32(1e-40)
    v[(roll >= 0.2) & (roll < 0.35)] = np.float32(-3e-40)
    v[(roll >= 0.35) & (roll < 0.45)] = np.nan
    v[(roll >= 0.45) & (roll < 0.55)] = -0.0
    v[(roll >= 0.55) & (roll < 0.6)] = 0.0
    v[:, 0] = np.tile(np.float32([1e-40, 2e-40, -3e-40, 5e-41]), n_series // 4)
    v[:, 1] = np.tile(np.float32([1.5e-38, -1.4e-38, 0.0, 2e-45]), n_series // 4)
    v[:, 2] = np.float32(-1e-41)
    return v


def _bits_equal(got, want):
    return (np.array_equal(np.isnan(got), np.isnan(want))
            and np.array_equal(np.where(np.isnan(got), 0, got).view(np.int32),
                               np.where(np.isnan(want), 0, want).view(np.int32)))


def _layouts(n_series):
    tags = [jmake_tags({b"job": f"j{i % 2}".encode(), b"host": f"h{i}".encode()})
            for i in range(n_series)]
    for matching in ([b"job"], None):
        yield (jagg.group_by_tags([JSeriesMeta(tags=t) for t in tags], matching),
               tagg.group_by_tags([SeriesMeta(tags=t) for t in tags], matching))


@pytest.mark.parametrize("op", tagg.OPS)
def test_grouped_ops_flush_subnormals_like_reference(op):
    """The twin (K3's CPU path) equals m3_tpu bit for bit on subnormal
    inputs and results, with the sign of each zero: XLA flushes f32
    subnormals to zero, inputs and outputs."""
    v = _subnormal_values()
    for jl, tl in _layouts(v.shape[0]):
        want = np.asarray(getattr(jagg, f"grouped_{op}")(v, jl))
        got = getattr(tagg, f"grouped_{op}")(torch.from_numpy(v), tl).numpy()
        assert _bits_equal(got, want)
        assert not (np.abs(got[got != 0]) < np.finfo(np.float32).tiny).any()
    if op in ("sum", "min"):
        jl, tl = next(_layouts(v.shape[0]))
        got = getattr(tagg, f"grouped_{op}")(torch.from_numpy(v), tl).numpy()
        assert (got[:, 0] == 0).all()  # the issue's case: subnormals only


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


@pytest.mark.parametrize("op,wc", [pytest.param(op, 0, id=op) for op in tagg.OPS]
                         + [pytest.param(op, wc, id=f"{op}-wc{wc}")
                            for wc in (8, 16, 32) for op in tagg.OPS])
def test_k3_source_host_build_flushes_like_twin(host_k3, op, wc):
    """The flush on K3's host build == the twin's bit for bit; with a nonzero wc,
    at each forced column-block width on [1100, 723] values (T odd: rows
    unaligned, the last column block ragged; one group of 1,100 members,
    longer than the ring, and two of 550)."""
    v = _subnormal_values() if wc == 0 else _subnormal_values(n_series=1100, steps=723)
    for _, tl in _layouts(v.shape[0]):
        pad = np.ascontiguousarray(tl.pad_index, np.int32)
        out = np.zeros((tl.num_groups, v.shape[1]), np.float32)
        assert host_k3(v.ctypes.data, v.shape[1], pad.ctypes.data, pad.shape[0], pad.shape[1],
                       tagg.OPS.index(op), wc, out.ctypes.data) == 0
        assert _bits_equal(out, tagg.grouped_reduce(torch.from_numpy(v), tl, op).numpy())
