"""Port parity for query admission and tenants: ``m3_tpu_torch/query/
scheduler.py`` and ``tenants.py``, and the Engine's ``scheduler=`` /
``tenant_enforcers=``, beside ``m3_tpu``'s on the same seeded scenarios.

- Mirrors of every case of ``tests/test_scheduler.py``: each runs through
  both packages and compares snapshots, shed reasons, counters, ledger
  window totals and records.
- Mirrors of the cases of ``tests/test_tenant.py`` that need no wire, HTTP
  coordinator, selfmon collector or ruler (those wait for ROADMAP §A10):
  identity normalization, the ledger (dumps and exposition text equal for
  the same charges and clock), the query → tenant → global enforcer chain,
  the limits file, and the Engine cases over a port ``Database(device=
  "cpu")`` beside ``m3_tpu``'s.

The process singletons (``tenants.LEDGER``) exist once per package: each
test swaps both for fresh ledgers with their own registries.
"""

import threading
import time

import numpy as np
import pytest

from m3_tpu.block.core import make_tags as jmake_tags
from m3_tpu.query import engine as jengine
from m3_tpu.query import m3_storage as jm3s
from m3_tpu.query import scheduler as jsched
from m3_tpu.query import stats as jstats
from m3_tpu.query import tenants as jtenants
from m3_tpu.query.cost import Enforcer as JEnforcer
from m3_tpu.query.cost import GlobalEnforcer as JGlobalEnforcer
from m3_tpu.query.cost import QueryLimitError as JQueryLimitError
from m3_tpu.query.cost import QueryLimits as JQueryLimits
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.database import NamespaceOptions as JNamespaceOptions
from m3_tpu.utils import instrument as jinstrument
from m3_tpu_torch.block.core import make_tags as tmake_tags
from m3_tpu_torch.query import engine as tengine
from m3_tpu_torch.query import m3_storage as tm3s
from m3_tpu_torch.query import scheduler as tsched
from m3_tpu_torch.query import stats as tstats
from m3_tpu_torch.query import tenants as ttenants
from m3_tpu_torch.query.cost import Enforcer as TEnforcer
from m3_tpu_torch.query.cost import GlobalEnforcer as TGlobalEnforcer
from m3_tpu_torch.query.cost import QueryLimitError as TQueryLimitError
from m3_tpu_torch.query.cost import QueryLimits as TQueryLimits
from m3_tpu_torch.storage.database import Database as TDatabase
from m3_tpu_torch.storage.database import NamespaceOptions as TNamespaceOptions
from m3_tpu_torch.utils import instrument as tinstrument

NANOS = 1_000_000_000
T0 = 1_700_000_000 * NANOS


class _Pkg:
    """One package's modules under the names the cases use."""

    def __init__(self, name, sched, tenants, stats, instrument, engine, m3s, db_cls, ns_opts,
                 make_tags, limits, glob, enforcer, limit_error):
        self.name = name
        self.sched, self.tenants, self.stats, self.instrument = sched, tenants, stats, instrument
        self.engine, self.m3s, self.Database, self.NamespaceOptions = engine, m3s, db_cls, ns_opts
        self.make_tags = make_tags
        self.QueryLimits, self.GlobalEnforcer, self.Enforcer = limits, glob, enforcer
        self.QueryLimitError = limit_error

    def database(self, path):
        if self.name == "port":
            return self.Database(str(path), num_shards=2, commitlog_enabled=False, device="cpu")
        return self.Database(str(path), num_shards=2, commitlog_enabled=False)

    def engine_for(self, storage, **kw):
        if self.name == "port":
            kw["device"] = "cpu"
        return self.engine.Engine(storage, **kw)


J = _Pkg("m3_tpu", jsched, jtenants, jstats, jinstrument, jengine, jm3s, JDatabase,
         JNamespaceOptions, jmake_tags, JQueryLimits, JGlobalEnforcer, JEnforcer, JQueryLimitError)
T = _Pkg("port", tsched, ttenants, tstats, tinstrument, tengine, tm3s, TDatabase,
         TNamespaceOptions, tmake_tags, TQueryLimits, TGlobalEnforcer, TEnforcer, TQueryLimitError)
BOTH = (J, T)


@pytest.fixture
def ledgers(monkeypatch):
    """Both packages' process ledgers swapped for fresh ones (own registries,
    a shared injected clock): {"m3_tpu": ledger, "port": ledger}."""
    now = [1000.0]
    out = {}
    for p in BOTH:
        led = p.tenants.TenantLedger(max_tenants=64, registry=p.instrument.Registry(prefix="m3tpu_"),
                                     clock=lambda: now[0])
        monkeypatch.setattr(p.tenants, "LEDGER", led)
        out[p.name] = led
    return out


def _counter_total(p, name: str, **label_filter) -> float:
    fam = p.instrument.DEFAULT.collect().get(f"m3tpu_{name}")
    if fam is None:
        return 0.0
    return sum(c["value"] for c in fam["children"]
               if all(c["labels"].get(k) == v for k, v in label_filter.items()))


def _join(threads, timeout=5.0):
    for t in threads:
        t.join(timeout)
        assert not t.is_alive(), "admission thread wedged"


def _wait_queued(s, n, deadline):
    while len(s.snapshot()["queued"]) < n and time.monotonic() < deadline:
        time.sleep(0.005)


# ---------------------------------------------------------------------------
# tests/test_scheduler.py: fast path and scoring
# ---------------------------------------------------------------------------


def test_fast_path_admit_release():
    snaps = []
    for p in BOTH:
        s = p.sched.QueryScheduler(max_inflight=2, max_queue=4, clock=lambda: 5.0)
        s.admit("up", 10)
        s.admit("up", 10)
        full = s.snapshot()
        s.release()
        s.release()
        snaps.append((full, s.snapshot()))
    assert snaps[0] == snaps[1]
    assert snaps[1][0]["inflight"] == 2 and snaps[1][0]["queued"] == []
    assert snaps[1][1]["inflight"] == 0


def test_score_terms(ledgers):
    got = []
    for p in BOTH:
        s = p.sched.QueryScheduler()
        row = [s.score("never_seen_tenant_xyz", 1.0), s.score("never_seen_tenant_xyz", 1e12),
               s.score("never_seen_tenant_xyz", 1.0, age=10.0)]
        p.tenants.LEDGER.charge("sched_score_bad", limit_rejections=50)
        row += [p.sched.tenant_pressure("sched_score_bad"), s.score("sched_score_bad", 1.0)]
        got.append(row)
    assert got[0] == got[1]
    fresh, huge, aged, pressure, bad = got[1]
    assert 0.0 <= fresh < 1.0 and huge < 1.0 and aged < 0.0
    assert pressure > 0.9 and bad > huge


def test_cost_memo_lru_and_feedback():
    got = []
    for p in BOTH:
        m = p.sched.CostMemo(capacity=2)
        row = [m.series_estimate("q1")]
        m.observe("q1", 40)
        m.observe("q2", 7)
        row.append(m.estimate("q1", 100))
        m.observe("q3", 3)  # q2 is LRU (q1 was touched by estimate)
        row += [m.series_estimate("q2"), m.series_estimate("q1"), m.series_estimate("q3")]
        m.observe("q1", 0)  # non-positive observations are ignored
        row.append(m.series_estimate("q1"))
        got.append(row)
    assert got[0] == got[1] == [1, 4000.0, 1, 40, 3, 40]


# ---------------------------------------------------------------------------
# tests/test_scheduler.py: queueing and priority
# ---------------------------------------------------------------------------


def _release_order(p):
    s = p.sched.QueryScheduler(max_inflight=1, max_queue=8, max_queue_wait=5.0)
    s.admit("up", 1)  # occupy the only slot
    p.tenants.LEDGER.charge("sched_prio_bad", limit_rejections=30)
    p.tenants.LEDGER.charge("sched_prio_good", queries=30)
    order = []

    def enter(tenant):
        with p.tenants.tenant_context(tenant):
            s.admit("up", 1)
        order.append(tenant)

    threads = [threading.Thread(target=enter, args=(t,), daemon=True)
               for t in ("sched_prio_bad", "sched_prio_good")]
    threads[0].start()
    deadline = time.monotonic() + 5.0
    _wait_queued(s, 1, deadline)  # the bad tenant queues FIRST
    threads[1].start()
    _wait_queued(s, 2, deadline)
    # the scores age with real time: compared to two places
    scores = sorted(round(w["score"], 2) for w in s.snapshot()["queued"])
    s.release()  # frees one slot: the good tenant despite arriving later
    while not order and time.monotonic() < deadline:
        time.sleep(0.005)
    s.release()
    _join(threads)
    s.release()
    return order, scores, s.snapshot()["inflight"]


def test_release_admits_lowest_score_first(ledgers):
    want, got = (_release_order(p) for p in BOTH)
    assert want == got
    assert got[0] == ["sched_prio_good", "sched_prio_bad"] and got[2] == 0


def _queue_full(p):
    s = p.sched.QueryScheduler(max_inflight=1, max_queue=1, max_queue_wait=5.0,
                               overload_watermark=2.0)
    s.admit("up", 1)
    p.tenants.LEDGER.charge("sched_evict_bad", limit_rejections=30)
    admitted = []

    def innocent():
        with p.tenants.tenant_context("sched_evict_good"):
            s.admit("up", 1)
        admitted.append(True)

    t = threading.Thread(target=innocent, daemon=True)
    t.start()
    _wait_queued(s, 1, time.monotonic() + 5.0)
    before = _counter_total(p, "query_shed_total", tenant="sched_evict_bad",
                            reason=p.sched.SHED_QUEUE_FULL)
    with p.tenants.tenant_context("sched_evict_bad"):
        with pytest.raises(p.sched.QueryShedError) as ei:
            s.admit("up", 1)  # queue is full; the worst score (us) is evicted
    after = _counter_total(p, "query_shed_total", tenant="sched_evict_bad",
                           reason=p.sched.SHED_QUEUE_FULL)
    s.release()
    _join([t])
    s.release()
    return (ei.value.reason, ei.value.tenant, after - before, admitted,
            p.tenants.LEDGER.window_totals("sched_evict_bad")["sheds"])


def test_queue_full_evicts_worst_scoring_entry(ledgers):
    want, got = (_queue_full(p) for p in BOTH)
    assert want == got == ("queue_full", "sched_evict_bad", 1.0, [True], 1.0)


def _deadline_shed(p):
    s = p.sched.QueryScheduler(max_inflight=1, max_queue=4, max_queue_wait=0.05)
    s.admit("up", 1)
    rec = p.stats.QueryStats(query="up")
    t0 = time.monotonic()
    with p.tenants.tenant_context("sched_deadline_t"):
        with pytest.raises(p.sched.QueryShedError) as ei:
            s.admit("up", 1, record=rec)
    waited = time.monotonic() - t0
    queued = s.snapshot()["queued"]
    s.release()
    return (ei.value.reason, rec.queue_state, rec.priority, queued), waited


def test_deadline_shed_stamps_record(ledgers):
    (want, _), (got, waited) = (_deadline_shed(p) for p in BOTH)
    assert want == got
    assert got[0] == "deadline" and got[1] == "shed" and got[3] == []
    assert 0.03 < waited < 2.0


def _overload_gate(p):
    s = p.sched.QueryScheduler(max_inflight=1, max_queue=4, overload_watermark=0.5,
                               max_queue_wait=5.0)
    s.admit("up", 1)
    p.tenants.LEDGER.charge("sched_gate_bad", limit_rejections=50)
    threads = []
    for _ in range(2):  # fill the queue past the 0.5 * 4 watermark
        t = threading.Thread(target=lambda: s.admit("up", 1), daemon=True)
        t.start()
        threads.append(t)
    deadline = time.monotonic() + 5.0
    _wait_queued(s, 2, deadline)
    t0 = time.monotonic()
    with p.tenants.tenant_context("sched_gate_bad"):
        with pytest.raises(p.sched.QueryShedError) as ei:
            s.admit("up", 1)
    fast = time.monotonic() - t0 < 1.0  # fast-fail, no queue wait
    ok = []

    def innocent():
        with p.tenants.tenant_context("sched_gate_good"):
            s.admit("up", 1)
        ok.append(True)

    t = threading.Thread(target=innocent, daemon=True)
    t.start()
    _wait_queued(s, 3, deadline)
    depth = len(s.snapshot()["queued"])  # queued, not shed
    for _ in range(3):
        s.release()
    _join(threads + [t])
    for _ in range(3):
        s.release()
    return ei.value.reason, fast, depth, ok


def test_overload_gate_fast_fails_pressured_tenant_only(ledgers):
    want, got = (_overload_gate(p) for p in BOTH)
    assert want == got == ("overload", True, 3, [True])


def test_ledger_charges_sheds(ledgers):
    got = []
    for p in BOTH:
        s = p.sched.QueryScheduler(max_inflight=1, max_queue=4, max_queue_wait=0.02)
        s.admit("up", 1)
        with p.tenants.tenant_context("sched_ledger_t"):
            with pytest.raises(p.sched.QueryShedError):
                s.admit("up", 1)
        s.release()
        got.append(p.tenants.LEDGER.window_totals("sched_ledger_t"))
    assert got[0] == got[1] and got[1]["sheds"] == 1


# ---------------------------------------------------------------------------
# tests/test_scheduler.py: the engine
# ---------------------------------------------------------------------------


def _mini_engine(p, path, **kw):
    db = p.database(path)
    db.create_namespace("default", p.NamespaceOptions())
    for i in range(4):
        tags = p.make_tags({"__name__": "sched_gauge", "i": str(i)})
        for j in range(10):
            db.write_tagged("default", tags, T0 + j * 10 * NANOS, float(i + j))
    return db, p.engine_for(p.m3s.M3Storage(db, "default"), **kw)


# record keys that hold wall time or a trace id: not compared across packages
_TIMED = {"startUnixNanos", "durationSecs", "stages", "traceId"}


def _record(p, query):
    rec = next(r for r in reversed(p.stats.RING.dump()) if r["query"] == query)
    return {k: v for k, v in rec.items() if k not in _TIMED}


def test_engine_admits_observes_and_stamps(tmp_path, ledgers):
    got = []
    for p in BOTH:
        s = p.sched.QueryScheduler(max_inflight=4)
        db, engine = _mini_engine(p, tmp_path / p.name, scheduler=s)
        try:
            res = engine.query_range("sched_gauge", T0, T0 + 90 * NANOS, 10 * NANOS)
            got.append((np.asarray(res.values), [m.tags for m in res.metas],
                        _record(p, "sched_gauge"), s.costs.series_estimate("sched_gauge"),
                        s.snapshot(), ledgers[p.name].dump()))
        finally:
            db.close()
    (jv, jm, jrec, jn, jsnap, jled), (tv, tm, trec, tn, tsnap, tled) = got
    np.testing.assert_array_equal(tv, jv)
    assert tm == jm and len(tm) == 4
    assert trec == jrec
    assert trec["queueState"] == "running" and isinstance(trec["priority"], float)
    assert tn == jn == 4  # the observed series count priced the next run
    assert tsnap == jsnap and tsnap["inflight"] == 0  # released in the finally
    assert tled == jled


def test_engine_shed_surfaces_typed_error(tmp_path, ledgers):
    got = []
    for p in BOTH:
        s = p.sched.QueryScheduler(max_inflight=1, max_queue=4, max_queue_wait=0.05)
        db, engine = _mini_engine(p, tmp_path / p.name, scheduler=s)
        try:
            s.admit("elsewhere", 1)  # saturate the only slot
            with p.tenants.tenant_context("sched_engine_t"):
                with pytest.raises(p.sched.QueryShedError) as ei:
                    engine.query_range("sched_gauge", T0, T0 + 90 * NANOS, 10 * NANOS)
            shed = _record(p, "sched_gauge")
            held = s.snapshot()["inflight"]  # the shed query took no slot
            s.release()
            res = engine.query_range("sched_gauge", T0, T0 + 90 * NANOS, 10 * NANOS)
            got.append((ei.value.reason, ei.value.tenant, held, shed, len(res.metas),
                        ledgers[p.name].dump()))
        finally:
            db.close()
    assert got[0] == got[1]
    reason, tenant, held, shed, n, _ = got[1]
    assert (reason, tenant, held, n) == ("deadline", "sched_engine_t", 1, 4)
    assert shed["queueState"] == "shed" and shed["tenant"] == "sched_engine_t"


# ---------------------------------------------------------------------------
# tests/test_tenant.py: identity, the ledger, the enforcer chain
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("raw", [None, "alpha", "team-a.prod:eu_1", "", 'bad"quote', "x" * 100,
                                 123, "-leading", "anonymous", "__overflow__"])
def test_normalize(raw, ledgers):
    got = [p.tenants.normalize(raw) for p in BOTH]
    assert got[0] == got[1]
    junk = raw in ("", 'bad"quote', "x" * 100, 123, "-leading")
    assert (got[1] == ttenants.OVERFLOW_TENANT) == (junk or raw == "__overflow__")
    assert ledgers["port"].dump()["invalidIds"] == ledgers["m3_tpu"].dump()["invalidIds"] == junk


def _known_workload(p):
    clock = [1000.0]
    reg = p.instrument.Registry(prefix="m3tpu_")
    led = p.tenants.TenantLedger(max_tenants=4, window_secs=300.0, registry=reg,
                                 clock=lambda: clock[0])
    led.charge("alpha", queries=2, datapoints=100, bytes_streamed=64, bytes_resident=32,
               cache_hits=3)
    led.charge("beta", queries=1, datapoints=10)
    clock[0] += 400.0  # alpha's early work leaves the window, stays in totals
    led.charge("alpha", queries=1, datapoints=5)
    return led.dump(), reg.collect(), reg.expose(), reg.expose_openmetrics()


def test_ledger_known_workload_window_and_totals():
    want, got = (_known_workload(p) for p in BOTH)
    assert got == want
    d = got[0]
    rows = {r["tenant"]: r for r in d["tenants"]}
    assert rows["alpha"]["total"]["queries"] == 3
    assert rows["alpha"]["total"]["datapoints"] == 105
    assert rows["alpha"]["window"] == {**dict.fromkeys(ttenants.FIELDS, 0.0),
                                       "queries": 1.0, "datapoints": 5.0}
    assert rows["beta"]["window"]["queries"] == 0 and rows["beta"]["total"]["queries"] == 1
    assert d["windowSecs"] == 300.0 and d["overflows"] == 0
    fam = got[1]["m3tpu_tenant_datapoints_scanned_total"]
    assert {c["labels"]["tenant"]: c["value"] for c in fam["children"]} == {
        "alpha": 105.0, "beta": 10.0}


def test_ledger_rejects_unknown_field():
    for p in BOTH:
        led = p.tenants.TenantLedger(registry=p.instrument.Registry(prefix="m3tpu_"))
        with pytest.raises(TypeError):
            led.charge("a", datapoint=1)  # a typo must not mint a field


def test_ledger_cardinality_cap_collapses_into_overflow():
    got = []
    for p in BOTH:
        led = p.tenants.TenantLedger(max_tenants=2, registry=p.instrument.Registry(prefix="m3tpu_"),
                                     clock=lambda: 0.0)
        for i in range(5):
            led.charge(f"t{i}", queries=1)
        got.append(led.dump())
    assert got[0] == got[1]
    rows = {r["tenant"]: r for r in got[1]["tenants"]}
    assert set(rows) == {"t0", "t1", ttenants.OVERFLOW_TENANT}
    assert rows[ttenants.OVERFLOW_TENANT]["total"]["queries"] == 3 and got[1]["overflows"] == 3


def _isolation(p):
    glob = p.GlobalEnforcer(p.QueryLimits(max_datapoints=1000))
    te = p.tenants.TenantEnforcers({"capped": p.QueryLimits(max_datapoints=5)},
                                   global_enforcer=glob)
    capped = p.Enforcer(p.QueryLimits(), te.scope_for("capped"))
    with pytest.raises(p.QueryLimitError) as ei:
        capped.charge(1, 50)
    capped.release()
    unwound = (glob.datapoints, te.scope_for("capped").datapoints)
    free = p.Enforcer(p.QueryLimits(), te.scope_for("free"))
    free.charge(1, 500)
    free.release()
    return ei.value.scope, str(ei.value), unwound, glob.datapoints


def test_tenant_scope_isolation_and_global_intact():
    want, got = (_isolation(p) for p in BOTH)
    assert want == got and got[0] == "tenant" and got[2] == (0, 0) and got[3] == 0


def test_global_scope_still_caps_above_tenants():
    got = []
    for p in BOTH:
        glob = p.GlobalEnforcer(p.QueryLimits(max_datapoints=100))
        te = p.tenants.TenantEnforcers({}, global_enforcer=glob)
        e = p.Enforcer(p.QueryLimits(), te.scope_for("any"))
        with pytest.raises(p.QueryLimitError) as ei:
            e.charge(1, 200)
        e.release()
        got.append((ei.value.scope, glob.datapoints))
    assert got[0] == got[1] == ("global", 0)


def test_tenant_enforcers_cap_shares_overflow_scope():
    for p in BOTH:
        te = p.tenants.TenantEnforcers({}, max_tenants=2,
                                       default_limits=p.QueryLimits(max_datapoints=7))
        a, b = te.scope_for("a"), te.scope_for("b")
        c, d = te.scope_for("c"), te.scope_for("d")
        assert c is d and c is te.scope_for(p.tenants.OVERFLOW_TENANT)
        assert c is not a and a is not b
        assert c.limits.max_datapoints == 7
        assert (c.scope, c.what) == ("tenant", "tenant __overflow__")


def test_load_tenant_limits(tmp_path):
    p = tmp_path / "limits.yml"
    p.write_text("default:\n  max_datapoints: 100\n"
                 "tenants:\n  alpha:\n    max_datapoints: 5\n  beta: {}\n")
    want, got = jtenants.load_tenant_limits(str(p)), ttenants.load_tenant_limits(str(p))
    assert got.default_limits == TQueryLimits(max_datapoints=100)
    assert got.by_tenant == {k: TQueryLimits(**vars(v)) for k, v in want.by_tenant.items()}
    assert got.by_tenant["alpha"].max_datapoints == 5 and got.by_tenant["beta"] == TQueryLimits()
    te = ttenants.TenantEnforcers.from_limit_set(got)
    assert te.scope_for("alpha").limits.max_datapoints == 5
    assert te.scope_for("gamma").limits.max_datapoints == 100
    for body in ("tenants:\n  alpha:\n    max_serie: 5\n", "tenantss: {}\n",
                 "tenants:\n  'bad id':\n    max_series: 1\n"):
        bad = tmp_path / "bad.yml"
        bad.write_text(body)
        for mod in (jtenants, ttenants):
            with pytest.raises(ValueError):
                mod.load_tenant_limits(str(bad))


def test_charge_writes_only_in_a_context(ledgers):
    for p in BOTH:
        p.tenants.charge_writes(5)  # outside a context: not attributed
        with p.tenants.tenant_context("writer"):
            p.tenants.charge_writes(3)
            p.tenants.charge_writes(0)
            with p.tenants.tenant_context(None):  # None keeps the outer tenant
                assert p.tenants.current() == "writer"
        assert p.tenants.current() is None
    assert ledgers["port"].dump() == ledgers["m3_tpu"].dump()
    assert ledgers["port"].window_totals("writer")["writes"] == 3


# ---------------------------------------------------------------------------
# tests/test_tenant.py: the engine and the records
# ---------------------------------------------------------------------------


def _tenant_db(p, path, n, op=False):
    db = p.database(path)
    db.create_namespace("default", p.NamespaceOptions())
    for i in range(n):
        labels = {"__name__": "m", **({"op": f"o{i % 3}"} if op else {})}
        db.write_tagged("default", p.make_tags(labels), T0 + i * NANOS, float(i))
    return db


def test_engine_422_counted_and_ring_stamped(tmp_path, ledgers):
    got = []
    for p in BOTH:
        db = _tenant_db(p, tmp_path / p.name, 20, op=True)
        try:
            te = p.tenants.TenantEnforcers({"capped": p.QueryLimits(max_datapoints=3)})
            eng = p.engine_for(p.m3s.M3Storage(db, "default"), tenant_enforcers=te)
            before = _counter_total(p, "query_limit_exceeded_total", scope="tenant")
            with p.tenants.tenant_context("capped"):
                with pytest.raises(p.QueryLimitError) as ei:
                    eng.query_range("m", T0, T0 + 20 * NANOS, NANOS)
            after = _counter_total(p, "query_limit_exceeded_total", scope="tenant")
            rec = _record(p, "m")
            got.append((str(ei.value), after - before, rec, ledgers[p.name].dump()))
        finally:
            db.close()
    assert got[0] == got[1]
    _, counted, rec, _ = got[1]
    assert counted == 1 and rec["tenant"] == "capped" and rec["limitExceeded"] == "tenant"
    assert rec["error"] is not None
    row = ledgers["port"].window_totals("capped")
    assert row["limit_rejections"] == 1 and row["errors"] == 1


def test_query_charges_ledger_and_stamps_records(tmp_path, ledgers):
    got = []
    for p in BOTH:
        db = _tenant_db(p, tmp_path / p.name, 10)
        try:
            eng = p.engine_for(p.m3s.M3Storage(db, "default"))
            with p.tenants.tenant_context("alpha"):
                r = eng.query_range("m", T0, T0 + 9 * NANOS, NANOS)
            alpha = _record(p, "m")
            eng.query_range("m", T0, T0 + 9 * NANOS, NANOS)
            anon = _record(p, "m")
            got.append((np.asarray(r.values), alpha, anon, ledgers[p.name].dump()))
        finally:
            db.close()
    np.testing.assert_array_equal(got[1][0], got[0][0])
    assert got[0][1:] == got[1][1:]
    _, alpha, anon, _ = got[1]
    assert alpha["tenant"] == "alpha" and alpha["limitExceeded"] is None
    assert anon["tenant"] == ttenants.DEFAULT_TENANT
    row = ledgers["port"].window_totals("alpha")
    assert row["queries"] == 1 and row["datapoints"] == 10
    assert row["bytes_streamed"] > 0 and row["bytes_resident"] == 0


def test_engine_with_both_scopes_and_a_deadline(tmp_path, ledgers):
    """The whole chain at once: admission bounded by an ambient deadline
    (net/resilience.deadline_scope), the tenant scope, then release and the
    cost memo, the same in both packages."""
    from m3_tpu.net.resilience import deadline_scope as jdeadline
    from m3_tpu_torch.net.resilience import deadline_scope as tdeadline

    got = []
    for p, scope in ((J, jdeadline), (T, tdeadline)):
        db = _tenant_db(p, tmp_path / p.name, 20, op=True)
        try:
            s = p.sched.QueryScheduler(max_inflight=1, max_queue=4, max_queue_wait=30.0)
            te = p.tenants.TenantEnforcers({"capped": p.QueryLimits(max_series=2)})
            eng = p.engine_for(p.m3s.M3Storage(db, "default"), scheduler=s, tenant_enforcers=te)
            rows = []
            with p.tenants.tenant_context("free"):
                rows.append(len(eng.query_range("m", T0, T0 + 20 * NANOS, NANOS).metas))
            with p.tenants.tenant_context("capped"):
                with pytest.raises(p.QueryLimitError):
                    eng.query_range("m", T0, T0 + 20 * NANOS, NANOS)
            s.admit("elsewhere", 1)
            t0 = time.monotonic()
            with scope(time.monotonic() + 0.05), p.tenants.tenant_context("free"):
                with pytest.raises(p.sched.QueryShedError) as ei:
                    eng.query_range("m", T0, T0 + 20 * NANOS, NANOS)
            rows.append((ei.value.reason, time.monotonic() - t0 < 2.0))
            s.release()
            got.append((rows, s.costs.series_estimate("m"), s.snapshot()["inflight"],
                        ledgers[p.name].dump()))
        finally:
            db.close()
    assert got[0] == got[1]
    assert got[1][0] == [3, ("deadline", True)] and got[1][1:3] == (3, 0)


def test_scheduler_stress_keeps_its_bounds(ledgers):
    """More threads than cores admitting and releasing with a short switch
    interval: the scheduler never runs more than ``max_inflight`` at once,
    every request ends admitted or shed, the shed counts (ledger and
    ``query_shed_total``) lose no update, and nothing stays in flight."""
    import os
    import sys

    s = tsched.QueryScheduler(max_inflight=3, max_queue=5, max_queue_wait=0.2)
    n_threads = min(4 * (os.cpu_count() or 2) + 4, 64)
    lock = threading.Lock()
    state = {"running": 0, "peak": 0, "admitted": 0, "shed": 0}
    before = _counter_total(T, "query_shed_total", tenant="stress")

    def worker():
        with ttenants.tenant_context("stress"):
            for _ in range(20):
                try:
                    s.admit("q", 1)
                except tsched.QueryShedError:
                    with lock:
                        state["shed"] += 1
                    continue
                with lock:
                    state["running"] += 1
                    state["peak"] = max(state["peak"], state["running"])
                    state["admitted"] += 1
                time.sleep(0.0005)
                with lock:
                    state["running"] -= 1
                s.release()

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        threads = [threading.Thread(target=worker, daemon=True) for _ in range(n_threads)]
        for t in threads:
            t.start()
        _join(threads, timeout=60.0)
    finally:
        sys.setswitchinterval(old)
    assert state["admitted"] + state["shed"] == 20 * n_threads
    assert state["peak"] <= 3 and state["admitted"] > 0
    snap = s.snapshot()
    assert snap["inflight"] == 0 and snap["queued"] == []
    assert (ledgers["port"].window_totals("stress") or {}).get("sheds", 0.0) == state["shed"]
    assert _counter_total(T, "query_shed_total", tenant="stress") - before == state["shed"]
