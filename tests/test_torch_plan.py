"""The one-program query plan (``m3_tpu_torch/query/plan.py``) and its
step-grid consolidation, kernel B-1, on the CPU (``device="cpu"``: the
kernels' twins).

- B-1's twin against the port's and ``m3_tpu.query.engine``'s
  ``consolidate_row``, and B-1's source built as host C++ against the twin,
  bit for bit, on seeded rows with every edge the rule has (no counted
  record, records only outside the window, steps before the first record
  and exactly ``lookback`` after one, equal timestamps, NaN / +-0 / +-inf /
  subnormal float points, int points at every mult), at P = 1, 720,
  2 * 720 + 24 and one past a shared-memory tile; and on the adversarial
  cases of ``torch_streams.consolidation_case`` (equal timestamps across a
  lane's run of steps and across a tile, repeated steps, a grid that steps
  back, T = 1, 31, 33, 77, empty rows between full ones, P = 1 and one past
  a tile), the host build at its own tile and at tiles of 256, and with
  other lane counts and runs, which move the merge walk's partition.
- ``Engine.query_range`` over the port's ``M3Storage`` through its
  ``Planner`` against ``m3_tpu``'s fused path (one query shape: the
  reference compiles one XLA program a shape) and against the port's own
  ``force_staged()`` path, values and metas bit for bit.
- Mirrors of ``tests/test_query_plan.py``'s cases with its routing reasons
  and counts: eligibility, the plan cache and its invalidations,
  coalescing, one device dispatch on a warm query.
- The port's divergence: a fault in the plan's device work is counted in
  ``query_plan_errors_total`` and raised; an ``Ineligible`` runs staged.
"""

import ctypes
import shutil
import subprocess
import threading

import numpy as np
import pytest
import torch

from m3_tpu.index.device.store import IndexDeviceOptions as JIndexDeviceOptions
from m3_tpu.query import engine as jengine
from m3_tpu.query import m3_storage as jm3s
from m3_tpu.resident.pool import ResidentOptions as JResidentOptions
from m3_tpu.storage.database import Database as JDatabase
from m3_tpu.storage.database import NamespaceOptions as JNamespaceOptions
from m3_tpu_torch.codec.m3tsz import Encoder
from m3_tpu_torch.index.device import IndexDeviceOptions
from m3_tpu_torch.ops import _build
from m3_tpu_torch.ops import decode as D
from m3_tpu_torch.query import engine as tengine
from m3_tpu_torch.query import plan as qplan
from m3_tpu_torch.query import stats
from m3_tpu_torch.query.engine import Engine
from m3_tpu_torch.query.m3_storage import M3Storage
from m3_tpu_torch.resident import ResidentOptions
from m3_tpu_torch.storage.database import Database as _Database
from m3_tpu_torch.storage.database import NamespaceOptions
from m3_tpu_torch.storage.fs import FilesetID, write_fileset
from m3_tpu_torch.utils.serialize import encode_tags
from torch_streams import CONSOLIDATION_CASES, consolidation_case, consolidation_records

NANOS = 1_000_000_000
HOUR = 3600 * NANOS
T0 = 1_600_000_000 * NANOS
STEP = 10 * NANOS
SPAN = (T0 + 60 * NANOS, T0 + 460 * NANOS, 20 * NANOS)
POW10 = np.array([1.0, 10.0, 100.0, 1e3, 1e4, 1e5, 1e6])


# ---------------------------------------------------------------------------
# B-1: the twin and the host build
# ---------------------------------------------------------------------------


def _decode_result(rec) -> D.DecodeResult:
    t = {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in rec.items()}
    return D.DecodeResult(ts=t["ts"], bits=t["bits"], point_is_float=t["point_is_float"],
                          mult=t["mult"], valid=t["valid"],
                          err=torch.zeros(rec["ts"].shape[0], dtype=torch.bool))


def _host_grid(rec, grid, lo, hi, lookback, consolidate_row):
    """Each row's counted samples, finalized in numpy, through a
    consolidate_row (the port's or the reference's)."""
    out = []
    for r in range(rec["ts"].shape[0]):
        m = rec["valid"][r] & (rec["ts"][r] >= lo) & (rec["ts"][r] < hi)
        bits = rec["bits"][r][m]
        vals = np.where(rec["point_is_float"][r][m], bits.view(np.float64),
                        bits.astype(np.float64) / POW10[np.minimum(rec["mult"][r][m], 6)])
        out.append(consolidate_row(rec["ts"][r][m], vals, grid, lookback))
    return np.stack(out) if out else np.zeros((0, len(grid)))


def _same_bits(a, b) -> bool:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return a.shape == b.shape and np.array_equal(a.view(np.int64), b.view(np.int64))


SHAPES = [(12, 1), (30, 720), (24, 2 * 720 + 24), (6, 8193)]  # the last one past a tile


@pytest.mark.parametrize("s,p", SHAPES)
def test_b1_twin_matches_consolidate_row(s, p):
    """The twin == the port's and the reference's consolidate_row over each
    row's counted samples, bit for bit (NaN payloads included), and its
    counts are each row's counted records, as a tensor."""
    rec, grid, lo, hi, lookback = consolidation_records(s, p, seed=p)
    values, counts = qplan.consolidate_grid(_decode_result(rec), lo, hi, grid, lookback)
    assert values.dtype == torch.float64 and values.shape == (s, len(grid))
    assert counts.dtype == torch.int32
    counted = rec["valid"] & (rec["ts"] >= lo) & (rec["ts"] < hi)
    np.testing.assert_array_equal(counts.numpy(), counted.sum(axis=1))
    for rule in (tengine.consolidate_row, jengine.consolidate_row):
        assert _same_bits(values.numpy(), _host_grid(rec, grid, lo, hi, lookback, rule))
    v = values.numpy()
    if p > 1:  # the generator's edges are all present
        assert np.isnan(v[0]).all() and np.isnan(v[1]).all()  # none counted; all outside
        assert (~np.isnan(v)).any() and np.isnan(v[:, 0]).all()  # steps before any record
        nan_payload = v.view(np.int64) == 0x7FF0000000000123
        assert nan_payload.any()


def test_b1_twin_edges_by_hand():
    """A step exactly lookback after its record is NaN, one step inside is
    kept; of equal timestamps the last wins; a step before the first
    record is NaN; int points divide by 10**mult."""
    ts = np.array([[100, 130, 130, 130, 200, 999]], np.int64)
    bits = np.array([[7, 11, np.float64(2.5).view(np.int64), 13, 123456, 5]], np.int64)
    pif = np.array([[False, False, True, False, False, False]])
    mult = np.array([[0, 1, 0, 3, 6, 0]], np.uint8)
    valid = np.array([[True, True, True, True, True, False]])
    rec = dict(ts=ts, bits=bits, point_is_float=pif, mult=mult, valid=valid)
    grid = np.array([90, 100, 129, 130, 159, 160, 200, 229, 230, 999], np.int64)
    values, counts = qplan.consolidate_grid(_decode_result(rec), 0, 1000, grid, 30)
    want = [np.nan, 7.0, 7.0, 0.013, 0.013, np.nan, 0.123456, 0.123456, np.nan, np.nan]
    assert _same_bits(values.numpy()[0], want)
    assert int(counts[0]) == 5
    # the window drops the records at 130: the step at 130 finds 100's, 30 old
    values, counts = qplan.consolidate_grid(_decode_result(rec), 0, 130, grid, 30)
    assert _same_bits(values.numpy()[0, :4], [np.nan, 7.0, 7.0, np.nan])
    assert int(counts[0]) == 1


@pytest.fixture(scope="module")
def host_b1(tmp_path_factory):
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        pytest.skip("no host C++ compiler to build the kernel source for the CPU")
    out = tmp_path_factory.mktemp("kernel") / "consolidate_grid_host.so"
    subprocess.run(
        [cxx, "-x", "c++", "-std=c++17", "-O2", "-ffp-contract=off", "-shared", "-fPIC",
         "-o", str(out), str(_build.SOURCES["consolidate_grid"][0])],
        check=True, capture_output=True, text=True,
    )
    lib = ctypes.CDLL(str(out))
    P, I, I64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    # ts, bits, pif, mult, valid, s, p, lo, hi, grid, t, lookback, values, counts, tile,
    # lanes, run
    lib.m3_consolidate_grid_host.argtypes = [P, P, P, P, P, I64, I64, I64, I64, P, I64, I64,
                                             P, P, I, I, I]
    lib.m3_consolidate_grid_host.restype = I
    lib.m3_consolidate_grid_tile_records.restype = I
    return lib


def _run_host(lib, rec, grid, lo, hi, lookback, tile, lanes=32, run=0):
    s, p = rec["ts"].shape
    values = np.empty((s, len(grid)), np.float64)
    counts = np.empty(s, np.int32)
    a = {k: np.ascontiguousarray(v) for k, v in rec.items()}
    grid = np.ascontiguousarray(grid, np.int64)
    rc = lib.m3_consolidate_grid_host(
        a["ts"].ctypes.data, a["bits"].ctypes.data, a["point_is_float"].ctypes.data,
        a["mult"].ctypes.data, a["valid"].ctypes.data, s, p, lo, hi, grid.ctypes.data,
        len(grid), lookback, values.ctypes.data, counts.ctypes.data, tile, lanes, run)
    assert rc == 0
    return values, counts


@pytest.mark.parametrize("tile", [0, 256])
@pytest.mark.parametrize("s,p", SHAPES)
def test_b1_source_host_build_matches_twin(host_b1, s, p, tile):
    """B-1's host build (the kernel's tile walk, compaction order and merge
    walk over 32 lanes' runs of steps, one thread) == the twin bit for bit,
    at the kernel's own tile (0) and at tiles of 256 records, which split
    every row past 256 records."""
    rec, grid, lo, hi, lookback = consolidation_records(s, p, seed=p + 1)
    if p == 8193:
        assert p == host_b1.m3_consolidate_grid_tile_records() + 1
    got, got_counts = _run_host(host_b1, rec, grid, lo, hi, lookback, tile)
    want, want_counts = qplan.consolidate_grid_reference(_decode_result(rec), lo, hi, grid,
                                                         lookback)
    assert _same_bits(got, want.numpy())
    np.testing.assert_array_equal(got_counts, want_counts.numpy())


@pytest.mark.parametrize("case", CONSOLIDATION_CASES)
def test_b1_twin_cases_match_consolidate_row(case):
    """The twin == the port's and the reference's consolidate_row on B-1's
    adversarial cases, bit for bit, counts too."""
    rec, grid, lo, hi, lookback = consolidation_case(case, seed=3)
    values, counts = qplan.consolidate_grid(_decode_result(rec), lo, hi, grid, lookback)
    counted = rec["valid"] & (rec["ts"] >= lo) & (rec["ts"] < hi)
    np.testing.assert_array_equal(counts.numpy(), counted.sum(axis=1))
    for rule in (tengine.consolidate_row, jengine.consolidate_row):
        assert _same_bits(values.numpy(), _host_grid(rec, grid, lo, hi, lookback, rule))


@pytest.mark.parametrize("tile", [0, 256])
@pytest.mark.parametrize("case", CONSOLIDATION_CASES)
def test_b1_host_build_cases_match_twin(host_b1, case, tile):
    """B-1's host build == the twin bit for bit on the adversarial cases, at
    the kernel's tile and at tiles of 256 (equal timestamps across a tile
    boundary, a row one past a tile)."""
    rec, grid, lo, hi, lookback = consolidation_case(case, seed=4)
    got, got_counts = _run_host(host_b1, rec, grid, lo, hi, lookback, tile)
    want, want_counts = qplan.consolidate_grid_reference(_decode_result(rec), lo, hi, grid,
                                                         lookback)
    assert _same_bits(got, want.numpy())
    np.testing.assert_array_equal(got_counts, want_counts.numpy())


@pytest.mark.parametrize("lanes,run", [(1, 0), (7, 0), (7, 5), (32, 1)])
@pytest.mark.parametrize("s,p", SHAPES)
def test_b1_host_build_partitions_match_twin(host_b1, s, p, lanes, run):
    """The merge walk over other partitions of the grid == the twin: one
    lane walking every step, 7 lanes (runs not a divisor of T), runs of 5
    steps (many passes) and runs of one step (every step searched)."""
    rec, grid, lo, hi, lookback = consolidation_records(s, p, seed=p + 2)
    got, got_counts = _run_host(host_b1, rec, grid, lo, hi, lookback, 0, lanes, run)
    want, want_counts = qplan.consolidate_grid_reference(_decode_result(rec), lo, hi, grid,
                                                         lookback)
    assert _same_bits(got, want.numpy())
    np.testing.assert_array_equal(got_counts, want_counts.numpy())


def test_b1_host_build_refuses_bad_arguments(host_b1):
    """The host entry returns 1 for what the kernel does not take: a tile
    past the kernel's, no lanes, a run past the most a lane takes."""
    rec, grid, lo, hi, lookback = consolidation_records(2, 8)
    a = {k: np.ascontiguousarray(v) for k, v in rec.items()}
    values = np.empty((2, len(grid)), np.float64)
    counts = np.empty(2, np.int32)
    g = np.ascontiguousarray(grid, np.int64)
    for tile, lanes, run in ((host_b1.m3_consolidate_grid_tile_records() + 1, 32, 0),
                             (0, 0, 0), (0, 32, 25), (-1, 32, 0)):
        assert host_b1.m3_consolidate_grid_host(
            a["ts"].ctypes.data, a["bits"].ctypes.data, a["point_is_float"].ctypes.data,
            a["mult"].ctypes.data, a["valid"].ctypes.data, 2, 8, lo, hi, g.ctypes.data,
            len(g), lookback, values.ctypes.data, counts.ctypes.data, tile, lanes, run) == 1


def test_b1_cpu_tensor_runs_the_twin():
    """A CPU tensor never reaches the kernel: no launch is counted."""
    rec, grid, lo, hi, lookback = consolidation_records(4, 40)
    before = qplan.LAUNCHES
    qplan.consolidate_grid(_decode_result(rec), lo, hi, grid, lookback)
    assert qplan.LAUNCHES == before


# ---------------------------------------------------------------------------
# the Planner: databases
# ---------------------------------------------------------------------------


def _tags(i, name=b"pm"):
    return ((b"__name__", name), (b"job", b"app%d" % (i % 3)), (b"s", b"%03d" % i))


def _seed(db, n_series=24, n_points=48, seed=0, name=b"pm", flush=True):
    """tests/test_query_plan.py's mixed value modes: float-mode (random),
    int-mode (integers) and scaled-decimal int-mode (the encoder's mult
    path)."""
    rng = np.random.default_rng(seed)
    sids = []
    for i in range(n_series):
        tags = _tags(i, name)
        sid = encode_tags(tags)
        db.write_tagged("ns", tags, T0, float(i))
        if i % 3 == 0:
            vals = [float(j % 9) for j in range(n_points - 1)]
        elif i % 3 == 1:
            vals = [round(float(rng.standard_normal()), 2) for _ in range(n_points - 1)]
        else:
            vals = [float(rng.standard_normal()) for _ in range(n_points - 1)]
        db.write_batch("ns", [(sid, T0 + (j + 1) * STEP, v) for j, v in enumerate(vals)])
        sids.append(sid)
    if flush:
        db.flush("ns", T0 + 4 * HOUR)
    return sids


def _port_db(path):
    db = _Database(str(path), num_shards=2, commitlog_enabled=False, device="cpu",
                   resident_options=ResidentOptions(max_bytes=16 << 20),
                   index_device_options=IndexDeviceOptions(max_bytes=64 << 20))
    db.create_namespace("ns", NamespaceOptions(block_size_nanos=HOUR))
    return db


@pytest.fixture
def plan_db(tmp_path):
    db = _port_db(tmp_path / "db")
    yield db
    db.close()


@pytest.fixture(scope="module")
def pair(tmp_path_factory):
    """(m3_tpu Database, port Database) over the same seeded writes; the
    tests that use it leave both as they found them."""
    base = tmp_path_factory.mktemp("pair")
    j = JDatabase(str(base / "j"), num_shards=2, commitlog_enabled=False,
                  resident_options=JResidentOptions(max_bytes=16 << 20),
                  index_device_options=JIndexDeviceOptions(max_bytes=64 << 20))
    j.create_namespace("ns", JNamespaceOptions(block_size_nanos=HOUR))
    t = _port_db(base / "t")
    for db in (j, t):
        _seed(db)
    yield j, t
    j.close()
    t.close()


def _run(eng, query, span, staged=False, explain=False, stats_mod=stats):
    """(values, metas, sealed QueryStats) for one evaluation."""
    st = stats_mod.start(query)
    assert st is not None
    if explain:
        st.record_routing = True
    try:
        if staged:
            with qplan.force_staged():
                r = eng.query_range(query, *span)
        else:
            r = eng.query_range(query, *span)
    finally:
        stats_mod.finish(st, 0.0)
    return np.asarray(r.values), [m.tags for m in r.metas], st


def _equal(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    view = np.int64 if a.itemsize == 8 else np.int32
    return np.array_equal(np.isnan(a), np.isnan(b)) and np.array_equal(
        np.where(np.isnan(a), 0, a).view(view), np.where(np.isnan(b), 0, b).view(view))


def _assert_bitexact(eng, query, span, expect_fused=True):
    vf, mf, stf = _run(eng, query, span)
    vs, ms, _ = _run(eng, query, span, staged=True)
    assert mf == ms, f"meta mismatch for {query}"
    assert _equal(vf, vs), f"value mismatch for {query}"
    if expect_fused:
        assert stf.plan_hits + stf.plan_misses >= 1, f"not fused: {query}"
        assert stf.plan_fallbacks == 0
    return stf


def _reasons(st, path="staged"):
    return [r["reason"] for r in st.routing if r["path"] == path]


# ---------------------------------------------------------------------------
# the Planner against m3_tpu's, and against the port's staged path
# ---------------------------------------------------------------------------


def test_plan_matches_reference_fused_and_port_staged(pair):
    """One query shape that composes most of the plan (a prefix regexp, a
    negated conjunction, a temporal function): the port's plan == m3_tpu's
    fused plan, values and metas bit for bit, and == the port's
    force_staged() path; both plan-served."""
    j, t = pair
    q = 'avg_over_time(pm{job=~"app.*",s!="003"}[2m])'
    from m3_tpu.query import stats as jstats

    vj, mj, stj = _run(jengine.Engine(jm3s.M3Storage(j, "ns")), q, SPAN, stats_mod=jstats)
    assert stj.plan_hits + stj.plan_misses == 1 and stj.plan_fallbacks == 0
    eng = Engine(M3Storage(t, "ns"), device="cpu")
    vt, mt, stt = _run(eng, q, SPAN)
    assert (stt.plan_hits, stt.plan_misses, stt.plan_fallbacks) == (
        stj.plan_hits, stj.plan_misses, stj.plan_fallbacks)
    assert mt == mj and len(mt) == 23
    assert _equal(vt, vj) and (~np.isnan(vt)).any()
    _assert_bitexact(eng, q, SPAN)


QUERIES = [
    'rate(pm{job=~"app.*"}[2m])',
    'increase(pm{job="app0"}[90s])',
    'avg_over_time(pm{job=~"app.*",s!="003"}[2m])',
    'rate(pm{job=~"app0|app2"}[2m])',
    'sum_over_time(pm{job!~"app1.*"}[2m])',
    'pm{job="app1"}',
    'sum(rate(pm{job=~"app.*"}[2m]))',
]


@pytest.mark.parametrize("query", QUERIES)
def test_plan_vs_staged_bitexact_across_shapes(pair, query):
    """The reference's per-shape sweep (marked slow there for its XLA
    compiles): each shape plan-served and == force_staged() bit for bit."""
    _, t = pair
    _assert_bitexact(Engine(M3Storage(t, "ns"), device="cpu"), query, SPAN)


def test_plan_matches_doc_ids_and_order(pair):
    """The plan's rows come in bitmap (segment doc) order: the staged
    path's index order, every series once."""
    _, t = pair
    eng = Engine(M3Storage(t, "ns"), device="cpu")
    vf, mf, st = _run(eng, 'pm{job=~"app.*"}', SPAN)
    assert st.plan_misses + st.plan_hits >= 1
    _vs, ms, _ = _run(eng, 'pm{job=~"app.*"}', SPAN, staged=True)
    assert mf == ms and len(mf) == 24


def test_warm_plan_is_one_device_dispatch(pair):
    _, t = pair
    eng = Engine(M3Storage(t, "ns"), device="cpu")
    q = 'rate(pm{job=~"app.*"}[2m])'
    _run(eng, q, SPAN)  # build
    _vf, _mf, st = _run(eng, q, SPAN)
    assert st.plan_hits == 1 and st.plan_misses == 0
    assert st.device_dispatches == 1, st.to_dict()
    assert st.to_dict()["deviceDispatches"] == 1 and st.to_dict()["planHits"] == 1
    _vs, _ms, sts = _run(eng, q, SPAN, staged=True)
    # the staged path pays its per-stage dispatches (the device index's K1
    # and K2 seams, the resident assembly and records decode), as the
    # reference's does (tests/test_query_plan.py asserts > 1 there too)
    assert sts.device_dispatches > 1


# ---------------------------------------------------------------------------
# eligibility (mirrors of tests/test_query_plan.py)
# ---------------------------------------------------------------------------


def test_host_regexp_leaf_falls_back_with_reason(plan_db):
    _seed(plan_db)
    eng = Engine(M3Storage(plan_db, "ns"), device="cpu")
    q = 'rate(pm{job=~"app.*[02]"}[2m])'  # general class: host automaton
    vf, mf, st = _run(eng, q, SPAN, explain=True)
    assert st.plan_fallbacks >= 1 and st.plan_hits == 0
    assert "plan:host-regexp-leaf" in _reasons(st)
    vs, ms, _ = _run(eng, q, SPAN, staged=True)
    assert mf == ms and _equal(vf, vs)


def test_buffer_overlay_falls_back(plan_db):
    _seed(plan_db)
    eng = Engine(M3Storage(plan_db, "ns"), device="cpu")
    q = 'rate(pm{job=~"app.*"}[2m])'
    _assert_bitexact(eng, q, SPAN)
    # a live write of an UNINDEXED series id into the range: the buffer
    # overlay alone
    plan_db.write("ns", b"unindexed-overlay", T0 + 200 * NANOS, 123.0)
    vf, mf, st = _run(eng, q, SPAN, explain=True)
    assert st.plan_fallbacks >= 1
    assert "plan:buffer-overlay" in _reasons(st)
    vs, ms, _ = _run(eng, q, SPAN, staged=True)
    assert mf == ms and _equal(vf, vs)


def test_partially_resident_falls_back_never_lies(plan_db):
    _seed(plan_db)
    eng = Engine(M3Storage(plan_db, "ns"), device="cpu")
    q = 'rate(pm{job=~"app.*"}[2m])'
    _assert_bitexact(eng, q, SPAN)
    ns = plan_db.namespaces["ns"]
    sid = encode_tags(_tags(0))
    shard = ns.shard_for(sid)
    keys, _ = shard.scan_block_keys(sid, SPAN[0] - 5 * 60 * NANOS, SPAN[1])
    assert keys
    plan_db.resident_pool.invalidate_series_block("ns", shard.id, sid, keys[0].block_start)
    vf, mf, st = _run(eng, q, SPAN, explain=True)
    assert st.plan_hits == 0  # the stale plan must NOT serve
    assert st.plan_fallbacks >= 1
    assert "plan:non-resident-block" in _reasons(st)
    vs, ms, _ = _run(eng, q, SPAN, staged=True)
    assert mf == ms and _equal(vf, vs)


def _new_volume(db, sid, stream_of, volume=1):
    """Supersede ``sid``'s block with a new volume holding ``stream_of``
    (the cold-flush supersession shape), re-admitted at seal."""
    ns = db.namespaces["ns"]
    bsz = ns.opts.block_size_nanos
    bs = (T0 // bsz) * bsz
    shard = ns.shard_for(sid)
    reader = shard.reader(FilesetID("ns", shard.id, bs, volume - 1))
    series = {s: reader.stream(s) for s in reader.series_ids}
    series[sid] = stream_of
    fid = FilesetID("ns", shard.id, bs, volume)
    with shard.lock:
        write_fileset(db.base, fid, series, bsz)
        shard._invalidate_filesets()
        shard._readers.pop(bs, None)
        payload = shard._collect_admission_locked([fid])
    db.resident_pool.invalidate_block("ns", shard.id, bs, below_volume=volume)
    shard._admit_payload(payload)


def test_annotated_err_lane_stitches_through_host(plan_db):
    # the annotated doc is written BEFORE the seed's flush so it lands in
    # the SEALED index segment
    tags = ((b"__name__", b"pm"), (b"job", b"ann"), (b"s", b"ann"))
    sid = encode_tags(tags)
    plan_db.write_tagged("ns", tags, T0 + 30 * NANOS, 1.0)
    _seed(plan_db, n_series=8)
    enc = Encoder(T0)
    enc.encode(T0 + 60 * NANOS, 100.0, annotation=b"x")
    enc.encode(T0 + 120 * NANOS, 200.0)
    _new_volume(plan_db, sid, enc.stream())
    eng = Engine(M3Storage(plan_db, "ns"), device="cpu")
    q = 'pm{job=~"a.*"}'  # matches app* and ann
    vf, mf, st = _run(eng, q, SPAN, explain=True)
    assert st.plan_hits + st.plan_misses >= 1, st.to_dict()
    assert any("annotated-err-lane" in r for r in _reasons(st, "fused"))
    vs, ms, _ = _run(eng, q, SPAN, staged=True)
    assert mf == ms and _equal(vf, vs)
    row = vf[mf.index(tuple(sorted(tags)))]
    assert 100.0 in row and 200.0 in row


# ---------------------------------------------------------------------------
# plan-cache keying / invalidation
# ---------------------------------------------------------------------------


def test_plan_cache_hits_and_lru(plan_db, monkeypatch):
    _seed(plan_db)
    storage = M3Storage(plan_db, "ns")
    eng = Engine(storage, device="cpu")
    q = 'rate(pm{job=~"app.*"}[2m])'
    _run(eng, q, SPAN)
    before = storage.planner.hits
    _run(eng, q, SPAN)
    _run(eng, q, SPAN)
    assert storage.planner.hits == before + 2
    assert len(storage.planner._cache) == 1
    # the LRU cap (M3_TPU_QUERY_PLAN_CACHE): a second plan displaces the first
    monkeypatch.setenv("M3_TPU_QUERY_PLAN_CACHE", "1")
    _run(eng, 'pm{job="app1"}', SPAN)
    assert len(storage.planner._cache) == 1
    misses = storage.planner.misses
    _run(eng, q, SPAN)
    assert storage.planner.misses == misses + 1


def test_plan_invalidates_on_volume_bump(plan_db):
    sids = _seed(plan_db, n_series=8)
    storage = M3Storage(plan_db, "ns")
    eng = Engine(storage, device="cpu")
    q = 'pm{job=~"app.*"}'
    _run(eng, q, SPAN)
    assert storage.planner.misses == 1
    enc = Encoder(T0)
    enc.encode(T0 + 60 * NANOS, 4242.0)
    _new_volume(plan_db, sids[0], enc.stream())
    v1, m1, st = _run(eng, q, SPAN, explain=True)
    # the cached plan must NOT have served stale volume-0 pages
    assert st.plan_hits == 0
    assert storage.planner.misses >= 2 or st.plan_fallbacks >= 1
    vs, ms, _ = _run(eng, q, SPAN, staged=True)
    assert m1 == ms and _equal(v1, vs)
    assert 4242.0 in v1[m1.index(tuple(sorted(_tags(0))))]


def test_plan_invalidates_on_eviction_and_clear(plan_db):
    _seed(plan_db)
    storage = M3Storage(plan_db, "ns")
    eng = Engine(storage, device="cpu")
    q = 'rate(pm{job=~"app.*"}[2m])'
    _assert_bitexact(eng, q, SPAN)
    plan_db.resident_pool.clear()  # operator eviction churn
    vf, mf, st = _run(eng, q, SPAN, explain=True)
    assert st.plan_hits == 0
    assert st.plan_fallbacks >= 1
    # the fallback path releases stale entries
    assert len(storage.planner._cache) == 0
    vs, ms, _ = _run(eng, q, SPAN, staged=True)
    assert mf == ms and _equal(vf, vs)


def test_plan_invalidates_on_segment_swap(plan_db):
    _seed(plan_db)
    storage = M3Storage(plan_db, "ns")
    eng = Engine(storage, device="cpu")
    q = 'pm{job=~"app.*"}'
    _run(eng, q, SPAN)
    misses0 = storage.planner.misses
    # an index-only doc in the SAME index block, then a flush: the block's
    # segments compact into a NEW segment (an identity swap)
    tags = ((b"__name__", b"pm"), (b"job", b"app9"), (b"s", b"zzz"))
    plan_db.namespaces["ns"].index.write(encode_tags(tags), tags, T0 + 100 * NANOS)
    plan_db.flush("ns", T0 + 4 * HOUR)
    vf, mf, st = _run(eng, q, SPAN)
    assert st.plan_hits == 0
    assert storage.planner.misses == misses0 + 1
    vs, ms, _ = _run(eng, q, SPAN, staged=True)
    assert mf == ms
    assert tuple(sorted(tags)) in mf  # no data: an all-NaN row, both paths
    assert _equal(vf, vs)


def test_plan_invalidates_on_new_sealed_block(plan_db):
    _seed(plan_db)
    storage = M3Storage(plan_db, "ns")
    eng = Engine(storage, device="cpu")
    wide = (T0 + 60 * NANOS, T0 + HOUR + 600 * NANOS, 60 * NANOS)
    q = 'pm{job=~"app.*"}'
    _run(eng, q, wide)
    tags = _tags(0)
    plan_db.write_tagged("ns", tags, T0 + HOUR + 100 * NANOS, 777.0)
    plan_db.flush("ns", T0 + 8 * HOUR)
    vf, mf, st = _run(eng, q, wide)
    assert st.plan_hits == 0  # the stale block set must not serve
    vs, ms, _ = _run(eng, q, wide, staged=True)
    assert mf == ms and _equal(vf, vs)
    assert 777.0 in vf[mf.index(tuple(sorted(tags)))]


# ---------------------------------------------------------------------------
# coalescing
# ---------------------------------------------------------------------------


def test_concurrent_identical_queries_coalesce_to_one_scan(plan_db):
    """N identical eligible queries arriving together execute as fewer
    plan executions than queries; followers get copies of the leader's
    values, and the answers equal a solo run's."""
    _seed(plan_db)
    storage = M3Storage(plan_db, "ns")
    eng = Engine(storage, device="cpu")
    q = 'rate(pm{job=~"app.*"}[2m])'
    baseline, base_metas, _ = _run(eng, q, SPAN)
    n = 8
    barrier = threading.Barrier(n)
    rows, recs, errs = [None] * n, [None] * n, []
    gate = threading.Event()
    execute = storage.planner._execute

    def slow_execute(*a, **k):
        gate.wait(5)  # hold the leader until every follower has arrived
        return execute(*a, **k)

    storage.planner._execute = slow_execute

    def worker(i):
        st = stats.start(q)
        try:
            barrier.wait()
            r = eng.query_range(q, *SPAN)
            rows[i] = (r.values, [m.tags for m in r.metas])
        except Exception as exc:  # surfaced below
            errs.append(exc)
        finally:
            stats.finish(st, 0.0)
            recs[i] = st

    threads = [threading.Thread(target=worker, args=(i,), daemon=True) for i in range(n)]
    for t in threads:
        t.start()
    threading.Timer(0.5, gate.set).start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    assert not errs, errs
    dispatches = sum(st.device_dispatches for st in recs)
    coalesced = sum(st.plan_coalesced for st in recs)
    assert dispatches < n, [st.device_dispatches for st in recs]
    assert coalesced >= 1 and coalesced == storage.planner.coalesced
    for vals, metas in rows:
        assert metas == base_metas and _equal(vals.numpy(), baseline)
    for i in range(1, n):
        assert rows[0][0].data_ptr() != rows[i][0].data_ptr()


def test_coalesce_key_distinguishes_spans(plan_db):
    _seed(plan_db)
    storage = M3Storage(plan_db, "ns")
    eng = Engine(storage, device="cpu")
    q = 'rate(pm{job=~"app.*"}[2m])'
    _run(eng, q, SPAN)
    before = storage.planner.coalesced
    _run(eng, q, (T0 + 80 * NANOS, T0 + 480 * NANOS, 20 * NANOS))
    _run(eng, q, SPAN)
    assert storage.planner.coalesced == before


# ---------------------------------------------------------------------------
# the port's divergence: a device fault raises
# ---------------------------------------------------------------------------


def test_plan_device_fault_is_counted_and_raised(plan_db, monkeypatch):
    """A fault in the plan's device work (here B-1's wrapper raising, as a
    failed launch would) is counted in query_plan_errors_total and raised
    out of the query; it is neither a fallback nor served staged."""
    _seed(plan_db)
    storage = M3Storage(plan_db, "ns")
    eng = Engine(storage, device="cpu")
    q = 'rate(pm{job=~"app.*"}[2m])'

    def broken(*a, **k):
        raise RuntimeError("consolidate_grid kernel launch failed: CUDA error 700")

    monkeypatch.setattr(qplan, "consolidate_grid", broken)
    errors, fallbacks = qplan._M_ERRORS.value, qplan._M_FALLBACKS.value
    with pytest.raises(RuntimeError, match="CUDA error 700"):
        _run(eng, q, SPAN)
    assert qplan._M_ERRORS.value == errors + 1
    assert qplan._M_FALLBACKS.value == fallbacks and storage.planner.fallbacks == 0
    monkeypatch.undo()
    # an Ineligible is a route: recorded, counted as a fallback, served staged
    vf, mf, st = _run(eng, 'rate(pm{job=~"app.*[02]"}[2m])', SPAN, explain=True)
    assert st.plan_fallbacks == 1 and "plan:host-regexp-leaf" in _reasons(st)
    assert qplan._M_ERRORS.value == errors + 1


def test_deliberate_bypasses_count_no_fallback(plan_db, monkeypatch):
    _seed(plan_db)
    storage = M3Storage(plan_db, "ns")
    eng = Engine(storage, device="cpu")
    q = 'rate(pm{job=~"app.*"}[2m])'
    _vs, _ms, st = _run(eng, q, SPAN, staged=True, explain=True)
    assert "plan:force-staged" in _reasons(st) and st.plan_fallbacks == 0
    monkeypatch.setenv("M3_TPU_QUERY_PLAN", "0")
    _vs, _ms, st = _run(eng, q, SPAN, explain=True)
    assert "plan:plan-disabled" in _reasons(st) and st.plan_fallbacks == 0
    assert storage.planner.fallbacks == 0


def test_engine_fetch_grid_returns_device_values(plan_db):
    """M3Storage.fetch_grid: (metas, values on the pool's device,
    datapoints) with the datapoints of the window, as the staged fetch
    counts them."""
    _seed(plan_db)
    st = M3Storage(plan_db, "ns")
    from m3_tpu_torch.query.promql import Matcher

    m = [Matcher("__name__", "=", "pm")]
    lo, hi = T0, T0 + 200 * NANOS
    grid = np.arange(T0, hi, 20 * NANOS, dtype=np.int64)
    metas, values, datapoints = st.fetch_grid(m, lo, hi, grid, 30 * NANOS)
    assert isinstance(values, torch.Tensor) and values.device.type == "cpu"
    assert values.shape == (24, len(grid))
    raw = st.fetch(m, lo, hi)
    assert datapoints == sum(len(t) for _, t, _ in raw) == 24 * 20
    assert [m.tags for m in metas] == [tags for tags, _, _ in raw]
