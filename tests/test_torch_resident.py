"""Port parity for decode from residency (m3_tpu_torch.resident,
m3_tpu_torch.ops.sideplane and the resident lane assembly of
m3_tpu_torch.parallel.scan), on the CPU.

- The side-plane packers and the host unpack equal m3_tpu.ops.sideplane's,
  overflow cases included; the torch device unpack equals the JAX one.
- Pool mechanics mirror tests/test_resident.py: page accounting and the
  zero page, LRU eviction and free-list reuse, the span limit, a corrupt
  entry raising, plan misses, the lease fence (in place vs copy), failed
  uploads, invalidation.
- The device lane assembly equals the host packers bit for bit, so the
  resident scan equals the streamed scan bit for bit; against the JAX
  package's resident scan (Pallas kernel in interpret mode) every
  per-series array and the count/min/max totals are bit-identical and the
  total sum is within rtol 1e-6 (torch and XLA add the series in different
  orders); resident fetches equal the host codec.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from m3_tpu.cache.block_cache import BlockKey as JBlockKey
from m3_tpu.codec.m3tsz import Encoder, decode
from m3_tpu.ops import chunked as jchunked
from m3_tpu.ops import sideplane as jside
from m3_tpu.resident import ResidentOptions as JOptions
from m3_tpu.resident import ResidentPool as JPool
from m3_tpu.resident import resident_scan_totals as j_resident_scan_totals
from m3_tpu_torch.cache.block_cache import BlockKey
from m3_tpu_torch.ops import chunked as tchunked
from m3_tpu_torch.ops import fused as tfused
from m3_tpu_torch.ops import sideplane as tside
from m3_tpu_torch.parallel import scan as tscan
from m3_tpu_torch.resident import (
    ResidentOptions,
    ResidentPool,
    ResidentPoolError,
    resident_fetch_arrays,
    resident_scan_totals,
    streamed_scan_totals,
)
from m3_tpu_torch.resident import pool as pool_mod
from m3_tpu_torch.resident.pool import ConfigError

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS


def _stream(values, t0=T0, step=NANOS):
    enc = Encoder(t0)
    t = t0
    for v in values:
        t += step
        enc.encode(t, float(v))
    return enc.stream()


def _random_series(rng, n_series, max_points=97):
    """Mixed workload: int gauges, true floats, big magnitudes, negatives,
    irregular steps, varied lengths."""
    streams = []
    for i in range(n_series):
        n = int(rng.integers(1, max_points))
        kind = i % 4
        if kind == 0:
            vals = rng.integers(-1000, 1000, n).astype(np.float64)
        elif kind == 1:
            vals = rng.standard_normal(n)
        elif kind == 2:
            vals = (rng.standard_normal(n) * 1e9).round(2)
        else:
            vals = np.round(rng.standard_normal(n), 3) * 10.0 ** rng.integers(-2, 3)
        enc = Encoder(T0)
        t = T0
        for v in vals:
            t += int(rng.integers(1, 60)) * NANOS
            enc.encode(t, float(v))
        streams.append(enc.stream())
    return streams


def _options(max_bytes=1 << 20, page_words=16, **kw):
    # small data pages and a side budget of its own, so the data pages are
    # the binding constraint of the accounting tests
    kw.setdefault("side_bytes", 1 << 20)
    kw.setdefault("side_page_chunks", 4)
    return dict(max_bytes=max_bytes, page_words=page_words, **kw)


def _pool(**kw):
    return ResidentPool(ResidentOptions(**_options(**kw)), device="cpu")


def _admit_each(pool, streams, shard=0, prefix=b"s", key=BlockKey, k=None):
    keys = []
    for i, s in enumerate(streams):
        sid = prefix + b"%03d" % i
        extra = {} if k is None else {"chunk_k": k}
        pool.admit_block("ns", shard, T0, 0, [(sid, s, 32)], **extra)
        keys.append(key("ns", shard, sid, T0, 0))
    return keys


# ---------- side planes ----------


def _snaps(streams, k=16):
    return [jchunked.snapshot_stream(s, k) for s in streams]


def test_side_rows_pack_and_unpack_match_jax():
    streams = _random_series(np.random.default_rng(1), 24)
    for snaps in _snaps(streams):
        want = jside.pack_side_rows(snaps, T0)
        got = tside.pack_side_rows(snaps, T0)
        np.testing.assert_array_equal(got, want)
        cols = {f: [p[f] for p in snaps] for f in snaps[0]}
        vec = tside.pack_side_rows_vec(
            cols["off"], cols["prev_time"], cols["prev_delta"], cols["time_unit"],
            np.asarray(cols["prev_float_bits"], np.uint64), np.asarray(cols["prev_xor"], np.uint64),
            np.asarray(cols["int_val"], np.uint64), cols["sig"], cols["mult"], cols["is_float"],
            cols["fast"], cols["fast_float"], T0)
        np.testing.assert_array_equal(vec, want)
        assert tside.unpack_side_rows(got, T0) == jside.unpack_side_rows(want, T0)


@pytest.mark.parametrize("field,value", [
    ("off", 1 << 21), ("time_unit", 8), ("sig", 64), ("mult", 32), ("prev_delta", 1 << 45),
    ("prev_time", T0 + (1 << 44)), ("prev_time", T0 - 1),
])
def test_side_row_overflow_is_none(field, value):
    snaps = _snaps([_stream(range(40))])[0]
    bad = [dict(p) for p in snaps]
    bad[-1][field] = value
    assert jside.pack_side_rows(bad, T0) is None
    assert tside.pack_side_rows(bad, T0) is None
    assert tside.pack_side_row(bad[-1], T0) is None
    assert tside.pack_side_row(bad[0], T0) is not None


def test_unpack_side_planes_matches_jax():
    import jax.numpy as jnp

    streams = _random_series(np.random.default_rng(2), 16)
    rows = np.concatenate([jside.pack_side_rows(s, T0) for s in _snaps(streams)])
    rows = np.concatenate([rows, np.zeros((3, tside.SIDE_WORDS), np.uint32)])  # zero page
    n = rows.shape[0]
    valid = np.arange(n) % 5 != 0
    blk_hi = np.full(n, T0 >> 32, np.uint32)
    blk_lo = np.full(n, T0 & 0xFFFFFFFF, np.uint32)
    want = jside.unpack_side_planes(jnp.asarray(rows), (jnp.asarray(blk_hi), jnp.asarray(blk_lo)),
                                    jnp.asarray(valid))
    got = tside.unpack_side_planes(
        torch.from_numpy(rows.view(np.int32)),
        (torch.from_numpy(blk_hi.astype(np.int64)), torch.from_numpy(blk_lo.astype(np.int64))),
        torch.from_numpy(valid))
    for name, w in want.items():
        g = got[name]
        if isinstance(w, tuple):
            for gi, wi in zip(g, w):
                np.testing.assert_array_equal(gi.numpy(), np.asarray(wi, np.int64), err_msg=name)
        else:
            np.testing.assert_array_equal(g.numpy(), np.asarray(w, np.int64), err_msg=name)


# ---------- pool mechanics ----------


def test_admission_page_accounting_and_zero_page():
    pool = _pool()
    streams = [_stream(range(10)), _stream(range(200)), b""]
    res = pool.admit_block(
        "ns", 0, T0, 0, [(b"a", streams[0], 32), (b"b", streams[1], 224), (b"c", b"", 0)]
    )
    assert res.admitted == 2 and res.complete
    st = pool.stats()
    assert st["entries"] == 2 and st["bytes"] == len(streams[0]) + len(streams[1])
    for sid in (b"a", b"b"):
        entry = pool.get(BlockKey("ns", 0, sid, T0, 0))
        assert entry is not None and 0 not in entry.pages and 0 not in entry.side_pages
    b_entry = pool.get(BlockKey("ns", 0, b"b", T0, 0))
    assert len(b_entry.pages) == -(-len(streams[1]) // (16 * 4))
    assert pool.is_complete("ns", 0, T0, 0)
    # the reserved zero pages stay zero; the staged pages hold the stream
    words = pool._words.numpy().view(np.uint32)
    assert not words[0].any() and not pool._side[0].any()
    data = np.frombuffer(streams[1] + bytes(-len(streams[1]) % 64), ">u4")
    np.testing.assert_array_equal(words[list(b_entry.pages)].reshape(-1), data)
    assert pool.device_bytes() == pool._words.nbytes + pool._side.nbytes
    a_entry = pool.get(BlockKey("ns", 0, b"a", T0, 0))
    assert st["upload_bytes"] == 16 * 4 * (len(a_entry.pages) + len(b_entry.pages)) + (
        pool._side[0].nbytes * (len(a_entry.side_pages) + len(b_entry.side_pages)))


def test_stats_keys_are_the_reference_subset():
    jst = JPool(JOptions(**_options())).stats()
    st = _pool().stats()
    # the read-through counter came with the Database wiring; the two device
    # ingest keys move only with born-resident admission (admit_block_device)
    assert set(st) == set(jst)
    assert st["readmissions"] == st["device_admissions"] == st["ingest_side_stage_bytes"] == 0


def test_lru_eviction_under_byte_budget_and_free_list_reuse():
    pool = _pool(max_bytes=5 * 16 * 4)  # 4 usable one-page lanes
    for i in range(4):
        assert pool.admit_block("ns", 0, T0 + i, 0, [(b"s", _stream([i]), 32)]).admitted
    freed = pool.get(BlockKey("ns", 0, b"s", T0 + 1, 0)).pages  # touch: now most recent
    assert pool.admit_block("ns", 0, T0 + 9, 0, [(b"s", _stream([9]), 32)]).admitted
    assert len(pool) == 4 and pool.evictions == 1
    assert pool.get(BlockKey("ns", 0, b"s", T0, 0)) is None  # LRU gone
    assert pool.get(BlockKey("ns", 0, b"s", T0 + 1, 0)).pages == freed
    assert not pool.is_complete("ns", 0, T0, 0)
    assert pool.is_complete("ns", 0, T0 + 9, 0)
    new = pool.get(BlockKey("ns", 0, b"s", T0 + 9, 0))
    assert new.pages[0] in range(1, 5)  # the evicted lane's page, reused


def test_batch_larger_than_pool_never_cannibalizes_itself():
    pool = _pool(max_bytes=4 * 16 * 4)  # 3 usable pages for 8 lanes
    values = [[float(i), float(i * 10)] for i in range(8)]
    res = pool.admit_block("ns", 0, T0, 0,
                           [(b"c%d" % i, _stream(v), 32) for i, v in enumerate(values)])
    assert not res.complete and res.rejected_budget > 0 and 0 < len(pool) <= 3
    for i in range(8):
        key = BlockKey("ns", 0, b"c%d" % i, T0, 0)
        if key in pool:
            (ts_vs,), err = resident_fetch_arrays(pool, [key])
            assert not err.any() and np.array_equal(ts_vs[1], values[i])


def test_page_span_limit_rejects_oversized_lane():
    pool = _pool(max_lane_pages=2)
    big = _stream(np.random.default_rng(0).standard_normal(500))
    res = pool.admit_block("ns", 0, T0, 0, [(b"big", big, 512), (b"ok", _stream([1]), 32)])
    assert res.rejected_span == 1 and res.admitted == 1 and not res.complete
    assert pool.get(BlockKey("ns", 0, b"big", T0, 0)) is None


@pytest.mark.parametrize("corrupt", [
    {"pages": (10**6,)}, {"pages": (0,)}, {"num_bits": 10**9}, {"side_pages": (10**6,)},
    {"n_chunks": 1000},
])
def test_corrupt_page_table_raises_not_out_of_bounds(corrupt):
    pool = _pool()
    pool.admit_block("ns", 0, T0, 0, [(b"s", _stream([1, 2, 3]), 32)])
    key = BlockKey("ns", 0, b"s", T0, 0)
    pool._od[key] = pool._od[key]._replace(**corrupt)
    with pytest.raises(ResidentPoolError):
        pool.plan_chunked([key])


def test_plan_chunked_misses_return_none():
    pool = _pool()
    assert pool.plan_chunked([BlockKey("ns", 0, b"s", T0, 0)]) is None  # nothing admitted
    pool.admit_block("ns", 0, T0, 0, [(b"s", _stream([1]), 32)])
    assert pool.plan_chunked([BlockKey("ns", 0, b"other", T0, 0)]) is None
    # mixed chunk sizes cannot share one plan
    pool.admit_block("ns", 0, T0, 0, [(b"k16", _stream([1]), 32)], chunk_k=16)
    keys = [BlockKey("ns", 0, b"s", T0, 0), BlockKey("ns", 0, b"k16", T0, 0)]
    assert pool.plan_chunked(keys) is None


def test_block_start_far_from_samples_admits_without_side_planes():
    """prev_time is stored block-relative in 44 bits: with block_start 0
    every chunk's carry overflows, the lane is admitted without side planes
    (counted) and a plan over it is None."""
    pool = _pool()
    res = pool.admit_block("ns", 0, 0, 0, [(b"s", _stream(range(40)), 64)])
    assert res.admitted == 1 and pool.side_pack_overflows == 1
    assert pool.get(BlockKey("ns", 0, b"s", 0, 0)).n_chunks == 0
    assert pool.plan_chunked([BlockKey("ns", 0, b"s", 0, 0)]) is None


def test_options_validate_and_disabled_pool():
    ResidentOptions(max_bytes=1 << 20).validate()
    with pytest.raises(ConfigError):
        ResidentOptions(max_bytes=100).validate()
    with pytest.raises(ConfigError):
        ResidentOptions(max_bytes=1 << 20, side_bytes=100).validate()
    with pytest.raises(ConfigError):
        ResidentOptions(page_words=0).validate()
    off = ResidentPool(ResidentOptions(max_bytes=0), device="cpu")
    assert not off.enabled
    assert off.admit_block("ns", 0, T0, 0, [(b"s", _stream([1]), 32)]) == (0, 0, 0, False)


def test_left_out_entry_points_raise():
    pool = _pool()
    # born-resident admission (ROADMAP §A6) is ported: one device-encoded lane
    # admits device to device, no stream byte uploaded
    from m3_tpu_torch.ops import encode as tenc

    t = T0 + np.arange(1, 41, dtype=np.int64) * NANOS
    res = tenc.encode_lanes([(t, np.arange(40.0))], [tenc.KIND_INT],
                            round_words_to=pool.options.page_words, device="cpu")
    side = tenc.side_rows_for(res, [(t, np.arange(40.0))], T0)
    r = pool.admit_block_device("ns", 0, T0, 0, res.words, [
        (b"d", 0, int(res.nbytes[0]), int(res.n_chunks[0]), tenc.lane_max_span(res, 0), side[0])])
    assert r.complete and r.admitted == 1
    assert pool.stats()["device_admissions"] == 1 and pool.stats()["upload_bytes"] == 0
    e = pool.get(BlockKey("ns", 0, b"d", T0, 0))
    got = pool._words[list(e.pages)].numpy().view(">u4").astype(np.uint32).tobytes()
    assert got.startswith(res.streams()[0])
    # the sharded resident scan (ROADMAP §A8) is ported: over a gloo world
    # of one it equals the single-device scan bit for bit
    keys = _admit_each(pool, [_stream([1.0]), _stream(range(40))])
    import tempfile

    import torch.distributed as dist
    from m3_tpu_torch.parallel.mesh import series_mesh

    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("gloo", store=dist.FileStore(f"{tmp}/store", 1), rank=0,
                                world_size=1)
        try:
            got = resident_scan_totals(pool, keys, mesh=series_mesh())
        finally:
            dist.destroy_process_group()
    want = resident_scan_totals(pool, keys)
    for f in want._fields:
        assert torch.equal(getattr(got, f), getattr(want, f)), f
    assert int(got.total_count) == 41


def test_side_planes_live_and_die_with_pages():
    pool = _pool()
    for i in range(6):
        pool.admit_block("ns", 0, T0 + i, 0, [(b"s", _stream(range(40)), 64)])
    st = pool.stats()
    assert st["side_pages_used"] > 0 and st["pages_used"] > 0
    pool.invalidate_series_block("ns", 0, b"s", T0)
    assert pool.stats()["side_pages_used"] < st["side_pages_used"]
    pool.clear()
    st3 = pool.stats()
    assert st3["pages_used"] == st3["side_pages_used"] == st3["bytes"] == 0
    assert len(pool._free) == pool.options.num_pages - 1
    assert len(pool._free_side) == pool.options.num_side_pages - 1


def test_invalidation_surface():
    pool = _pool()
    for vol in (0, 1):
        pool.admit_block("ns", 0, T0, vol, [(b"a", _stream([1.0]), 32), (b"b", _stream([2.0]), 32)])
    pool.admit_block("ns", 1, T0, 0, [(b"c", _stream([3.0]), 32)])
    assert len(pool) == 5
    assert pool.invalidate_block("ns", 0, T0, below_volume=1) == 2  # superseded volume
    assert not pool.is_complete("ns", 0, T0, 0) and pool.is_complete("ns", 0, T0, 1)
    assert pool.invalidate_series_block("ns", 0, b"a", T0) == 1
    assert pool.drop_shard(None, 1) == 1
    assert len(pool) == 1 and pool.invalidations == 4
    assert pool.shard_usage() == {("ns", 0): len(_stream([2.0]))}


def test_rebalance_sheds_cold_shard():
    pool = _pool(max_bytes=64 * 16 * 4)
    for shard in (0, 1):
        for i in range(8):
            pool.admit_block("ns", shard, T0 + i, 0, [(b"s", _stream(range(30)), 32)])
    used0 = pool.shard_usage()[("ns", 0)]
    evicted = pool.rebalance({"1": {"hits": 1000}}, slack=0.0)
    assert evicted > 0 and pool.rebalance_evictions == evicted
    assert pool.shard_usage().get(("ns", 0), 0) < used0
    assert pool.shard_usage()[("ns", 1)] == used0  # the hot shard keeps its entries


def test_admission_inplace_unless_scan_lease_active():
    """No lease: the upload writes the live buffers in place. Under a lease
    it writes a clone, so the holder's snapshot stays bit-stable."""
    pool = _pool()
    pool.admit_block("ns", 0, T0, 0, [(b"a", _stream([1.0]), 32)])
    assert pool.inplace_admissions == 1 and pool.copy_admissions == 0
    key_a = BlockKey("ns", 0, b"a", T0, 0)
    with pool.read_lease():
        plan = pool.plan_chunked([key_a])
        before = plan.words.clone(), plan.side.clone()
        pool.admit_block("ns", 0, T0 + 1, 0, [(b"b", _stream([2.0]), 32)])
        assert pool.copy_admissions == 1 and pool.inplace_admissions == 1
        assert torch.equal(plan.words, before[0]) and torch.equal(plan.side, before[1])
        assert pool._words is not plan.words
    live = pool._words
    pool.admit_block("ns", 0, T0 + 2, 0, [(b"c", _stream([3.0]), 32)])
    assert pool.inplace_admissions == 2 and pool._words is live
    assert pool.stats()["epoch"] >= 3
    for i, sid in enumerate((b"a", b"b", b"c")):
        (ts_vs,), err = resident_fetch_arrays(pool, [BlockKey("ns", 0, sid, T0 + i, 0)])
        assert not err.any() and ts_vs[1][0] == float(i + 1)


def test_read_lease_waits_for_inplace_write():
    pool = _pool()
    pool._donating = True
    import threading

    entered = threading.Event()

    def scan():
        with pool.read_lease():
            entered.set()

    t = threading.Thread(target=scan)
    t.start()
    assert not entered.wait(0.2)  # fenced while the in-place write runs
    with pool._lock:
        pool._donating = False
        pool._fence.notify_all()
    assert entered.wait(5)
    t.join()


def test_failed_upload_reclaims_pages_and_recovers(monkeypatch):
    real = pool_mod._scatter

    def boom(*a, **kw):
        raise RuntimeError("injected scatter failure")

    pool = _pool()
    pool.admit_block("ns", 0, T0, 0, [(b"a", _stream([1.0]), 32)])
    st0 = pool.stats()
    with pool.read_lease():  # copy path: the batch's pages come back
        monkeypatch.setattr(pool_mod, "_scatter", boom)
        with pytest.raises(RuntimeError):
            pool.admit_block("ns", 0, T0 + 1, 0, [(b"b", _stream([2.0]), 32)])
        monkeypatch.setattr(pool_mod, "_scatter", real)
    st = pool.stats()
    assert len(pool) == 1 and st["pages_used"] == st0["pages_used"]
    assert st["side_pages_used"] == st0["side_pages_used"]
    # in-place path: the pool resets instead of serving half-written pages
    monkeypatch.setattr(pool_mod, "_scatter", boom)
    with pytest.raises(RuntimeError):
        pool.admit_block("ns", 0, T0 + 3, 0, [(b"d", _stream([4.0]), 32)])
    monkeypatch.setattr(pool_mod, "_scatter", real)
    assert len(pool) == 0 and pool._words is None
    assert len(pool._free) == pool.options.num_pages - 1
    res = pool.admit_block("ns", 0, T0 + 4, 0, [(b"e", _stream([5.0]), 32)])
    assert res.admitted == 1 and res.complete
    (ts_vs,), err = resident_fetch_arrays(pool, [BlockKey("ns", 0, b"e", T0 + 4, 0)])
    assert not err.any() and ts_vs[1][0] == 5.0


def test_shared_snapshots_are_packed_once_and_staged_alike():
    """Items that pass one snapshot list (tiled data) share its packing;
    every lane still gets its own side pages holding those rows."""
    streams = _random_series(np.random.default_rng(9), 4)
    snaps = [tchunked.snapshot_stream(s, 32) for s in streams]
    pool = _pool()
    items = [(b"t%03d" % i, streams[i % 4], 32, snaps[i % 4]) for i in range(12)]
    assert pool.admit_block("ns", 0, T0, 0, items).admitted == 12
    side = pool._side.numpy().view(np.uint32)
    spc = pool.options.side_page_chunks
    for i in range(12):
        e = pool.get(BlockKey("ns", 0, b"t%03d" % i, T0, 0))
        rows = side[list(e.side_pages)].reshape(-1, tside.SIDE_WORDS)[: e.n_chunks]
        np.testing.assert_array_equal(rows, tside.pack_side_rows(snaps[i % 4], T0))
        assert len(e.side_pages) == -(-len(snaps[i % 4]) // spc)


# ---------- device lane assembly ----------


@pytest.fixture(scope="module")
def mixed_pool():
    streams = _random_series(np.random.default_rng(42), 24)
    pool = _pool(max_bytes=4 << 20)
    keys = _admit_each(pool, streams, k=16)
    return pool, keys, streams


@pytest.mark.parametrize("order,rows", [("c", 8), ("s", 8), ("c", 32)])
def test_assemble_resident_packed_equals_pack_lanes(mixed_pool, order, rows):
    pool, keys, streams = mixed_pool
    plan = pool.plan_chunked(keys)
    got, s_pad = tscan.assemble_resident_packed(plan, 32, order=order, rows=rows)
    batch = tchunked.build_chunked(streams + [b""] * (s_pad - len(streams)), k=16)
    want = tfused.pack_lanes(batch, order=order, rows=rows, device="cpu")
    assert got.n == want.n and got.order == order
    assert torch.equal(got.windows, want.windows)
    assert torch.equal(got.lanes, want.lanes)
    assert torch.equal(got.tile_flags, want.tile_flags)


def test_assemble_resident_lanes_equals_chunked_device_args(mixed_pool):
    pool, keys, streams = mixed_pool
    got, s_pad = tscan.assemble_resident_lanes(pool.plan_chunked(keys), 32)
    batch = tchunked.build_chunked(streams + [b""] * (s_pad - len(streams)), k=16)
    want = tscan.chunked_device_args(batch, device="cpu")
    assert set(got) == set(want)
    for name, w in want.items():
        for g, wi in zip(got[name], w) if isinstance(w, tuple) else [(got[name], w)]:
            assert g.dtype == wi.dtype and torch.equal(g, wi), name


def test_assembly_in_blocks_equals_one_block(mixed_pool, monkeypatch):
    pool, keys, _ = mixed_pool
    plan = pool.plan_chunked(keys)
    whole, _ = tscan.assemble_resident_packed(plan, 256, rows=8)
    lanes, _ = tscan.assemble_resident_lanes(plan, 256)
    monkeypatch.setattr(tscan, "_GATHER_BLOCK_LANES", 1024)
    blocked, _ = tscan.assemble_resident_packed(plan, 256, rows=8)
    lanes_b, _ = tscan.assemble_resident_lanes(plan, 256)
    assert whole.n > 1024
    assert torch.equal(whole.windows, blocked.windows) and torch.equal(whole.lanes, blocked.lanes)
    assert torch.equal(whole.tile_flags, blocked.tile_flags)
    assert torch.equal(lanes["windows"], lanes_b["windows"])


def test_fused_scan_over_resident_lanes(mixed_pool):
    """B3 (the twin here) over the resident per-field lanes equals B3 over
    the host-built ones, and counts what B1's resident scan counts."""
    pool, keys, streams = mixed_pool
    plan = pool.plan_chunked(keys)
    args, s_pad = tscan.assemble_resident_lanes(plan, 32)
    c, k = plan.num_chunks, plan.chunk_k
    got = tscan.chunked_scan_aggregate_fused(args, s_pad, c, k)
    batch = tchunked.build_chunked(streams + [b""] * (s_pad - len(streams)), k=k)
    want = tscan.chunked_scan_aggregate_fused(tscan.chunked_device_args(batch, "cpu"), s_pad, c, k)
    _assert_scan_identical(got, want)
    assert int(got.total_count) == int(resident_scan_totals(pool, keys).total_count)


# ---------- scans and fetches ----------


def _assert_scan_identical(got, want, total_sum=True):
    for f in ("series_sum", "series_count", "series_min", "series_max", "series_last"):
        g, w = np.asarray(getattr(got, f)), np.asarray(getattr(want, f))
        if g.dtype == np.float32:
            g, w = g.view(np.int32), w.view(np.int32)
        np.testing.assert_array_equal(g, w, err_msg=f)
    np.testing.assert_array_equal(np.asarray(got.series_err), np.asarray(want.series_err))
    assert int(got.total_count) == int(want.total_count)
    fields = ("total_min", "total_max") + (("total_sum",) if total_sum else ())
    for f in fields:
        assert np.float32(getattr(got, f)).view(np.int32) == np.float32(
            getattr(want, f)).view(np.int32), f


def test_resident_scan_bit_exact_vs_streamed(mixed_pool):
    pool, keys, streams = mixed_pool
    got = resident_scan_totals(pool, keys)
    assert got.series_sum.shape == (len(keys),) and got.series_sum.device.type == "cpu"
    _assert_scan_identical(got, streamed_scan_totals(streams, k=16, device="cpu"))
    padded = resident_scan_totals(pool, keys, device_out=True)
    assert padded.series_sum.shape == (32,)


def test_resident_scan_matches_jax_resident_scan():
    streams = _random_series(np.random.default_rng(7), 24)
    pool = _pool(max_bytes=4 << 20)
    keys = _admit_each(pool, streams)
    jpool = JPool(JOptions(**_options(max_bytes=4 << 20)))
    jkeys = _admit_each(jpool, streams, key=JBlockKey)
    got = resident_scan_totals(pool, keys)
    want = j_resident_scan_totals(jpool, jkeys)
    _assert_scan_identical(got, want, total_sum=False)
    np.testing.assert_allclose(float(got.total_sum), float(want.total_sum), rtol=1e-6)


def test_resident_fetch_arrays_bit_exact_vs_host_codec(mixed_pool):
    pool, keys, streams = mixed_pool
    arrays, err = resident_fetch_arrays(pool, keys)
    assert not err.any() and len(arrays) == len(keys)
    for (ts, vs), s in zip(arrays, streams):
        dps = decode(s)
        np.testing.assert_array_equal(ts, [d.timestamp for d in dps])
        np.testing.assert_array_equal(vs.view(np.int64), np.asarray([d.value for d in dps]).view(np.int64))


def test_annotated_stream_flags_err_lane():
    enc = Encoder(T0)
    enc.encode(T0 + NANOS, 1.0, annotation=b"meta")
    enc.encode(T0 + 2 * NANOS, 2.0)
    pool = _pool()
    keys = _admit_each(pool, [_stream([1.0, 2.0, 3.0]), enc.stream()])
    _, err = resident_fetch_arrays(pool, keys)
    assert not err[0] and err[1]
    agg = resident_scan_totals(pool, keys)
    assert not bool(agg.series_err[0]) and bool(agg.series_err[1])


def test_warm_scans_move_zero_upload_bytes(mixed_pool):
    from m3_tpu_torch.resident.scan import _M_STREAMED_BYTES

    pool, keys, streams = mixed_pool
    resident_scan_totals(pool, keys)
    up, streamed = pool._m_upload.value, _M_STREAMED_BYTES.value
    for _ in range(3):
        resident_scan_totals(pool, keys)
        resident_fetch_arrays(pool, keys[:4])
    assert pool._m_upload.value == up and _M_STREAMED_BYTES.value == streamed
    streamed_scan_totals(streams[:6], k=16, device="cpu")
    assert _M_STREAMED_BYTES.value - streamed == sum(len(s) for s in streams[:6])


def test_eviction_mid_plan_scan_stays_consistent():
    pool = _pool(max_bytes=4 << 20)
    keys = _admit_each(pool, [_stream([1.0, 2.0]), _stream([3.0, 4.0])], prefix=b"v")
    with pool.read_lease():
        plan = pool.plan_chunked(keys)
        pool.invalidate_series_block("ns", 0, b"v001", T0)
        packed, _ = tscan.assemble_resident_packed(plan, 8)
        assert packed.windows.shape[1] >= 1
    assert pool.plan_chunked(keys) is None
    assert resident_scan_totals(pool, keys) is None
    assert resident_fetch_arrays(pool, keys) is None
