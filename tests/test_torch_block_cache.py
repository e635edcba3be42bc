"""Port parity for the decoded-block cache (m3_tpu_torch.cache): mirrors
of ``tests/test_block_cache.py`` — hit/miss accounting, byte-budget LRU
eviction, write/flush/tick invalidation, single-flight concurrency,
admission policy, and the cache-aware reads of the port's Database (on
``device="cpu"``) and ``M3Storage.fetch``. The YAML config loader and the
cluster, repair and session cases wait for their slices."""

from __future__ import annotations

import threading

import numpy as np

from m3_tpu_torch.cache import (
    AdmissionPolicy,
    BlockCache,
    BlockKey,
    CacheInvalidator,
    CacheOptions,
    DecodedBlock,
)
from m3_tpu_torch.storage.database import Database as _Database
from m3_tpu_torch.storage.database import NamespaceOptions

NANOS = 1_000_000_000
T0 = 1_600_000_000 * NANOS  # block-aligned for the default 2h block size
BLOCK = 2 * 3600 * NANOS


def Database(*args, **kwargs):
    """The port's Database on the CPU (it defaults to the card)."""
    return _Database(*args, device="cpu", **kwargs)


def _db(tmp_path, **kw):
    db = Database(str(tmp_path), num_shards=4, commitlog_enabled=False, **kw)
    db.create_namespace("default", NamespaceOptions())
    return db



def make_block(n=16, t0=T0, step=NANOS):
    times = np.arange(t0, t0 + n * step, step, dtype=np.int64)
    return DecodedBlock(times, np.arange(n, dtype=np.float64), np.ones(n, np.uint8))


def key_for(i=0, sid=b"s", bs=T0, vol=0, ns="default"):
    return BlockKey(ns, i, sid, bs, vol)


def test_hit_miss_accounting():
    cache = BlockCache(CacheOptions(max_bytes=1 << 20))
    k = key_for()
    assert cache.get(k) is None
    assert cache.stats()["misses"] == 1 and cache.stats()["hits"] == 0
    cache.put(k, make_block())
    assert cache.get(k) is not None
    st = cache.stats()
    assert st["hits"] == 1 and st["misses"] == 1 and st["hit_rate"] == 0.5
    assert st["entries"] == 1 and st["bytes"] > 0


def test_byte_budget_lru_eviction_order():
    blk = make_block(n=16)
    # room for exactly 3 entries
    cache = BlockCache(CacheOptions(max_bytes=3 * blk.nbytes))
    keys = [key_for(i) for i in range(4)]
    for k in keys[:3]:
        assert cache.put(k, make_block(n=16))
    # touch k0 so k1 becomes the least recently used
    assert cache.get(keys[0]) is not None
    assert cache.put(keys[3], make_block(n=16))
    assert keys[1] not in cache  # LRU victim
    assert keys[0] in cache and keys[2] in cache and keys[3] in cache
    st = cache.stats()
    assert st["evictions"] == 1
    assert st["bytes"] <= 3 * blk.nbytes


def test_reput_same_key_does_not_leak_bytes():
    cache = BlockCache(CacheOptions(max_bytes=1 << 20))
    k = key_for()
    blk = make_block(n=16)
    cache.put(k, blk)
    cache.put(k, make_block(n=16))  # replace in place
    assert cache.stats()["entries"] == 1
    assert cache.stats()["bytes"] == blk.nbytes


def test_decoded_block_valid_lazy():
    blk = make_block(n=8)
    base = blk.times.nbytes + blk.values.nbytes + blk.units.nbytes
    assert blk.nbytes == base + 256  # lazy mask not charged to the budget
    assert blk.valid.all() and len(blk.valid) == 8
    assert not blk.valid.flags.writeable
    explicit = DecodedBlock(
        blk.times, blk.values, blk.units, valid=np.zeros(8, bool)
    )
    assert not explicit.valid.any()
    assert explicit.nbytes == base + 8 + 256  # provided mask is charged


def test_eviction_frees_bytes_exactly():
    blk_bytes = make_block(n=8).nbytes
    cache = BlockCache(CacheOptions(max_bytes=2 * blk_bytes))
    for i in range(10):
        cache.put(key_for(i), make_block(n=8))
    assert len(cache) == 2
    assert cache.stats()["bytes"] == 2 * blk_bytes
    assert cache.stats()["evictions"] == 8


def test_admission_policy():
    opts = CacheOptions(
        max_bytes=1 << 20, min_block_bytes=1024, namespaces=["allowed"]
    )
    policy = AdmissionPolicy(opts)
    big, small = make_block(n=256), make_block(n=4)
    assert big.nbytes >= 1024 and small.nbytes < 1024
    assert policy.admit(key_for(ns="allowed"), big.nbytes)
    assert not policy.admit(key_for(ns="allowed"), small.nbytes)  # too small
    assert not policy.admit(key_for(ns="other"), big.nbytes)  # not allowlisted
    assert not policy.admit(key_for(ns="allowed"), (1 << 20) + 1)  # > budget
    cache = BlockCache(opts)
    assert not cache.put(key_for(ns="other"), big)
    assert cache.put(key_for(ns="allowed"), big)
    assert len(cache) == 1
    disabled = AdmissionPolicy(CacheOptions(enabled=False))
    assert not disabled.admit(key_for(), big.nbytes)


def test_get_or_decode_single_flight():
    cache = BlockCache(CacheOptions(max_bytes=1 << 20))
    k = key_for()
    decodes = []
    started = threading.Barrier(3)  # 2 workers + the main thread
    release = threading.Event()

    def decode():
        decodes.append(threading.get_ident())
        release.wait(5.0)
        return make_block()

    results = []

    def worker():
        started.wait(5.0)
        results.append(cache.get_or_decode(k, decode))

    threads = [threading.Thread(target=worker) for _ in range(2)]
    for t in threads:
        t.start()
    # let both threads race into get_or_decode, then let the decode finish
    started.wait(5.0)
    release.set()
    for t in threads:
        t.join(5.0)
    assert len(decodes) == 1, "racing readers must decode the key once"
    assert len(results) == 2 and all(r is not None for r in results)
    assert results[0] is results[1]  # same shared entry
    assert cache.stats()["hits"] == 1 and cache.stats()["misses"] == 1


def test_get_or_decode_uncacheable_negative_cached():
    """A None decode (annotated stream) leaves a negative sentinel: the
    block is immutable, so later reads skip the decode-and-discard."""
    cache = BlockCache(CacheOptions(max_bytes=1 << 20))
    k = key_for()
    calls = []

    def decode():
        calls.append(1)
        return None

    assert cache.get_or_decode(k, decode) is None
    assert cache.get_or_decode(k, decode) is None  # sentinel hit, no decode
    assert len(calls) == 1 and cache.stats()["hits"] == 1
    assert cache.get(k) is None  # sentinel never leaks to callers
    # write invalidation purges the sentinel like any entry
    CacheInvalidator(cache).on_write("default", 0, b"s", T0)
    assert cache.get_or_decode(k, decode) is None
    assert len(calls) == 2


def test_invalidation_surface():
    cache = BlockCache(CacheOptions(max_bytes=1 << 20))
    inval = CacheInvalidator(cache)
    k_v0 = key_for(0, vol=0)
    k_v1 = key_for(0, vol=1)
    k_other = key_for(0, sid=b"other")
    for k in (k_v0, k_v1, k_other):
        cache.put(k, make_block())
    # write hook: every volume of that (series, block) drops; others stay
    assert inval.on_write("default", 0, b"s", T0) == 2
    assert k_v0 not in cache and k_v1 not in cache and k_other in cache
    # flush supersession: only volumes BELOW the new one drop
    cache.put(k_v0, make_block())
    cache.put(k_v1, make_block())

    class Fid:
        block_start, volume = T0, 1

    # both volume-0 entries of the block drop (k_v0 AND the other series —
    # a cold flush merges every cold series into the new volume); volume 1
    # survives
    assert inval.on_flush("default", 0, [Fid()]) == 2
    assert k_v0 not in cache and k_other not in cache and k_v1 in cache
    # tick expiry: the whole block goes (only k_v1 is left)
    assert inval.on_tick_expire("default", 0, [T0]) == 1
    assert len(cache) == 0
    # hooks are no-ops without a cache
    assert CacheInvalidator(None).on_write("default", 0, b"s", T0) == 0


def test_read_through_and_warm_hit_rate(tmp_path):
    db = _db(tmp_path)
    sids = [b"series-%d" % i for i in range(8)]
    for sid in sids:
        for j in range(32):
            db.write("default", sid, T0 + j * NANOS, float(j))
    db.flush("default", T0 + 2 * BLOCK)
    # cold pass populates
    for sid in sids:
        t, v, _ = db.read_arrays("default", sid, 0, 2**62)
        assert len(t) == 32 and v[31] == 31.0
    cold = db.block_cache.stats()
    assert cold["entries"] == len(sids) and cold["hits"] == 0
    # warm pass: every block served from cache
    for sid in sids:
        t, v, _ = db.read_arrays("default", sid, 0, 2**62)
        assert len(t) == 32
    warm = db.block_cache.stats()
    assert warm["misses"] == cold["misses"], "warm pass must not re-decode"
    warm_lookups = (warm["hits"] - cold["hits"]) + (warm["misses"] - cold["misses"])
    assert (warm["hits"] - cold["hits"]) / warm_lookups >= 0.9
    db.close()


def test_cache_parity_with_segment_path(tmp_path):
    """Cached reads must be indistinguishable from the segment decode path
    (same merge, same newest-wins dedupe, same codec rounding)."""
    db = _db(tmp_path)
    nocache = _db(
        tmp_path / "nocache", cache_options=CacheOptions(enabled=False)
    )
    assert nocache.block_cache is None
    # unaligned timestamps exercise the codec's unit truncation; overwrite
    # + cold write exercise the buffer-over-fileset precedence
    writes = [
        (b"s1", T0 + 123_456_789, 1.5),
        (b"s1", T0 + NANOS, 2.5),
        (b"s1", T0 + BLOCK + 7, 3.5),
        (b"s2", T0 + 2 * NANOS, -4.0),
    ]
    for db_ in (db, nocache):
        for sid, t, v in writes:
            db_.write("default", sid, t, v)
        db_.flush("default", T0 + BLOCK)  # first block sealed, second buffered
        db_.write("default", sid=b"s1", t_nanos=T0 + NANOS, value=9.0)  # cold overwrite
    expected = {}
    for sid in (b"s1", b"s2"):
        a = db.read("default", sid, 0, 2**62)
        b = nocache.read("default", sid, 0, 2**62)
        expected[sid] = [(dp.timestamp, dp.value) for dp in a]
        assert expected[sid] == [(dp.timestamp, dp.value) for dp in b]
    # warm read identical too
    a2 = db.read("default", b"s1", 0, 2**62)
    assert [(dp.timestamp, dp.value) for dp in a2] == expected[b"s1"]
    db.close()
    nocache.close()


def test_write_invalidates_cached_block(tmp_path):
    """Acceptance: a write into a cached block's series invalidates the
    affected entries and the next read returns fresh data."""
    db = _db(tmp_path)
    for j in range(16):
        db.write("default", b"hot", T0 + j * NANOS, float(j))
        db.write("default", b"cold", T0 + j * NANOS, float(-j))
    db.flush("default", T0 + BLOCK)
    db.read("default", b"hot", 0, 2**62)
    db.read("default", b"cold", 0, 2**62)
    assert db.block_cache.stats()["entries"] == 2
    # cold write into the sealed, cached block
    db.write("default", b"hot", T0 + 3 * NANOS, 999.0)
    st = db.block_cache.stats()
    assert st["entries"] == 1 and st["invalidations"] == 1, (
        "write must drop exactly the written series' entries"
    )
    dps = db.read("default", b"hot", 0, 2**62)
    by_t = {dp.timestamp: dp.value for dp in dps}
    assert by_t[T0 + 3 * NANOS] == 999.0, "read after write must be fresh"
    assert len(dps) == 16
    # the untouched series still hits
    h0 = db.block_cache.stats()["hits"]
    db.read("default", b"cold", 0, 2**62)
    assert db.block_cache.stats()["hits"] == h0 + 1
    db.close()


def test_write_batch_invalidates_cached_block(tmp_path):
    db = _db(tmp_path)
    for j in range(8):
        db.write("default", b"wb", T0 + j * NANOS, float(j))
    db.flush("default", T0 + BLOCK)
    db.read("default", b"wb", 0, 2**62)
    assert db.block_cache.stats()["entries"] == 1
    db.write_batch("default", [(b"wb", T0 + 100 * NANOS, 7.0)])
    assert db.block_cache.stats()["entries"] == 0
    dps = db.read("default", b"wb", 0, 2**62)
    assert {dp.value for dp in dps} >= {7.0}
    db.close()


def test_cold_flush_supersedes_cached_volume(tmp_path):
    db = _db(tmp_path)
    for j in range(8):
        db.write("default", b"s", T0 + j * NANOS, float(j))
    db.flush("default", T0 + BLOCK)
    db.read("default", b"s", 0, 2**62)  # caches volume 0
    keys = list(db.block_cache._od)
    assert keys and keys[0].volume == 0
    db.write("default", b"s", T0 + 50 * NANOS, 50.0)  # cold write
    db.flush("default", T0 + BLOCK)  # cold flush → volume 1
    assert all(k.volume != 0 for k in db.block_cache._od), (
        "superseded volume-0 entries must be reclaimed"
    )
    t, v, _ = db.read_arrays("default", b"s", 0, 2**62)
    assert len(t) == 9 and 50.0 in v.tolist()
    assert any(k.volume == 1 for k in db.block_cache._od)
    db.close()


def test_annotated_block_falls_back_and_negative_caches(tmp_path):
    """An annotated sealed stream can't live in the cache (arrays drop
    Datapoint.annotation): reads fall back to the iterator path with
    annotations intact, and the key is negative-cached so only the first
    read pays the probe decode."""
    from m3_tpu_torch.codec.m3tsz import Encoder
    from m3_tpu_torch.storage.fs import CHUNK_K, FilesetID, write_fileset

    db = _db(tmp_path)
    sid = b"annotated"
    enc = Encoder(T0)
    enc.encode(T0, 1.0, annotation=b"meta")
    enc.encode(T0 + NANOS, 2.0)
    shard = db.namespaces["default"].shard_for(sid)
    fid = FilesetID("default", shard.id, T0, volume=0)
    write_fileset(str(tmp_path), fid, {sid: enc.stream()}, BLOCK, CHUNK_K)
    shard._flushed_blocks.add(T0)
    shard._invalidate_filesets()
    dps = db.read("default", sid, 0, 2**62)
    assert [dp.value for dp in dps] == [1.0, 2.0]
    assert dps[0].annotation == b"meta"
    st = db.block_cache.stats()
    assert st["entries"] == 1  # the negative sentinel
    dps2 = db.read("default", sid, 0, 2**62)
    assert dps2[0].annotation == b"meta"
    st2 = db.block_cache.stats()
    assert st2["misses"] == st["misses"], "second read must not re-probe"
    assert st2["hits"] > st["hits"]
    db.close()


def test_tick_expiry_drops_cached_entries(tmp_path):
    db = _db(tmp_path)
    for j in range(8):
        db.write("default", b"s", T0 + j * NANOS, float(j))
    db.flush("default", T0 + BLOCK)
    db.read("default", b"s", 0, 2**62)
    assert db.block_cache.stats()["entries"] == 1
    retention = db.namespaces["default"].opts.retention_nanos
    db.tick(T0 + BLOCK + retention + NANOS)
    assert db.block_cache.stats()["entries"] == 0
    db.close()


def test_concurrent_shard_reads_decode_once(tmp_path):
    db = _db(tmp_path)
    for j in range(64):
        db.write("default", b"s", T0 + j * NANOS, float(j))
    db.flush("default", T0 + BLOCK)
    results, errors = [], []

    def reader():
        try:
            t, v, _ = db.read_arrays("default", b"s", 0, 2**62)
            results.append(v.sum())
        except Exception as exc:  # pragma: no cover
            errors.append(exc)

    threads = [threading.Thread(target=reader) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(10.0)
    assert not errors and len(set(results)) == 1
    st = db.block_cache.stats()
    assert st["misses"] == 1 and st["hits"] == 7
    db.close()


def test_query_fetch_uses_cache(tmp_path):
    """query/m3_storage.py fetch is cache-aware end to end."""
    from m3_tpu_torch.query.m3_storage import M3Storage
    from m3_tpu_torch.query.promql import Matcher

    db = _db(tmp_path)
    for i in range(6):
        tags = ((b"__name__", b"cpu"), (b"host", b"h%d" % i))
        for j in range(24):
            db.write_tagged("default", tags, T0 + j * NANOS, float(i + j))
    db.flush("default", T0 + BLOCK)
    storage = M3Storage(db, "default")
    matchers = [Matcher("__name__", "=", "cpu")]
    cold = storage.fetch(matchers, T0, T0 + BLOCK)
    assert len(cold) == 6 and all(len(t) == 24 for _, t, _ in cold)
    before = db.block_cache.stats()
    warm = storage.fetch(matchers, T0, T0 + BLOCK)
    after = db.block_cache.stats()
    assert after["misses"] == before["misses"]
    assert after["hits"] - before["hits"] >= 6
    for (tg_a, t_a, v_a), (tg_b, t_b, v_b) in zip(cold, warm):
        assert tg_a == tg_b
        np.testing.assert_array_equal(t_a, t_b)
        np.testing.assert_array_equal(v_a, v_b)
    db.close()

